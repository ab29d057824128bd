"""The polarized field through GRIN rods on the port's fused path against
the JAX package, on the CPU.

The port's ``simulate_fused`` with ``track_field`` (its plain versions of
K1, K2, K5 and K6 on CPU tensors) against the JAX package's
``simulate_fused`` (its fused kernels in interpret mode, as
tests/test_grin.py:435 runs them: ``block_rows=4``, ``auto_dispatch=False``)
on the JAX package's own rays and parameters (``interop``):

- tests/test_grin.py:242's meridional launches: an s-polarized (y) launch
  stays exactly y, a p-polarized one turns with the ray;
- tests/test_grin.py:283's Brewster plate after the rod
  (``chip_smoke.grin_field_scene``'s, its media ordered so that the ray
  enters the glass): p at Brewster's angle gives T = 1, s less;
- tests/test_grin.py:435's 32-step rod, 1024 rays;
- a rod as a 3-bounce Scene, lit by skew rays;
- gradients in n0, grin_A and E0 of a loss away from any focus against
  ``jax.grad`` of the JAX package's eager ``simulate``;
- the host harness of csrc/grin.cuh with the field (tests/grin_harness.cpp
  built with g++): the rod's field against the plain rod's and its adjoint
  against torch autograd in float64.

Tolerances, each with its reason: positions atol 2e-5 and directions 2e-6
(tests/test_torch_grin.py's: float32 through up to 32 RK4 steps of another
compiler's order); the field's components atol 1e-5 and its power rtol 1e-5
(tests/test_grin.py:435's own); moments rtol 1e-5 and atol 1e-5 of their
scale (tests/test_torch_kind_mix.py's); gradients rtol 2e-3 of the leaf's
scale (float32 sums over the rays in another order, through the steps'
adjoint); the harness's field within 1e-6 of the float32 plain rod and
its cotangents within 1e-5 of their scale against float64 autograd.
"""

import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.rays.ray import Rays as JRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core import grin as tgrin
from raytracetorch_tpu_torch.core.intersect import intersect
from raytracetorch_tpu_torch.core.table import (ROW_OFFSETS, FlatRow,
                                                flatten_table_rows)

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')
HARNESS = Path(__file__).with_name('grin_harness.cpp')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **kw)


def _rod(rt, L, n_steps=32):
    return rt.GrinRod(radius=cs.GRIN_R, thickness=L, n0=cs.GRIN_N0,
                      grin_A=cs.GRIN_A0, n_steps=n_steps,
                      translation=[0, 0, L / 2.0], name='rod')


def _scenes(make):
    """(JAX scene, port scene, JAX params, port params) of ``make(rt)``."""
    js, ts = make(jrt), make(trt)
    pj = js.init_params()
    return js, ts, pj, interop.params_from_numpy(_np(pj), 'cpu')


def _fan(xs, dxs=None):
    """Rays at (x, 0, -3) along +z (or tilted by dxs in x)."""
    xs = np.asarray(xs, np.float32)
    dx = np.zeros_like(xs) if dxs is None else np.asarray(dxs, np.float32)
    pos = np.stack([xs, np.zeros_like(xs), np.full_like(xs, -3.0)], 1)
    d = np.stack([dx, np.zeros_like(xs), np.sqrt(1.0 - dx * dx)], 1)
    rj = JRays.create(jnp.asarray(pos), jnp.asarray(d, jnp.float32))
    return rj, interop.rays_from_numpy(_np(rj), 'cpu')


def _disk(radius, n, center=(0.0, 0.0, -3.0)):
    rj = jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                 translation=list(center)).sample(KEY, n)
    return rj, interop.rays_from_numpy(_np(rj), 'cpu')


def _point(n):
    rj = jrt.PointSource.make(na=cs.GRIN_FIELD_NA,
                              translation=list(cs.GRIN_FIELD_SRC)).sample(
                                  KEY, n)
    return rj, interop.rays_from_numpy(_np(rj), 'cpu')


def _fused(js, ts, pj, pt, rj, rt_, E0):
    """Both packages' fused traces with the field -> ((JAX out, sensors,
    aux), (port out, sensors, aux))."""
    kw = dict(block_rows=4, auto_dispatch=False) if js.sequential else \
        dict(block_rows=2)
    ej = jnp.asarray(E0, jnp.complex64 if np.iscomplexobj(E0)
                     else jnp.float32)
    return (js.simulate_fused(pj, rj, KEY, track_field=True, E0=ej, **kw),
            ts.simulate_fused(pt, rt_, track_field=True, E0=E0))


def _compare(res_j, res_t, moments=True):
    """Rays, the field's six streams and |E|^2, and the moments."""
    (oj, sj, aj), (ot, st, at) = res_j, res_t
    for c, tol in (('px', 2e-5), ('py', 2e-5), ('pz', 2e-5), ('dx', 2e-6),
                   ('dy', 2e-6), ('dz', 2e-6), ('intensity', 2e-6)):
        _close(getattr(ot, c), getattr(oj, c), atol=tol)
    for f in FIELDS:
        _close(getattr(at['field'], f), getattr(aj['field'], f), atol=1e-5)
    _close(at['field_power'], aj['field_power'], rtol=1e-5, atol=1e-6)
    if moments:
        mj = np.asarray(sj.moments)
        _close(st.moments, mj, rtol=1e-5,
               atol=1e-5 * max(np.abs(mj).max(), 1.0))


def test_meridional_launches_keep_s_and_turn_p():
    """tests/test_grin.py:242: through a 25 mm rod an s-polarized (y)
    launch at x = 2 stays exactly y, a p-polarized (x) one turns with the
    ray (the minimal rotation of x from z to the exit direction); the
    fused traces of both packages agree."""
    js, ts, pj, pt = _scenes(lambda rt: rt.SequentialScene([_rod(rt, 25.0)]))
    rj, rt_ = _fan([2.0, 2.0])
    E0 = [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]
    res_j, res_t = _fused(js, ts, pj, pt, rj, rt_, E0)
    _compare(res_j, res_t, moments=False)
    f, out = res_t[2]['field'], res_t[0]
    _close([f.erx[0], f.ery[0], f.erz[0]], [0.0, 1.0, 0.0], atol=1e-6)
    d = torch.stack(out.dir_c, 1)[1].double().numpy()
    want = np.array([d[2], 0.0, -d[0]]) / math.hypot(d[2], d[0])
    _close([f.erx[1], f.ery[1], f.erz[1]], want, atol=1e-5)


def test_brewster_plate_after_the_rod():
    """tests/test_grin.py:283: the rod bends the ray launched at x = 2 onto
    Brewster's angle of a FRESNEL_W plate: p-polarized it passes whole (T
    = 1), s-polarized it loses R_s; both packages' fused traces agree."""
    js, ts, pj, pt = _scenes(lambda rt: cs.grin_field_scene(rt, 'brewster'))
    rj, rt_ = _fan([cs.GRIN_FIELD_X, cs.GRIN_FIELD_X])
    res_j, res_t = _fused(js, ts, pj, pt, rj, rt_,
                          [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    _compare(res_j, res_t)
    intensity = res_t[0].intensity
    _close(intensity[0], 1.0, atol=1e-5)
    assert float(intensity[1]) < 0.9


def test_32_step_rod_field_matches_jax():
    """tests/test_grin.py:435: a 10 mm rod of 32 steps under a collimated
    disk of radius 3, 1024 rays, E0 = (0.8, 0.6, 0): the rays, the field
    and its power of both packages' fused traces."""
    js, ts, pj, pt = _scenes(lambda rt: rt.SequentialScene([
        _rod(rt, 10.0),
        rt.SensorElement(radius=10.0, translation=[0, 0, 20.0], name='s')]))
    rj, rt_ = _disk(3.0, 1024)
    _compare(*_fused(js, ts, pj, pt, rj, rt_, [0.8, 0.6, 0.0]))


def _ns_scene(rt):
    return rt.Scene([_rod(rt, 20.0),
                     rt.SensorElement(radius=8.0, translation=[0, 0, 25.0],
                                      name='s')], n_bounces=3)


def test_rod_scene_field_matches_jax():
    """A 20 mm rod of 32 steps as a 3-bounce Scene under the off-axis point
    source of chip_smoke.py section 22 (skew rays), circular E0: the rays,
    the field and the moments of both packages' fused bounce loops."""
    js, ts, pj, pt = _scenes(_ns_scene)
    rj, rt_ = _point(256)
    _compare(*_fused(js, ts, pj, pt, rj, rt_, cs.GRIN_FIELD_E0['ns']))


def _grad_scene(rt, nonseq):
    els = [_rod(rt, 12.0, n_steps=16),
           rt.SensorElement(radius=8.0, translation=[0, 0, 30.0], name='s')]
    return rt.Scene(els, n_bounces=3) if nonseq else rt.SequentialScene(els)


@pytest.mark.parametrize('nonseq', [False, True])
def test_field_gradients_match_jax(nonseq):
    """Gradients of a spot and field loss (the sensor 18 mm past the rod,
    away from its focus) in the rod's n0 and grin_A and in E0 through the
    port's fused trace (K2's or K6's plain version) against jax.grad of the
    JAX package's eager simulate."""
    js, ts, pj, pt = _scenes(lambda rt: _grad_scene(rt, nonseq))
    rj, rt_ = _point(128)
    E0 = np.array([0.6, 0.8, 0.0], np.float32)

    def loss_of(sens, field):
        return (sens.spot_rms(0)[0] ** 2 + 0.1 * field.erx.mean()
                + 0.1 * field.ery.mean())

    def jloss(p, e0):
        _, s, aux = js.simulate(p, rj, KEY, track_field=True, E0=e0)
        return loss_of(s, aux['field'])
    gp_j, ge_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(pj,
                                                          jnp.asarray(E0))
    p = {k: dict(v) for k, v in pt.items()}
    p['rod'] = {k: v.clone().requires_grad_(k in ('n0', 'grin_A'))
                for k, v in pt['rod'].items()}
    e0 = torch.from_numpy(E0).requires_grad_(True)
    _, s, aux = ts.simulate_fused(p, rt_, track_field=True, E0=e0)
    g = torch.autograd.grad(loss_of(s, aux['field']),
                            [p['rod']['n0'], p['rod']['grin_A'], e0])
    for a, b in zip(g, (gp_j['rod']['n0'], gp_j['rod']['grin_A'], ge_j)):
        b = np.asarray(b)
        _close(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max())


# ---- csrc/grin.cuh's field on the host ----

@pytest.fixture(scope='module')
def harness(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ on this machine to build the host harness of '
                    'csrc/grin.cuh')
    out = tmp_path_factory.mktemp('harness') / 'grin_harness.so'
    subprocess.run([gxx, '-O2', '-std=c++17', '-shared', '-fPIC', '-o',
                    str(out), str(HARNESS)], check=True)
    return ctypes.CDLL(str(out))


def test_harness_field_and_its_adjoint(harness):
    """grin.cuh's rod with the field (grin_rod_field) against the plain
    rod's field, and its adjoint (grin_backward with kField) against torch
    autograd of the plain rod in float64, on seeded rays and fields through
    a rotated rod with a4 and az (some die at its rim): the ray, field,
    table (Rw, tw, ph) and medium cotangents."""
    fp = ctypes.POINTER(ctypes.c_float)

    def ptr(a):
        return a.ctypes.data_as(fp)
    rod = trt.GrinRod(radius=3.0, thickness=12.0, n0=1.6, grin_A=0.012,
                      a4=2e-4, az=0.003, n_steps=20,
                      rotation=[0.02, -0.03, 0.01],
                      translation=[0.1, -0.2, 6.0], name='rod')
    sc = trt.SequentialScene([rod])
    meta = sc.static_meta()[0]
    flat32 = flatten_table_rows(sc.build_table(sc.init_params('cpu')))[0]
    flat32 = flat32.detach().numpy().astype(np.float32)
    n = 64
    rng = np.random.default_rng(11)
    r, a = 2.9 * np.sqrt(rng.random(n)), 2 * math.pi * rng.random(n)
    s, b = 0.4 * np.sqrt(rng.random(n)), 2 * math.pi * rng.random(n)
    pos = np.stack([r * np.cos(a), r * np.sin(a), np.full(n, -3.0)],
                   1).astype(np.float32)
    dirs = np.stack([s * np.cos(b), s * np.sin(b), np.sqrt(1 - s * s)], 1)
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
        np.float32)
    E = rng.normal(size=(n, 6)).astype(np.float32)

    def plain(flat_t, p_t, d_t, e_t):
        row = FlatRow(flat_t)
        pc = tuple(p_t[:, j] for j in range(3))
        dc = tuple(d_t[:, j] for j in range(3))
        res = intersect(row, pc, dc, meta)
        return res, tgrin.grin_interaction(
            row, meta, dc, res['hit_s'], Er=tuple(e_t[:, j] for j in (0, 1, 2)),
            Ei=tuple(e_t[:, j] for j in (3, 4, 5))), row
    res, out, _ = plain(*(torch.from_numpy(x) for x in (flat32, pos, dirs,
                                                        E)))
    bits = []
    for i in range(n):
        o, bb, e = np.zeros(7, np.float32), ctypes.c_uint(0), E[i].copy()
        harness.grin_forward_field_h(
            ptr(flat32), meta.grin_steps, ptr(dirs[i].copy()),
            ctypes.c_float(float(res['hit_s'][0][i])),
            ctypes.c_float(float(res['hit_s'][1][i])), ptr(o),
            ctypes.byref(bb), ptr(e))
        want = [float(out[5 + j // 3][j % 3][i]) for j in range(6)]
        _close(e, want, atol=1e-6)
        bits.append(bb.value)
    assert 0 < sum((v & 2) == 0 for v in bits) < n
    gcot = rng.normal(size=(n, 7)).astype(np.float32)
    gE = rng.normal(size=(n, 6)).astype(np.float32)
    g_opl, g_na = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    n_cur = rng.uniform(1.0, 1.5, n).astype(np.float32)
    xs = [torch.from_numpy(x).double().requires_grad_(True)
          for x in (flat32, pos, dirs, E, n_cur)]
    res, out, row = plain(*xs[:4])
    active = res['valid'] & out[3]
    G, GE = torch.from_numpy(gcot).double(), torch.from_numpy(gE).double()
    loss = torch.where(
        active, sum(G[:, j] * out[0][j] for j in range(3))
        + sum(G[:, 3 + j] * out[1][j] for j in range(3))
        + G[:, 6] * torch.where(out[2], 1.0, 0.0)
        + torch.from_numpy(g_opl).double() * (xs[4] * res['t'] + out[4])
        + torch.from_numpy(g_na).double() * row.ph[0]
        + sum(GE[:, j] * out[5 + j // 3][j % 3] for j in range(6)),
        0.0).sum()
    gf, gp, gd, ge, gn = torch.autograd.grad(loss, xs)
    tg_sum = np.zeros(18)
    for i in np.nonzero(active.numpy())[0]:
        g, tg, gnb = gcot[i].copy(), np.zeros(18, np.float32), ctypes.c_float()
        g_e = gE[i].copy()
        harness.grin_backward_field_h(
            ptr(flat32), meta.grin_steps, ptr(pos[i].copy()),
            ptr(dirs[i].copy()), ctypes.c_uint(bits[i]),
            ctypes.c_float(n_cur[i]), ctypes.c_float(g_opl[i]),
            ctypes.c_float(g_na[i]), ptr(g), ptr(tg), ctypes.byref(gnb),
            ptr(E[i].copy()), ptr(g_e))
        tg_sum += tg
        want = np.concatenate([gp[i].numpy(), gd[i].numpy(),
                               [gcot[i, 6] * float(out[2][i])]])
        _close(g, want, atol=1e-5 * np.abs(want).max())
        _close(g_e, ge[i].numpy(), atol=1e-5 * np.abs(ge[i].numpy()).max())
        _close(gnb.value, gn[i], rtol=1e-5, atol=1e-6)
    cols = [ROW_OFFSETS['Rw'] + j for j in range(9)] + \
        [ROW_OFFSETS['tw'] + j for j in range(3)] + \
        [ROW_OFFSETS['ph'] + j for j in range(6)]
    want = gf.numpy()[cols]
    _close(tg_sum, want, atol=1e-5 * np.abs(want).max())
