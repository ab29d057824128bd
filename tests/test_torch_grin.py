"""GRIN rods in the PyTorch port against the JAX package, on the CPU.

- core/grin.py's ``integrate_grin`` and ``grin_interaction`` against the
  JAX package's on seeded inputs, with and without the field;
- tests/test_grin.py's closed-form anchors held in the port: the parabolic
  rod's sinusoids, the quarter-pitch focus and half-pitch inversion, the
  optical path length, the gradients in grin_A and t, barrel kills, the
  paraxial matrix, backward rays, and turning-point kills (an axial term);
- the eager ``SequentialScene.simulate`` and ``Scene.simulate`` against the
  JAX package's ``simulate``, rays and path lengths, on example 24's scenes
  (chip_smoke.py section 20's builders), tests/test_grin.py:203's rod, the
  mixed table and the field of test_grin_then_brewster (:283);
- gradients in n0, grin_A, a4, az, t and the pose against ``jax.grad``;
- the plain fused versions (``simulate_fused`` on CPU tensors) against the
  JAX package's fused kernels in interpret mode (the pattern of
  tests/test_grin.py:328 and :367), forward and backward;
- GRIN beside the Fresnel kinds, coatings, diffractive or freeform rows
  and under the field on the fused path, equal to the eager trace; the
  refusals: more than MAX_GRIN_STEPS steps, and K0's counterpart
  ``trace_sequential_v1``; the eager traces take them;
- the rod's hand-written forward and adjoint (csrc/grin.cuh, through the
  host harness tests/grin_harness.cpp built with g++) against the plain
  rod and torch autograd of it in float64.

Tolerances, each with its reason: positions atol 2e-5 and directions
2e-6 (float32 through up to 64 RK4 steps of another compiler's order, and
tests/test_grin.py's own); path lengths rtol 2e-6 (its sums of 64 steps);
moments rtol 1e-5 + atol 1e-5 of their scale; gradients rtol 2e-3 of the
leaf's scale (float32 sums over the rays in another order, through the
steps' adjoint); the field's streams atol 2e-6.  The harness runs in
float32 against the float64 reference: its forward within 1e-6 of the
float32 plain rod and its cotangents within 1e-5 of their scale.
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
from raytracetorch_tpu.core import grin as jgrin
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu.rays.ray import Rays as JRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import PhysKind
from raytracetorch_tpu_torch.core import grin as tgrin
from raytracetorch_tpu_torch.core.intersect import intersect
from raytracetorch_tpu_torch.core.table import (ROW_OFFSETS, FlatRow,
                                                flatten_table_rows)
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.ops import fused_trace as ft

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
N0, A, R = 1.6, 0.01, 5.0
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')
HARNESS = Path(__file__).with_name('grin_harness.cpp')


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rod(rt, L, n_steps=64, **kw):
    return rt.GrinRod(radius=R, thickness=L, n0=N0, grin_A=A,
                      n_steps=n_steps, translation=[0, 0, L / 2.0],
                      name='rod', **kw)


def _rays(pos, d):
    """The same rays for both packages from [N, 3] numpy arrays."""
    pos, d = np.asarray(pos, np.float32), np.asarray(d, np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    rj = JRays.create(jnp.asarray(pos), jnp.asarray(d))
    return rj, interop.rays_from_numpy(_np(rj), 'cpu')


def _fan(xs, ys=None, dxs=None, dys=None, z=-3.0):
    xs = np.asarray(xs, np.float64)
    ys = np.zeros_like(xs) if ys is None else np.asarray(ys, np.float64)
    dx = np.zeros_like(xs) if dxs is None else np.asarray(dxs, np.float64)
    dy = np.zeros_like(xs) if dys is None else np.asarray(dys, np.float64)
    dz = np.sqrt(1.0 - dx * dx - dy * dy)
    return _rays(np.stack([xs, ys, np.full_like(xs, z)], 1),
                 np.stack([dx, dy, dz], 1))


def _random_rays(n, r_max, s_max, seed):
    """Seeded positions over a disk of r_max at z = -3 and slopes up to
    s_max in any azimuth (chip_smoke.py grin_rays' draw, by numpy)."""
    rng = np.random.default_rng(seed)
    r, a = r_max * np.sqrt(rng.random(n)), 2 * math.pi * rng.random(n)
    s, b = s_max * np.sqrt(rng.random(n)), 2 * math.pi * rng.random(n)
    pos = np.stack([r * np.cos(a), r * np.sin(a), np.full(n, -3.0)], 1)
    d = np.stack([s * np.cos(b), s * np.sin(b), np.sqrt(1 - s * s)], 1)
    return _rays(pos, d)


def _scenes(make):
    """(JAX scene, port scene, JAX params, port params) of ``make(rt)``."""
    js, ts = make(jrt), make(trt)
    pj = js.init_params()
    return js, ts, pj, interop.params_from_numpy(_np(pj), 'cpu')


def _ray_case(name, n):
    """A section 20 case's rays for both packages, drawn with numpy."""
    if name == 'quarter':
        return _fan(np.linspace(-0.5, 0.5, n))
    if name == 'design':
        return _fan(np.linspace(-0.8, 0.8, n))
    if name == 'relay':
        rng = np.random.default_rng(5)
        s, b = cs.GRIN_RELAY_NA * np.sqrt(rng.random(n)), \
            2 * math.pi * rng.random(n)
        pos = np.tile([cs.GRIN_RELAY_X, 0.0, -0.001], (n, 1))
        d = np.stack([s * np.cos(b), s * np.sin(b), np.sqrt(1 - s * s)], 1)
        return _rays(pos, d)
    if name == 'mixed':
        return _random_rays(n, 4.0, 0.0, 6)
    if name == 'ns_turn':
        return _random_rays(n, 3.0, 0.6, 7)
    return _random_rays(n, 4.8, 0.3, 8)


def _compare_rays(oj, ot, pos_atol=2e-5, allowed=0):
    """Positions, directions and intensities; ``allowed`` rays may differ
    (those that pass near a turning point, where 1 / pz amplifies float32
    rounding)."""
    bad = np.zeros(np.asarray(oj.px).shape, bool)
    for c, tol in (('px', pos_atol), ('py', pos_atol), ('pz', pos_atol),
                   ('dx', 2e-6), ('dy', 2e-6), ('dz', 2e-6),
                   ('intensity', 1e-6)):
        bad |= ~(np.abs(getattr(ot, c).double().numpy()
                        - np.asarray(getattr(oj, c), np.float64)) <= tol)
    assert int(bad.sum()) <= allowed, np.nonzero(bad)[0]
    return bad


def _compare_moments(mt, mj):
    mj = np.asarray(mj)
    _close(mt, mj, rtol=1e-5, atol=1e-5 * max(np.abs(mj).max(), 1.0))


# ---- core/grin.py against the JAX package ----

def _grin_inputs(seed, n=64):
    rng = np.random.default_rng(seed)
    f = np.float32
    x, y = (rng.uniform(-3, 3, n).astype(f) for _ in range(2))
    px, py = (rng.uniform(-0.3, 0.3, n).astype(f) for _ in range(2))
    coef = dict(c0=f(2.56), c2=f(-0.0256), c4=f(3e-5), cz=f(-0.004),
                L=f(14.0), r2=f(16.0))
    return x, y, px, py, coef


@pytest.mark.parametrize('field', [False, True])
def test_integrate_grin_matches_jax(field):
    """Seeded entry states through 16 RK4 steps (some die at the radius 4
    or turn around) with and without the field's per-step rotation."""
    x, y, px, py, c = _grin_inputs(1)
    E = None
    if field:
        rng = np.random.default_rng(2)
        E = [rng.normal(size=64).astype(np.float32) for _ in range(6)]

    def run(mod, arr):
        co = [arr(c[k]) for k in ('c0', 'c2', 'c4', 'cz', 'L', 'r2')]
        er = ei = None
        if field:
            er, ei = tuple(arr(e) for e in E[:3]), tuple(arr(e) for e in E[3:])
        return mod.integrate_grin(*co, arr(x), arr(y), arr(px), arr(py), 16,
                                  er=er, ei=ei)
    oj = run(jgrin, jnp.asarray)
    ot = run(tgrin, torch.as_tensor)
    assert 0 < int(np.asarray(oj[5]).sum()) < 64
    np.testing.assert_array_equal(ot[5].numpy(), np.asarray(oj[5]))
    for a, b in zip(ot[:4], oj[:4]):
        _close(a, b, atol=2e-6)
    _close(ot[4], oj[4], rtol=2e-6)
    if field:
        for a, b in zip(ot[6] + ot[7], oj[6] + oj[7]):
            _close(a, b, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize('field', [False, True])
def test_grin_interaction_matches_jax(field):
    """A rotated, decentered rod with a4 and az terms: the whole
    interaction from the entry hit, rays and field, against JAX's."""
    def make(rt):
        return rt.SequentialScene([rt.GrinRod(
            radius=3.0, thickness=12.0, n0=1.6, grin_A=0.012, a4=2e-4,
            az=0.003, n_steps=16, rotation=[0.02, -0.03, 0.01],
            translation=[0.1, -0.2, 6.0], name='rod')])
    js, ts, pj, pt = _scenes(make)
    rj, rt_ = _random_rays(64, 2.9, 0.4, 3)
    tj, tt = js.build_table(pj), ts.build_table(pt)
    mj, mt = js.static_meta()[0], ts.static_meta()[0]
    E = None
    if field:
        rng = np.random.default_rng(4)
        E = [rng.normal(size=64).astype(np.float32) for _ in range(6)]

    def run(grin, row, meta, rays, arr, isect):
        res = isect(row, rays.pos_c, rays.dir_c, meta)
        kw = {}
        if field:
            kw = dict(Er=tuple(arr(e) for e in E[:3]),
                      Ei=tuple(arr(e) for e in E[3:]))
        return grin.grin_interaction(row, meta, rays.dir_c, res['hit_s'], **kw)
    from raytracetorch_tpu.core.intersect import intersect as jintersect
    oj = run(jgrin, tj.row(0), mj, rj, jnp.asarray,
             lambda r, p, d, m: jintersect(r, p, d, static_meta=m))
    ot = run(tgrin, tt.row(0), mt, rt_, torch.as_tensor, intersect)
    assert 0 < int(np.asarray(oj[2]).sum()) < 64
    for j in (2, 3):
        np.testing.assert_array_equal(ot[j].numpy(), np.asarray(oj[j]))
    for a, b in zip(ot[0] + ot[1], oj[0] + oj[1]):
        _close(a, b, atol=2e-5)
    _close(ot[4], oj[4], rtol=2e-6, atol=1e-5)
    if field:
        for a, b in zip(ot[5] + ot[6], oj[5] + oj[6]):
            _close(a, b, atol=2e-6)


# ---- tests/test_grin.py's closed-form anchors in the port ----

def _exact(x0, px0, pz, L):
    w = N0 * math.sqrt(A) / pz
    return (x0 * math.cos(w * L) + px0 / (pz * w) * math.sin(w * L),
            -x0 * pz * w * math.sin(w * L) + px0 * math.cos(w * L))


def test_parabolic_rod_exact():
    """tests/test_grin.py:56: RK4 against the closed-form sinusoid,
    collimated and tilted, meridional and skew, positions and directions."""
    L = 40.0
    sc = trt.SequentialScene([_rod(trt, L)])
    x0s, y0s = [0.0, 1.0, -2.5, 3.0, 0.5], [0.0, 0.5, 1.0, -2.0, 2.5]
    dxs, dys = [0.0, 0.02, -0.03, 0.0, 0.05], [0.0, 0.0, 0.01, 0.04, -0.02]
    out = sc.simulate(sc.init_params('cpu'),
                      _fan(x0s, y0s, dxs, dys)[1])[0]
    for i in range(5):
        dz = math.sqrt(1.0 - dxs[i] ** 2 - dys[i] ** 2)
        xe, ye = x0s[i] + 3.0 * dxs[i] / dz, y0s[i] + 3.0 * dys[i] / dz
        pz = math.sqrt(N0 ** 2 * (1 - A * (xe ** 2 + ye ** 2))
                       - dxs[i] ** 2 - dys[i] ** 2)
        xL, pxL = _exact(xe, dxs[i], pz, L)
        yL, pyL = _exact(ye, dys[i], pz, L)
        _close(out.px[i], xL, atol=2e-5)
        _close(out.py[i], yL, atol=2e-5)
        _close(out.dx[i], pxL, atol=2e-6)
        _close(out.dy[i], pyL, atol=2e-6)
        _close(out.pz[i], L, atol=1e-5)
    _close(out.intensity, 1.0, atol=1e-6)


def test_quarter_pitch_focus_and_half_pitch():
    """tests/test_grin.py:85: a quarter-pitch rod focuses a paraxial fan on
    its exit face's axis; a half-pitch rod inverts."""
    Lq = math.pi / (2.0 * math.sqrt(A))
    sc = trt.SequentialScene([
        _rod(trt, Lq), trt.SensorElement(radius=2.0,
                                         translation=[0, 0, Lq + 1e-3],
                                         name='s')])
    sens = sc.simulate(sc.init_params('cpu'),
                       _fan(np.linspace(-0.4, 0.4, 41))[1])[1]
    assert float(sens.spot_rms(0)[0]) < 4e-4
    sc2 = trt.SequentialScene([_rod(trt, 2 * Lq)])
    out = sc2.simulate(sc2.init_params('cpu'), _fan([1.5])[1])[0]
    _close(out.px[0], -1.5, atol=2e-3)


def test_opl_closed_form():
    """tests/test_grin.py:107: axial OPL n0 L; off-axis pz L + x0^2 w^2 pz
    (L/2 - sin(2wL)/(4w))."""
    L, x0 = 30.0, 2.0
    sc = trt.SequentialScene([_rod(trt, L)])
    aux = sc.simulate(sc.init_params('cpu'), _fan([0.0, x0])[1],
                      track_opl=True)[2]
    opl = aux['opl'].double().numpy() - 3.0
    _close(opl[0], N0 * L, rtol=1e-6)
    pz = math.sqrt(N0 ** 2 * (1 - A * x0 ** 2))
    w = N0 * math.sqrt(A) / pz
    _close(opl[1], pz * L + x0 ** 2 * w ** 2 * pz
           * (L / 2.0 - math.sin(2 * w * L) / (4 * w)), rtol=1e-6)
    _close(aux['n_final'], 1.0)


def test_grin_gradients_closed_form():
    """tests/test_grin.py:124: d(exit x)/d grin_A and d/dt against the
    analytic derivatives, eager and through the fused trace's plain
    version."""
    L, x0 = 25.0, 1.5
    rays = _fan([x0])[1]
    pz = math.sqrt(N0 ** 2 * (1 - A * x0 ** 2))
    w = N0 * math.sqrt(A) / pz

    def x_of_A(a):
        pzv = math.sqrt(N0 ** 2 * (1 - a * x0 ** 2))
        return x0 * math.cos(N0 * math.sqrt(a) / pzv * L)
    fd = (x_of_A(A + 1e-6) - x_of_A(A - 1e-6)) / 2e-6
    for leaf, want, rel in (('grin_A', fd, 1e-3),
                            ('t', -x0 * w * math.sin(w * L), 1e-4)):
        sc = trt.SequentialScene([_rod(trt, L, **{f'{leaf}_grad': True})])
        for sim in (sc.simulate, sc.simulate_fused):
            p = sc.init_params('cpu')
            p['rod'][leaf].requires_grad_(True)
            g = torch.autograd.grad(sim(p, rays)[0].px[0], p['rod'][leaf])[0]
            assert float(g) == pytest.approx(want, rel=rel), (leaf, sim)


def test_barrel_and_turning_point_kills():
    """tests/test_grin.py:162's barrel kill, and turning points: the rod of
    chip_smoke.py's 'ns_turn' case (az = -0.07) stops steep rays at
    pz^2 <= 1e-10 without any reaching its barrel; both kinds die with a
    finite state in the eager and the plain fused traces, sequential and
    non-sequential."""
    L = 60.0
    sc = trt.SequentialScene([_rod(trt, L)])
    x_launch = 4.8 - 3.0 * 0.3 / math.sqrt(1 - 0.09)
    out = sc.simulate(sc.init_params('cpu'),
                      _fan([x_launch, 0.0], dxs=[0.3, 0.0])[1])[0]
    assert out.intensity.tolist() == [0.0, 1.0]
    assert torch.isfinite(out.pos).all()
    # turning points: the rod integrated with and without its barrel
    rj, rays = _random_rays(2000, 3.0, 0.6, 7)
    c0 = torch.tensor(N0 ** 2)
    args = (c0, -c0 * A, torch.tensor(0.0), torch.tensor(cs.GRIN_TURN_AZ),
            torch.tensor(cs.GRIN_NS_L))
    x0 = rays.px + 3.0 * rays.dx / rays.dz
    y0 = rays.py + 3.0 * rays.dy / rays.dz
    free = tgrin.integrate_grin(*args, torch.tensor(1e6), x0, y0, rays.dx,
                                rays.dy, 64)[5]
    barrel = tgrin.integrate_grin(*args, torch.tensor(R * R), x0, y0,
                                  rays.dx, rays.dy, 64)[5]
    turning = int((~free).sum())
    assert turning > 100 and torch.equal(free, barrel)
    for name in ('ns', 'ns_turn'):
        ns = cs.grin_scene(trt, name)
        p = ns.init_params('cpu')
        r = _ray_case(name, 2000)[1]
        dead = [(o.intensity == 0) & torch.isfinite(o.px)
                for o in (ns.simulate(p, r)[0], ns.simulate_fused(p, r)[0])]
        assert int(dead[0].sum()) > 20 and torch.equal(dead[0], dead[1])


def test_grin_paraxial_matrix():
    """tests/test_grin.py:180: the bare rod's paraxial matrix is the
    closed-form GRIN ABCD."""
    L = 17.0
    sc = trt.SequentialScene([_rod(trt, L)])
    m = sc.paraxial(sc.init_params('cpu')).numpy()
    g = math.sqrt(A)
    want = np.array([[math.cos(g * L), math.sin(g * L) / (N0 * g)],
                     [-N0 * g * math.sin(g * L), math.cos(g * L)]])
    _close(m[:2, :2], want, atol=1e-6)
    _close(m[2:4, 2:4], want, atol=1e-6)
    with pytest.raises(ValueError):
        trt.GrinRod(radius=5.0, thickness=-1.0)
    with pytest.raises(ValueError):
        trt.GrinRod(radius=20.0, thickness=5.0, n0=1.5, grin_A=0.01)


def test_grin_backward_rays_pass():
    """tests/test_grin.py:317: a ray travelling -z never couples into the
    rod: it passes unchanged, eager and fused, sequential and as a
    Scene."""
    r = trt.Rays.create([[0.0, 0.0, 50.0]], [[0.0, 0.0, -1.0]])
    for sc in (trt.SequentialScene([_rod(trt, 10.0)]),
               trt.Scene([_rod(trt, 10.0)], n_bounces=2)):
        p = sc.init_params('cpu')
        for sim in (sc.simulate, sc.simulate_fused):
            out = sim(p, r)[0]
            assert float(out.pz[0]) == 50.0 and float(out.intensity[0]) == 1


# ---- the eager traces against the JAX package ----

@pytest.mark.parametrize('name', ['quarter', 'relay', 'design', 'mixed',
                                  'ns_seq', 'ns', 'ns_turn'])
def test_eager_scenes_match_jax(name):
    """chip_smoke.py section 20's scenes (example 24's three, the mixed
    table, tests/test_grin.py:203's rod sequential and as a Scene, the
    turning-point rod): rays, moments and path lengths against JAX's
    ``simulate``; of the turning-point rod's rays at most 4 of 400 (rays
    that pass near a turning point) may differ."""
    js, ts, pj, pt = _scenes(lambda rt: cs.grin_scene(rt, name))
    rj, rt_ = _ray_case(name, 400)
    oj, sj, aj = js.simulate(pj, rj, KEY, track_opl=True)
    ot, st, at = ts.simulate(pt, rt_, track_opl=True)
    keep = ~_compare_rays(oj, ot, allowed=4 if name == 'ns_turn' else 0)
    if keep.all():
        _compare_moments(st.moments, sj.moments)
    _close(at['opl'][keep], np.asarray(aj['opl'])[keep], rtol=2e-6,
           atol=1e-5)
    _close(at['n_final'], aj['n_final'])
    assert 0.0 < float(ot.intensity.sum())


def test_nonseq_matches_sequential():
    """tests/test_grin.py:203: the rod as a 4-bounce Scene equals the rod as
    a SequentialScene, rays, path lengths and moments, with barrel kills,
    in the eager trace and the fused trace's plain version."""
    sq, ns = cs.grin_scene(trt, 'ns_seq'), cs.grin_scene(trt, 'ns')
    p = sq.init_params('cpu')
    rays = _ray_case('ns', 500)[1]
    for sim in ('simulate', 'simulate_fused'):
        o1, s1, a1 = getattr(sq, sim)(p, rays, track_opl=True)
        o2, s2, a2 = getattr(ns, sim)(p, rays, track_opl=True)
        _compare_rays(o1, o2, pos_atol=1e-5)
        _close(a2['opl'], a1['opl'], rtol=1e-6)
        _close(a2['n_final'], a1['n_final'], atol=1e-6)
        _compare_moments(s2.moments, s1.moments)
        assert int((o1.intensity == 0).sum()) > 0


def _brewster(rt, shapes, d_exit):
    """test_grin_then_brewster's plate: FRESNEL_W at Brewster's angle to
    the rod's exit direction."""
    L = 25.0
    th = math.atan2(d_exit[0], d_exit[2]) + math.atan(1.5)
    return rt.SequentialScene([
        _rod(rt, L),
        rt.ElementCustom(shapes.disk, 1, PhysKind.FRESNEL_W, ph=(1.0, 1.5),
                         extra={'radius': 30.0}, rotation=[0.0, th, 0.0],
                         translation=[0, 0, L + 20.0], name='plate')])


def test_field_through_rod_matches_jax():
    """The field through the rod (eager): tests/test_grin.py:242's s and p
    launches and :283's Brewster plate after the rod, whose transmitted
    power is the full T only for a correctly transported field; the
    Scene's field equals the SequentialScene's."""
    sq0 = trt.SequentialScene([_rod(trt, 25.0)])
    d_exit = sq0.simulate(sq0.init_params('cpu'), _fan([2.0])[1])[0].dir[0]
    js, ts, pj, pt = _scenes(
        lambda rt: _brewster(rt, jshapes if rt is jrt else tshapes,
                             d_exit.tolist()))
    rj, rt_ = _fan([2.0, 2.0, 1.0], [0.0, 0.0, 0.5])
    E0 = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.6, 0.8, 0.0]]
    oj, _, aj = js.simulate(pj, rj, KEY, track_field=True, E0=E0)
    ot, _, at = ts.simulate(pt, rt_, track_field=True, E0=E0)
    _close(ot.intensity[0], 1.0, atol=2e-4)       # p at Brewster: T = 1
    _compare_rays(oj, ot)
    for f in FIELDS:
        _close(getattr(at['field'], f), getattr(aj['field'], f), atol=2e-6)
    _close(at['field_power'], aj['field_power'], atol=2e-6)
    sq, ns = (trt.SequentialScene([_rod(trt, 25.0)]),
              trt.Scene([_rod(trt, 25.0)], n_bounces=3))
    p = sq.init_params('cpu')
    fa = sq.simulate(p, rt_, track_field=True, E0=E0)[2]['field']
    fb = ns.simulate(p, rt_, track_field=True, E0=E0)[2]['field']
    for f in FIELDS:
        _close(getattr(fb, f), getattr(fa, f), atol=1e-6)


# ---- gradients against jax.grad ----

def _grad_scene(rt):
    return rt.SequentialScene([
        rt.GrinRod(radius=R, thickness=20.0, n0=N0, grin_A=A, a4=1e-5,
                   az=0.002, n_steps=8, n0_grad=True, grin_A_grad=True,
                   a4_grad=True, az_grad=True, t_grad=True,
                   rotation=[0.01, -0.02, 0.0],
                   translation=[0.05, 0.0, 10.0], name='rod'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 28.0], name='s')])


LEAVES = ('n0', 'grin_A', 'a4', 'az', 't', 'trans', 'rot_vec')


def test_gradients_match_jax():
    """Gradients of a spot and path-length loss in every GrinRod parameter
    and the pose: the eager trace and the fused trace's plain version
    against jax.grad of the JAX package's eager trace (the bounce loop's:
    test_plain_k5_k6_vs_jax_kernel)."""
    js, ts, pj, pt = _scenes(_grad_scene)
    rj, rt_ = _random_rays(300, 3.0, 0.1, 9)

    def jloss(p):
        _, s, aux = js.simulate(p, rj, KEY, track_opl=True)
        return s.spot_rms(0)[0] + 1e-3 * aux['opl'].mean()
    gj = jax.jit(jax.grad(jloss))(pj)['rod']
    for sim in ('simulate', 'simulate_fused'):
        p = {k: dict(v) for k, v in pt.items()}
        p['rod'] = {k: v.clone().requires_grad_(k in LEAVES)
                    for k, v in pt['rod'].items()}
        _, s, aux = getattr(ts, sim)(p, rt_, track_opl=True)
        loss = s.spot_rms(0)[0] + 1e-3 * aux['opl'].mean()
        g = torch.autograd.grad(loss, [p['rod'][k] for k in LEAVES])
        for k, a in zip(LEAVES, g):
            b = np.asarray(gj[k])
            _close(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max())


# ---- the plain fused versions against JAX's fused kernels ----

def _fused_scene(rt, nonseq):
    els = [_rod(rt, 10.0, n_steps=8),
           rt.SensorElement(radius=20.0, translation=[0, 0, 30.0], name='s')]
    return rt.Scene(els, n_bounces=3) if nonseq else rt.SequentialScene(els)


def test_plain_k1_k2_vs_jax_kernel():
    """tests/test_grin.py:328's pattern: K1's plain version against the JAX
    fused kernel (interpret mode, 8 steps), rays and moments (the path
    length: test_plain_k5_k6_vs_jax_kernel); K2's (the fused trace's
    backward) against jax.grad of the JAX fused trace in the rod's n0,
    grin_A, t and translation."""
    js, ts, pj, pt = _scenes(lambda rt: _fused_scene(rt, False))
    bundle = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                     translation=[0, 0, -3.0])
    rj = bundle.sample(KEY, 256)
    rt_ = interop.rays_from_numpy(_np(rj), 'cpu')
    oj, sj, _ = js.simulate_fused(pj, rj, KEY, block_rows=4,
                                  auto_dispatch=False)
    ot, st, _ = ts.simulate_fused(pt, rt_)
    _compare_rays(oj, ot)
    _compare_moments(st.moments, sj.moments)

    def jloss(p):
        return js.simulate_fused(p, rj, KEY, block_rows=4,
                                 auto_dispatch=False)[1].spot_rms(0)[0]
    gj = jax.grad(jloss)(pj)['rod']
    p = {k: dict(v) for k, v in pt.items()}
    keys = ('n0', 'grin_A', 't', 'trans')
    p['rod'] = {k: v.clone().requires_grad_(k in keys)
                for k, v in pt['rod'].items()}
    g = torch.autograd.grad(ts.simulate_fused(p, rt_)[1].spot_rms(0)[0],
                            [p['rod'][k] for k in keys])
    for k, a in zip(keys, g):
        b = np.asarray(gj[k])
        _close(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max())


def test_plain_k5_k6_vs_jax_kernel():
    """tests/test_grin.py:367's pattern: K5's plain version against the JAX
    fused bounce loop (interpret mode), rays, moments and path lengths;
    K6's against the JAX scan-backward kernel's table and ray cotangents
    (interpret mode), 8 steps, 128 rays."""
    from raytracetorch_tpu.core.sensor import SensorState as JSensorState
    from raytracetorch_tpu.ops.pallas_trace import trace_nonseq_pallas_bwd
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    js, ts, pj, pt = _scenes(lambda rt: _fused_scene(rt, True))
    bundle = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                     translation=[0, 0, -3.0])
    rj = bundle.sample(KEY, 128)
    rt_ = interop.rays_from_numpy(_np(rj), 'cpu')
    oj, sj, aj = js.simulate_fused(pj, rj, KEY, track_opl=True, block_rows=2)
    ot, st, at = ts.simulate_fused(pt, rt_, track_opl=True)
    _compare_rays(oj, ot)
    _close(at['opl'], aj['opl'], rtol=2e-6, atol=1e-5)
    _compare_moments(st.moments, sj.moments)
    # K6: the JAX kernel's cotangents of a moment loss
    cfg, meta = js.sensor_config(), js.static_meta()
    table = js.build_table(pj)

    def head(m):
        s = JSensorState(moments=m, grid=None)
        return s.total_weight(0)[0] + s.spot_rms(0)[0]
    g_mom = jax.vjp(head, sj.moments)[1](jnp.float32(1.0))[0]
    g_rays = rj.replace(**{c: jnp.zeros_like(getattr(rj, c)) for c in COMPS})
    gt_j, gr_j = trace_nonseq_pallas_bwd(table, rj, KEY, cfg, meta, 3, g_rays,
                                         g_mom, interpret=True, block_rows=2,
                                         mode='scan')
    flat = flatten_table_rows(ts.build_table(pt))
    gt_t, gr_t = fn.trace_nonseq_bwd_plain(
        flat, rt_, ts.sensor_config(), ts.static_meta(), 3, (None,) * 7,
        torch.from_numpy(np.asarray(g_mom)))
    for c, a in zip(COMPS, gr_t):
        b = np.asarray(gr_j[c])
        _close(a, b, rtol=1e-4, atol=1e-5 * max(np.abs(b).max(), 1.0))
    for name in ('Rw', 'tw', 'ph'):
        off = ROW_OFFSETS[name]
        a = gt_t[0, off:off + np.asarray(getattr(gt_j, name))[0].size]
        b = np.asarray(getattr(gt_j, name))[0].reshape(-1)
        _close(a, b, rtol=2e-3, atol=2e-3 * max(np.abs(b).max(), 1e-6))


# ---- refusals ----

def _with(rt, kind):
    """A rod beside a row of another family."""
    rod = _rod(rt, 10.0)
    if kind == 'fresnel':
        other = rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0,
                               ior_glass=1.5, fresnel='weighted',
                               translation=[0, 0, 15.0], name='lens')
    elif kind == 'coat':
        other = rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0,
                               ior_glass=1.5, fresnel='weighted',
                               coating=[(1.38, 0.1)],
                               translation=[0, 0, 15.0], name='lens')
    elif kind == 'diff':
        other = rt.DiffractionGrating(period_um=10.0, order=1,
                                      translation=[0, 0, 15.0], name='g')
    else:
        other = rt.FreeformLens(c1=0.0, c2=0.0, d=10.0, t=2.0,
                                ior_glass=1.5, xy1=((2, 0, 1e-4),),
                                translation=[0, 0, 15.0], name='ff')
    return rt.SequentialScene([rod, other,
                               rt.SensorElement(radius=10.0,
                                                translation=[0, 0, 30.0],
                                                name='s')])


def _fused_equals_eager(sc, p, rays, **kw):
    """The fused trace of ``sc`` (the plain versions on the CPU) equals its
    eager trace on ``rays``: ray state and moments to float32 round-off."""
    out_f, s_f = sc.simulate_fused(p, rays, generator=torch.Generator()
                                   .manual_seed(0), **kw)[:2]
    out_e, s_e = sc.simulate(p, rays, generator=torch.Generator()
                             .manual_seed(0), **kw)[:2]
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'):
        torch.testing.assert_close(getattr(out_f, c), getattr(out_e, c),
                                   rtol=0, atol=1e-5)
    torch.testing.assert_close(s_f.moments, s_e.moments, rtol=1e-5,
                               atol=1e-5)
    assert torch.isfinite(out_f.px).all()


@pytest.mark.parametrize('kind', ['fresnel', 'coat', 'diff', 'freeform'])
def test_fused_refuses_grin_beside_other_families(kind):
    """GRIN beside a row of another family (the Fresnel kinds, a coating, a
    grating, a freeform surface) runs on the fused path, the family
    instantiation's on the card, and equals the eager trace."""
    sc = _with(trt, kind)
    _fused_equals_eager(sc, sc.init_params('cpu'), _fan([0.1, 0.5])[1])


def test_fused_refuses_field_steps_and_k0():
    """Under the field the fused trace carries the field through a rod and
    equals the eager trace, rays and field (tests/test_torch_grin_field.py
    holds it to the JAX package); more than MAX_GRIN_STEPS steps raise
    naming the limit; trace_sequential_v1 (K0's counterpart) refuses GRIN
    rows, as the TPU kernel does (pallas_trace.py:166); fuzzy apodization
    of a rod's row runs and equals the eager chain (which applies none to a
    rod)."""
    sc = trt.SequentialScene([_rod(trt, 10.0)])
    p = sc.init_params('cpu')
    rays = _fan([0.1, 0.5])[1]
    E0 = [0.6, 0.8, 0.0]
    _fused_equals_eager(sc, p, rays, track_field=True, E0=E0)
    f_f = sc.simulate_fused(p, rays, track_field=True, E0=E0)[2]['field']
    f_e = sc.simulate(p, rays, track_field=True, E0=E0)[2]['field']
    for f in FIELDS:
        torch.testing.assert_close(getattr(f_f, f), getattr(f_e, f),
                                   rtol=0, atol=1e-6)
    big = trt.SequentialScene([_rod(trt, 10.0, n_steps=ft.MAX_GRIN_STEPS + 1)])
    with pytest.raises(NotImplementedError, match='MAX_GRIN_STEPS'):
        big.simulate_fused(big.init_params('cpu'), rays)
    table = sc.build_table(p)
    with pytest.raises(ValueError, match='GRIN'):
        ft.trace_sequential_v1(table, rays, sc.sensor_config(),
                               sc.static_meta())
    fz = {0: trt.ComponentFuzzy(lambda x, y, z: 1.0 - x * x)}
    out_f, s_f = ft.trace_sequential_fused(
        table, rays, sc.sensor_config(), sc.static_meta(), fuzzy_fns=fz)
    out_e, s_e = sc.simulate(p, rays, fuzzy_fns=fz)[:2]
    torch.testing.assert_close(out_f.intensity, out_e.intensity, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(out_f.px, out_e.px, rtol=0, atol=1e-5)
    assert ft.grin_kinds(sc.static_meta())
    assert ft.kind_rows(sc.static_meta(), sc.sensor_config())[0][7] == 64


def test_wrappers_read_grin_from_kinds():
    """The K1, K2, K5 and K6 wrappers take GRIN rods from the kinds tensor
    (``grin_rows``) when their caller does not say, whatever bits ride
    above a row's kind; the family instantiation takes a rod beside every
    other family (``family_bits``), and so does the field's: a rod beside a
    Fresnel lens under the field traces, fused equal to eager."""
    def kinds_of(sc):
        return torch.tensor(ft.kind_rows(sc.static_meta(),
                                         sc.sensor_config()),
                            dtype=torch.int32)
    rod = kinds_of(trt.SequentialScene([_rod(trt, 10.0)]))
    assert ft.grin_rows(rod) and ft.grin_of(rod)
    other = kinds_of(_with(trt, 'fresnel'))
    assert ft.grin_rows(other)
    lens = kinds_of(trt.SequentialScene(_with(trt, 'fresnel').elements[1:]))
    assert not ft.grin_rows(lens)
    assert not ft.grin_of(lens)
    lens[:, 0] |= int(PhysKind.GRIN) << ft.DISP_SHIFT
    assert not ft.grin_rows(lens)
    for kw in (dict(fresnel=True), dict(diff=True), dict(ff=object())):
        for kinds, grin in ((rod, None), (lens, True)):
            assert ft.grin_of(kinds, grin)
            bits = ft.family_bits(grin=True, **kw)
            assert bits & ft.FAM_GRIN and bits != ft.FAM_GRIN
    sc = _with(trt, 'fresnel')
    _fused_equals_eager(sc, sc.init_params('cpu'), _fan([0.1, 0.5])[1],
                        track_field=True, E0=[0.0, 1.0, 0.0])


# ---- csrc/grin.cuh on the host ----

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


def test_harness_rod_and_adjoint(harness):
    """grin.cuh's rod (its forward, the saved decisions) against the plain
    rod, and its adjoint against torch autograd of the plain rod in
    float64, on seeded rays through a rotated rod with a4 and az (some die
    at its rim): the ray, table (Rw, tw, ph) and medium cotangents."""
    fp = ctypes.POINTER(ctypes.c_float)

    def ptr(a):
        return a.ctypes.data_as(fp)
    rod = trt.GrinRod(radius=3.0, thickness=12.0, n0=1.6, grin_A=0.012,
                      a4=2e-4, az=0.003, n_steps=16,
                      rotation=[0.02, -0.03, 0.01],
                      translation=[0.1, -0.2, 6.0], name='rod')
    sc = trt.SequentialScene([rod])
    meta = sc.static_meta()[0]
    flat = flatten_table_rows(sc.build_table(sc.init_params('cpu')))[0]
    flat32 = flat.numpy().astype(np.float32)
    _, rays = _random_rays(64, 2.9, 0.4, 11)
    pos = torch.stack(rays.pos_c, 1).numpy().astype(np.float32)
    dirs = torch.stack(rays.dir_c, 1).numpy().astype(np.float32)

    def plain(flat_t, p_t, d_t, n_cur=None):
        row = FlatRow(flat_t)
        pc, dc = tuple(p_t[:, j] for j in range(3)), \
            tuple(d_t[:, j] for j in range(3))
        res = intersect(row, pc, dc, meta)
        return res, tgrin.grin_interaction(row, meta, dc, res['hit_s']), row
    res, out, _ = plain(torch.from_numpy(flat32), torch.from_numpy(pos),
                        torch.from_numpy(dirs))
    bits = []
    for i in range(64):
        o, b = np.zeros(7, np.float32), ctypes.c_uint(0)
        harness.grin_forward_h(ptr(flat32), meta.grin_steps,
                               ptr(dirs[i].copy()),
                               ctypes.c_float(float(res['hit_s'][0][i])),
                               ctypes.c_float(float(res['hit_s'][1][i])),
                               ptr(o), ctypes.byref(b))
        want = [float(out[0][j][i]) for j in range(3)] + \
            [float(out[1][j][i]) for j in range(3)] + [float(out[4][i])]
        _close(o, want, atol=1e-6, rtol=1e-6)
        assert bool(b.value & 2) == bool(out[2][i])
        bits.append(b.value)
    assert 0 < sum((b & 2) == 0 for b in bits) < 64
    rng = np.random.default_rng(12)
    gcot = rng.normal(size=(64, 7)).astype(np.float32)
    g_opl, g_na = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    n_cur = rng.uniform(1.0, 1.5, 64).astype(np.float32)
    f64 = torch.from_numpy(flat32).double().requires_grad_(True)
    p64 = torch.from_numpy(pos).double().requires_grad_(True)
    d64 = torch.from_numpy(dirs).double().requires_grad_(True)
    nc64 = torch.from_numpy(n_cur).double().requires_grad_(True)
    res, out, row = plain(f64, p64, d64)
    active = res['valid'] & out[3]
    G = torch.from_numpy(gcot).double()
    loss = torch.where(
        active, sum(G[:, j] * out[0][j] for j in range(3))
        + sum(G[:, 3 + j] * out[1][j] for j in range(3))
        + G[:, 6] * torch.where(out[2], 1.0, 0.0)
        + torch.from_numpy(g_opl).double() * (nc64 * res['t'] + out[4])
        + torch.from_numpy(g_na).double() * row.ph[0], 0.0).sum()
    gf, gp, gd, gn = torch.autograd.grad(loss, [f64, p64, d64, nc64])
    tg_sum = np.zeros(18)
    for i in np.nonzero(active.numpy())[0]:
        g, tg, gnb = gcot[i].copy(), np.zeros(18, np.float32), ctypes.c_float()
        harness.grin_backward_h(ptr(flat32), meta.grin_steps,
                                ptr(pos[i].copy()), ptr(dirs[i].copy()),
                                ctypes.c_uint(bits[i]),
                                ctypes.c_float(n_cur[i]),
                                ctypes.c_float(g_opl[i]),
                                ctypes.c_float(g_na[i]), ptr(g), ptr(tg),
                                ctypes.byref(gnb))
        tg_sum += tg
        want = np.concatenate([gp[i].numpy(), gd[i].numpy(),
                               [gcot[i, 6] * float(out[2][i])]])
        _close(g, want, atol=1e-5 * np.abs(want).max())
        _close(gnb.value, gn[i], rtol=1e-5, atol=1e-6)
    cols = [ROW_OFFSETS['Rw'] + j for j in range(9)] + \
        [ROW_OFFSETS['tw'] + j for j in range(3)] + \
        [ROW_OFFSETS['ph'] + j for j in range(6)]
    want = gf.numpy()[cols]
    _close(tg_sum, want, atol=1e-5 * np.abs(want).max())
    others = np.delete(gf.numpy(), cols)
    assert float(np.abs(others).max()) == 0.0
