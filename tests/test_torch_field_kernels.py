"""The plain versions of K1's and K2's instantiation with the field in the
PyTorch port against the JAX package's fused kernel, on the CPU: K1's
plain version (``trace_sequential_fused_plain`` with the launch field)
against the JAX package's ``simulate_fused`` in interpret mode on the
scenes of tests/test_pallas.py:343-414 (the SNELL singlet; the FRESNEL
Brewster plane, whose polarized branch decisions must agree ray for ray);
K2's plain version (the fused trace's backward) against ``jax.grad`` of
the eager trace, which is where the JAX package's interpret-mode backward
routes (tests/test_pallas.py:628-665); and the host-side pieces the
kernels read: the crystal constants of csrc/field.cuh against
utils/birefringence.py, the physics enum, a JONES row's kinds bits and the
fused wrappers' field plumbing.

Tolerances, each with its reason: the field's streams and |E|^2 atol 2e-6
(float32, another compilation's contractions); positions atol 1e-5,
directions 2e-6; moments rtol 1e-5 + atol 1e-5 of their scale (sums in
another order); the grad loss's curvature gradient rtol 1e-3 and E0's rtol
2e-3: each is a sum of the rays' cancelling terms, which the two packages
add in other orders (the port's eager trace and the fused trace's plain
version agree bit for bit, both ~5e-4 from the JAX package's float32
reductions; the JAX test itself holds its fused against its eager
curvature gradient at 3e-2).
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.constants import PhysKind as JPhysKind
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import PhysKind
from raytracetorch_tpu_torch.core.field import FieldState
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.ops import fused_trace as ft
from raytracetorch_tpu_torch.rays import reference_prng as rp
from raytracetorch_tpu_torch.utils.birefringence import WAVEPLATE_MATERIALS

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
CSRC = pathlib.Path(__file__).resolve().parent.parent / \
    'raytracetorch_tpu_torch' / 'csrc'
N_B = 1.5168
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _singlet(rt, grad=False):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=N_B,
                       c1_grad=grad, name='lens'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.0],
                         name='sensor')])


def _plane(rt, shapes):
    return rt.SequentialScene([
        rt.ElementCustom(shapes.plane, 1, PhysKind.FRESNEL, ph=(N_B, 1.0),
                         name='iface'),
        rt.SensorElement(radius=100.0, translation=[0, 0, 25.0],
                         name='sensor')])


def _stack(rt):
    """The singlet with a polarizer, a quarter-wave plate and an analyzer
    before its sensor: more rows than K2 keeps saved fields of in shared
    memory."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=N_B,
                       name='lens'),
        rt.LinearPolarizer(radius=8.0, angle=0.3, translation=[0, 0, 14.0],
                           name='pol'),
        rt.QuarterWaveplate(radius=8.0, angle=math.pi / 4,
                            translation=[0, 0, 15.0], name='qwp'),
        rt.LinearPolarizer(radius=8.0, angle=1.2, translation=[0, 0, 16.0],
                           name='analyzer'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.0],
                         name='sensor')])


def _window(rt, shapes):
    """A flat SNELL window, its exit face turned over, met along z: every
    ray at normal incidence, where the s/p basis takes its fallback."""
    return rt.SequentialScene([
        rt.ElementCustom(shapes.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                         name='entry'),
        rt.ElementCustom(shapes.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                         rotation=[math.pi, 0.0, 0.0],
                         translation=[0.0, 0.0, 5.0], name='exit'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 10.0],
                         name='sensor')])


def _case(name, n):
    """(JAX scene, port scene, JAX rays, port rays, E0, FRESNEL draws)."""
    if name in ('singlet', 'stack', 'window'):
        js, ts = {'singlet': (_singlet(jrt), _singlet(trt)),
                  'stack': (_stack(jrt), _stack(trt)),
                  'window': (_window(jrt, jshapes),
                             _window(trt, tshapes))}[name]
        bundle = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                         translation=[0, 0, -10.0])
        E0 = ([[0.8, 0.6, 0.0]] if name == 'window'
              else [[math.sqrt(0.5), math.sqrt(0.5), 0.0]])
    else:
        th_b = math.atan(N_B)
        js, ts = _plane(jrt, jshapes), _plane(trt, tshapes)
        bundle = jrt.CollimatedDisk.make(
            radius=jnp.float32(2.0), translation=[0, 0, -10.0],
            rotation=[th_b, 0.0, 0.0])
        E0 = [[math.sqrt(0.5), math.cos(th_b) * math.sqrt(0.5),
               math.sin(th_b) * math.sqrt(0.5)]]
    rays_j = bundle.sample(KEY, n)
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    u = rp.fresnel_uniforms(rp.prng_key(0), ts.static_meta(), n)
    return js, ts, rays_j, rays_t, E0, (u if u.shape[0] else None)


@pytest.mark.parametrize('name', ['singlet', 'brewster_mc', 'stack',
                                  'window'])
def test_plain_k1_vs_jax_kernel(name):
    """K1's plain version with the field against the JAX package's fused
    kernel (interpret mode): the final field, |E|^2, the rays and the
    |E|^2-weighted moments; on the FRESNEL plane the polarized branch of
    every ray."""
    js, ts, rays_j, rays_t, E0, u = _case(name, 512)
    out_j, s_j, aux_j = js.simulate_fused(
        js.init_params(), rays_j, KEY, track_field=True, E0=E0,
        interpret=True, block_rows=4)
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    out_t, s_t, aux_t = ts.simulate_fused(pt, rays_t, track_field=True,
                                          E0=E0, uniforms=u)
    for f in FIELDS:
        _close(getattr(aux_t['field'], f), getattr(aux_j['field'], f),
               atol=2e-6, err_msg=f)
    _close(aux_t['field_power'], aux_j['field_power'], atol=2e-6)
    for c in ('px', 'py', 'pz'):
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-6, atol=1e-5)
    for c in ('dx', 'dy', 'dz', 'intensity'):
        _close(getattr(out_t, c), getattr(out_j, c), atol=2e-6)
    ref = np.asarray(s_j.moments)
    _close(s_t.moments, ref, rtol=1e-5,
           atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    if name == 'brewster_mc':
        np.testing.assert_array_equal(np.asarray(out_t.dz < 0),
                                      np.asarray(out_j.dz) < 0)


def test_plain_k2_vs_jax_grad():
    """K2's plain version (the fused trace's backward with the field)
    against jax.grad of the JAX package's eager trace on
    tests/test_pallas.py:628-665's loss: the total weight plus the sum of
    |E|^2 squared, in the lens curvature c1 and in E0."""
    js, ts = _singlet(jrt, grad=True), _singlet(trt, grad=True)
    rays_j = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                     translation=[0, 0, -10.0]).sample(KEY,
                                                                       1024)
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    e0 = np.float32([[math.sqrt(0.5), math.sqrt(0.5), 0.0]])

    def loss_j(p, e):
        _, sens, aux = js.simulate(p, rays_j, KEY, track_field=True, E0=e)
        return sens.total_weight(0)[0] + jnp.sum(aux['field_power'] ** 2)
    v_j, (g_j, ge_j) = jax.value_and_grad(loss_j, argnums=(0, 1))(
        js.init_params(), jnp.asarray(e0))
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    pt['lens']['c1'].requires_grad_(True)
    e_t = torch.from_numpy(e0).requires_grad_(True)
    _, sens, aux = ts.simulate_fused(pt, rays_t, track_field=True, E0=e_t)
    loss = sens.total_weight(0)[0] + (aux['field_power'] ** 2).sum()
    g_c1, g_e0 = torch.autograd.grad(loss, [pt['lens']['c1'], e_t])
    assert abs(float(loss) - float(v_j)) <= 1e-5 * abs(float(v_j))
    ref = float(g_j['lens']['c1'])
    assert abs(float(g_c1) - ref) <= 1e-3 * abs(ref)
    _close(g_e0, ge_j, rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize('name', ['window', 'stack'])
def test_plain_k2_vs_jax_grad_rays_and_e0(name):
    """K2's plain version with the field against jax.grad of the JAX
    package's eager trace in the launch rays and E0, on the window (the s/p
    basis's fallback at normal incidence, differentiated on the branch
    taken) and the six-row stack: a loss of the final positions, the final
    field's six streams, the sum of |E|^2 squared and the moments."""
    js, ts, rays_j, rays_t, E0, _ = _case(name, 256)
    e0 = np.float32(E0)
    w = np.random.default_rng(3).normal(size=(8, 256)).astype(np.float32)

    names = ('px', 'py', 'dx', 'dy', 'dz')

    def loss_j(c, e):
        out, sens, aux = js.simulate(js.init_params(), rays_j.replace(**c),
                                     KEY, track_field=True, E0=e)
        return (jnp.sum(w[0] * out.px) + jnp.sum(w[1] * out.py)
                + sum(jnp.sum(w[2 + j] * getattr(aux['field'], f))
                      for j, f in enumerate(FIELDS))
                + jnp.sum(aux['field_power'] ** 2)
                + jnp.sum(sens.moments[..., :3]))
    g_rj, ge_j = jax.grad(loss_j, argnums=(0, 1))(
        {c: getattr(rays_j, c) for c in names}, jnp.asarray(e0))
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    comps = {c: getattr(rays_t, c).clone().requires_grad_(True)
             for c in names}
    e_t = torch.from_numpy(e0).requires_grad_(True)
    out, sens, aux = ts.simulate_fused(pt, rays_t.replace(**comps),
                                       track_field=True, E0=e_t)
    loss = ((torch.from_numpy(w[0]) * out.px).sum()
            + (torch.from_numpy(w[1]) * out.py).sum()
            + sum((torch.from_numpy(w[2 + j]) * getattr(aux['field'], f))
                  .sum() for j, f in enumerate(FIELDS))
            + (aux['field_power'] ** 2).sum() + sens.moments[..., :3].sum())
    grads = torch.autograd.grad(loss, [*comps.values(), e_t])
    for c, g in zip(comps, grads):
        ref = np.asarray(g_rj[c])
        _close(g, ref, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(ref).max()),
               err_msg=c)
    _close(grads[-1], ge_j, rtol=2e-3, atol=1e-4)


def test_plain_k2_launch_field_cotangents():
    """K2's plain version with the field gives the launch field's six
    cotangents: those of a seeded loss on the final field and the moments
    equal autograd through the eager trace (the port's own chain) on the
    same launch field."""
    ts = trt.SequentialScene([
        trt.QuarterWaveplate(radius=8.0, angle=0.4, name='q'),
        trt.ElementCustom(tshapes.plane, 1, PhysKind.FRESNEL_W,
                          ph=(1.5, 1.0), rotation=[0.5, 0.0, 0.0],
                          translation=[0, 0, 5.0], name='w'),
        trt.SensorElement(radius=20.0, translation=[0, 0, 20.0], name='s')])
    params = ts.init_params('cpu')
    rays = trt.CollimatedDisk.make(radius=2.0, translation=[0, 0, -5.0]) \
        .sample(torch.Generator().manual_seed(0), 256, 'cpu')
    meta = ft.TraceMeta(ts.static_meta(), None, field=True)
    cfg = ts.sensor_config()
    flat = trt.flatten_table_rows(ts.build_table(params)).detach()
    field = FieldState.init(rays, [[0.3, 1.0, 0.0]]).streams()
    gen = torch.Generator().manual_seed(1)
    g_field = [torch.randn(rays.n, generator=gen) for _ in range(6)]
    g_rays = [torch.randn(rays.n, generator=gen) for _ in range(7)]
    g_mom = torch.randn(1, 1, 7, generator=gen)
    res = ft.trace_seq_bwd_plain(flat, rays, cfg, meta, g_rays, g_mom,
                                 maps=(), field=field, g_field=g_field)
    fin = [f.detach().requires_grad_(True) for f in field]
    out, sens, aux = ft.trace_sequential_fused_plain(flat, rays, cfg, meta,
                                                     (), field=fin)
    outs = [getattr(out, c) for c in ft.COMPS] + [sens.moments] + [
        aux[k] for k in ft.FIELD_KEYS]
    cots = list(g_rays) + [g_mom] + g_field
    pairs = [(o, g) for o, g in zip(outs, cots) if o.requires_grad]
    ref = torch.autograd.grad([o for o, _ in pairs], fin,
                              [g for _, g in pairs], allow_unused=True)
    for a, b in zip(res[-1], ref):
        _close(a, torch.zeros_like(a) if b is None else b, rtol=1e-6,
               atol=1e-7)


def _floats(text):
    return [float(x.rstrip('f')) for x in
            re.findall(r'-?\d+\.\d*(?:e-?\d+)?f', text)]


def test_header_crystal_constants():
    """csrc/field.cuh's kCrystalCoef holds utils/birefringence.py's
    Sellmeier coefficients: per crystal (quartz, MgF2, calcite) the
    ordinary then the extraordinary index, Ghosh's (A, B, C, D, E, 0) or
    the three-term (B1, C1, B2, C2, B3, C3)."""
    src = (CSRC / 'field.cuh').read_text()
    body = src.split('kCrystalCoef[3][2][6] = {', 1)[1].split('};', 1)[0]
    got = _floats(body)
    want = []
    for mat in ('QUARTZ', 'MGF2', 'CALCITE'):
        form, co, ce = WAVEPLATE_MATERIALS[mat]
        for c in (co, ce):
            want += (list(c) + [0.0] if form == 'ghosh'
                     else [x for pair in c for x in pair])
    assert len(got) == len(want) == 36
    _close(got, want, rtol=1e-7)
    assert tuple(WAVEPLATE_MATERIALS) == ft.JONES_CRYSTALS


def test_header_kinds():
    """The physics kinds the kernels branch on: JONES = 11 in the physics
    enum (csrc/trace_seq_common.cuh) and field.cuh's constants, equal to
    the port's and the JAX package's PhysKind."""
    common = (CSRC / 'trace_seq_common.cuh').read_text()
    field = (CSRC / 'field.cuh').read_text()
    assert int(re.search(r'JONES = (\d+)', common).group(1)) == \
        PhysKind.JONES == JPhysKind.JONES
    names = {'kFkBlock': 'BLOCK', 'kFkReflect': 'REFLECT', 'kFkSnell':
             'SNELL', 'kFkFresnel': 'FRESNEL', 'kFkFresnelW': 'FRESNEL_W',
             'kFkReflectW': 'REFLECT_W', 'kFkJones': 'JONES',
             'kFkDoe': 'DOE', 'kFkPhaseGrid': 'PHASE_GRID'}
    for c, kind in names.items():
        assert int(re.search(rf'{c} = (\d+)', field).group(1)) == \
            PhysKind[kind]


@pytest.mark.parametrize('make, bits', [
    (lambda: trt.LinearPolarizer(radius=1.0, name='p'), 0),
    (lambda: trt.Waveplate(radius=1.0, chromatic=True, name='w'), 1),
    (lambda: trt.Waveplate(radius=1.0, material='quartz', name='w'), 3),
    (lambda: trt.Waveplate(radius=1.0, material='MgF2', name='w'), 5),
    (lambda: trt.Waveplate(radius=1.0, material='calcite', name='w'), 7)])
def test_jones_kind_bits(make, bits):
    """A JONES row's kinds row carries its chromatic flag and crystal above
    COAT_SHIFT (field.cuh::jones_delta's bits), and the fused trace runs
    the instantiation with the field for it, with no family's side data
    (a JONES row is of none)."""
    sc = trt.SequentialScene([make(), trt.SensorElement(radius=5.0,
                                                        name='s')])
    meta = ft.TraceMeta(sc.static_meta(), None, field=True)
    rows = ft.kind_rows(meta, sc.sensor_config())
    assert rows[0][0] == PhysKind.JONES | bits << ft.COAT_SHIFT
    assert ft.field_kinds(meta) and not ft.field_kinds(sc.static_meta())
    # no family: the field's instantiation reads no side data
    assert ft.families(meta) == 0
    assert ft.coat_side(meta, 'cpu') is None
    assert ft.ff_side(meta, 'cpu') is None
    assert ft.fuzzy_buffer(meta, 'cpu') is None
    assert ft.plate_maps(meta, None) == ()
    flags = ft.StreamFlags(False, False, False, True)
    assert flags.any and flags.keys() == ft.FIELD_KEYS
    assert ft.StreamFlags(True, False, False).keys() == ('opl', 'n_final')
