"""The mixed-surface and asphere scenes of the PyTorch port against the JAX
package, on the CPU: the cylindrical singlet (QUADRIC_ZY faces, side planes
under the CYL_EDGE bound, the rectangular volume bound), the rectangular
stop and sensor, and the even-asphere singlet (Halley refinement onto the
sag, the sag's normal).

Inputs are made with numpy from a seed (or by the JAX package and carried
over through numpy), about 3,000 rays.  Tolerances, each with its reason:

- geometry: the same float32 formulas in both packages; the quadric and the
  bounds exactly (comparisons of equal floats), sag and normals to 1e-6,
  refined roots to 1e-5 (4 Halley steps of float32 rounding);
- traces, as tests/test_pallas.py holds the JAX kernel to the XLA chain:
  positions atol 1e-5, intensity atol 1e-6, moments rtol 1e-5 atol 1e-3;
- gradients: rtol 1e-4 of each leaf (float32 adjoints summed over 3,000
  rays in another order); the asphere's polynomial terms span r^4..r^10,
  so each is held to its own scale.

The CUDA kernels themselves are held to these plain versions on the card
in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.static_dispatch import vb_check_one as jax_vb_check
from raytracetorch_tpu.geom import surfaces as jsurf
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas,
                                               trace_sequential_pallas_v2)
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import CYL_EDGE_EPS, CYL_RECT_EPS, VBKind
from raytracetorch_tpu_torch.core.static_dispatch import vb_check_one
from raytracetorch_tpu_torch.geom import surfaces as tsurf
from raytracetorch_tpu_torch.ops import fused_trace

torch.set_num_threads(2)

N = 3000
SCENES = {'mixed': chip_smoke.mixed_scene,
          'asphere': chip_smoke.asphere_scene}
# The asphere's coefficients and their magnitudes (a4..a10 r^4..r^10 at the
# rim are each O(1e-2) of the sag): (c, k, a)
ASPH = (0.05, -0.6, (2.5e-4, 1e-6, -3e-9, 1e-11))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rays(n, seed, radius=4.0):
    return jrt.CollimatedDisk.make(
        radius=jnp.float32(radius),
        translation=[0, 0, -10.0]).sample(jax.random.PRNGKey(seed), n)


def _port(scene_j, rays_j):
    """The JAX scene's params, table, kinds and rays, carried over through
    numpy, and the port's scene of the same elements."""
    p = scene_j.init_params()
    return (interop.params_from_numpy(_np(p), 'cpu'),
            interop.table_from_numpy(_np(scene_j.build_table(p)), 'cpu'),
            interop.meta_from_slots(scene_j.static_meta()),
            interop.rays_from_numpy(_np(rays_j), 'cpu'))


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _assert_trace_close(out_t, sens_t, out_j, sens_j):
    _close(out_t.pos.numpy(), out_j.pos, atol=1e-5)
    _close(out_t.intensity.numpy(), out_j.intensity, atol=1e-6)
    _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-5, atol=1e-3)


# ---- geometry ----

def test_q_quadric_zy_matches_jax():
    rng = np.random.default_rng(0)
    for c, k in rng.uniform(-0.1, 0.1, (8, 2)).astype(np.float32):
        q_t, s_t = tsurf.q_quadric_zy(torch.tensor(c), float(k))
        q_j, s_j = jsurf.q_quadric_zy(jnp.float32(c), float(k))
        _close(q_t.numpy(), q_j, rtol=0, atol=0)
        assert s_t == s_j == -1.0


def _asph_inputs(n, seed):
    """Rays near the axis heading +z from z = -1.5 towards an asphere at
    the origin, and base-conic starting points a little off its sag."""
    rng = np.random.default_rng(seed)
    c, k, a = ASPH
    kc2 = (1.0 + k) * c * c
    o = [rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), np.full(n, -1.5)]
    d = [rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n)]
    d.append(np.sqrt(1.0 - d[0] ** 2 - d[1] ** 2))
    t0 = 1.5 + rng.uniform(-0.3, 0.3, n)
    f32 = [np.float32(v) for v in (c, kc2, *a)]
    return (f32[0], f32[1], f32[2:], [v.astype(np.float32) for v in o],
            [v.astype(np.float32) for v in d], t0.astype(np.float32))


def test_asph_sag_refine_normal_match_jax():
    """asph_sag, asph_refine (4 Halley steps and the validity rule) and
    asph_normal give the JAX package's values on the same inputs."""
    c, kc2, a, o, d, t0 = _asph_inputs(N, 1)
    tt = [torch.from_numpy(v) for v in (*o, *d, t0)]
    ct, kt, at = (torch.tensor(c), torch.tensor(kc2),
                  [torch.tensor(v) for v in a])
    r2 = np.linspace(0, 60, N).astype(np.float32)
    _close(tsurf.asph_sag(ct, kt, at, torch.from_numpy(r2)).numpy(),
           jsurf.asph_sag(c, kc2, a, r2), rtol=1e-6, atol=1e-6)
    valid = np.ones(N, bool)
    t_t, v_t = tsurf.asph_refine(ct, kt, at, tt[0:3], tt[3:6], tt[6],
                                 torch.from_numpy(valid))
    t_j, v_j = jsurf.asph_refine(c, kc2, a, o, d, t0, valid)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert v_t.all()
    _close(t_t.numpy(), t_j, atol=1e-5)
    hit = [o[i] + t0 * d[i] for i in range(3)]
    n_t = tsurf.asph_normal(ct, kt, at, [torch.from_numpy(h) for h in hit])
    n_j = jsurf.asph_normal(c, kc2, a, hit)
    for a_, b_ in zip(n_t, n_j):
        _close(a_.numpy(), b_, atol=1e-6)


def test_asph_refine_lands_on_the_sag():
    """A refined root lies on the asphere: z = S(r^2) to float32 accuracy
    (tests/test_asphere.py::test_asphere_hit_on_surface's bound)."""
    c, kc2, a, o, d, t0 = _asph_inputs(N, 2)
    ct, kt, at = (torch.tensor(c), torch.tensor(kc2),
                  [torch.tensor(v) for v in a])
    tt = [torch.from_numpy(v) for v in (*o, *d)]
    t, valid = tsurf.asph_refine(ct, kt, at, tt[0:3], tt[3:6],
                                 torch.from_numpy(t0),
                                 torch.ones(N, dtype=torch.bool))
    x, y, z = (tt[i] + t * tt[3 + i] for i in range(3))
    sag = tsurf.asph_sag(ct, kt, at, x * x + y * y)
    assert valid.all()
    _close((z - sag).numpy(), np.zeros(N), atol=2e-5)


def _bound_points(kind, vb, seed):
    """Random element-frame points around a rectangle [xmin, xmax] x [ymin,
    ymax] (vb[4:8] for CYL_EDGE, else vb[0:4]), with points on each edge,
    within the CYL_RECT_EPS slack and just beyond it, and z around the two
    faces' sags (CYL_EDGE) with points at the CYL_EDGE_EPS margins."""
    rng = np.random.default_rng(seed)
    cyl = kind == VBKind.CYL_EDGE
    edge = vb[4:8] if cyl else vb[0:4]
    xmin, xmax, ymin, ymax = edge
    n = 2000
    x = rng.uniform(xmin - 1, xmax + 1, n)
    y = rng.uniform(ymin - 1, ymax + 1, n)
    for i, v in enumerate((xmin, xmax)):
        x[i * 100:(i + 1) * 100] = v + rng.choice(
            [0.0, CYL_RECT_EPS / 2, -CYL_RECT_EPS / 2, 2 * CYL_RECT_EPS,
             -2 * CYL_RECT_EPS], 100)
    for i, v in enumerate((ymin, ymax)):
        y[200 + i * 100:300 + i * 100] = v + rng.choice(
            [0.0, CYL_RECT_EPS / 2, -CYL_RECT_EPS / 2, 2 * CYL_RECT_EPS,
             -2 * CYL_RECT_EPS], 100)
    z = rng.uniform(-3, 3, n)
    if cyl:
        y32 = y.astype(np.float32)
        for j, (c, zf, sgn) in enumerate(((vb[0], vb[1], 1.0),
                                          (vb[2], vb[3], -1.0))):
            sag = (jsurf.sag_z(np.float32(c), y32) + np.float32(zf))
            sel = slice(400 + j * 200, 600 + j * 200)
            z[sel] = np.asarray(sag)[sel] + sgn * rng.choice(
                [CYL_EDGE_EPS, 2 * CYL_EDGE_EPS, 0.0, CYL_EDGE_EPS / 2], 200)
    return [v.astype(np.float32) for v in (x, y, z)]


@pytest.mark.parametrize('kind', [VBKind.RECT, VBKind.CYL_EDGE])
def test_volume_bounds_match_jax(kind):
    """VB RECT ([xmin, xmax, ymin, ymax] with CYL_RECT_EPS slack) and
    CYL_EDGE ([c1, z1, c2, z2] + the rectangle, between the y-dependent
    sags with CYL_EDGE_EPS margins) decide every point as the JAX package
    does, points on the edges and within the slack included."""
    vb = ([-7.0, 7.0, -6.0, 6.0, 0, 0, 0, 0] if kind == VBKind.RECT
          else [0.04, -1.5, -0.04, 1.5, -7.0, 7.0, -6.0, 6.0])
    vb = np.asarray(vb, np.float32)
    hit = _bound_points(kind, vb, int(kind))
    got = vb_check_one(kind, torch.from_numpy(vb),
                       [torch.from_numpy(h) for h in hit]).numpy()
    want = np.asarray(jax_vb_check(
        kind, jnp.asarray(vb), jnp.zeros((8, 3)), jnp.zeros(8),
        jnp.zeros(8, bool), hit))
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.9


# ---- elements ----

ELEMENTS = {
    'cyl': lambda rt: rt.CylSingletLens(c1=0.04, c2=-0.04, height=12.0,
                                        width=14.0, t=3.0, ior_glass=1.5,
                                        rotation=[0.01, -0.02, 0.03],
                                        translation=[0.1, -0.2, 1.0],
                                        name='cyl'),
    'rect_stop': lambda rt: rt.RectangularAperture(
        half_x=5.0, half_y=4.0, invert=True, translation=[0, 0, 8.0],
        name='stop'),
    'rect_sensor': lambda rt: rt.SensorElement(
        half_x=3.0, half_y=2.0, translation=[0, 0, 20.0], name='det'),
    'asphere': lambda rt: rt.AsphericLens(
        c1=0.05, k1=-0.6, a1=[2.5e-4, 1e-6], c2=-0.02, k2=0.3,
        a2=[1e-5, 0.0, -1e-9], d=10.0, t=3.0, ior_glass=1.5, name='asph'),
}


@pytest.mark.parametrize('name', sorted(ELEMENTS))
def test_element_tables_match_jax(name):
    """Each new element's params carry over one to one (same names and
    shapes, ``a1`` a [4] tensor) and its table rows equal the JAX
    package's; its static kinds too."""
    js = jrt.SequentialScene([ELEMENTS[name](jrt)])
    ts = trt.SequentialScene([ELEMENTS[name](trt)])
    pj = _np(js.init_params())
    pt = ts.init_params('cpu')
    p_in = interop.params_from_numpy(pj, 'cpu')
    assert pt.keys() == p_in.keys()
    for el in pt:
        assert pt[el].keys() == p_in[el].keys()
        for k in pt[el]:
            _close(pt[el][k].numpy(), p_in[el][k].numpy(), rtol=0, atol=0)
    assert ts.trainable() == js.trainable()
    tj = _np(js.build_table(js.init_params()))
    tt = ts.build_table(p_in)
    for f in ('q', 'n_sign', 'Rw', 'tw', 'Rs', 'ts', 'sb', 'vb', 'ph',
              'asph', 'sb_kind', 'vb_kind', 'ph_kind', 'sb_invert'):
        _close(getattr(tt, f).numpy(), getattr(tj, f), rtol=0, atol=2e-7)
    for mt, mj in zip(ts.static_meta(), js.static_meta()):
        for slot in ('ph', 'sb', 'vb', 'sensor', 'invert', 'asph', 'plane'):
            assert getattr(mt, slot) == getattr(mj, slot), slot


def test_cylindrical_lens_analytics_match_jax():
    """The cylindrical singlet's paraxial matrices (no power in x) and its
    optical surfaces' z; the asphere's parameter scales."""
    js, ts = (m.SequentialScene([ELEMENTS['cyl'](m)]) for m in (jrt, trt))
    pj = js.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    _close(ts.paraxial(pt).numpy(), js.paraxial(pj), atol=1e-6)
    _close(torch.stack(ts.elements[0].optical_zs(pt['cyl'])).numpy(),
           jnp.stack(js.elements[0].optical_zs(pj['cyl'])), atol=1e-6)
    a_t, a_j = ELEMENTS['asphere'](trt), ELEMENTS['asphere'](jrt)
    assert a_t.param_scales() == a_j.param_scales()


# ---- traces ----

@pytest.mark.parametrize('case', sorted(SCENES))
def test_eager_simulate_matches_jax(case):
    """The eager chain (``SequentialScene.simulate``) against the JAX
    package's ``simulate``."""
    js, ts = SCENES[case](jrt), SCENES[case](trt)
    rays = _rays(N, 3)
    p, _, _, rays_t = _port(js, rays)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0))
    out_t, sens_t, _ = ts.simulate(p, rays_t)
    _assert_trace_close(out_t, sens_t, out_j, sens_j)
    assert float(sens_t.moments[0, 0, 0]) > 0


@pytest.mark.parametrize('case', sorted(SCENES))
def test_dispatcher_matches_jax_kernel(case):
    """The dispatcher on CPU tensors (the plain version of K1, through the
    instantiation choice of the extended kinds) against the JAX package's
    fused kernel ``trace_sequential_pallas_v2`` in interpret mode."""
    js = SCENES[case](jrt)
    rays = _rays(N, 4)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), interpret=True, block_rows=4)
    _, table, meta, rays_t = _port(js, rays)
    assert fused_trace.ext_kinds(meta)
    cfg = trt.SensorConfig(n_sensors=js.n_sensors, n_bundles=1)
    fused_trace.LAUNCHES = 0
    out_t, sens_t = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert fused_trace.LAUNCHES == 0
    _assert_trace_close(out_t, sens_t, out_j, sens_j)


def test_v1_matches_jax_first_kernel():
    """K0's counterpart ``trace_sequential_v1`` takes the extended kinds
    (on the card K1's kernel in its instantiation with them) and matches
    the JAX package's first kernel, ``trace_sequential_pallas`` in
    interpret mode, on the mixed-surface scene."""
    js = SCENES['mixed'](jrt)
    rays = _rays(N, 8)
    out_j, sens_j, _ = trace_sequential_pallas(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), interpret=True)
    _, table, meta, rays_t = _port(js, rays)
    cfg = trt.SensorConfig(n_sensors=js.n_sensors, n_bundles=1)
    out_t, sens_t, aux = trt.trace_sequential_v1(table, rays_t, cfg, meta)
    assert aux == {}
    _assert_trace_close(out_t, sens_t, out_j, sens_j)


def test_v1_follows_the_chain_at_an_asphere():
    """At an asphere the JAX package's first kernel disagrees with its own
    chain: ``_kernel`` refines the root onto the sag but takes the base
    conic's normal (``normal_world`` without the row's kinds), where
    ``simulate`` and ``trace_sequential_pallas_v2`` take the sag's.  The
    port's ``trace_sequential_v1`` runs K1's function, so it follows the
    chain (ROADMAP Queue 3)."""
    js = SCENES['asphere'](jrt)
    rays = _rays(N, 9)
    k0_j, _, _ = trace_sequential_pallas(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), interpret=True)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0))
    assert np.abs(np.asarray(k0_j.pos) - np.asarray(out_j.pos)).max() > 0.1
    _, table, meta, rays_t = _port(js, rays)
    cfg = trt.SensorConfig(n_sensors=js.n_sensors, n_bundles=1)
    out_t, sens_t, _ = trt.trace_sequential_v1(table, rays_t, cfg, meta)
    _assert_trace_close(out_t, sens_t, out_j, sens_j)


def _loss_jax(scene, rays):
    def loss(p):
        out, sens, _ = scene.simulate(p, rays, jax.random.PRNGKey(0))
        return (jrt.spot_size_loss(sens) + jnp.mean(out.px * out.dx)
                + jnp.mean(out.intensity * out.py))
    return loss


def _loss_torch(simulate, rays):
    def loss(p):
        out, sens, _ = simulate(p, rays)
        return (trt.spot_size_loss(sens) + torch.mean(out.px * out.dx)
                + torch.mean(out.intensity * out.py))
    return loss


def _grads_torch(loss, p, trained):
    for el, k in trained:
        p[el][k] = p[el][k].clone().requires_grad_(True)
    value = loss(p)
    value.backward()
    return float(value.detach()), {(el, k): p[el][k].grad.numpy()
                          for el, k in trained}


def _assert_grads_close(g_t, g_j):
    for key, gt in g_t.items():
        gj = np.asarray(g_j[key[0]][key[1]])
        assert np.isfinite(gt).all()
        # each coefficient to its own scale (a4..a10 span r^4..r^10)
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=0, err_msg=key)


@pytest.mark.parametrize('case', sorted(SCENES))
def test_gradients_match_jax(case):
    """Gradients of a spot and ray loss in the issue's leaves (cyl.c1,
    lens2.c2; asph.k1, asph.a1) through the fused trace's plain versions
    (``simulate_fused`` on CPU tensors: FusedTrace, K2's plain version) and
    through the eager chain, against ``jax.grad`` of the JAX package's
    ``simulate``."""
    trained = chip_smoke.EXT_TRAINED[case]
    js, ts = SCENES[case](jrt), SCENES[case](trt)
    rays = _rays(N, 5)
    p_t, _, _, rays_t = _port(js, rays)
    val_j, g_j = jax.value_and_grad(_loss_jax(js, rays))(js.init_params())
    for simulate in (ts.simulate_fused, ts.simulate):
        p = {el: dict(v) for el, v in p_t.items()}
        val_t, g_t = _grads_torch(_loss_torch(simulate, rays_t), p, trained)
        np.testing.assert_allclose(val_t, float(val_j), rtol=1e-5)
        _assert_grads_close(g_t, g_j)


@pytest.mark.parametrize('case', sorted(SCENES))
def test_scene_versions_match_jax(case):
    """The non-sequential ``Scene`` of each (12 bounces): the eager bounce
    loop and the fused one's plain version (K5) against JAX
    ``Scene.simulate``, and their gradients (K6's plain version, autograd
    of the eager loop) against ``jax.grad``."""
    trained = chip_smoke.EXT_TRAINED[case]
    js = SCENES[case](jrt, chip_smoke.EXT_BOUNCES)
    ts = SCENES[case](trt, chip_smoke.EXT_BOUNCES)
    rays = _rays(N, 6)
    p_t, _, _, rays_t = _port(js, rays)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0))
    for simulate in (ts.simulate, ts.simulate_fused):
        out_t, sens_t, _ = simulate(p_t, rays_t)
        _assert_trace_close(out_t, sens_t, out_j, sens_j)
    val_j, g_j = jax.value_and_grad(_loss_jax(js, rays))(js.init_params())
    for simulate in (ts.simulate_fused, ts.simulate):
        p = {el: dict(v) for el, v in p_t.items()}
        val_t, g_t = _grads_torch(_loss_torch(simulate, rays_t), p, trained)
        np.testing.assert_allclose(val_t, float(val_j), rtol=1e-5)
        _assert_grads_close(g_t, g_j)


def test_asphere_zero_terms_trace_the_spherical_singlet():
    """An asphere with k = 0 and no polynomial terms traces the spherical
    singlet (tests/test_asphere.py::test_asphere_zero_coeffs_matches_
    singlet's bounds: positions 1e-4, directions 1e-5)."""
    kw = dict(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5, name='l')
    sa = trt.SequentialScene([trt.AsphericLens(**kw)])
    ss = trt.SequentialScene([trt.SingletLens(**kw)])
    rays = interop.rays_from_numpy(_np(_rays(1000, 7)), 'cpu')
    oa, _, _ = sa.simulate_fused(sa.init_params('cpu'), rays)
    os_, _, _ = ss.simulate_fused(ss.init_params('cpu'), rays)
    _close(oa.pos.numpy(), os_.pos.numpy(), atol=1e-4)
    _close(oa.dir.numpy(), os_.dir.numpy(), atol=1e-5)


def test_kind_rows_mark_asphere_rows():
    """The kinds' surface column: 0 for a quadric, 1 for a plane, 2 for an
    even asphere (fused_trace.SURF_*)."""
    scene = chip_smoke.asphere_scene(trt)
    rows = fused_trace.kind_rows(scene.static_meta(), scene.sensor_config())
    assert [r[3] for r in rows] == [fused_trace.SURF_ASPHERE,
                                    fused_trace.SURF_ASPHERE,
                                    fused_trace.SURF_QUADRIC,
                                    fused_trace.SURF_PLANE]
