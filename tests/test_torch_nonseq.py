"""The non-sequential scene of the PyTorch port against the JAX package.

Inputs are JAX-sampled rays (and, for the trace functions, JAX-built
tables) carried across by ``interop``.  Two scenes:

- the bench singlet traced as a ``Scene`` ("naive scene" of BASELINE.json),
  8 bounces;
- the mirror fold: a ``SphericalMirror`` (R = -40) at z = 40 folds rays back
  through a sensor at z = 0.5, with a 32 x 32 grid over [-4, 4]^2
  (tests/test_pallas.py::test_nonseq_fused_grid_parity).

Tolerances, from the JAX tests named:
- bench scene: <= 0.2% of rays with |dpos| > 1e-4 or |dI| > 1e-5, spot RMS
  rtol 1e-3, centroid atol 1e-3 (test_pallas.py::test_nonseq_fused_matches_
  xla: a ray on a bound's rim may flip, and 8 bounces amplify it);
- mirror fold: moments rtol 1e-4 atol 1e-3, grid rtol 1e-5 atol 1e-4
  (test_nonseq_fused_grid_parity; unit weights, so JAX's bf16 grid split
  is exact);
- an ordered system traced both ways: positions atol 1e-4, directions
  1e-5, moments rtol/atol 1e-4 (test_nonsequential.py);
- gradients of the spot RMS: rtol 1e-3 against ``jax.grad``.

The CUDA kernel K5 is compared with the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.trace import \
    trace_nonsequential as jax_trace_nonsequential
from raytracetorch_tpu.ops.pallas_trace import (
    flatten_table_rows as jax_flatten, trace_nonseq_pallas)
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.trace import bounce_step
from raytracetorch_tpu_torch.ops import fused_nonseq

torch.set_num_threads(2)

N = 3000


def _naive(rt, n_bounces=8, stop_z=0.0):
    return rt.Scene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.CircularAperture(radius=5.0, translation=[0, 0, stop_z],
                            name='stop'),
        rt.SensorElement(radius=6.0, translation=[0, 0, 19.322],
                         name='sensor'),
    ], n_bounces=n_bounces)


def _fold(rt):
    scene = rt.Scene([
        rt.SphericalMirror(c1=-0.025, d=0.0, translation=[0.0, 0.0, 40.0],
                           name='mirror'),
        rt.SensorElement(radius=10.0, translation=[0.0, 0.0, 0.5],
                         name='sensor'),
    ], n_bounces=4)
    scene.grid_shape, scene.grid_half_extent = (32, 32), 4.0
    return scene


SCENES = {'naive': _naive, 'fold': _fold}


def _jax_rays(case, n, seed):
    key = jax.random.PRNGKey(seed)
    if case == 'fold':
        return jrt.CollimatedDisk.make(radius=jnp.float32(2.0),
                                       translation=[0, 0, 1.0]).sample(key, n)
    return jrt.CollimatedDisk.make(radius=jnp.float32(4.0),
                                   translation=[0, 0, -10.0]).sample(key, n)


def _to_port(scene, rays):
    """The JAX scene's table, kinds, sensor config and rays, through
    numpy."""
    to_np = jax.tree_util.tree_map
    table = interop.table_from_numpy(
        to_np(np.asarray, scene.build_table(scene.init_params())), 'cpu')
    cfg = scene.sensor_config()
    cfg_t = trt.SensorConfig(n_sensors=cfg.n_sensors,
                             n_bundles=cfg.n_bundles,
                             grid_shape=tuple(cfg.grid_shape),
                             grid_half_extent=cfg.grid_half_extent)
    return (table, interop.rays_from_numpy(to_np(np.asarray, rays), 'cpu'),
            cfg_t, interop.meta_from_slots(scene.static_meta()))


def _assert_matches(case, out_t, s_t, out_j, s_j):
    if case == 'naive':
        dp = np.abs(out_t.pos.numpy() - np.asarray(out_j.pos)).max(1)
        di = np.abs(out_t.intensity.numpy() - np.asarray(out_j.intensity))
        assert int(((dp > 1e-4) | (di > 1e-5)).sum()) <= 0.002 * N
        np.testing.assert_allclose(s_t.spot_rms(0).numpy(),
                                   np.asarray(s_j.spot_rms(0)), rtol=1e-3)
        np.testing.assert_allclose(s_t.centroid(0).numpy(),
                                   np.asarray(s_j.centroid(0)), atol=1e-3)
    else:
        np.testing.assert_allclose(s_t.moments.numpy(),
                                   np.asarray(s_j.moments), rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(s_t.grid.numpy(), np.asarray(s_j.grid),
                                   rtol=1e-5, atol=1e-4)
        assert float(s_t.grid.sum()) > 0.9 * N     # hits actually landed
        assert float(out_t.dz.mean()) < 0.0


def test_mirror_rows_match_jax():
    """SphericalMirror's flat rows (HEMI_APER bound, effective aperture)
    equal JAX's, unbounded, bounded by d, by diameter, and tilted."""
    def mirrors(rt):
        return rt.SequentialScene([
            rt.SphericalMirror(c1=-0.025, d=0.0, translation=[0, 0, 40.0],
                               name='m0'),
            rt.SphericalMirror(c1=0.02, d=12.0, rotation=[0.1, -0.05, 0.0],
                               translation=[1.0, 0, 20.0], name='m1'),
            rt.SphericalMirror(c1=0.01, d=12.0, diameter=8.0,
                               translation=[0, 0, 5.0], name='m2'),
        ])
    js, ts = mirrors(jrt), mirrors(trt)
    flat_j = np.asarray(jax_flatten(js.build_table(js.init_params())))
    flat_t = trt.flatten_table_rows(ts.build_table(ts.init_params('cpu')))
    np.testing.assert_allclose(flat_t.numpy(), flat_j, rtol=0, atol=1e-7)
    assert [m.sb for m in ts.static_meta()] == [trt.SBKind.HEMI_APER] * 3
    assert [(m.ph, m.sb, m.vb, m.plane) for m in ts.static_meta()] == [
        (m.ph, m.sb, m.vb, m.plane) for m in js.static_meta()]
    p = ts.init_params('cpu')['m1']
    assert float(ts.elements[1].f(p)) == pytest.approx(25.0)
    assert float(ts.elements[1].R(p)) == pytest.approx(50.0)


@pytest.mark.parametrize('case', sorted(SCENES))
def test_trace_nonsequential_matches_jax(case):
    js = SCENES[case](jrt)
    rays = _jax_rays(case, N, seed=1)
    out_j, s_j, _ = jax_trace_nonsequential(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.n_bounces, js.sensor_config(), static_meta=js.static_meta())
    table, rays_t, cfg, meta = _to_port(js, rays)
    out_t, s_t, aux = trt.trace_nonsequential(table, rays_t, js.n_bounces,
                                              cfg, meta)
    assert aux == {}
    _assert_matches(case, out_t, s_t, out_j, s_j)


@pytest.mark.parametrize('case', sorted(SCENES))
def test_fused_plain_matches_jax_kernel(case):
    """The plain version of K5 (trace_nonseq_fused on CPU tensors) against
    the JAX fused kernel in interpret mode."""
    js = SCENES[case](jrt)
    rays = _jax_rays(case, N, seed=2)
    out_j, s_j, _ = trace_nonseq_pallas(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.n_bounces, js.sensor_config(), static_meta=js.static_meta(),
        interpret=True, block_rows=2)
    table, rays_t, cfg, meta = _to_port(js, rays)
    before = fused_nonseq.NONSEQ_LAUNCHES
    out_t, s_t = trt.trace_nonseq_fused(table, rays_t, cfg, meta,
                                        js.n_bounces)
    assert fused_nonseq.NONSEQ_LAUNCHES == before   # CPU: plain version
    _assert_matches(case, out_t, s_t, out_j, s_j)


def test_scene_matches_sequential_scene_on_ordered_system():
    """On an ordered system the bounce loop equals the sequential chain
    (tests/test_nonsequential.py), eagerly and fused."""
    scene = _naive(trt, stop_z=10.0)
    seq = scene.to_sequential()
    assert [el.name for el in seq.elements] == ['lens', 'stop', 'sensor']
    assert isinstance(seq.to_base(), trt.Scene)
    p = scene.init_params('cpu')
    rays = interop.rays_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_rays('naive', 2048, seed=3)), 'cpu')
    out_s, s_s, _ = seq.simulate(p, rays)
    for sim in (scene.simulate, scene.simulate_fused):
        out_n, s_n, _ = sim(p, rays)
        np.testing.assert_allclose(out_n.pos.numpy(), out_s.pos.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(out_n.dir.numpy(), out_s.dir.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(s_n.moments.numpy(), s_s.moments.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_extra_budget_is_a_no_op_and_early_exit_equals_full_budget():
    """Budgets of 4, 16 and 100 bounces trace identically (rays settle in
    4), and the loop's early exit equals running every bounce."""
    p = _naive(trt).init_params('cpu')
    rays = interop.rays_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_rays('naive', 1024, seed=4)), 'cpu')
    outs = [_naive(trt, n_bounces=nb).simulate(p, rays)
            for nb in (4, 16, 100)]
    for out, sens, _ in outs[1:]:
        torch.testing.assert_close(out.pos, outs[0][0].pos, rtol=0, atol=0)
        torch.testing.assert_close(out.dir, outs[0][0].dir, rtol=0, atol=0)
        torch.testing.assert_close(sens.moments, outs[0][1].moments, rtol=0,
                                   atol=0)
    scene = _naive(trt, n_bounces=12)
    table = scene.build_table(p)
    rows = [table.row(k) for k in range(table.n_surfaces)]
    cfg, meta = scene.sensor_config(), scene.static_meta()
    full, sens = rays, trt.SensorState.init(cfg)
    for _ in range(12):             # every bounce, no early exit
        full, sens, _ = bounce_step(rows, full, cfg, sens, meta)
    torch.testing.assert_close(full.pos, outs[0][0].pos, rtol=0, atol=0)
    torch.testing.assert_close(sens.moments, outs[0][1].moments, rtol=0,
                               atol=0)
    out_f, sens_f, _ = _naive(trt, n_bounces=100).simulate_fused(p, rays)
    torch.testing.assert_close(out_f.pos, full.pos, rtol=0, atol=0)


def test_no_phantom_sensor_recrossings():
    """Port of tests/test_nonsequential.py::test_no_phantom_sensor_
    recrossings without the Fresnel branch (not ported): near-axis rays on a
    far sensor plane must not re-hit it at t ~ 5e-6 and record twice.  The
    recorded flux equals the launched flux at every budget, and JAX's."""
    def scene_of(rt, nb):
        return rt.Scene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0,
                           ior_glass=1.5168, name='lens'),
            rt.SensorElement(radius=8.0, translation=[0, 0, 19.3],
                             name='s'),
        ], n_bounces=nb)
    rays = _jax_rays('naive', 10_000, seed=5)
    rays_t = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')
    fluxes = []
    for nb in (3, 6, 12):
        scene = scene_of(trt, nb)
        _, sens, _ = scene.simulate(scene.init_params('cpu'), rays_t)
        fluxes.append(float(sens.moments[0, 0, 0]))
    assert fluxes == [10_000.0] * 3
    js = scene_of(jrt, 12)
    _, s_j, _ = js.simulate(js.init_params(), rays, jax.random.PRNGKey(0))
    assert float(s_j.moments[0, 0, 0]) == fluxes[-1]


def test_ray_cast_matches_jax():
    """Nearest-hit query from points inside the scene in random directions:
    winner row, element, surface within the element and hit mask equal
    JAX's."""
    rng = np.random.default_rng(6)
    n = 2000
    pos = rng.uniform([-4, -4, -5], [4, 4, 25], (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    js, ts = _naive(jrt), _naive(trt)
    rays_j = jrt.Rays.create(pos, d)
    res_j = js.ray_cast(js.init_params(), rays_j)
    res_t = ts.ray_cast(ts.init_params('cpu'), interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays_j), 'cpu'))
    hit = np.asarray(res_j['hit'])
    np.testing.assert_array_equal(res_t['hit'].numpy(), hit)
    assert 0.2 * n < hit.sum() < n
    for k in ('surface', 'element', 'surf_in_element'):
        np.testing.assert_array_equal(res_t[k].numpy()[hit],
                                      np.asarray(res_j[k])[hit], err_msg=k)


def test_nonsequential_gradients_match_jax():
    """d spot_rms / d(c1, c2) through the eager bounce loop equals
    jax.grad through the JAX bounce loop."""
    js, ts = _naive(jrt, n_bounces=6), _naive(trt, n_bounces=6)
    rays = _jax_rays('naive', 512, seed=7)
    key = jax.random.PRNGKey(0)

    def loss_j(p):
        _, sens, _ = js.simulate(p, rays, key)
        return sens.spot_rms(0)[0]

    g_j = jax.grad(loss_j)(js.init_params())['lens']
    p = ts.init_params('cpu')
    for k in ('c1', 'c2'):
        p['lens'][k].requires_grad_(True)
    _, sens, _ = ts.simulate(p, interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu'))
    sens.spot_rms(0)[0].backward()
    for k in ('c1', 'c2'):
        g = float(p['lens'][k].grad)
        assert g != 0.0
        np.testing.assert_allclose(g, float(g_j[k]), rtol=1e-3, err_msg=k)


def test_mirror_fold_path():
    """Port of tests/test_nonsequential.py::test_mirror_fold_path: f = 20,
    so the spot at z = 0.5 after the focus at z = 20 has an RMS radius in
    (1, 2), and the rays travel backwards."""
    scene = _fold(trt)
    p = scene.init_params('cpu')
    gen = torch.Generator().manual_seed(0)
    rays = trt.CollimatedDisk.make(radius=2.0).sample(gen, 512, 'cpu')
    out, sens, _ = scene.simulate(p, rays)
    assert float(out.dz.mean()) < 0.0
    assert float(sens.total_weight(0)[0]) > 500
    assert 1.0 < float(sens.spot_rms(0)[0]) < 2.0
    assert float(scene.elements[0].f(p['mirror'])) == pytest.approx(-20.0)


def test_simulate_fused_under_grad_raises_k6():
    """Scene.simulate_fused under grad goes through FusedNonseq (its
    backward is kernel K6; the plain versions on the CPU) and gives finite,
    nonzero gradients for the params and the rays; like the JAX custom_vjp
    it is first order only, so a double backward raises."""
    scene = _naive(trt)
    p = scene.init_params('cpu')
    rays = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0]) \
        .sample(torch.Generator().manual_seed(0), 64, 'cpu')
    p['lens']['c1'].requires_grad_(True)
    r = rays.replace(px=rays.px.clone().requires_grad_(True))
    out, sens, _ = scene.simulate_fused(p, r)
    assert type(sens.moments.grad_fn).__name__ == 'FusedNonseqBackward'
    loss = sens.spot_rms(0)[0] + out.px.square().mean()
    g_c1, g_px = torch.autograd.grad(loss, (p['lens']['c1'], r.px),
                                     create_graph=True)
    assert bool(torch.isfinite(g_c1)) and float(g_c1.detach()) != 0.0
    assert bool(torch.isfinite(g_px).all()) and float(g_px.abs().max()) > 0
    with pytest.raises(RuntimeError, match='once_differentiable'):
        g_c1.backward()
    with torch.no_grad():
        _, s0, _ = scene.simulate_fused(p, rays)
    assert s0.moments.grad_fn is None
    torch.testing.assert_close(s0.moments, sens.moments.detach(), rtol=0,
                               atol=0)


@pytest.mark.parametrize('make,match', [
    (lambda: trt.SphericalMirror(c1=0.01, d=10.0, metal='Al',
                                 roughness=0.1), 'not modeled'),
    (lambda: trt.SphericalMirror(c1=0.01, d=10.0, roughness=0.1),
     'item 14'),
])
def test_unported_mirror_options_raise(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make()


def test_unported_streams_raise():
    """The streams this test refused until the field came to the
    non-sequential trace: ``track_field`` now traces (finite |E|^2 in
    ``aux``; tests/test_torch_field_nonseq.py holds it to the JAX package)
    and an ``E0`` without it is ignored, as in the JAX package."""
    scene = _naive(trt)
    p = scene.init_params('cpu')
    rays = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0]) \
        .sample(torch.Generator().manual_seed(0), 64, 'cpu')
    aux = scene.simulate(p, rays, track_field=True)[2]
    assert bool(torch.isfinite(aux['field_power']).all())
    assert 'field' not in scene.simulate(p, rays, E0=torch.ones(1, 3))[2]


def test_fuzzy_fns_run():
    """The call that test_unported_streams_raise refused before fuzzy
    apodization was ported: a legacy [N, 3] callable on the stop's row
    scales the intensity of the rays that pass it, eagerly."""
    scene = _naive(trt)
    p = scene.init_params('cpu')
    rays = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0]) \
        .sample(torch.Generator().manual_seed(0), 64, 'cpu')
    stop = scene.elements[0].n_surfaces          # the stop's row
    half = {stop: lambda h: torch.full_like(h[:, 0], 0.5)}
    out, _, _ = scene.simulate(p, rays, fuzzy_fns=half)
    ref, _, _ = scene.simulate(p, rays)
    torch.testing.assert_close(out.intensity, 0.5 * ref.intensity)
