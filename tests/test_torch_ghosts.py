"""Ghost (two-reflection stray light) tracing of the PyTorch port
(utils/ghosts.py: ``ghost_pairs``, ``ghost_table``, ``ghost_trace``) and the
REFLECT_W kind, against the JAX package, on the CPU: tests/test_ghosts.py's
checks that need neither ``ghost_report`` (the dense dispatch) nor the
field.

Energy checks are closed-form: at normal incidence on an n = 1.5 window,
R = 0.04 exactly, and the window's two-reflection ghost carries T R R T with
no approximation (every incidence is normal).  Tolerances: the closed forms
rtol 1e-5 (float32); kinds equal to the JAX package's, tables to rtol 1e-6
(each package builds the rows from the params in its own float32
arithmetic, then reorders them); ghost traces against the JAX package's at
positions atol 2e-5 of the scene's scale, intensities rtol 1e-5, gradients
rtol 1e-4 (float32 adjoints summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu.utils import ghosts as jghosts
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.utils import ghosts

torch.set_num_threads(2)

R15 = ((1.0 - 1.5) / 2.5) ** 2          # 0.04
T15 = 1.0 - R15
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _axial_rays(n, z0=-5.0, r=0.0, seed=0):
    """+z rays at z0, on the axis or uniform over the square of half side
    ``r`` (numpy-seeded) -> (port Rays, JAX Rays)."""
    rng = np.random.default_rng(seed)
    if r > 0:
        x, y = rng.uniform(-r, r, (2, n)).astype(np.float32)
    else:
        x = y = np.zeros(n, np.float32)
    return _rays(x, y, z0)


def _rays(x, y, z0):
    n = len(x)
    zero = np.zeros(n, np.float32)
    arrays = dict(px=x, py=y, pz=np.full(n, z0, np.float32), dx=zero,
                  dy=zero, dz=np.ones(n, np.float32),
                  intensity=np.ones(n, np.float32),
                  ray_id=np.zeros(n, np.int32), wavelength=zero)
    t = trt.Rays.from_components(
        *[tuple(torch.from_numpy(arrays[c].copy()) for c in cs)
          for cs in (('px', 'py', 'pz'), ('dx', 'dy', 'dz'))],
        torch.from_numpy(arrays['intensity'].copy()),
        torch.from_numpy(arrays['ray_id'].copy()),
        torch.from_numpy(arrays['wavelength'].copy()))
    j = JaxRays.from_components(
        tuple(jnp.asarray(arrays[c]) for c in ('px', 'py', 'pz')),
        tuple(jnp.asarray(arrays[c]) for c in ('dx', 'dy', 'dz')),
        jnp.asarray(arrays['intensity']), jnp.asarray(arrays['ray_id']),
        jnp.asarray(arrays['wavelength']))
    return t, j


def _singlet(rt):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10., t=3., ior_glass=1.5,
                       c1_grad=True, name='lens'),
        rt.CircularAperture(radius=5.0, name='stop'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.322],
                         name='sensor'),
    ])


def test_window_ghost_energy_exact():
    """The window's ghost (0, 1) carries T R R T exactly, goes forward
    again and lands on the sensor with that flux; the fused trace's plain
    version (K1's function, which applies the miss-kill too) gives the
    same."""
    scene = chip_smoke.window_scene(trt)
    p = scene.init_params('cpu')
    rays, _ = _axial_rays(500, r=2.0)
    out, sensors, _ = ghosts.ghost_trace(scene, p, rays, (0, 1))
    flux = float(out.intensity.mean())
    np.testing.assert_allclose(flux, T15 * R15 * R15 * T15, rtol=1e-5)
    np.testing.assert_allclose(flux, chip_smoke.WINDOW_GHOST, rtol=1e-5)
    assert float(out.dz.min()) > 0.99
    total = float(sensors.total_weight(0).sum())
    np.testing.assert_allclose(total, flux * rays.n, rtol=1e-5)
    table, meta = ghosts.ghost_table(scene, p, (0, 1))
    out_f, sens_f = trt.trace_sequential_fused(table, rays,
                                               scene.sensor_config(), meta)
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'):
        torch.testing.assert_close(getattr(out_f, c), getattr(out, c),
                                   rtol=0, atol=0)


def test_ghost_ideal_transmission():
    """``transmission='ideal'`` keeps lossless refraction: the flux is
    R R; another ``transmission`` raises ValueError."""
    scene = chip_smoke.window_scene(trt)
    p = scene.init_params('cpu')
    rays, _ = _axial_rays(100)
    out, _, _ = ghosts.ghost_trace(scene, p, rays, (0, 1),
                                   transmission='ideal')
    np.testing.assert_allclose(float(out.intensity.mean()), R15 * R15,
                               rtol=1e-5)
    with pytest.raises(ValueError, match='transmission'):
        ghosts.ghost_trace(scene, p, rays, (0, 1), transmission='lossless')


def test_miss_kills_ghost_path():
    """Rays outside the reflecting face's bound leave the ghost path (they
    belong to the primary beam): their intensity goes to 0, in the eager
    trace and in the fused trace's plain version; the JAX package's
    ``ghost_trace`` agrees ray for ray."""
    scene = chip_smoke.window_scene(trt)
    p = scene.init_params('cpu')
    x = np.linspace(-9.0, 9.0, 64).astype(np.float32)  # half outside d=10
    rays, rays_j = _rays(x, np.zeros(64, np.float32), -5.0)
    out, _, _ = ghosts.ghost_trace(scene, p, rays, (0, 1))
    inside = np.abs(x) <= 5.0            # the DISK bound is inclusive
    i_out = out.intensity.numpy()
    assert np.all(i_out[~inside] == 0.0)
    assert np.all(i_out[inside] > 0.0)
    js = chip_smoke.window_scene(jrt)
    out_j, _, _ = jghosts.ghost_trace(js, js.init_params(), rays_j, KEY,
                                      (0, 1))
    np.testing.assert_allclose(i_out, np.asarray(out_j.intensity),
                               rtol=1e-5, atol=1e-9)
    table, meta = ghosts.ghost_table(scene, p, (0, 1))
    out_f, _ = trt.trace_sequential_fused(table, rays, scene.sensor_config(),
                                          meta)
    assert torch.equal(out_f.intensity, out.intensity)


def test_ghost_pairs_and_tables_match_jax():
    """``ghost_pairs`` and ``ghost_table``'s flat rows and kinds equal the
    JAX package's row for row, for both transmissions: every pair of the
    singlet scene, and of the Cooke triplet's 36 the first, two in the
    middle and the last."""
    for make in (_singlet, chip_smoke.cooke_scene):
        js, ts = make(jrt), make(trt)
        pairs = ghosts.ghost_pairs(ts)
        assert pairs == jghosts.ghost_pairs(js) and len(pairs) > 0
        pj = js.init_params()
        pt = interop.params_from_numpy(_np(pj), 'cpu')
        if len(pairs) > 4:
            pairs = [pairs[0], pairs[len(pairs) // 2],
                     pairs[len(pairs) // 2 + 1], pairs[-1]]
        for pair in pairs:
            for transmission in ('fresnel', 'ideal'):
                tj, mj = jghosts.ghost_table(js, pj, pair, transmission)
                tt, mt = ghosts.ghost_table(ts, pt, pair, transmission)
                assert list(mt) == interop.meta_from_slots(list(mj))
                np.testing.assert_array_equal(tt.ph_kind.numpy(),
                                              np.asarray(tj.ph_kind))
                ref = trt.flatten_table_rows(interop.table_from_numpy(
                    _np(tj), 'cpu'))
                np.testing.assert_allclose(
                    trt.flatten_table_rows(tt).detach().numpy(),
                    ref.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('pair', [(0, 1), (0, 2), (1, 2)])
def test_singlet_ghosts_match_jax(pair):
    """The singlet's ghosts traced eagerly against the JAX package's
    ``ghost_trace``: the rays and the sensor moments (pairs with the edge
    row carry no flux: no ray reaches the edge)."""
    ts, js = _singlet(trt), _singlet(jrt)
    rays, rays_j = _axial_rays(400, r=3.0, seed=2)
    out, sens, _ = ghosts.ghost_trace(ts, ts.init_params('cpu'), rays, pair)
    out_j, sens_j, _ = jghosts.ghost_trace(js, js.init_params(), rays_j, KEY,
                                           pair)
    scale = max(1.0, float(np.abs(np.asarray(out_j.pos)).max()))
    np.testing.assert_allclose(out.pos.numpy(), np.asarray(out_j.pos),
                               atol=2e-5 * scale)
    np.testing.assert_allclose(out.intensity.numpy(),
                               np.asarray(out_j.intensity), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(sens.moments.numpy(), sens_j.moments,
                               rtol=1e-4, atol=1e-6)
    if pair == (0, 1):
        assert float(out.intensity.sum()) > 0


def test_ghost_flux_differentiable():
    """The mean ghost flux of the singlet's pair (0, 1) is differentiable in
    c1: finite, nonzero and equal to ``jax.grad`` of the JAX package's
    (rtol 1e-4), through the eager trace and the fused trace's plain
    version (K1 and K2's functions)."""
    ts, js = _singlet(trt), _singlet(jrt)
    rays, rays_j = _axial_rays(32, r=2.0)

    def jax_flux(p):
        out, _, _ = jghosts.ghost_trace(js, p, rays_j, KEY, (0, 1))
        return jnp.mean(out.intensity)
    ref = float(jax.grad(jax_flux)(js.init_params())['lens']['c1'])
    assert np.isfinite(ref) and ref != 0.0
    for fused in (False, True):
        p = ts.init_params('cpu')
        p['lens']['c1'] = p['lens']['c1'].clone().requires_grad_(True)
        if fused:
            table, meta = ghosts.ghost_table(ts, p, (0, 1))
            out, _ = trt.trace_sequential_fused(table, rays,
                                                ts.sensor_config(), meta)
        else:
            out, _, _ = ghosts.ghost_trace(ts, p, rays, (0, 1))
        out.intensity.mean().backward()
        got = float(p['lens']['c1'].grad)
        np.testing.assert_allclose(got, ref, rtol=1e-4)
