"""The obscured pupil's gradients against the JAX package in float64, on
the CPU (ROADMAP Queue 3, recorded divergences).

chip_smoke.py's ``pupil_scene`` (an ObscuredAperture before an
IdealThinLens that focuses on the sensor) under the JAX package's
CollimatedDisk (r = 4, ``PRNGKey(MIX_SEED)``, 192 rays) and the loss
spot_rms^2 + 1e-3 * weight.  At the focus the spot's RMS is ~7e-8 mm, so in
float32 the gradient in the lens's power is rounding of that loss: the JAX
package's own SequentialScene and Scene part by 4.1% there, and the port
lies between them.  In float64 (``jax.enable_x64``, the port on float64
tensors) both packages compute the same function:

- the gradients in ('lens', 'P') and ('s', 'trans') of the eager and the
  fused traces (the plain versions on CPU tensors), as a SequentialScene
  and as a 3-bounce Scene, within rtol 1e-6 of JAX's eager ones;
- in float32, defocused (the sensor at z = 45), the same gradients within
  rtol 1e-5 (float32 sums over the rays in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import chip_smoke as cs
import raytracetorch_tpu as jrt
from raytracetorch_tpu_torch import interop
import raytracetorch_tpu_torch as trt

N_RAYS = 192
LEAVES = (('lens', 'P'), ('s', 'trans'))


def _scene(rt, sensor_z, n_bounces):
    """chip_smoke.pupil_scene with the sensor at ``sensor_z``."""
    els = [rt.ObscuredAperture(radius=cs.PUPIL_R, obscuration=cs.PUPIL_OBS,
                               n_vanes=cs.PUPIL_VANES,
                               vane_width=cs.PUPIL_VANE_W, name='pupil'),
           rt.IdealThinLens(focal=50.0, diameter=12.0,
                            translation=[0, 0, 2.0], name='lens'),
           rt.SensorElement(radius=6.0, translation=[0, 0, sensor_z],
                            name='s')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, tree)


@functools.lru_cache(maxsize=None)
def _jax_grads(sensor_z, n_bounces, dtype):
    js = _scene(jrt, sensor_z, n_bounces)
    rays = jrt.CollimatedDisk.make(
        radius=jnp.float32(4.0), translation=[0, 0, -1.0]).sample(
            jax.random.PRNGKey(cs.MIX_SEED), N_RAYS)
    params, rays = _cast(js.init_params(), dtype), _cast(rays, dtype)

    def loss(p):
        s = js.simulate(p, rays, jax.random.PRNGKey(0))[1]
        return s.spot_rms(0)[0] ** 2 + 1e-3 * s.total_weight(0)[0]
    g = jax.jit(jax.grad(loss))(params)
    return _np(rays), _np(params), [np.asarray(g[e][k]) for e, k in LEAVES]


def _port_grads(sensor_z, n_bounces, simulate, rays_np, params_np, dtype):
    ts = _scene(trt, sensor_z, n_bounces)
    rays = interop.rays_from_numpy(rays_np, 'cpu')
    rays = rays.replace(**{c: getattr(rays, c).to(dtype) for c in
                           ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')})
    p = interop.params_from_numpy(params_np, 'cpu')
    p = {e: {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in d.items()} for e, d in p.items()}
    leaves = [p[e][k].requires_grad_(True) for e, k in LEAVES]
    s = getattr(ts, simulate)(p, rays)[1]
    loss = s.spot_rms(0)[0] ** 2 + 1e-3 * s.total_weight(0)[0]
    return [g.detach().numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize('n_bounces', [None, 3])
@pytest.mark.parametrize('simulate', ['simulate', 'simulate_fused'])
def test_pupil_gradients_match_jax_in_float64(simulate, n_bounces):
    """At the focus (z = 52), in float64: the port's gradients in the lens's
    power and the sensor's pose within rtol 1e-6 of the JAX package's."""
    with enable_x64():
        rays, params, want = _jax_grads(52.0, n_bounces, 'float64')
    got = _port_grads(52.0, n_bounces, simulate, rays, params,
                      torch.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize('n_bounces', [None, 3])
def test_pupil_gradients_match_jax_defocused(n_bounces):
    """Away from the focus (z = 45), in float32: the same gradients, eager
    and fused, within rtol 1e-5 of the JAX package's float32 ones."""
    rays, params, want = _jax_grads(45.0, n_bounces, 'float32')
    for simulate in ('simulate', 'simulate_fused'):
        got = _port_grads(45.0, n_bounces, simulate, rays, params,
                          torch.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


if __name__ == '__main__':
    # JAX_PLATFORMS=cpu python tests/test_torch_pupil_f64.py: the gradient
    # in the lens's power of each path at the focus, in float32 and float64
    import json
    for dtype, jdt, tdt in (('float32', 'float32', torch.float32),
                            ('float64', 'float64', torch.float64)):
        with enable_x64() if dtype == 'float64' else __import__(
                'contextlib').nullcontext():
            row = {}
            for nb in (None, 3):
                rays, params, want = _jax_grads(52.0, nb, jdt)
                row[f'jax_{nb or "seq"}'] = float(want[0])
                for sim in ('simulate', 'simulate_fused'):
                    row[f'port_{sim}_{nb or "seq"}'] = float(_port_grads(
                        52.0, nb, sim, rays, params, tdt)[0])
        print(json.dumps({dtype: row}))
