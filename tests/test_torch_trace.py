"""Parity of the PyTorch port's eager sequential trace
(``SequentialScene.simulate`` -> core/trace.py) and its gradients with the
JAX package, on rays the JAX package samples and hands over through numpy.

Bounds (those of tests/test_pallas.py for kernel vs XLA trace): positions atol
1e-5, intensity atol 1e-6, moments rtol 1e-5 atol 1e-3; gradients rtol 1e-3
(sums of thousands of per-ray terms in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch import interop

torch.set_num_threads(2)


def _bench(rt, stop=None):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        stop or rt.CircularAperture(radius=5.0, name='stop'),
        rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                         name='sensor'),
    ])


def _jax_rays(n, seed=0, radius=4.0, rotation=None):
    rays = jrt.CollimatedDisk.make(
        radius=jnp.float32(radius), translation=[0, 0, -10.0],
        rotation=rotation).sample(jax.random.PRNGKey(seed), n)
    return rays, interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')


def _assert_trace_close(out_t, sens_t, out_j, sens_j):
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.dir.numpy(), np.asarray(out_j.dir),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.intensity.numpy(),
                               np.asarray(out_j.intensity), atol=1e-6)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)


@pytest.mark.parametrize('n', [2999, 4096])
def test_simulate_matches_jax(n):
    js, ts = _bench(jrt), _bench(trt)
    rj, rt_ = _jax_rays(n, seed=n)
    out_j, sens_j, _ = js.simulate(js.init_params(), rj,
                                   jax.random.PRNGKey(0))
    out_t, sens_t, aux = ts.simulate(ts.init_params('cpu'), rt_)
    assert aux == {}
    _assert_trace_close(out_t, sens_t, out_j, sens_j)
    np.testing.assert_allclose(sens_t.spot_rms(0).numpy(),
                               np.asarray(sens_j.spot_rms(0)), rtol=1e-5)
    np.testing.assert_allclose(sens_t.centroid(0).numpy(),
                               np.asarray(sens_j.centroid(0)), atol=1e-6)
    for a, b in zip(sens_t.spot_moment(0), sens_j.spot_moment(0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_simulate_matches_jax_off_axis():
    """Tilted input beam through an inverted iris: the miss, absorb and
    edge-refraction branches all fire."""
    def scene(rt):
        return _bench(rt, rt.CircularAperture(radius=2.0, invert=True,
                                              name='iris',
                                              translation=[0, 0, 5.0]))
    js, ts = scene(jrt), scene(trt)
    rj, rt_ = _jax_rays(3000, seed=3, radius=4.9, rotation=[0.15, 0.0, 0.0])
    out_j, sens_j, _ = js.simulate(js.init_params(), rj,
                                   jax.random.PRNGKey(0))
    out_t, sens_t, _ = ts.simulate(ts.init_params('cpu'), rt_)
    _assert_trace_close(out_t, sens_t, out_j, sens_j)
    dead = out_t.intensity.numpy() == 0
    assert 0 < dead.sum() < dead.size


def _grads_jax(js, rays, names):
    p = js.init_params()
    g = jax.grad(lambda pp: jrt.spot_size_loss(
        js.simulate(pp, rays, jax.random.PRNGKey(0))[1]))(p)
    return [float(g['lens'][k]) for k in names]


def _grads_torch(ts, rays, names):
    p = ts.init_params('cpu')
    for k in names:
        p['lens'][k].requires_grad_(True)
    loss = trt.spot_size_loss(ts.simulate(p, rays)[1])
    loss.backward()
    return [float(p['lens'][k].grad) for k in names]


def test_spot_loss_gradients_match_jax():
    names = ('c1', 'c2', 't')
    rj, rt_ = _jax_rays(4096, seed=11)
    gj = _grads_jax(_bench(jrt), rj, names)
    gt = _grads_torch(_bench(trt), rt_, names)
    np.testing.assert_allclose(gt, gj, rtol=1e-3)
    assert all(abs(g) > 1e-3 for g in gt)


def test_gradients_finite_all_blocked():
    """An iris that absorbs every ray: the sensor records nothing, the loss
    is 0 and every gradient stays finite (zero)."""
    ts = _bench(trt, trt.CircularAperture(radius=1e-3, invert=True,
                                          translation=[0, 0, 5.0],
                                          name='iris'))
    _, rt_ = _jax_rays(2048, seed=5)
    p = ts.init_params('cpu')
    for k in ('c1', 'c2'):
        p['lens'][k].requires_grad_(True)
    out, sens, _ = ts.simulate(p, rt_)
    assert float(out.intensity.sum()) == 0.0
    loss = trt.spot_size_loss(sens)
    loss.backward()
    assert float(loss.detach()) == 0.0
    for k in ('c1', 'c2'):
        assert torch.isfinite(p['lens'][k].grad).all()
        assert float(p['lens'][k].grad) == 0.0


def test_spot_target_loss_matches_jax():
    js, ts = _bench(jrt), _bench(trt)
    rj, rt_ = _jax_rays(2000, seed=9, rotation=[0.02, 0.0, 0.0])
    _, sj, _ = js.simulate(js.init_params(), rj, jax.random.PRNGKey(0))
    _, st, _ = ts.simulate(ts.init_params('cpu'), rt_)
    target = [0.1, -0.2]
    np.testing.assert_allclose(
        float(trt.spot_target_loss(st, target)),
        float(jrt.spot_target_loss(sj, target)), rtol=1e-5)
