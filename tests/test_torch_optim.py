"""The design loop of the PyTorch port: optim/fit.py, optim/constraints.py,
the scene's bundle API, the singlet's thick-lens analytics and entry.py.

The optimizer tests are twins of tests/test_optimize_singlet.py on the
port's eager ``simulate`` (and one through ``simulate_fused``, which on the
CPU runs the plain versions of both kernels).  They assert the same ranges,
not trajectories: optax's and torch's L-BFGS differ.  The analytics and
constraint values are held to the JAX package's on the same parameters
(rtol 1e-6: a handful of f32 operations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.optim import constraints as jcons
from raytracetorch_tpu_torch.entry import entry, flagship_scene, train_step
from raytracetorch_tpu_torch.ops import fused_trace

torch.set_num_threads(2)


def _design_scene(rt=trt):
    """The reference's optimization lens: f ~ 99.6, target plane z=100."""
    return rt.SequentialScene([rt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        c1_grad=True, c2_grad=True, name='lens')])


def _rays(n, seed):
    gen = torch.Generator('cpu').manual_seed(seed)
    return trt.CollimatedDisk.make(radius=5.0,
                                   translation=[0, 0, -10.0]).sample(
        gen, n, 'cpu')


def _transverse(out, target_z=100.0):
    t = (target_z - out.pz) / (out.dz + 1e-6)
    return out.px + t * out.dx, out.py + t * out.dy


def _spot_loss(simulate, rays):
    def loss(p):
        out, _, _ = simulate(p, rays)
        x, y = _transverse(out)
        return torch.mean(x ** 2 + y ** 2)
    return loss


def _assert_best_form(scene, params, p2, l0, lf):
    assert lf < l0 * 0.02, f'failed to converge: {l0} -> {lf}'
    ratio = float(p2['lens']['c1']) / float(p2['lens']['c2'])
    # best-form singlet for an object at infinity, n ~ 1.52: c1/c2 ~ -6
    assert -7.5 < ratio < -4.5, f'ratio {ratio}'
    f = float(scene.elements[0].f(p2['lens']))
    assert 95.0 < f < 106.0, f'focal length {f}'
    # only the trainable leaves moved, and the others not by a bit
    for k in ('t', 'ior_glass', 'radius', 'trans', 'rot_vec'):
        assert torch.equal(p2['lens'][k], params['lens'][k]), k


@pytest.mark.parametrize('path', ['simulate', 'simulate_fused'])
def test_lbfgs_converges_to_best_form(path):
    scene = _design_scene()
    params = scene.init_params('cpu')
    loss = _spot_loss(getattr(scene, path), _rays(3000, 0))
    l0 = float(loss(params))
    before = fused_trace.BWD_LAUNCHES
    p2, losses = trt.fit_lbfgs(loss, params, trainable=scene.trainable(),
                               steps=25)
    assert fused_trace.BWD_LAUNCHES == before       # CPU: no kernel
    assert losses.shape == (25,) and float(losses[0]) == pytest.approx(l0)
    _assert_best_form(scene, params, p2, l0, float(losses[-1]))


def test_adam_also_converges():
    scene = _design_scene()
    params = scene.init_params('cpu')
    loss = _spot_loss(scene.simulate, _rays(4000, 1))
    l0 = float(loss(params))
    p2, losses = trt.fit(loss, params, trainable=scene.trainable(),
                         steps=200, lr=2e-4)
    assert float(losses[-1]) < l0 * 0.5
    assert torch.equal(p2['lens']['t'], params['lens']['t'])


def test_fit_float_mask_and_scales():
    """A float mask trains only the unmasked entries of a leaf (Adam leaves
    the others exactly in place), and ``scales`` reparameterizes p = s y."""
    scene = _design_scene()
    params = scene.init_params('cpu')
    trainable = scene.trainable()
    trainable['lens']['trans'] = [0.0, 0.0, 1.0]
    loss = _spot_loss(scene.simulate, _rays(1000, 2))
    p2, losses = trt.fit(loss, params, trainable=trainable, steps=5,
                         lr=1e-3, scales={'lens': {'c1': 0.01, 'c2': 0.01}})
    assert torch.equal(p2['lens']['trans'][:2], params['lens']['trans'][:2])
    assert float(p2['lens']['trans'][2]) != 0.0
    # the step is taken in the scaled variable: Adam's first step is ~lr
    assert abs(float(p2['lens']['c1'] - params['lens']['c1'])) < 1e-4
    assert torch.equal(p2['lens']['t'], params['lens']['t'])
    assert bool(torch.isfinite(losses).all())


def test_grad_mask_fn():
    g = {'a': {'x': torch.ones(3), 'y': torch.ones(())},
         'b': {'z': torch.ones(2)}}
    params = {el: {k: torch.zeros_like(v).requires_grad_(True)
                   for k, v in d.items()} for el, d in g.items()}
    for el, d in params.items():
        for k, v in d.items():
            v.grad = g[el][k].clone()
    trt.grad_mask_fn({'a': {'x': [1.0, 0.0, 0.5], 'y': False},
                      'b': {'z': True}})(params)
    assert params['a']['x'].grad.tolist() == [1.0, 0.0, 0.5]
    assert float(params['a']['y'].grad) == 0.0
    assert params['b']['z'].grad.tolist() == [1.0, 1.0]


def test_focal_length_loss_gradient():
    scene = _design_scene()
    params = scene.init_params('cpu')
    assert float(trt.focal_length_loss(scene, params, 100.0)) < 1e-8
    trt.trainable_leaves(params, scene.trainable())
    trt.focal_length_loss(scene, params, 50.0).backward()
    g = float(params['lens']['c1'].grad)
    assert g != 0.0 and np.isfinite(g)
    assert params['lens']['t'].grad is None


def test_sensor_based_spot_goals():
    scene = _design_scene()
    scene.add_element(trt.SensorElement(radius=20.0,
                                        translation=[0, 0, 100.0],
                                        name='sensor'))
    params = scene.init_params('cpu')
    b0 = trt.CollimatedDisk.make(radius=5.0, ray_id=0,
                                 translation=[0, 0, -10.0])
    b1 = trt.CollimatedDisk.make(radius=5.0, ray_id=1,
                                 rotation=[-0.05, 0.0, 0.0],
                                 translation=[0, 0, -10.0])
    scene.add_bundle(b0, 2000)
    scene.add_bundle(b1, 2000)
    assert scene.n_bundles == 2 and scene.sensor_config().n_bundles == 2
    rays = scene.sample_rays(torch.Generator('cpu').manual_seed(0), 'cpu')
    assert rays.n == 4000
    _, sensors, _ = scene.simulate(params, rays)
    # both bundles recorded separately (the default n_bundles is the
    # scene's bundle count)
    w = sensors.total_weight(0)
    assert w.shape == (2,) and bool((w > 1500).all())
    # the tilted bundle lands off-axis in y
    c = sensors.centroid(0)
    assert abs(float(c[0, 1])) < 0.2 and float(c[1, 1]) > 2.0
    sl = float(trt.spot_size_loss(sensors))
    assert 0.0 < sl < 2.0
    assert float(trt.spot_target_loss(sensors, c)) < 1e-9
    # the fused trace takes the same call
    _, sens_f, _ = scene.simulate_fused(params, rays)
    torch.testing.assert_close(sens_f.moments, sensors.moments, rtol=1e-5,
                               atol=1e-3)


def test_scene_population_api():
    scene = _design_scene()
    assert scene.n_bundles == 1 and scene.bundles == []
    meta = scene.static_meta()
    sensor = scene.add_element(trt.SensorElement(radius=6.0, name='s'))
    assert scene.find_element('s') is sensor
    assert len(scene.static_meta()) == len(meta) + 1   # meta rebuilt
    with pytest.raises(KeyError):
        scene.find_element('missing')
    bundle = scene.add_bundle(trt.CollimatedDisk.make(radius=1.0), 10)
    assert scene.bundles == [(bundle, 10)]
    scene.clear_bundles()
    assert scene.bundles == [] and scene.n_bundles == 1
    scene.clear_elements()
    assert scene.elements == []


def test_singlet_analytics_match_jax():
    kw = dict(c1=0.03, c2=-0.01, d=20.0, t=5.0, ior_glass=1.6, name='lens',
              translation=[0.0, 0.0, 7.0])
    lj, lt = jrt.SingletLens(**kw), trt.SingletLens(**kw)
    pj = jrt.SequentialScene([lj]).init_params()['lens']
    pt = trt.SequentialScene([lt]).init_params('cpu')['lens']
    for name in ('power1', 'power2', 'power', 'f', 'f_bfl', 'f_ffl', 'R1',
                 'R2'):
        np.testing.assert_allclose(float(getattr(lt, name)(pt)),
                                   float(getattr(lj, name)(pj)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose([float(z) for z in lt.optical_zs(pt)],
                               [float(z) for z in lj.optical_zs(pj)],
                               rtol=1e-6)
    stop_j = jrt.CircularAperture(radius=2.0, translation=[0, 0, 3.0])
    stop_t = trt.CircularAperture(radius=2.0, translation=[0, 0, 3.0])
    assert float(stop_t.optical_zs(stop_t.init_params('cpu'))[0]) == \
        float(stop_j.optical_zs(stop_j.init_params())[0]) == 3.0


def test_constraints_barriers():
    scene = _design_scene()
    params = scene.init_params('cpu')
    assert np.isfinite(float(
        trt.thickness_constraint(scene, params, 1.0, 10.0)))
    trt.trainable_leaves(params)
    trt.thickness_constraint(scene, params, 1.0, 10.0).backward()
    # d/dt of -log(t - 1) - log(10 - t) at t=4: -1/3 + 1/6 = -1/6
    np.testing.assert_allclose(float(params['lens']['t'].grad), -1.0 / 6.0,
                               rtol=1e-4)
    assert np.isfinite(float(
        trt.system_length_constraint(scene, params, l_max=20.0).detach()))

    def two(rt):
        return rt.SequentialScene([
            rt.SingletLens(c1=0.016667, c2=-0.00283, d=25.4, t=4.0,
                           ior_glass=1.5168, name='a'),
            rt.SingletLens(c1=0.016667, c2=-0.00283, d=25.4, t=4.0,
                           ior_glass=1.5168, translation=[0, 0, 30.0],
                           name='b')])
    s2 = two(trt)
    p2 = s2.init_params('cpu')
    trt.trainable_leaves(p2)
    trt.spacing_constraint(s2, p2, 5.0).backward()
    # gap = 26; d(-log(gap - 5)) / d z_b = -1/21
    np.testing.assert_allclose(float(p2['b']['trans'].grad[2]), -1.0 / 21.0,
                               rtol=1e-4)


def test_constraints_match_jax():
    def two(rt):
        return rt.SequentialScene([
            rt.SingletLens(c1=0.02, c2=-0.01, d=25.4, t=4.0,
                           ior_glass=1.5168, name='a'),
            rt.CircularAperture(radius=5.0, translation=[0, 0, 12.0],
                                name='stop'),
            rt.SingletLens(c1=0.016667, c2=-0.00283, d=25.4, t=6.0,
                           ior_glass=1.6, translation=[0, 0, 30.0],
                           name='b')])
    sj, st = two(jrt), two(trt)
    pj, pt = sj.init_params(), st.init_params('cpu')
    for name, args in (('thickness_constraint', (2.0, 9.0)),
                       ('thickness_constraint', (2.0,)),
                       ('spacing_constraint', (1.0,)),
                       ('system_length_constraint', (60.0,))):
        vj = float(getattr(jcons, name)(sj, pj, *args, weight=0.5))
        vt = float(getattr(trt, name)(st, pt, *args, weight=0.5))
        np.testing.assert_allclose(vt, vj, rtol=1e-6, err_msg=name)
    x = torch.tensor(3.0)
    np.testing.assert_allclose(
        [float(trt.log_barrier_lb(x, 1.0)), float(trt.log_barrier_ub(x, 5.0)),
         float(trt.log_barrier(x, 1.0, 5.0))],
        [float(jcons.log_barrier_lb(jnp.float32(3.0), 1.0)),
         float(jcons.log_barrier_ub(jnp.float32(3.0), 5.0)),
         float(jcons.log_barrier(jnp.float32(3.0), 1.0, 5.0))], rtol=1e-6)


def test_lm_converges_in_few_iterations():
    scene = _design_scene()
    params = scene.init_params('cpu')
    rays = _rays(2000, 3)

    def residuals(p):
        out, _, _ = scene.simulate(p, rays)
        return torch.cat(_transverse(out))

    c0 = 0.5 * float((residuals(params) ** 2).sum())
    p2, costs = trt.fit_lm(residuals, params, trainable=scene.trainable(),
                           steps=12)
    assert costs.shape == (12,)
    assert float(costs[-1]) < c0 * 0.02, f'{c0} -> {float(costs[-1])}'
    # costs are monotone non-increasing (rejected steps keep the params)
    cs = costs.numpy()
    assert np.all(np.diff(cs) <= 1e-6 * cs[:-1] + 1e-12)
    ratio = float(p2['lens']['c1']) / float(p2['lens']['c2'])
    assert -7.5 < ratio < -4.5, f'ratio {ratio}'
    # non-trainable leaves are exactly untouched
    for k in ('t', 'ior_glass', 'trans'):
        assert torch.equal(p2['lens'][k], params['lens'][k]), k


def test_entry_forward_matches_jax_and_train_step():
    """The port's entry traces the flagship scene like the JAX entry's
    forward on the same rays; train_step takes masked Adam steps through
    simulate_fused that lower the spot loss and move only c1 and c2."""
    forward, (params, rays) = entry('cpu')
    assert rays.n == 8192
    rms = forward(params, rays)
    scene_j = jrt.SequentialScene([
        jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        ior_media=1.0, name='lens'),
        jrt.CircularAperture(radius=5.0, name='stop'),
        jrt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                          name='sensor')])
    rays_j = jrt.Rays(*(jnp.asarray(getattr(rays, c).numpy())
                        for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz',
                                  'intensity', 'ray_id', 'wavelength')))
    _, sens_j, _ = scene_j.simulate(scene_j.init_params(), rays_j,
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(rms.numpy(), np.asarray(sens_j.spot_rms(0)),
                               rtol=1e-5)

    scene = flagship_scene()
    trainable = scene.trainable()
    start = {k: v.clone() for k, v in params['lens'].items()}
    opt = torch.optim.Adam(trt.trainable_leaves(params, trainable), lr=1e-4)
    mask = trt.grad_mask_fn(trainable)
    losses = [float(train_step(scene, params, opt, rays, mask))
              for _ in range(5)]
    assert losses[-1] < losses[0]
    for k, v in params['lens'].items():
        assert torch.equal(v, start[k]) == (k not in ('c1', 'c2')), k
