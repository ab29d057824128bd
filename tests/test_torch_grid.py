"""Irradiance grids of the PyTorch port against the JAX package.

- ``bin_grid_plain`` (core/sensor.py; the plain version of kernel K3)
  against JAX ``core/sensor.py::_bin_grid`` on numpy hits, some outside the
  grid: exact with unit weights (JAX's hi+lo bf16 split carries 1.0
  exactly); rtol 3e-5 with random weights, because that split rounds each
  weight to about 2^-16.
- The grid's gradient: ``ct[iy, ix]`` in the weights and none in x or y,
  as JAX's custom_vjp.
- ``SequentialScene.simulate`` and ``simulate_fused`` (the plain versions
  of K1 on the CPU) with two sensors and a 32 x 32 grid against JAX
  ``simulate`` / ``simulate_fused(block_rows=2)``, with the bounds of
  tests/test_pallas.py::test_fused_multi_sensor_and_grid_parity (moments
  rtol 1e-5 atol 1e-3, grid rtol 1e-5 atol 1e-4).
- ``trace_seq_bwd_plain`` (K2's plain version) with the grid's cotangent
  against JAX ``trace_sequential_pallas_v2_bwd(..., g_grid=W)`` in
  interpret mode, with the bounds of
  tests/test_pallas.py::test_fused_grid_bwd_kernel_parity (rtol 1e-4,
  atol 1e-5).

The CUDA kernels themselves are compared with these plain versions on the
card in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.sensor import _bin_grid
from raytracetorch_tpu.ops.pallas_trace import trace_sequential_pallas_v2_bwd
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.sensor import bin_grid_plain, bin_indices
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_trace, grid

torch.set_num_threads(2)

N = 5000


def _hits(seed, e):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(N) * 0.6 * e).astype(np.float32)
    y = (rng.standard_normal(N) * 0.6 * e).astype(np.float32)
    w = rng.random(N).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize('weights,e,hw', [('unit', 1.0, (64, 48)),
                                          ('random', 5.0, (32, 32))])
def test_bin_grid_plain_matches_jax(weights, e, hw):
    x, y, w = _hits(1, e)
    if weights == 'unit':
        w = np.ones_like(w)
    assert ((np.abs(x) > e) | (np.abs(y) > e)).sum() > 10   # some clip
    g_j = np.asarray(_bin_grid(hw, e, 1024, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(w)))
    g_t = bin_grid_plain(hw, e, torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(w)).numpy()
    assert g_t.shape == hw
    if weights == 'unit':
        np.testing.assert_array_equal(g_t, g_j)
        assert g_t.sum() == N
    else:
        np.testing.assert_allclose(g_t, g_j, rtol=3e-5, atol=0)


def test_bin_indices_truncate_then_clip():
    """As JAX's ``.astype(int32)``: toward zero (so (-1, 0) lands in bin
    0), then clipped; far-out hits and NaN stay in range."""
    x = torch.tensor([-1.5, -1.0, -0.999, 0.0, 0.999, 1.0, 1e30, -1e30,
                      float('nan')])
    ix, iy = bin_indices((4, 8), 1.0, x, x)
    assert ix.tolist() == [0, 0, 0, 4, 7, 7, 7, 0, 0]
    assert iy.tolist() == [0, 0, 0, 2, 3, 3, 3, 0, 0]
    jx = np.clip(((np.float32([-1.5, -1.0, -0.999, 0.0, 0.999, 1.0]) + 1.0)
                  / 2.0 * 8).astype(np.int32), 0, 7)
    assert ix[:6].tolist() == jx.tolist()


def test_grid_gradient_is_the_gather():
    """d sum(grid * ct) / d w = ct[iy, ix] (equal to jax.grad through the
    custom_vjp), and no gradient in x or y."""
    hw, e = (16, 16), 2.0
    x, y, w = _hits(2, e)
    ct = np.random.default_rng(3).standard_normal(hw).astype(np.float32)
    xt, yt, wt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (x, y, w))
    (bin_grid_plain(hw, e, xt, yt, wt) * torch.from_numpy(ct)).sum() \
        .backward()
    ix, iy = bin_indices(hw, e, xt.detach(), yt.detach())
    np.testing.assert_array_equal(wt.grad.numpy(), ct[iy.numpy(), ix.numpy()])
    assert xt.grad is None and yt.grad is None
    gx, gy, gw = jax.grad(
        lambda a, b, c: jnp.sum(_bin_grid(hw, e, 1024, a, b, c) * ct),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(gw))
    assert not np.asarray(gx).any() and not np.asarray(gy).any()


def test_bin_grid_slots_plain_masks_other_slots():
    """The multi-slot plain version: a hit lands only in its own slot; an
    int slot puts every hit in that slot."""
    x, y, w = (torch.from_numpy(a) for a in _hits(4, 1.0))
    slot = torch.from_numpy(np.arange(N, dtype=np.int32) % 3)
    cfg = trt.SensorConfig(n_sensors=3, grid_shape=(8, 8))
    g = grid.bin_grid(x, y, w, slot, cfg)
    assert g.shape == (3, 8, 8)
    for s in range(3):
        torch.testing.assert_close(
            g[s], bin_grid_plain((8, 8), 1.0, x[slot == s], y[slot == s],
                                 w[slot == s]), rtol=1e-6, atol=1e-6)
    g1 = grid.bin_grid(x, y, w, 1, cfg)
    assert float(g1[0].abs().sum()) == 0 and float(g1[2].abs().sum()) == 0
    torch.testing.assert_close(g1[1], bin_grid_plain((8, 8), 1.0, x, y, w))


def _two_sensor(rt):
    scene = rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 10.0], name='s0'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 19.322],
                         name='s1'),
    ])
    scene.grid_shape, scene.grid_half_extent = (32, 32), 5.0
    return scene


def _jax_rays(n, seed):
    return jrt.CollimatedDisk.make(radius=jnp.float32(4.0),
                                   translation=[0, 0, -10.0]).sample(
        jax.random.PRNGKey(seed), n)


@pytest.mark.parametrize('path', ['simulate', 'simulate_fused'])
def test_sequential_grid_matches_jax(path):
    js, ts = _two_sensor(jrt), _two_sensor(trt)
    rays = _jax_rays(2000, 5)
    key = jax.random.PRNGKey(0)
    if path == 'simulate':
        _, s_j, _ = js.simulate(js.init_params(), rays, key)
    else:
        _, s_j, _ = js.simulate_fused(js.init_params(), rays, key,
                                      block_rows=2)
    rays_t = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')
    _, s_t, _ = getattr(ts, path)(ts.init_params('cpu'), rays_t)
    assert s_t.grid.shape == (2, 32, 32)
    np.testing.assert_allclose(s_t.moments.numpy(), np.asarray(s_j.moments),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s_t.grid.numpy(), np.asarray(s_j.grid),
                               rtol=1e-5, atol=1e-4)
    # each sensor saw the whole bundle once
    assert abs(float(s_t.grid[0].sum()) - 2000.0) < 1e-3
    assert abs(float(s_t.grid[1].sum()) - 2000.0) < 1e-3


def test_fused_trace_grid_gradient():
    """A loss on the grid through simulate_fused (FusedTrace, plain versions
    on the CPU) gives the eager path's gradients: the incoming intensities
    get W[slot, iy, ix]."""
    ts = _two_sensor(trt)
    rays = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, _jax_rays(600, 6)), 'cpu')
    W = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 32, 32)).astype(np.float32))
    grads = []
    for sim in (ts.simulate_fused, ts.simulate):
        p = ts.init_params('cpu')
        p['lens']['c1'].requires_grad_(True)
        r = rays.replace(intensity=rays.intensity.clone().requires_grad_(True))
        _, s, _ = sim(p, r)
        ((s.grid * W).sum() + s.spot_rms(1)[0]).backward()
        grads.append((p['lens']['c1'].grad, r.intensity.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(grads[0][1], grads[1][1], rtol=1e-5,
                               atol=1e-7)
    assert float(grads[0][1].abs().max()) > 0.1


def test_seq_bwd_plain_grid_matches_jax_kernel():
    """K2's plain version with a grid cotangent W against the JAX fused
    backward kernel (interpret mode) fed the same W."""
    def scene_of(rt):
        scene = rt.SequentialScene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           name='lens'),
            rt.SensorElement(radius=20.0, translation=[0, 0, 19.322],
                             name='sensor'),
        ])
        scene.grid_shape, scene.grid_half_extent = (16, 16), 5.0
        return scene

    js, ts = scene_of(jrt), scene_of(trt)
    n = 256
    rays = _jax_rays(n, 7)
    W = np.random.default_rng(9).standard_normal((1, 16, 16)).astype(
        np.float32)
    comps = fused_trace.COMPS
    zero_rays = rays.replace(**{c: jnp.zeros_like(getattr(rays, c))
                                for c in comps})
    g_mom = np.zeros((1, 1, 7), np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), zero_rays, g_mom,
        interpret=True, block_rows=2, g_grid=jnp.asarray(W))
    table = ts.build_table(ts.init_params('cpu'))
    rays_t = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        trt.flatten_table_rows(table), rays_t, ts.sensor_config(),
        ts.static_meta(), (None,) * 7, torch.from_numpy(g_mom),
        g_grid=torch.from_numpy(W))
    for c, g in zip(comps, g_in):
        np.testing.assert_allclose(g.numpy(), np.asarray(ct[c]), rtol=1e-4,
                                   atol=1e-5, err_msg=c)
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue                  # bool fields carry float0 cotangents
        off = ROW_OFFSETS[name]
        width = ref.reshape(k, -1).shape[1]
        np.testing.assert_allclose(g_flat[:, off:off + width].numpy(),
                                   ref.reshape(k, -1), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # the grid cotangent reached the intensities
    assert float(g_in[6].abs().sum()) > 1.0
