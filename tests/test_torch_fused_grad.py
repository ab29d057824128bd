"""Gradients through the port's fused trace (ops/fused_trace.py).

On the CPU ``FusedTrace`` runs the plain versions of both kernels, so these
tests hold the plain backward (the function kernel K2 computes on the card)
to the JAX package:

- the plain backward against the JAX package's fused backward kernel
  ``trace_sequential_pallas_v2_bwd`` in interpret mode, on the same table,
  rays and numpy-seeded cotangents, with tests/test_pallas.py's bounds
  (per-ray rtol 2e-4 / atol 1e-5, table rtol 1e-4 / atol 1e-5), the table's
  atol taken relative to the field's scale where that exceeds 1: a table
  entry is a sum over all rays, and one that vanishes in exact arithmetic
  (an off-axis Rw entry of an on-axis sensor) carries f32 summation noise
  in proportion to the sum's terms (+-1e-3 at a scale of 7e3 here);
- parameter gradients of a spot loss through ``simulate_fused`` against
  ``jax.grad`` through the JAX ``simulate`` (rtol 1e-4 / atol 1e-6, the
  bound of tests/test_pallas.py::test_fused_gradients_match_xla);
- the zero table-cotangent columns that entitle K2 to reduce only 19 of
  the 160 columns;
- gradients with respect to the rays.

K2 itself is compared with the plain backward on the card in
tests/test_torch_cuda.py."""

import jax
import numpy as np
import pytest
import torch

import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import trace_sequential_pallas_v2_bwd
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_trace
from test_torch_fused_trace import _bench, _port_inputs, _rays, _two_bundle

torch.set_num_threads(2)

N = 1000              # not a multiple of 256 (the kernel's block)
COMPS = fused_trace.COMPS
CASES = {'bench': (_bench, 1), 'two_bundle': (_two_bundle, 2)}


def _cotangents(n, cfg, seed):
    rng = np.random.default_rng(seed)
    g_rays = [rng.standard_normal(n).astype(np.float32) for _ in COMPS]
    g_mom = rng.standard_normal(
        (max(cfg.n_sensors, 1), cfg.n_bundles, 7)).astype(np.float32)
    return g_rays, g_mom


def _case(name, n=N):
    make, nb = CASES[name]
    scene = make()
    rays = _rays(n, nb, seed=10 + nb)
    table, rays_t, cfg, meta = _port_inputs(scene, rays, nb)
    return scene, rays, table, rays_t, cfg, meta


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_matches_jax_kernel(case):
    scene, rays, table, rays_t, cfg, meta = _case(case)
    g_rays, g_mom = _cotangents(N, cfg, seed=len(case))
    zero = np.zeros(N, np.float32)
    g_rays_j = JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id),
                       wavelength=zero)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        scene.build_table(scene.init_params()), rays,
        jax.random.PRNGKey(0), scene.sensor_config(n_bundles=cfg.n_bundles),
        scene.static_meta(), g_rays_j, g_mom, interpret=True, block_rows=2)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        trt.flatten_table_rows(table), rays_t, cfg, meta,
        [torch.from_numpy(g) for g in g_rays], torch.from_numpy(g_mom))
    for c, g in zip(COMPS, g_in):
        np.testing.assert_allclose(g.numpy(), np.asarray(ct[c]), rtol=2e-4,
                                   atol=1e-5, err_msg=c)
    k = g_flat.shape[0]
    for name, shape in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue                  # bool fields carry float0 cotangents
        off = ROW_OFFSETS[name]
        width = ref.reshape(k, -1).shape[1]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g_flat[:, off:off + width].numpy(),
                                   ref.reshape(k, -1), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    # the cotangents are not trivial
    assert float(g_flat.abs().max()) > 1.0
    assert all(float(g.abs().max()) > 0 for g in g_in)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_backward_zero_outside_grad_cols(case):
    """The table cotangent of the main-path kinds is zero outside q[0:5],
    Rw[0:9], tw[0:3] and ph[0:2]: the columns K2 reduces."""
    _, _, table, rays_t, cfg, meta = _case(case)
    g_rays, g_mom = _cotangents(N, cfg, seed=7)
    g_flat, _ = fused_trace.trace_seq_bwd_plain(
        trt.flatten_table_rows(table), rays_t, cfg, meta,
        [torch.from_numpy(g) for g in g_rays], torch.from_numpy(g_mom))
    outside = [c for c in range(g_flat.shape[1])
               if c not in fused_trace.GRAD_COLS]
    assert float(g_flat[:, outside].abs().max()) == 0.0
    assert float(g_flat[:, list(fused_trace.GRAD_COLS)].abs().max()) > 1.0
    assert len(fused_trace.GRAD_COLS) == 19


def _spot(sim):
    def f(p, rays):
        _, s, _ = sim(p, rays)
        return s.spot_rms(0)[0]
    return f


def test_simulate_fused_param_grads_match_jax():
    """d spot_rms / d params through the port's simulate_fused (FusedTrace
    on the CPU) equals jax.grad through the JAX simulate, and the port's
    eager simulate, leaf by leaf."""
    js, ts = _bench(), trt.SequentialScene(
        [trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                         name='lens'),
         trt.CircularAperture(radius=5.0, name='stop'),
         trt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                           name='sensor')])
    rays = _rays(1500, 1, seed=5)
    key = jax.random.PRNGKey(0)
    g_jax = jax.grad(lambda p: js.simulate(p, rays, key)[1].spot_rms(0)[0])(
        js.init_params())
    rays_t = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')
    grads = {}
    for name, sim in (('fused', ts.simulate_fused), ('eager', ts.simulate)):
        p = ts.init_params('cpu')
        trt.trainable_leaves(p)
        fused_trace.BWD_LAUNCHES = 0
        _spot(sim)(p, rays_t).backward()
        assert fused_trace.BWD_LAUNCHES == 0   # CPU: the plain backward
        # a leaf the loss does not reach (a bound radius, read only by
        # comparisons) keeps no grad; jax.grad gives it zeros
        grads[name] = {el: {k: torch.zeros_like(v) if v.grad is None
                            else v.grad for k, v in d.items()}
                       for el, d in p.items()}
    for el, d in g_jax.items():
        for k, g in d.items():
            for name in ('fused', 'eager'):
                np.testing.assert_allclose(
                    grads[name][el][k].numpy(), np.asarray(g),
                    rtol=1e-4, atol=1e-6, err_msg=f'{name} {el}.{k}')
    assert float(grads['fused']['lens']['c1']) != 0.0


def test_fused_trace_ray_gradients():
    """Rays that require grad get gradients through the fused trace: a loss
    on output pz and px plus the spot RMS, with rays.px and rays.dx
    requiring grad, equals the eager trace's on the same rays; the untouched
    wavelength passes through."""
    scene = trt.SequentialScene(
        [trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                         name='lens'),
         trt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                           name='sensor')])
    gen = torch.Generator('cpu').manual_seed(2)
    base = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0],
                                   rotation=[0.02, 0.0, 0.0]).sample(
        gen, 2000, 'cpu')
    grads = []
    for sim in (scene.simulate_fused, scene.simulate):
        rays = base.replace(px=base.px.clone().requires_grad_(True),
                            dx=base.dx.clone().requires_grad_(True),
                            wavelength=base.wavelength.clone()
                            .requires_grad_(True))
        out, sens, _ = sim(scene.init_params('cpu'), rays)
        loss = (out.pz.mean() + out.px.square().mean()
                + trt.spot_size_loss(sens) + out.wavelength.sum())
        loss.backward()
        grads.append((rays.px.grad, rays.dx.grad, rays.wavelength.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    assert float(grads[0][0].abs().max()) > 0
    assert float(grads[0][1].abs().max()) > 0
    torch.testing.assert_close(grads[0][2], torch.ones(2000))


def test_fused_trace_is_first_order_only():
    """Like the JAX custom_vjp, FusedTrace has no higher-order rule."""
    _, _, table, rays_t, cfg, meta = _case('bench', n=300)
    flat = trt.flatten_table_rows(table).requires_grad_(True)
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32)
    *_, moments = fused_trace.FusedTrace.apply(
        flat, kinds, cfg, tuple(meta),
        *(getattr(rays_t, c) for c in COMPS), rays_t.ray_id)
    # the loss is not linear in the moments, so its cotangent requires grad
    (g,) = torch.autograd.grad(moments[0, 0, 1:6].square().sum(), flat,
                               create_graph=True)
    with pytest.raises(RuntimeError, match='once_differentiable'):
        g.sum().backward()


def test_fused_forward_only_skips_the_function():
    """Without grad the dispatcher runs the forward alone: no graph."""
    _, _, table, rays_t, cfg, meta = _case('two_bundle', n=300)
    out, sens = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert out.px.grad_fn is None and sens.moments.grad_fn is None
    table.q.requires_grad_(True)
    out, sens = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert type(sens.moments.grad_fn).__name__ == 'FusedTraceBackward'
    with torch.no_grad():
        out, sens = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert sens.moments.grad_fn is None
