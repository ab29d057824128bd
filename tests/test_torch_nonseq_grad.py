"""Gradients through the port's fused non-sequential trace
(ops/fused_nonseq.py).

On the CPU ``FusedNonseq`` runs the plain versions of both kernels, so these
tests hold the plain backward (the function kernel K6 computes on the card)
to the JAX package, on JAX-sampled rays carried across by ``interop``:

- the plain backward against the JAX fused backward kernel
  ``trace_nonseq_pallas_bwd`` in interpret mode, in both its modes
  (``scan`` and ``unrolled``), on the mirror fold with its curvature
  trainable, a 16 x 16 grid over [-4, 4]^2, 4 bounces and numpy-seeded
  cotangents of the rays, the moments and the grid
  (tests/test_pallas.py::test_nonseq_bwd_scan_matches_unrolled), to rtol
  2e-4 / atol 1e-5 (tests/test_pallas.py::test_fused_gradients_match_xla);
- gradients through ``FusedNonseq`` on the two-mirror cavity at a 25-bounce
  budget, where rays live longer than K6's 8 checkpoints, against
  ``jax.grad`` through the JAX XLA bounce loop, same tolerance
  (tests/test_pallas.py::test_nonseq_bwd_scan_large_budget);
- ``Scene.simulate_fused`` under grad against the eager ``Scene.simulate``
  on the naive scene with a 32 x 32 grid, to 1e-6 relative (both run the
  same eager arithmetic on the CPU);
- the non-sequential design loop: ``fit_lbfgs`` through
  ``Scene.simulate_fused`` lands in the best-form ranges of
  tests/test_optimize_singlet.py.

K6 itself is compared with the plain backward on the card in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.trace import \
    trace_nonsequential as jax_trace_nonsequential
from raytracetorch_tpu.ops.pallas_trace import trace_nonseq_pallas_bwd
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from test_torch_nonseq import _jax_rays, _naive, _to_port
from test_torch_optim import (_assert_best_form, _design_scene, _rays,
                              _spot_loss)

torch.set_num_threads(2)

COMPS = fused_trace.COMPS
RTOL, ATOL = 2e-4, 1e-5


def _fold(rt):
    scene = rt.Scene([
        rt.SphericalMirror(c1=-0.025, d=0.0, translation=[0.0, 0.0, 40.0],
                           c1_grad=True, name='mirror'),
        rt.SensorElement(radius=10.0, translation=[0.0, 0.0, 0.5],
                         name='sensor'),
    ], n_bounces=4)
    scene.grid_shape, scene.grid_half_extent = (16, 16), 4.0
    return scene


def _cavity(rt):
    """Two facing mirrors and an off-axis sensor between them
    (tests/test_pallas.py::test_nonseq_bwd_scan_large_budget)."""
    return rt.Scene([
        rt.SphericalMirror(c1=-0.02, d=0.0, translation=[0.0, 0.0, 40.0],
                           c1_grad=True, name='m1'),
        rt.SphericalMirror(c1=0.02, d=0.0, translation=[0.0, 0.0, 0.0],
                           rotation=[0.0, np.pi, 0.0], name='m2'),
        rt.SensorElement(radius=3.0, translation=[6.0, 0.0, 20.0],
                         name='sensor'),
    ], n_bounces=25)


def _assert_table_matches(g_flat, ct_table):
    """The port's flat [K, 160] table cotangent against a JAX SurfaceTable
    cotangent, field by field (bool fields carry float0 and are skipped).
    As in tests/test_torch_fused_grad.py the atol is taken relative to the
    field's scale where that exceeds 1: a table entry is a sum over all rays
    and bounces, and one that nearly cancels carries f32 summation noise in
    proportion to its terms (2e-3 at a scale of 2e4 on the mirror fold)."""
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        off = ROW_OFFSETS[name]
        width = ref.reshape(k, -1).shape[1]
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(g_flat[:, off:off + width].numpy(),
                                   ref.reshape(k, -1), rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)


@pytest.mark.parametrize('mode', ['scan', 'unrolled'])
def test_plain_backward_matches_jax_kernel(mode):
    js = _fold(jrt)
    n = 256
    rays = _jax_rays('fold', n, seed=11)
    table, rays_t, cfg, meta = _to_port(js, rays)
    rng = np.random.default_rng(12)
    g_rays = [rng.standard_normal(n).astype(np.float32) for _ in COMPS]
    g_mom = rng.standard_normal((1, 1, 7)).astype(np.float32)
    g_grid = rng.standard_normal((1, 16, 16)).astype(np.float32)
    g_rays_j = JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id),
                       wavelength=np.zeros(n, np.float32))
    ct_table, ct = trace_nonseq_pallas_bwd(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), js.n_bounces, g_rays_j, g_mom,
        interpret=True, block_rows=2, g_grid=g_grid, mode=mode)
    before = fused_nonseq.NONSEQ_BWD_LAUNCHES
    g_flat, g_in = fused_nonseq.trace_nonseq_bwd_plain(
        trt.flatten_table_rows(table), rays_t, cfg, meta, js.n_bounces,
        [torch.from_numpy(g) for g in g_rays], torch.from_numpy(g_mom),
        g_grid=torch.from_numpy(g_grid))
    assert fused_nonseq.NONSEQ_BWD_LAUNCHES == before
    for c, g in zip(COMPS, g_in):
        np.testing.assert_allclose(g.numpy(), np.asarray(ct[c]), rtol=RTOL,
                                   atol=ATOL, err_msg=c)
    _assert_table_matches(g_flat, ct_table)
    # the mirror's curvature gets a cotangent, and only K2's 19 columns do
    assert float(g_flat[0, ROW_OFFSETS['q']:ROW_OFFSETS['q'] + 5].abs()
                 .max()) > 0
    outside = [c for c in range(g_flat.shape[1])
               if c not in fused_trace.GRAD_COLS]
    assert float(g_flat[:, outside].abs().max()) == 0.0
    assert all(float(g.abs().max()) > 0 for g in g_in)


def test_cavity_gradients_match_jax_grad():
    """25 bounces between two mirrors: the loss total_weight + spot_rms
    through ``FusedNonseq`` on the CPU equals jax.grad through the JAX XLA
    bounce loop, for the table and the 7 ray streams.

    The cavity is rounding-chaotic: after a reflection near a mirror's
    vertex the quadratic formula's cancellation leaves the self-intersection
    root at ~6e-6, about the world-scale epsilon, so another rounding of the
    same ray can re-hit the mirror (1,573 of 4,096 rays end elsewhere in JAX
    and in the port after 25 bounces, 1,351 between the port in float64 and
    float32).  The gradients are compared on 256 rays whose 25-bounce paths
    both packages trace alike."""
    js = _cavity(jrt)
    rays = jrt.CollimatedDisk.make(radius=jnp.float32(2.0),
                                   translation=[0, 0, 1.0]).sample(
        jax.random.PRNGKey(13), 1024)
    key = jax.random.PRNGKey(0)
    cfg_j, meta_j = js.sensor_config(), js.static_meta()
    table_j = js.build_table(js.init_params())
    out_j, _, _ = jax_trace_nonsequential(table_j, rays, key, 25, cfg_j,
                                          static_meta=meta_j)
    table, rays_t, cfg, meta = _to_port(js, rays)
    out_t, _ = fused_nonseq.trace_nonseq_fused_plain(
        trt.flatten_table_rows(table), rays_t, cfg, meta, 25)
    same = ((np.abs(out_t.pos.numpy() - np.asarray(out_j.pos)).max(1) < 1e-3)
            & (np.abs(out_t.dir.numpy() - np.asarray(out_j.dir)).max(1)
               < 1e-4))
    keep = np.flatnonzero(same)[:256]
    assert keep.size == 256
    rays = jax.tree_util.tree_map(lambda a: a[keep], rays)

    def xla_loss(table, *ray_comps):
        r = rays.replace(**dict(zip(COMPS, ray_comps)))
        _, sens, _ = jax_trace_nonsequential(table, r, key, 25, cfg_j,
                                             static_meta=meta_j)
        return sens.total_weight(0)[0] + sens.spot_rms(0)[0]

    grads = jax.grad(xla_loss, argnums=tuple(range(8)), allow_int=True)(
        table_j, *(getattr(rays, c) for c in COMPS))
    table, rays_t, cfg, meta = _to_port(js, rays)
    flat = trt.flatten_table_rows(table).requires_grad_(True)
    comps = [getattr(rays_t, c).requires_grad_(True) for c in COMPS]
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32)
    outs = fused_nonseq.FusedNonseq.apply(flat, kinds, cfg, tuple(meta), 25,
                                          *comps, rays_t.ray_id)
    assert type(outs[7].grad_fn).__name__ == 'FusedNonseqBackward'
    sens = trt.SensorState(moments=outs[7], grid=None)
    (sens.total_weight(0)[0] + sens.spot_rms(0)[0]).backward()
    _assert_table_matches(flat.grad, grads[0])
    for c, x, g in zip(COMPS, comps, grads[1:]):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg=c)
    assert float(flat.grad[0, ROW_OFFSETS['q']:ROW_OFFSETS['q'] + 5].abs()
                 .max()) > 0


def test_simulate_fused_grads_match_eager():
    """Scene.simulate_fused under grad (FusedNonseq, plain versions on the
    CPU) equals the eager Scene.simulate: d/d(c1, c2) and d/d(rays) of a
    loss on the spot, the grid and the output rays."""
    scene = _naive(trt)
    scene.grid_shape, scene.grid_half_extent = (32, 32), 1.0
    base = interop.rays_from_numpy(jax.tree_util.tree_map(
        np.asarray, _jax_rays('naive', 2048, seed=14)), 'cpu')
    w = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (1, 32, 32)).astype(np.float32))
    grads = []
    for sim in (scene.simulate_fused, scene.simulate):
        p = scene.init_params('cpu')
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        rays = base.replace(**{c: getattr(base, c).clone().requires_grad_(
            True) for c in COMPS})
        out, sens, _ = sim(p, rays)
        loss = (sens.spot_rms(0)[0] + (sens.grid * w).sum()
                + out.px.square().mean() + out.dz.mean())
        loss.backward()
        grads.append([p['lens']['c1'].grad, p['lens']['c2'].grad]
                     + [getattr(rays, c).grad for c in COMPS])
    for name, a, b in zip(('c1', 'c2') + COMPS, *grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(
            b.abs().max()), msg=name)
    assert all(float(g.abs().max()) > 0 for g in grads[0][:2])
    assert float(grads[0][2 + COMPS.index('intensity')].abs().max()) > 0


def test_nonseq_design_loop_lands_in_best_form():
    """L-BFGS through Scene.simulate_fused on the reference's singlet
    traced as a non-sequential Scene, on the rays of the sequential twin in
    tests/test_torch_optim.py."""
    seq = _design_scene()
    scene = seq.to_base()
    scene.n_bounces = 8
    params = scene.init_params('cpu')
    loss = _spot_loss(scene.simulate_fused, _rays(3000, 0))
    l0 = float(loss(params))
    before = fused_nonseq.NONSEQ_BWD_LAUNCHES
    p2, losses = trt.fit_lbfgs(loss, params, trainable=scene.trainable(),
                               steps=25)
    assert fused_nonseq.NONSEQ_BWD_LAUNCHES == before   # CPU: no kernel
    _assert_best_form(seq, params, p2, l0, float(losses[-1]))
