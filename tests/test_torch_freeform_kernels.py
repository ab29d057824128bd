"""K1's, K2's, K5's and K6's plain versions with freeform surfaces against
the JAX package on the CPU: K1/K2's against the JAX fused kernels in
interpret mode on example 19's freeform corrector (its freeform rows
traced into the TPU kernel there, the 8 Newton steps differentiated by
``jax.vjp``), K5/K6's against the JAX bounce loop and ``jax.grad`` through
it on the same scene as a ``Scene``.  The fuzzy programs' lowered
operations: tests/test_torch_fuzzy_ops.py.

Tolerances as tests/test_torch_fuzzy_kernels.py's: per ray rtol 2e-4 /
atol 1e-5 and the table rtol 1e-4 / atol 1e-5 of the stream's or field's
scale where that exceeds 1 (float32 adjoints summed in another order);
positions atol 1e-7 of the scene's depth (tests/test_torch_freeform.py).
"""

import jax
import numpy as np
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from test_torch_freeform import (EX19_TERMS, KEY, _close, _disk, _np,
                                 _pair)

torch.set_num_threads(2)


def _check_table(g_flat, ct_table):
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        ref = ref.reshape(k, -1)
        off = ROW_OFFSETS[name]
        got = g_flat[:, off:off + ref.shape[1]].numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        _close(got, ref, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


def _kernels_vs_plain(js, ts, rays_j, rays_t, depth, fuzzy_j=None,
                      fuzzy_t=None):
    """K1 and K2 of the JAX package in interpret mode against the port's
    plain versions: the rays, the moments and the ray and table cotangents
    under numpy-seeded cotangents.  Returns the port's table cotangent."""
    table_j = js.build_table(js.init_params())
    flat = trt.flatten_table_rows(interop.table_from_numpy(_np(table_j),
                                                           'cpu'))
    meta = fused_trace.TraceMeta(interop.meta_from_slots(js.static_meta()),
                                 fuzzy_t)
    cfg, cfg_j = ts.sensor_config(), js.sensor_config()
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays_j, KEY, cfg_j, js.static_meta(), interpret=True,
        block_rows=1, fuzzy_fns=fuzzy_j)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps)
    for c in fused_trace.COMPS:
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-5,
               atol=1e-7 * depth if c[0] == 'p' else 2e-6, err_msg=c)
    _close(sens_t.moments, sens_j.moments, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(7)
    n = rays_t.n
    g_rays = [rng.standard_normal(n).astype(np.float32)
              for _ in fused_trace.COMPS]
    g_mom = rng.standard_normal(tuple(sens_t.moments.shape)).astype(
        np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays_j, KEY, cfg_j, js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays_j.ray_id),
                wavelength=np.zeros(n, np.float32)),
        g_mom, interpret=True, block_rows=1, fuzzy_fns=fuzzy_j)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps)[:2]
    for c, g in zip(fused_trace.COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g, ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
    _check_table(g_flat, ct_table)
    return g_flat


def test_plain_k1_k2_match_jax_kernels():
    """K1's and K2's plain versions on example 19's freeform corrector
    against ``trace_sequential_pallas_v2`` and its backward in interpret
    mode, at 128 rays (one block of the TPU kernel); the freeform row's ff
    columns carry the coefficients' cotangents."""
    js, ts, rays_j, rays_t, _ = _pair('ex19', n=128)
    g_flat = _kernels_vs_plain(js, ts, rays_j, rays_t, 50.0)
    ff = ROW_OFFSETS['ff']
    assert float(g_flat[0, ff:ff + 5].abs().min()) > 0


def window(rt, base=False):
    """Example 19's freeform window (its coefficients trainable) before a
    sensor at z = 40: an ordered system, so its bounce loop traces the
    chain (tests/test_nonsequential.py)."""
    els = [rt.FreeformLens(c1=0.0, c2=0.0, d=24.0, t=2.0, ior_glass=1.5168,
                           translation=[0, 0, 20.0], xy1=EX19_TERMS,
                           xy1_grad=True, name='corrector'),
           rt.SensorElement(radius=12.0, translation=[0, 0, 40.0],
                            name='sensor')]
    return rt.Scene(els, n_bounces=3) if base else rt.SequentialScene(els)


def test_plain_k5_k6_match_jax_bounce_loop():
    """K5's plain version on example 19's freeform window as a 3-bounce
    ``Scene`` against the JAX bounce loop, and K6's (FusedNonseq's
    backward) spot-variance gradient in the freeform coefficients against
    ``jax.grad`` of the JAX package's sequential trace of the same ordered
    scene (``jax.grad`` through the JAX bounce loop with freeform rows
    compiles for minutes on the CPU)."""
    js, ts = window(jrt, base=True), window(trt, base=True)
    rays_j, rays_t = _disk(128, 8.0, -10.0)
    table_j = js.build_table(js.init_params())
    flat = trt.flatten_table_rows(interop.table_from_numpy(_np(table_j),
                                                           'cpu'))
    meta = interop.meta_from_slots(js.static_meta())
    cfg = ts.sensor_config()
    out_j, sens_j, _ = js.simulate(js.init_params(), rays_j, KEY)
    out_t, sens_t = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays_t, cfg, meta, js.n_bounces)
    for c in fused_trace.COMPS:
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-5,
               atol=1e-7 * 40.0 if c[0] == 'p' else 2e-6, err_msg=c)
    _close(sens_t.moments, sens_j.moments, rtol=1e-4, atol=1e-3)
    assert float(sens_t.moments[0, 0, 0]) > 100
    seq_j = window(jrt)

    def var_j(p):
        m = seq_j.simulate(p, rays_j, KEY)[1].moments[0, 0]
        return (m[3] / m[0] - (m[1] / m[0]) ** 2
                + m[4] / m[0] - (m[2] / m[0]) ** 2)
    g = jax.grad(var_j)(seq_j.init_params())['corrector']['xy1']
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    pt['corrector']['xy1'].requires_grad_(True)
    m = ts.simulate_fused(pt, rays_t)[1].moments[0, 0]
    (m[3] / m[0] - (m[1] / m[0]) ** 2
     + m[4] / m[0] - (m[2] / m[0]) ** 2).backward()
    got = pt['corrector']['xy1'].grad.numpy()
    assert np.abs(np.asarray(g)).min() > 0
    _close(got, np.asarray(g), rtol=1e-4, atol=1e-4 * np.abs(g).max())
