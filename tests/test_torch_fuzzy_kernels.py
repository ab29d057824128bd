"""K1's and K2's plain versions with fuzzy apodization against the JAX
package's fused kernels in interpret mode, on the CPU, once: the Gaussian
apodizer of tests/test_torch_fuzzy.py (its component-style callable traced
into the TPU kernel there, interpreted by the port's program here).
Tolerances as tests/test_torch_diffractive_grad.py's: per ray rtol 2e-4 /
atol 1e-5 and the table rtol 1e-4 / atol 1e-5 of the stream's or field's
scale where that exceeds 1 (float32 adjoints summed in another order).
"""

import numpy as np
import torch

import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_trace
from test_torch_fuzzy import KEY, _close, _np, _pair

torch.set_num_threads(2)


def test_plain_k1_k2_match_jax_kernels():
    """K1's and K2's plain versions on the Gaussian apodizer against
    ``trace_sequential_pallas_v2`` and its backward in interpret mode (the
    component-style callable traced into the TPU kernel), at 256 rays: the
    rays, the moments, and the ray and table cotangents under
    numpy-seeded cotangents."""
    js, ts, rays_j, rays_t, _ = _pair('gauss', n=256)
    table_j = js.build_table(js.init_params())
    flat = trt.flatten_table_rows(interop.table_from_numpy(_np(table_j),
                                                           'cpu'))
    meta = fused_trace.TraceMeta(
        interop.meta_from_slots(js.static_meta()), ts.fuzzy_fns())
    cfg = ts.sensor_config()
    cfg_j = js.sensor_config()
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays_j, KEY, cfg_j, js.static_meta(), interpret=True,
        block_rows=1, fuzzy_fns=js.fuzzy_fns())
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps)
    for c in fused_trace.COMPS:
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-5,
               atol=2e-5 * 20.0 if c[0] == 'p' else 2e-6, err_msg=c)
    _close(sens_t.moments, sens_j.moments, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(7)
    n = rays_t.n
    g_rays = [rng.standard_normal(n).astype(np.float32)
              for _ in fused_trace.COMPS]
    g_mom = rng.standard_normal((1, 1, 7)).astype(np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays_j, KEY, cfg_j, js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays_j.ray_id),
                wavelength=np.zeros(n, np.float32)),
        g_mom, interpret=True, block_rows=1, fuzzy_fns=js.fuzzy_fns())
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps)[:2]
    for c, g in zip(fused_trace.COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g, ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
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
    # the apodizer's row: its frame's cotangent comes through the program
    assert float(g_flat[min(meta.fuzzy)].abs().max()) > 0
