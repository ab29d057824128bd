"""Chromatic dispersion in the PyTorch port against the JAX package's
kernels, on the CPU: the plain versions of K1 and K2 (the functions the
card's kernels compute) against the JAX package's fused forward and
backward kernels in interpret mode on the achromat, the 12-bounce Scene's
gradients (K6's function) against ``jax.grad`` of the JAX bounce loop,
K6's plain version's wavelength cotangent, and the first TPU kernel's
divergence on a dispersive row (ROADMAP Queue 3).  Scenes, rays and
tolerances as tests/test_torch_dispersion.py; the JAX kernels in interpret
mode to tests/test_torch_fused_grad.py's bounds (per ray rtol 2e-4 / atol
1e-5, the table rtol 1e-4 / atol 1e-5), each atol taken relative to the
stream's or field's scale where that exceeds 1 (the achromat's direction
cotangents reach ~100: its sensor is 100 mm away), each dispersion column
to its own scale."""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas,
                                               trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from test_torch_dispersion import (_assert_trace_close,
                                   _assert_wavelength_grads_close, _close,
                                   _grads_torch, _loss_jax, _loss_torch,
                                   _port, _rays, _scenes)

torch.set_num_threads(2)


@pytest.mark.parametrize('case', ['achromat_abbe'])
def test_plain_versions_match_jax_kernels(case):
    """K1's and K2's plain versions against the JAX package's
    ``trace_sequential_pallas_v2`` and its backward in interpret mode, on
    the same table, rays and numpy-seeded cotangents: rays, moments, the
    ray and wavelength cotangents and every table column (the 12 disp
    columns included, each to its own scale)."""
    js, _, _, nb = _scenes(case)
    rays, _ = _rays(case, 256, 6)
    _, table, meta, rays_t = _port(js, rays)
    cfg = trt.SensorConfig(n_sensors=js.n_sensors, n_bundles=nb)
    cfg_j = js.sensor_config(n_bundles=nb)
    flat = trt.flatten_table_rows(table)
    table_j = js.build_table(js.init_params())
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays, jax.random.PRNGKey(0), cfg_j, js.static_meta(),
        interpret=True, block_rows=2)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, fused_trace.plate_maps(meta, None))
    _assert_trace_close(out_t, sens_t, out_j, sens_j)
    rng = np.random.default_rng(7)
    n = rays_t.n
    g_rays = [rng.standard_normal(n).astype(np.float32)
              for _ in fused_trace.COMPS]
    g_mom = rng.standard_normal((1, nb, 7)).astype(np.float32)
    zero = np.zeros(n, np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays, jax.random.PRNGKey(0), cfg_j, js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id), wavelength=zero),
        g_mom, interpret=True, block_rows=2)
    g_flat, g_in, _, g_wl = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=fused_trace.plate_maps(meta, None),
        need_wavelength=True)
    for c, g in zip(fused_trace.COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g.numpy(), ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
    _assert_wavelength_grads_close(g_wl.numpy(), ct['wavelength'])
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        ref = ref.reshape(k, -1)
        off = ROW_OFFSETS[name]
        got = g_flat[:, off:off + ref.shape[1]].numpy()
        cols = range(ref.shape[1]) if name == 'disp' else [None]
        for j in cols:
            r_, g_ = (ref, got) if j is None else (ref[:, j], got[:, j])
            scale = max(1.0, float(np.abs(r_).max()))
            _close(g_, r_, rtol=1e-4, atol=1e-5 * scale, err_msg=(name, j))
    dcols = list(fused_trace.DISP_GRAD_COLS)
    assert float(g_flat[:, dcols].abs().max()) > 0
    outside = [c for c in range(g_flat.shape[1])
               if c not in fused_trace.grad_cols((), True, True)]
    assert float(g_flat[:, outside].abs().max()) == 0.0


def test_plain_nonseq_backward_returns_the_wavelength():
    """K6's plain version returns the wavelength's cotangent: on the
    achromat as a Scene it equals the sequential one's (the Scene traces
    the same rows in order)."""
    case = 'achromat_sellmeier'
    js, _, _, nb = _scenes(case)
    rays, _ = _rays(case, 200, 8)
    _, table, meta, rays_t = _port(js, rays)
    cfg = trt.SensorConfig(n_sensors=1, n_bundles=nb)
    flat = trt.flatten_table_rows(table)
    rng = np.random.default_rng(9)
    g_rays = [torch.from_numpy(rng.standard_normal(rays_t.n).astype(
        np.float32)) for _ in fused_trace.COMPS]
    g_mom = torch.from_numpy(rng.standard_normal((1, nb, 7)).astype(
        np.float32))
    seq = fused_trace.trace_seq_bwd_plain(flat, rays_t, cfg, meta, g_rays,
                                          g_mom, maps=(),
                                          need_wavelength=True)
    ns = fused_nonseq.trace_nonseq_bwd_plain(
        flat, rays_t, cfg, meta, chip_smoke.DISP_BOUNCES, g_rays, g_mom,
        maps=(), need_wavelength=True)
    assert float(seq[3].abs().max()) > 0
    _close(ns[3].numpy(), seq[3].numpy(), rtol=1e-4,
           atol=1e-5 * float(seq[3].abs().max()))


def test_v1_disperses_where_the_first_tpu_kernel_does_not():
    """The JAX package's first kernel (``trace_sequential_pallas``,
    ``_kernel``) calls the physics without the wavelength, so it refracts
    the achromat's F light at the d-line indices, apart from its own chain
    (``simulate``) and from K1; the port's ``trace_sequential_v1`` runs
    K1's function and follows the chain (ROADMAP Queue 3)."""
    js = chip_smoke.achromat_scene(jrt)
    rays = jrt.Rays.create([[0.0, 2.0, -10.0]] * 2, [[0.0, 0.0, 1.0]] * 2,
                           wavelength=[chip_smoke.F_LINE,
                                       chip_smoke.D_LINE])
    k0_j, _, _ = trace_sequential_pallas(
        js.build_table(js.init_params()), rays, jax.random.PRNGKey(0),
        js.sensor_config(), js.static_meta(), interpret=True)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0))
    pos_k0, pos_j = np.asarray(k0_j.pos), np.asarray(out_j.pos)
    assert np.abs(pos_k0[0] - pos_j[0]).max() > 1e-3    # F: apart
    _close(pos_k0[1], pos_j[1], atol=1e-5)              # d line: alike
    _, table, meta, rays_t = _port(js, rays)
    out_t, sens_t, _ = trt.trace_sequential_v1(
        table, rays_t, trt.SensorConfig(n_sensors=1, n_bundles=1), meta)
    _assert_trace_close(out_t, sens_t, out_j, sens_j)


@pytest.mark.parametrize('case', ['achromat_abbe', 'achromat_sellmeier'])
def test_scene_gradients_match_jax(case):
    """The 12-bounce Scene's gradients (K6's function: autograd of the
    fused loop's plain version; and the eager loop) against ``jax.grad`` of
    the JAX bounce loop."""
    trained = chip_smoke.DISP_TRAINED[case]
    js, ts, _, nb = _scenes(case, chip_smoke.DISP_BOUNCES)
    rays, _ = _rays(case, 300, 4)
    p_t, _, _, rays_t = _port(js, rays)
    val_j, g_j = jax.value_and_grad(_loss_jax(js, rays, nb))(
        js.init_params())
    for simulate in (ts.simulate_fused, ts.simulate):
        p = {el: dict(v) for el, v in p_t.items()}
        val_t, g_t = _grads_torch(_loss_torch(simulate, rays_t, nb), p,
                                  trained)
        _close(val_t, float(val_j), rtol=1e-5)
        for key, gt in g_t.items():
            _close(gt, g_j[key[0]][key[1]], rtol=1e-4, err_msg=key)
