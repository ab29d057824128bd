"""Fused non-sequential trace: the CUDA kernels K5 (the whole bounce loop per
ray) and K6 (its adjoint), their plain versions, and the autograd Function
that joins them.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py``, non-sequential
part, for the kinds of ops/fused_trace.py plus the ideal spherical mirror,
with every optional stream off:

- ``trace_nonseq_pallas`` (TPU kernel ``_kernel_nonseq``, bounce body
  ``_nonseq_bounce_core``) -> kernel K5, ``csrc/trace_nonseq_fwd.cu``;
- ``trace_nonseq_pallas_bwd`` (TPU kernels ``_kernel_nonseq_bwd_scan`` and
  ``_kernel_nonseq_bwd``) -> kernel K6, ``csrc/trace_nonseq_bwd.cu``;
- the ``custom_vjp`` ``fused_nonseq_grad`` with ``_fused_nonseq_fwd`` and
  ``_fused_nonseq_bwd`` -> ``FusedNonseq``.

The kernels' notes are in their sources.  In this module:

- ``trace_nonseq_fused`` is the entry point (``Scene.simulate_fused``).
  When grad is enabled and the table or a ray stream requires grad it goes
  through ``FusedNonseq``; otherwise it runs the forward alone.  CPU tensors
  run the plain versions; CUDA tensors launch the kernels or raise.  Rows of
  kinds the kernels lack raise NotImplementedError before anything runs.
- ``trace_nonseq_fused_plain`` and ``trace_nonseq_bwd_plain`` are the two
  kernels' functions in plain torch: the eager bounce loop of core/trace.py
  over the rows of the flat table, and its autograd.
- ``trace_nonseq_fwd_cuda`` and ``trace_nonseq_bwd_cuda`` launch the
  kernels and count their launches in ``NONSEQ_LAUNCHES`` and
  ``NONSEQ_BWD_LAUNCHES``.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.table import ROW_WIDTH, FlatRow
from ..core.trace import bounce_loop
from .fused_trace import (COMPS, GRAD_COLS, THREADS, _rays_of, check,
                          check_inputs, flat_inputs, grid_args, kernel,
                          needs_grad, new_grid, plain_vjp, stream, unpack)

NONSEQ_LAUNCHES = 0       # kernel launches by trace_nonseq_fwd_cuda (K5)
NONSEQ_BWD_LAUNCHES = 0   # kernel launches by trace_nonseq_bwd_cuda (K6)


def trace_nonseq_fused(table, rays, cfg: SensorConfig, static_meta,
                       n_bounces):
    """Fused bounce loop within ``n_bounces`` -> ``(rays, SensorState)``,
    differentiable with respect to the table and the 7 ray streams
    px..intensity (first order).

    CPU tensors run the plain versions; CUDA tensors launch K5 and, in
    backward, K6 (or raise: there is no fallback)."""
    flat, kinds = flat_inputs(table, rays, cfg, static_meta)
    if needs_grad(flat, rays):
        return unpack(FusedNonseq.apply(flat, kinds, cfg, tuple(static_meta),
                                        n_bounces,
                                        *(getattr(rays, c) for c in COMPS),
                                        rays.ray_id), rays, cfg)
    return _forward(flat, kinds, rays, cfg, static_meta, n_bounces)


def _forward(flat, kinds, rays, cfg, static_meta, n_bounces):
    if flat.device.type == 'cpu':
        return trace_nonseq_fused_plain(flat, rays, cfg, static_meta,
                                        n_bounces)
    return trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, n_bounces)


class FusedNonseq(torch.autograd.Function):
    """The fused bounce loop with its backward: K5 forward, K6 backward on
    CUDA tensors; the plain versions on CPU tensors.

    Counterpart of ``fused_nonseq_grad`` / ``_fused_nonseq_fwd`` /
    ``_fused_nonseq_bwd``.  Like ``_fused_nonseq_fwd`` it keeps only its
    inputs (table and input rays) as residuals; the backward re-runs the
    bounce loop.  The wavelength is not an output, so its identity
    pass-through is left to autograd.  Like the JAX ``custom_vjp`` it has no
    higher-order or forward-mode rule.

    ``apply(flat_table, kinds, cfg, meta, n_bounces, px, py, pz, dx, dy, dz,
    intensity, ray_id)`` -> the 7 output ray streams, ``moments [S, B, 7]``
    and, when ``cfg.grid_shape`` is set, ``grid [S, H, W]``."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, n_bounces, px, py, pz, dx,
                dy, dz, intensity, ray_id):
        comps = (px, py, pz, dx, dy, dz, intensity)
        out, sensors = _forward(flat_table, kinds, _rays_of(comps, ray_id),
                                cfg, meta, n_bounces)
        ctx.save_for_backward(flat_table, kinds, *comps, ray_id)
        ctx.cfg, ctx.meta, ctx.n_bounces = cfg, meta, n_bounces
        ctx.set_materialize_grads(False)
        grid = (sensors.grid,) if cfg.grid_shape else ()
        return (*(getattr(out, c) for c in COMPS), sensors.moments, *grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        flat, kinds, *comps, ray_id = ctx.saved_tensors
        rays = _rays_of(comps, ray_id)
        g_rays, g_moments = grads[:7], grads[7]
        g_grid = grads[8] if ctx.cfg.grid_shape else None
        need = ctx.needs_input_grad
        need_table, need_rays = need[0], any(need[5:12])
        if flat.device.type == 'cuda':
            g_flat, g_in = trace_nonseq_bwd_cuda(
                flat, kinds, rays, ctx.cfg, ctx.n_bounces, g_rays, g_moments,
                need_table, need_rays, g_grid=g_grid)
        else:
            g_flat, g_in = trace_nonseq_bwd_plain(
                flat, rays, ctx.cfg, ctx.meta, ctx.n_bounces, g_rays,
                g_moments, g_grid=g_grid)
        g_in = [g if n else None
                for g, n in zip(g_in or (None,) * 7, need[5:12])]
        return (g_flat if need_table else None, None, None, None, None,
                *g_in, None)


def trace_nonseq_fused_plain(flat_table, rays, cfg: SensorConfig,
                             static_meta, n_bounces):
    """K5's function in plain torch: the eager bounce loop over the rows of
    the flat table the kernel reads."""
    rows = [FlatRow(flat_table[k]) for k in range(len(static_meta))]
    return bounce_loop(rows, rays, n_bounces, cfg, static_meta,
                       torch.float32, plain=True)


def trace_nonseq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                           n_bounces, g_rays, g_moments, g_grid=None):
    """K6's function in plain torch: re-run ``trace_nonseq_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments and
    ``g_grid`` that of the [S, H, W] grid (each None for zero).  Returns
    ``(g_flat [K, 160], 7 input-ray cotangents)``."""
    return plain_vjp(
        lambda flat, r: trace_nonseq_fused_plain(flat, r, cfg, static_meta,
                                                 n_bounces),
        flat_table, rays, g_rays, g_moments, g_grid)


def trace_nonseq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces):
    """Launch K5 on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``; all on one CUDA device."""
    global NONSEQ_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_fwd_cuda')
    _check_bounces(n_bounces)
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in COMPS]
    partials = torch.empty(-(-n // THREADS), n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    grid = new_grid(cfg, device)
    if n > 0:
        with torch.cuda.device(device):
            rc = kernel('rtt_trace_nonseq_fwd')(
                flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in COMPS),
                rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                partials.data_ptr(), n_slots, n_bundles,
                *grid_args(cfg, grid if cfg.grid_shape else None),
                int(n_bounces), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_fwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_LAUNCHES += 1
    out = rays.replace(**dict(zip(COMPS, outs)))
    return out, SensorState(moments=partials.sum(dim=0), grid=grid)


def trace_nonseq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces, g_rays, g_moments, need_table=True,
                          need_rays=True, g_grid=None, replay=False):
    """Launch K6 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, and with ``replay=True`` also the rays
    at the state the kernel's forward replay ended at (K5's output, bit for
    bit).

    Inputs as for ``trace_nonseq_fwd_cuda``; ``g_rays`` holds the
    cotangents of the 7 output streams (None for zero), ``g_moments`` that
    of the [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each
    None for zero).  ``need_table`` / ``need_rays`` say which cotangents to
    compute; the kernel skips the others."""
    global NONSEQ_BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_bwd_cuda')
    _check_bounces(n_bounces)
    # autograd may hand expanded (stride-0) cotangents: the kernel reads
    # them densely
    g_rays = [None if g is None else g.contiguous() for g in g_rays]
    for c, g in zip(COMPS, g_rays):
        if g is not None:
            check(g, f'g_{c}', torch.float32, (n,), device)
    mom_shape = (n_slots, n_bundles, N_MOMENTS)
    g_mom = (torch.zeros(mom_shape, dtype=torch.float32, device=device)
             if g_moments is None else g_moments.contiguous())
    check(g_mom, 'g_moments', torch.float32, mom_shape, device)
    if g_grid is not None:
        g_grid = g_grid.contiguous()
        check(g_grid, 'g_grid', torch.float32,
              (n_slots, *cfg.grid_shape), device)

    def streams(wanted):
        return ([torch.empty(n, dtype=torch.float32, device=device)
                 for _ in COMPS] if wanted else None)
    outs, ends = streams(need_rays), streams(replay)
    partials = (torch.empty(-(-n // THREADS), k, len(GRAD_COLS),
                            dtype=torch.float32, device=device)
                if need_table else None)
    if n > 0 and (need_table or need_rays or replay):
        def ptr(t):
            return None if t is None else t.data_ptr()
        fn = kernel('rtt_trace_nonseq_bwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *map(ptr, g_rays),
                    g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                    ptr(partials), *map(ptr, ends or (None,) * 7), n_slots,
                    n_bundles, *grid_args(cfg, g_grid), int(n_bounces), n,
                    stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_bwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_BWD_LAUNCHES += 1
    g_flat = None
    if need_table:
        g_flat = torch.zeros(k, ROW_WIDTH, dtype=torch.float32,
                             device=device)
        g_flat[:, list(GRAD_COLS)] = partials.sum(dim=0)
    res = (g_flat, tuple(outs) if need_rays else None)
    if replay:
        res += (rays.replace(**dict(zip(COMPS, ends))),)
    return res


def _check_bounces(n_bounces):
    if n_bounces < 0:
        raise ValueError(f'n_bounces must be >= 0, got {n_bounces}')
