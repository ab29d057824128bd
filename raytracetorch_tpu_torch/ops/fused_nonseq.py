"""Fused non-sequential trace: the CUDA kernels K5 (the whole bounce loop per
ray) and K6 (its adjoint), their plain versions, and the autograd Function
that joins them.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py``, non-sequential
part, for the kinds of ops/fused_trace.py (pixelated phase plates and the
extended kinds included) plus the ideal spherical mirror, with every other
optional stream off:

- ``trace_nonseq_pallas`` (TPU kernel ``_kernel_nonseq``, bounce body
  ``_nonseq_bounce_core``) -> kernel K5, ``csrc/trace_nonseq_fwd.cu``;
- ``trace_nonseq_pallas_bwd`` (TPU kernels ``_kernel_nonseq_bwd_scan`` and
  ``_kernel_nonseq_bwd``) -> kernel K6, ``csrc/trace_nonseq_bwd.cu``;
- the ``custom_vjp`` ``fused_nonseq_grad`` with ``_fused_nonseq_fwd`` and
  ``_fused_nonseq_bwd`` -> ``FusedNonseq``.

The kernels' notes are in their sources.  In this module:

- ``trace_nonseq_fused`` is the entry point (``Scene.simulate_fused``).
  When grad is enabled and the table, a ray stream or a phase map requires
  grad it goes through ``FusedNonseq``; otherwise it runs the forward
  alone.  Phase maps travel as in ops/fused_trace.py; K5 reads the winning
  plate's corners, K6 scatters their cotangents.  CPU tensors
  run the plain versions; CUDA tensors launch the kernels or raise.  Rows of
  kinds the kernels lack raise NotImplementedError before anything runs.
- ``trace_nonseq_fused_plain`` and ``trace_nonseq_bwd_plain`` are the two
  kernels' functions in plain torch: the eager bounce loop of core/trace.py
  over the rows of the flat table, and its autograd.
- ``trace_nonseq_fwd_cuda`` and ``trace_nonseq_bwd_cuda`` launch the
  kernels and count their launches in ``NONSEQ_LAUNCHES`` and
  ``NONSEQ_BWD_LAUNCHES`` (a launch with the extended kinds also in
  ``fused_trace.EXT_LAUNCHES``).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.table import FlatRow
from ..core.trace import bounce_loop
from . import fused_trace
from .fused_trace import (COMPS, THREADS, _rays_of, check_cotangents,
                          check_inputs, dispersive, dispersive_kinds,
                          ext_kinds, ext_maps,
                          flat_inputs, grad_cols, grid_args, kernel,
                          needs_grad, new_grid, plain_vjp, plate_args,
                          plate_buffers, plate_cotangents, plate_inputs,
                          plate_maps, plate_rows, ptr, split_plates, stream,
                          table_and_map_cotangents, unpack)

NONSEQ_LAUNCHES = 0       # kernel launches by trace_nonseq_fwd_cuda (K5)
NONSEQ_BWD_LAUNCHES = 0   # kernel launches by trace_nonseq_bwd_cuda (K6)


def trace_nonseq_fused(table, rays, cfg: SensorConfig, static_meta,
                       n_bounces, grids=None):
    """Fused bounce loop within ``n_bounces`` -> ``(rays, SensorState)``,
    differentiable with respect to the table, the 7 ray streams
    px..intensity and the phase maps of ``grids`` ({PHASE_GRID row:
    [H, W] map}) (first order).

    CPU tensors run the plain versions; CUDA tensors launch K5 and, in
    backward, K6 (or raise: there is no fallback)."""
    flat, kinds = flat_inputs(table, rays, cfg, static_meta)
    maps = plate_maps(static_meta, grids)
    if needs_grad(flat, rays, maps):
        return unpack(FusedNonseq.apply(flat, kinds, cfg, tuple(static_meta),
                                        n_bounces,
                                        *(getattr(rays, c) for c in COMPS),
                                        rays.ray_id,
                                        *plate_inputs(rays, maps)),
                      rays, cfg)
    return _forward(flat, kinds, rays, cfg, static_meta, n_bounces, maps)


def _forward(flat, kinds, rays, cfg, static_meta, n_bounces, maps=None):
    if flat.device.type == 'cpu':
        return trace_nonseq_fused_plain(flat, rays, cfg, static_meta,
                                        n_bounces, maps)
    return trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, n_bounces, maps,
                                 ext_kinds(static_meta))


class FusedNonseq(torch.autograd.Function):
    """The fused bounce loop with its backward: K5 forward, K6 backward on
    CUDA tensors; the plain versions on CPU tensors.

    Counterpart of ``fused_nonseq_grad`` / ``_fused_nonseq_fwd`` /
    ``_fused_nonseq_bwd``.  Like ``_fused_nonseq_fwd`` it keeps only its
    inputs (table and input rays) as residuals; the backward re-runs the
    bounce loop.  The wavelength is read (phase plates, dispersion) and gets
    the cotangent of that reading when it requires grad (from K6's
    instantiation with the extended kinds); it is not an output, so its
    identity pass-through is left to autograd.  Like the JAX ``custom_vjp``
    it has no higher-order or forward-mode rule.

    ``apply(flat_table, kinds, cfg, meta, n_bounces, px, py, pz, dx, dy, dz,
    intensity, ray_id, *plates)`` -> the 7 output ray streams, ``moments
    [S, B, 7]`` and, when ``cfg.grid_shape`` is set, ``grid [S, H, W]``;
    ``plates`` as for ``FusedTrace``: the maps and the wavelength get their
    cotangents from K6."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, n_bounces, px, py, pz, dx,
                dy, dz, intensity, ray_id, *plates):
        comps = (px, py, pz, dx, dy, dz, intensity)
        wavelength, maps = split_plates(plates)
        out, sensors = _forward(flat_table, kinds,
                                _rays_of(comps, ray_id, wavelength), cfg,
                                meta, n_bounces, maps)
        ctx.save_for_backward(flat_table, kinds, *comps, ray_id, *plates)
        ctx.cfg, ctx.meta, ctx.n_bounces = cfg, meta, n_bounces
        ctx.set_materialize_grads(False)
        grid = (sensors.grid,) if cfg.grid_shape else ()
        return (*(getattr(out, c) for c in COMPS), sensors.moments, *grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        flat, kinds, *comps, ray_id = ctx.saved_tensors[:10]
        wavelength, maps = split_plates(ctx.saved_tensors[10:])
        rays = _rays_of(comps, ray_id, wavelength)
        g_rays, g_moments = grads[:7], grads[7]
        g_grid = grads[8] if ctx.cfg.grid_shape else None
        need = ctx.needs_input_grad
        need_table, need_rays = need[0], any(need[5:12])
        need_wl = len(need) > 13 and need[13]
        if flat.device.type == 'cuda':
            res = trace_nonseq_bwd_cuda(
                flat, kinds, rays, ctx.cfg, ctx.n_bounces, g_rays, g_moments,
                need_table, need_rays, g_grid=g_grid, maps=maps,
                need_maps=any(need[14:]), ext=ext_kinds(ctx.meta),
                disp=dispersive(ctx.meta), need_wavelength=need_wl)
        else:
            res = trace_nonseq_bwd_plain(
                flat, rays, ctx.cfg, ctx.meta, ctx.n_bounces, g_rays,
                g_moments, g_grid=g_grid, maps=maps, need_wavelength=need_wl)
        g_flat, g_in = res[:2]
        g_in = [g if n else None
                for g, n in zip(g_in or (None,) * 7, need[5:12])]
        return (g_flat if need_table else None, None, None, None, None,
                *g_in, None, *plate_cotangents(res, maps, need[13:]))


def trace_nonseq_fused_plain(flat_table, rays, cfg: SensorConfig,
                             static_meta, n_bounces, maps=None):
    """K5's function in plain torch: the eager bounce loop over the rows of
    the flat table the kernel reads, with the phase maps ``maps`` of its
    PHASE_GRID rows (in row order)."""
    rows = [FlatRow(flat_table[k]) for k in range(len(static_meta))]
    return bounce_loop(rows, rays, n_bounces, cfg, static_meta,
                       torch.float32, plain=True,
                       grids=dict(zip(plate_rows(static_meta), maps or ())))


def trace_nonseq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                           n_bounces, g_rays, g_moments, g_grid=None,
                           maps=None, need_wavelength=False):
    """K6's function in plain torch: re-run ``trace_nonseq_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments and
    ``g_grid`` that of the [S, H, W] grid (each None for zero).  Returns
    ``(g_flat [K, 160], 7 input-ray cotangents)``, with phase maps their
    cotangents third, and with ``need_wavelength`` the wavelength's
    cotangent fourth (the maps' then ``()`` without maps)."""
    return plain_vjp(
        lambda flat, r, m: trace_nonseq_fused_plain(flat, r, cfg,
                                                    static_meta, n_bounces,
                                                    m),
        flat_table, rays, g_rays, g_moments, g_grid, maps, need_wavelength)


def trace_nonseq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces, maps=None, ext=False):
    """Launch K5 on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``, ``maps`` the PHASE_GRID rows' [H, W] maps
    in row order; all on one CUDA device.  ``ext``: the table has the
    extended kinds (``fused_trace.ext_kinds``)."""
    global NONSEQ_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_fwd_cuda')
    _check_bounces(n_bounces)
    plates = plate_buffers(ext_maps(maps, ext), rays, device)
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
                *plate_args(plates), int(ext), int(n_bounces), n,
                stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_fwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_LAUNCHES += 1
        fused_trace.EXT_LAUNCHES += int(ext)
    out = rays.replace(**dict(zip(COMPS, outs)))
    return out, SensorState(moments=partials.sum(dim=0), grid=grid)


def trace_nonseq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces, g_rays, g_moments, need_table=True,
                          need_rays=True, g_grid=None, replay=False,
                          maps=None, need_maps=True, ext=False, disp=None,
                          need_wavelength=False):
    """Launch K6 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, with phase maps (or the extended kinds)
    their cotangents (or None) next, with ``need_wavelength`` the
    wavelength's cotangent next, and with ``replay=True`` last the rays at
    the state the kernel's forward replay ended at (K5's output, bit for
    bit).

    Inputs as for ``trace_nonseq_fwd_cuda``; ``g_rays`` holds the
    cotangents of the 7 output streams (None for zero), ``g_moments`` that
    of the [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each
    None for zero).  ``need_table`` / ``need_rays`` / ``need_maps`` /
    ``need_wavelength`` say which cotangents to compute; the kernel skips
    the others.  ``ext`` as for ``trace_nonseq_fwd_cuda``, ``disp`` as for
    ``fused_trace.trace_seq_bwd_cuda`` (a dispersive table and the
    wavelength's cotangent take the instantiation with dispersion)."""
    global NONSEQ_BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_bwd_cuda')
    _check_bounces(n_bounces)
    if disp is None:
        disp = ext and dispersive_kinds(kinds)
    ext = ext or need_wavelength
    plates = plate_buffers(ext_maps(maps, ext), rays, device)
    g_rays, g_mom, g_grid = check_cotangents(g_rays, g_moments, g_grid, cfg,
                                             n, device)
    cols = grad_cols(plates, ext, disp)

    def streams(wanted):
        return ([torch.empty(n, dtype=torch.float32, device=device)
                 for _ in COMPS] if wanted else None)
    outs, ends = streams(need_rays), streams(replay)
    partials = (torch.empty(-(-n // THREADS), k, len(cols),
                            dtype=torch.float32, device=device)
                if need_table else None)
    g_maps = (torch.zeros_like(plates.maps)
              if plates is not None and need_maps else None)
    g_wl = (torch.empty(n, dtype=torch.float32, device=device)
            if need_wavelength else None)
    if n > 0 and (need_table or need_rays or replay or g_maps is not None
                  or need_wavelength):
        fn = kernel('rtt_trace_nonseq_bwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *map(ptr, g_rays),
                    g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                    ptr(partials), *map(ptr, ends or (None,) * 7), n_slots,
                    n_bundles, *grid_args(cfg, g_grid), *plate_args(plates),
                    ptr(g_maps), ptr(g_wl), int(ext and disp), int(ext),
                    int(n_bounces), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_bwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_BWD_LAUNCHES += 1
        fused_trace.EXT_LAUNCHES += int(ext)
    res = table_and_map_cotangents(k, cols, partials, outs, plates, g_maps,
                                   device, g_wl)
    if replay:
        res += (rays.replace(**dict(zip(COMPS, ends))),)
    return res


def _check_bounces(n_bounces):
    if n_bounces < 0:
        raise ValueError(f'n_bounces must be >= 0, got {n_bounces}')
