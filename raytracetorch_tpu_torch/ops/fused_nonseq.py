"""Fused non-sequential trace: the CUDA kernel K5 (the whole bounce loop per
ray) and its plain version.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py::trace_nonseq_pallas``
(TPU kernel ``_kernel_nonseq``, bounce body ``_nonseq_bounce_core``) for the
kinds of ops/fused_trace.py plus the ideal spherical mirror, with every
optional stream off.  The kernel's notes are in ``csrc/trace_nonseq_fwd.cu``.
In this module:

- ``trace_nonseq_fused`` is the entry point (``Scene.simulate_fused``): CPU
  tensors run the plain version, CUDA tensors launch the kernel or raise.
  Rows of kinds the kernel lacks raise NotImplementedError before anything
  runs.  It is forward only: under autograd it raises, because its backward
  is kernel K6 (ROADMAP Queue 2), not ported yet.
- ``trace_nonseq_fused_plain`` is K5's function in plain torch: the eager
  bounce loop of core/trace.py over the rows of the flat table.
- ``trace_nonseq_fwd_cuda`` launches the kernel and counts its launches in
  ``NONSEQ_LAUNCHES``.
"""

from __future__ import annotations

import torch

from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.table import FlatRow
from ..core.trace import bounce_loop
from .fused_trace import (COMPS, THREADS, check_inputs, flat_inputs,
                          grid_args, kernel, needs_grad, new_grid, stream)

NONSEQ_LAUNCHES = 0   # kernel launches by trace_nonseq_fwd_cuda (K5)

TODO_K6 = ('gradients through the fused non-sequential trace need kernel K6 '
           '(ROADMAP Queue 2), not ported yet: use Scene.simulate')


def trace_nonseq_fused(table, rays, cfg: SensorConfig, static_meta,
                       n_bounces):
    """Fused bounce loop within ``n_bounces`` -> ``(rays, SensorState)``.

    CPU tensors run the plain version; CUDA tensors launch K5 (or raise:
    there is no fallback)."""
    flat, kinds = flat_inputs(table, rays, cfg, static_meta)
    if needs_grad(flat, rays):
        raise NotImplementedError(TODO_K6)
    if flat.device.type == 'cpu':
        return trace_nonseq_fused_plain(flat, rays, cfg, static_meta,
                                        n_bounces)
    return trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, n_bounces)


def trace_nonseq_fused_plain(flat_table, rays, cfg: SensorConfig,
                             static_meta, n_bounces):
    """K5's function in plain torch: the eager bounce loop over the rows of
    the flat table the kernel reads."""
    rows = [FlatRow(flat_table[k]) for k in range(len(static_meta))]
    return bounce_loop(rows, rays, n_bounces, cfg, static_meta,
                       torch.float32, plain=True)


def trace_nonseq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces):
    """Launch K5 on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``; all on one CUDA device."""
    global NONSEQ_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_fwd_cuda')
    if n_bounces < 0:
        raise ValueError(f'n_bounces must be >= 0, got {n_bounces}')
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
