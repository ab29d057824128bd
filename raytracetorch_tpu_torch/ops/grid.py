"""Irradiance-grid binning: kernel K3 (csrc/grid_bin.cu), its plain version,
and the autograd Function that joins the kernel's scatter and gather.

Counterpart of the TPU kernel functions ``_grid_partial`` /
``_grid_accumulate`` (the histogram) and ``_grid_partial_g`` (its gather
backward) of ``raytracetorch_tpu/ops/pallas_trace.py``, and of their XLA
twin ``raytracetorch_tpu/core/sensor.py::_bin_grid``.  The kernel's notes
are in its source.  In this module:

- ``bin_grid`` is the entry point that ``SensorState.record`` calls: CPU
  tensors (or ``plain=True``) run the plain version, CUDA tensors run
  ``GridBin`` (the kernel forward, its gather backward), any other device
  raises.
- ``bin_grid_slots_plain`` is the plain version over sensor slots: one
  ``core/sensor.py::bin_grid_plain`` (``index_put_`` with accumulate) per
  slot, with the weights of the other slots masked to zero.
- ``bin_grid_cuda`` and ``grid_gather_cuda`` launch the kernel's scatter
  and gather and count them in ``GRID_LAUNCHES`` and ``GATHER_LAUNCHES``.

The fused kernels K1 and K5 bin their sensor hits with K3's device function
(csrc/grid_bin.cuh) as they trace; those launches count as theirs.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.sensor import SensorConfig, bin_grid_plain
from .fused_trace import check, kernel, stream

GRID_LAUNCHES = 0      # launches of the scatter by bin_grid_cuda (K3)
GATHER_LAUNCHES = 0    # launches of the gather by grid_gather_cuda (K3)


def _n_slots(cfg: SensorConfig):
    return max(cfg.n_sensors, 1)


def bin_grid(x, y, w, slot, cfg: SensorConfig, grid=None, plain=False):
    """``[S, H, W]`` grid of the hits ``(x, y)`` with weights ``w`` in sensor
    slot ``slot`` (an int for all hits, or an ``[N]`` int tensor), added to
    ``grid`` when given.  Differentiable in ``w`` and ``grid``."""
    device = x.device
    if plain or device.type == 'cpu':
        new = bin_grid_slots_plain(x, y, w, slot, cfg)
    elif device.type == 'cuda':
        new = GridBin.apply(x, y, w, slot, cfg)
    else:
        raise ValueError(f'no grid binning for device {device}')
    return new if grid is None else grid + new


def bin_grid_slots_plain(x, y, w, slot, cfg: SensorConfig):
    """K3's function in plain torch over the sensor slots."""
    parts = []
    for s in range(_n_slots(cfg)):
        if isinstance(slot, int):
            w_s = w if s == slot else torch.zeros_like(w)
        else:
            w_s = torch.where(slot == s, w, 0.0)
        parts.append(bin_grid_plain(cfg.grid_shape, cfg.grid_half_extent, x,
                                    y, w_s))
    return torch.stack(parts)


class GridBin(torch.autograd.Function):
    """K3 on CUDA tensors with its gather backward: d loss / d w[i] =
    g[slot_i, iy_i, ix_i]; no gradient in x, y or the slot (the JAX
    ``_bin_grid`` custom_vjp).

    ``apply(x, y, w, slot, cfg)`` -> the ``[S, H, W]`` grid."""

    @staticmethod
    def forward(ctx, x, y, w, slot, cfg):
        x, y, w = x.contiguous(), y.contiguous(), w.contiguous()
        ctx.cfg, ctx.slot = cfg, slot
        ctx.save_for_backward(x, y)
        return bin_grid_cuda(x, y, w, slot, cfg)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g_w = (grid_gather_cuda(g.contiguous(), x, y, ctx.slot, ctx.cfg)
               if ctx.needs_input_grad[2] else None)
        return None, None, g_w, None, None


def _check_hits(x, y, slot, name, w=None):
    """Shared checks of both wrappers -> (device, N, slot pointer, slot0)."""
    device = x.device
    if device.type != 'cuda':
        raise ValueError(f'{name} needs CUDA tensors, got {device}')
    n = x.shape[0]
    for t, tn in ((x, 'x'), (y, 'y')) + (() if w is None else ((w, 'w'),)):
        check(t, tn, torch.float32, (n,), device)
    if isinstance(slot, int):
        return device, n, None, slot
    check(slot, 'slot', torch.int32, (n,), device)
    return device, n, slot.data_ptr(), 0


def bin_grid_cuda(x, y, w, slot, cfg: SensorConfig, grid=None):
    """Launch K3's scatter on the current stream: add the hits into
    ``grid`` (checked, accumulated in place) or into a new zeroed
    ``[S, H, W]`` float32 grid; returns the grid."""
    global GRID_LAUNCHES
    device, n, slot_ptr, slot0 = _check_hits(x, y, slot, 'bin_grid_cuda', w)
    h, wd = cfg.grid_shape
    shape = (_n_slots(cfg), h, wd)
    if grid is None:
        grid = torch.zeros(shape, dtype=torch.float32, device=device)
    check(grid, 'grid', torch.float32, shape, device)
    if n > 0:
        with torch.cuda.device(device):
            rc = kernel('rtt_grid_bin')(
                x.data_ptr(), y.data_ptr(), w.data_ptr(), slot_ptr, slot0, n,
                grid.data_ptr(), shape[0], h, wd,
                float(cfg.grid_half_extent), stream(device))
        if rc != 0:
            raise RuntimeError(f'grid_bin launch failed with CUDA error {rc}')
        GRID_LAUNCHES += 1
    return grid


def grid_gather_cuda(g, x, y, slot, cfg: SensorConfig):
    """Launch K3's gather on the current stream: ``g[slot_i, iy_i, ix_i]``
    per hit (0 for a slot outside the grid's) -> ``[N]`` float32."""
    global GATHER_LAUNCHES
    device, n, slot_ptr, slot0 = _check_hits(x, y, slot, 'grid_gather_cuda')
    h, wd = cfg.grid_shape
    check(g, 'g', torch.float32, (_n_slots(cfg), h, wd), device)
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n > 0:
        with torch.cuda.device(device):
            rc = kernel('rtt_grid_gather')(
                g.data_ptr(), x.data_ptr(), y.data_ptr(), slot_ptr, slot0, n,
                out.data_ptr(), _n_slots(cfg), h, wd,
                float(cfg.grid_half_extent), stream(device))
        if rc != 0:
            raise RuntimeError(f'grid_gather launch failed with CUDA error '
                               f'{rc}')
        GATHER_LAUNCHES += 1
    return out
