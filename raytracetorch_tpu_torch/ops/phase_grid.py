"""Phase-map corner reads: kernel K4 (csrc/grid_corners.cu), its plain
version, and the autograd Function that joins the kernel's gather and its
scatter.

Counterpart of the TPU kernel function ``_grid_corners_mxu`` of
``raytracetorch_tpu/ops/pallas_trace.py`` (and of the per-ray gather in
``raytracetorch_tpu/core/physics.py::phase_grid_dir``, which it replaces
inside the fused TPU kernels).  The kernel's notes are in its source.  In
this module:

- ``grid_corners`` is the entry point that ``core/physics.py::
  phase_grid_dir`` calls in the eager trace: CPU tensors (or ``plain=True``)
  run the plain version, CUDA tensors run ``GridCorners`` (the kernel's
  gather forward, its scatter backward), any other device raises.
- ``grid_corners_plain`` is the plain version: four advanced-index reads at
  the clamped cells, whose autograd is the scatter; ``grid_corners_bwd_plain``
  writes that scatter out with ``index_put_`` for comparisons.
- ``grid_corners_cuda`` and ``grid_corners_bwd_cuda`` launch the kernel's
  gather and scatter and count them in ``CORNER_LAUNCHES`` and
  ``CORNER_BWD_LAUNCHES``.

Every corner index is clamped into the map, as XLA's gather clamps in the
reference's eager trace: at the far rim of a map at least 34 wide the cell
index is ``W - 1`` (core/physics.py::corner_clip) and ``iu + 1`` reads
column ``W - 1`` again.  The fused kernels K1, K2, K5 and K6 read and
scatter the corners with K4's device functions (csrc/grid_corners.cuh) as
they trace; those launches count as theirs.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .fused_trace import check, kernel, stream

CORNER_LAUNCHES = 0      # launches of the gather by grid_corners_cuda (K4)
CORNER_BWD_LAUNCHES = 0  # launches of the scatter by grid_corners_bwd_cuda


def grid_corners(grid, iv, iu, plain=False):
    """The corners ``(g00, g01, g10, g11)`` of cells ``(iv, iu)`` (int
    tensors of one shape) of the ``[H, W]`` map ``grid``: ``grid[iv, iu]``,
    ``grid[iv, iu + 1]``, ``grid[iv + 1, iu]``, ``grid[iv + 1, iu + 1]``
    with every index clamped into the map.  Differentiable in ``grid``."""
    device = grid.device
    if plain or device.type == 'cpu':
        return grid_corners_plain(grid, iv, iu)
    if device.type == 'cuda':
        return GridCorners.apply(grid, iv, iu)
    raise ValueError(f'no corner reads for device {device}')


def _cells(shape, iv, iu):
    """The clamped row and column indices (v0, v1, u0, u1), int64."""
    h, w = shape
    iv, iu = iv.long(), iu.long()
    return (iv.clamp(0, h - 1), (iv + 1).clamp(0, h - 1),
            iu.clamp(0, w - 1), (iu + 1).clamp(0, w - 1))


def grid_corners_plain(grid, iv, iu):
    """K4's gather in plain torch: four advanced-index reads at the clamped
    cells (their autograd is K4's scatter)."""
    v0, v1, u0, u1 = _cells(grid.shape, iv, iu)
    return grid[v0, u0], grid[v0, u1], grid[v1, u0], grid[v1, u1]


def grid_corners_bwd_plain(g_corners, iv, iu, shape):
    """K4's scatter in plain torch: the four corner cotangents (None for
    zero) of cells ``(iv, iu)`` added into a new ``[H, W]`` map at the
    clamped cells, with ``index_put_`` (accumulate)."""
    v0, v1, u0, u1 = _cells(shape, iv, iu)
    ref = next(g for g in g_corners if g is not None)
    out = torch.zeros(shape, dtype=ref.dtype, device=ref.device)
    for g, cell in zip(g_corners, ((v0, u0), (v0, u1), (v1, u0), (v1, u1))):
        if g is not None:
            out.index_put_(cell, g, accumulate=True)
    return out


class GridCorners(torch.autograd.Function):
    """K4 on CUDA tensors: the gather forward, the scatter backward; the
    indices get no gradient.

    ``apply(grid, iv, iu)`` -> ``(g00, g01, g10, g11)``, each of the
    indices' shape."""

    @staticmethod
    def forward(ctx, grid, iv, iu):
        ctx.shape = tuple(grid.shape)
        ctx.save_for_backward(iv, iu)
        ctx.set_materialize_grads(False)
        return grid_corners_cuda(grid.contiguous(), iv, iu)

    @staticmethod
    @once_differentiable
    def backward(ctx, *g_corners):
        iv, iu = ctx.saved_tensors
        g_grid = None
        if ctx.needs_input_grad[0] and any(g is not None for g in g_corners):
            g_grid = grid_corners_bwd_cuda(g_corners, iv, iu, ctx.shape)
        return g_grid, None, None


def _check_cells(iv, iu, device, name):
    """Shared checks of both wrappers -> (flat iv, flat iu, N)."""
    if device.type != 'cuda':
        raise ValueError(f'{name} needs CUDA tensors, got {device}')
    iv = iv.to(torch.int32).contiguous().reshape(-1)
    iu = iu.to(torch.int32).contiguous().reshape(-1)
    n = iv.shape[0]
    check(iv, 'iv', torch.int32, (n,), device)
    check(iu, 'iu', torch.int32, (n,), device)
    return iv, iu, n


def grid_corners_cuda(grid, iv, iu):
    """Launch K4's gather on the current stream -> the four corners, each a
    float32 tensor of the indices' shape."""
    global CORNER_LAUNCHES
    device = grid.device
    shape = iv.shape
    fiv, fiu, n = _check_cells(iv, iu, device, 'grid_corners_cuda')
    if grid.dim() != 2 or 0 in grid.shape:
        raise ValueError(f'grid must be a non-empty [H, W] map, got shape '
                         f'{tuple(grid.shape)}')
    h, w = grid.shape
    check(grid, 'grid', torch.float32, (h, w), device)
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in range(4)]
    if n > 0:
        with torch.cuda.device(device):
            rc = kernel('rtt_grid_corners')(
                grid.data_ptr(), h, w, fiv.data_ptr(), fiu.data_ptr(), n,
                *(o.data_ptr() for o in outs), stream(device))
        if rc != 0:
            raise RuntimeError(f'grid_corners launch failed with CUDA error '
                               f'{rc}')
        CORNER_LAUNCHES += 1
    return tuple(o.reshape(shape) for o in outs)


def grid_corners_bwd_cuda(g_corners, iv, iu, shape):
    """Launch K4's scatter on the current stream: add the four corner
    cotangents (None for zero; any strides) of cells ``(iv, iu)`` into a new
    zeroed ``[H, W]`` float32 map; returns the map."""
    global CORNER_BWD_LAUNCHES
    device = iv.device
    fiv, fiu, n = _check_cells(iv, iu, device, 'grid_corners_bwd_cuda')
    h, w = shape
    g = [None if c is None else c.to(torch.float32).contiguous().reshape(-1)
         for c in g_corners]
    for c, name in zip(g, ('g00', 'g01', 'g10', 'g11')):
        if c is not None:
            check(c, name, torch.float32, (n,), device)
    g_grid = torch.zeros(h, w, dtype=torch.float32, device=device)
    if n > 0 and any(c is not None for c in g):
        with torch.cuda.device(device):
            rc = kernel('rtt_grid_corners_bwd')(
                *(None if c is None else c.data_ptr() for c in g),
                fiv.data_ptr(), fiu.data_ptr(), n, g_grid.data_ptr(), h, w,
                stream(device))
        if rc != 0:
            raise RuntimeError(f'grid_corners_bwd launch failed with CUDA '
                               f'error {rc}')
        CORNER_BWD_LAUNCHES += 1
    return g_grid
