"""Sensor state: streaming moment accumulators and irradiance grids.

Counterpart of ``raytracetorch_tpu/core/sensor.py``.  Per sensor slot ``s``
and bundle ``b``:

  moments[s, b] = [sum_w, sum_wx, sum_wy, sum_wx2, sum_wy2, sum_wxy, n_hits]

Centroids, RMS spot radii and second moments follow in closed form.  An
optional irradiance grid bins the weighted sensor-local hits into an
``[S, H, W]`` image over ``[-e, e]^2`` (``SensorConfig.grid_shape`` /
``grid_half_extent``).

The JAX package bins with one-hot MXU matmuls because a TPU has no fast
scatter; here binning is a scatter-add.  ``bin_grid_plain`` is its plain
version (``index_put_`` with ``accumulate=True``); ``record`` bins through
``ops/grid.py::bin_grid``, which runs that plain version on CPU tensors and
the CUDA kernel K3 on CUDA tensors.  Either way the gradient is the JAX
custom_vjp's: d grid / d w is the gather ``ct[iy, ix]``, and bins have no
derivative in x or y.
"""

from __future__ import annotations

import dataclasses

import torch

N_MOMENTS = 7


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Static sensor configuration of a trace."""

    n_sensors: int = 0
    n_bundles: int = 1
    grid_shape: tuple = ()          # (H, W), or () for no grid
    grid_half_extent: float = 1.0   # the grid spans [-e, e]^2 (sensor-local)


def moment_terms(hit_local, weight):
    """The 7 per-ray moment terms of weighted sensor-local hits."""
    x, y = hit_local[0], hit_local[1]
    return (weight, weight * x, weight * y, weight * x * x,
            weight * y * y, weight * x * y, (weight > 0).to(weight.dtype))


def bin_indices(hw, half_extent, x, y):
    """Bin of each hit: ``clip(trunc((x + e) / (2e) * W), 0, W - 1)`` and
    likewise in y (JAX ``_bin_indices``: ``.astype(int32)`` truncates toward
    zero, then clips).  The truncation and the clip run in floating point,
    so hits far outside the grid clip instead of overflowing an int, and a
    NaN goes to bin 0, as in XLA's conversion.  Returns int64
    ``(ix, iy)``."""
    h, w = hw
    e = float(half_extent)
    fx = torch.nan_to_num(torch.trunc((x + e) / (2 * e) * w), nan=0.0)
    fy = torch.nan_to_num(torch.trunc((y + e) / (2 * e) * h), nan=0.0)
    ix = torch.clamp(fx, 0, w - 1).to(torch.int64)
    iy = torch.clamp(fy, 0, h - 1).to(torch.int64)
    return ix, iy


def bin_grid_plain(hw, half_extent, x, y, w):
    """``[H, W]`` weighted histogram of the hits ``(x, y)`` with weights
    ``w``: the plain version of kernel K3 (JAX ``_bin_grid``).
    Differentiable in ``w`` (the gather); no gradient in ``x`` or ``y``."""
    h, wd = hw
    ix, iy = bin_indices(hw, half_extent, x.detach(), y.detach())
    flat = torch.zeros(h * wd, dtype=w.dtype, device=w.device)
    flat = flat.index_put((iy * wd + ix,), w, accumulate=True)
    return flat.reshape(h, wd)


@dataclasses.dataclass
class SensorState:
    moments: torch.Tensor            # [S, B, 7]
    grid: torch.Tensor               # [S, H, W] ([S, 0, 0] with no grid)

    @classmethod
    def init(cls, cfg: SensorConfig, dtype=torch.float32, device=None):
        s = max(cfg.n_sensors, 1)
        h, w = cfg.grid_shape if cfg.grid_shape else (0, 0)
        return cls(moments=torch.zeros(s, cfg.n_bundles, N_MOMENTS,
                                       dtype=dtype, device=device),
                   grid=torch.zeros(s, h, w, dtype=dtype, device=device))

    def record(self, cfg: SensorConfig, slot, ray_id, hit_local, weight,
               plain=False):
        """Accumulate hits (weight already masked to zero for rays that did
        not hit) into the moments and the grid.  ``slot`` is an int (a
        sequential sensor row) or an ``[N]`` int tensor (the winners of a
        non-sequential bounce): then each slot takes one masked pass.
        ``plain=True`` bins with ``bin_grid_plain`` on any device (the
        kernels' plain versions use it).  Returns a new state
        (autograd-friendly)."""
        n_slots = self.moments.shape[0]
        if isinstance(slot, int):
            slot_ws = [(slot, weight)]
        else:
            slot_ws = [(s, torch.where(slot == s, weight, 0.0))
                       for s in range(n_slots)]
        moments = self.moments
        for s, w in slot_ws:
            terms = moment_terms(hit_local, w)
            cols = []
            for b in range(cfg.n_bundles):
                wb = torch.where(ray_id == b, 1.0, 0.0)
                cols.append(torch.stack([torch.sum(t * wb) for t in terms]))
            delta = torch.stack(cols)                        # [B, 7]
            onehot = torch.zeros(n_slots, 1, 1, dtype=delta.dtype,
                                 device=delta.device)
            onehot[s] = 1.0
            moments = moments + onehot * delta
        grid = self.grid
        if cfg.grid_shape:
            from ..ops.grid import bin_grid
            grid = bin_grid(hit_local[0], hit_local[1], weight, slot, cfg,
                            grid, plain=plain)
        return SensorState(moments=moments, grid=grid)

    def total_weight(self, slot=0):
        return self.moments[slot, :, 0]

    def centroid(self, slot=0):
        """Intensity-weighted centroid per bundle: [B, 2]."""
        m = self.moments[slot]
        w = torch.clamp(m[:, 0], min=1e-12)
        return torch.stack([m[:, 1] / w, m[:, 2] / w], dim=-1)

    def spot_rms(self, slot=0, target_xy=None):
        """Intensity-weighted RMS spot radius about the centroid (or fixed
        targets): [B]."""
        m = self.moments[slot]
        w = torch.clamp(m[:, 0], min=1e-12)
        ex, ey = m[:, 1] / w, m[:, 2] / w
        ex2, ey2 = m[:, 3] / w, m[:, 4] / w
        if target_xy is None:
            var = (ex2 - ex * ex) + (ey2 - ey * ey)
        else:
            tx, ty = target_xy[..., 0], target_xy[..., 1]
            var = (ex2 - 2 * tx * ex + tx * tx) + (ey2 - 2 * ty * ey + ty * ty)
        return torch.sqrt(torch.clamp(var, min=1e-24))

    def spot_moment(self, slot=0, target_xy=None):
        """Per-axis second moment about centroid/target averaged over x and
        y: ([B] spot_size, [B] intensity_sum)."""
        m = self.moments[slot]
        w_raw = m[:, 0]
        w = torch.where(w_raw == 0, 1.0, w_raw)
        ex, ey = m[:, 1] / w, m[:, 2] / w
        ex2, ey2 = m[:, 3] / w, m[:, 4] / w
        if target_xy is None:
            cx, cy = ex, ey
        else:
            cx, cy = target_xy[..., 0], target_xy[..., 1]
        var = (ex2 - 2 * cx * ex + cx * cx) + (ey2 - 2 * cy * ey + cy * cy)
        return var / 2.0, w_raw
