"""Sensor state: streaming moment accumulators.

Counterpart of ``raytracetorch_tpu/core/sensor.py`` (the moment branch;
irradiance grids are kernel K3, ROADMAP Queue 2).  Per sensor slot ``s``
and bundle ``b``:

  moments[s, b] = [sum_w, sum_wx, sum_wy, sum_wx2, sum_wy2, sum_wxy, n_hits]

Centroids, RMS spot radii and second moments follow in closed form.
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


def moment_terms(hit_local, weight):
    """The 7 per-ray moment terms of weighted sensor-local hits."""
    x, y = hit_local[0], hit_local[1]
    return (weight, weight * x, weight * y, weight * x * x,
            weight * y * y, weight * x * y, (weight > 0).to(weight.dtype))


@dataclasses.dataclass
class SensorState:
    moments: torch.Tensor            # [S, B, 7]

    @classmethod
    def init(cls, cfg: SensorConfig, dtype=torch.float32, device=None):
        s = max(cfg.n_sensors, 1)
        return cls(moments=torch.zeros(s, cfg.n_bundles, N_MOMENTS,
                                       dtype=dtype, device=device))

    def record(self, cfg: SensorConfig, slot: int, ray_id, hit_local,
               weight):
        """Accumulate hits into ``slot`` (weight already masked to zero for
        rays that did not hit).  Returns a new state (autograd-friendly)."""
        terms = moment_terms(hit_local, weight)
        cols = []
        for b in range(cfg.n_bundles):
            wb = torch.where(ray_id == b, 1.0, 0.0)
            cols.append(torch.stack([torch.sum(t * wb) for t in terms]))
        delta = torch.stack(cols)                        # [B, 7]
        onehot = torch.zeros(self.moments.shape[0], 1, 1,
                             dtype=delta.dtype, device=delta.device)
        onehot[slot] = 1.0
        return SensorState(moments=self.moments + onehot * delta)

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
