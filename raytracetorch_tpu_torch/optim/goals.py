"""Optimization goals (losses) for lens design.

Counterpart of ``raytracetorch_tpu/optim/goals.py``.  Each goal is a
differentiable scalar of a trace's sensor moments or of the scene's
paraxial matrix.
"""

from __future__ import annotations

import torch


def focal_length_loss(scene, params, f_target):
    """Squared error of the system paraxial power against 1/f_target."""
    M = scene.paraxial(params)
    return (-M[1, 0] - 1.0 / f_target) ** 2


def spot_size_loss(sensors, slot=0, target_xy=None, weights=None):
    """Mean intensity-weighted RMS spot radius across bundles; bundles with
    no recorded hits are left out of the mean."""
    rms = sensors.spot_rms(slot, target_xy)          # [B]
    present = (sensors.total_weight(slot) > 0).to(rms.dtype)
    if weights is not None:
        present = present * weights
    denom = torch.clamp(torch.sum(present), min=1e-12)
    return torch.sum(rms * present) / denom


def spot_target_loss(sensors, target_xy, slot=0):
    """Mean squared distance of each bundle's centroid to its target
    (``target_xy`` [B, 2] or [2])."""
    c = sensors.centroid(slot)                       # [B, 2]
    t = torch.atleast_2d(torch.as_tensor(target_xy, dtype=c.dtype,
                                         device=c.device)).expand(c.shape)
    present = (sensors.total_weight(slot) > 0).to(c.dtype)
    d2 = torch.sum((c - t) ** 2, dim=-1)
    denom = torch.clamp(torch.sum(present), min=1e-12)
    return torch.sum(d2 * present) / denom
