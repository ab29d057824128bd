"""Sequential trace loop, eager with autograd.

Counterpart of ``raytracetorch_tpu/core/trace.py::trace_sequential`` (the
XLA trace loop).  Each surface row is visited once in table order with its
statically specialized bound and physics formulas; dead rays are masked
no-ops.  The optional streams of the JAX trace loop (opl, field, path/hit
recording, fuzzy apodization, GRIN) are ROADMAP Queue 1 item 12, and the
non-sequential trace is item 13.

This is the differentiable path (``SequentialScene.simulate``); the fused
CUDA kernel (ops/fused_trace.py) runs the same chain forward-only.
"""

from __future__ import annotations

import torch

from ..geom import vec3 as v3
from ..rays.ray import Rays
from .intersect import intersect, normal_world
from .sensor import SensorConfig, SensorState
from .static_dispatch import apply_physics_one


def _surface_step(row, rays: Rays, cfg: SensorConfig, sensors: SensorState,
                  static_meta):
    """Apply one surface interaction to the whole ray batch (masked).

    ``row`` is a SurfaceTable row or a FlatRow (a row of the fused kernel's
    flat table): only its float columns are read; the kinds come from
    ``static_meta``."""
    res = intersect(row, rays.pos_c, rays.dir_c, static_meta)
    active = res['valid'] & (rays.intensity > 0)
    n_w = normal_world(row, res['hit_s'], static_meta)
    new_dir, imod = apply_physics_one(static_meta, row, res['hit_s'],
                                      rays.dir_c, n_w)
    new_pos = v3.fma(rays.pos_c, res['t'], rays.dir_c)
    if static_meta.sensor:
        # sensors record the surface-local hit and the INCOMING intensity
        w = torch.where(active, rays.intensity, 0.0)
        sensors = sensors.record(cfg, static_meta.slot, rays.ray_id,
                                 res['hit_s'], w)
    return rays.masked_update(active, new_pos, new_dir, imod), sensors


def trace_sequential(table, rays: Rays, cfg: SensorConfig = SensorConfig(),
                     static_meta=None):
    """Ordered pass over every surface row; returns ``(rays, sensors,
    aux)`` (``aux`` is empty: the optional streams are not ported yet)."""
    if static_meta is None or len(static_meta) != table.n_surfaces:
        raise ValueError('trace_sequential needs one StaticRowMeta per row '
                         '(SequentialScene.static_meta())')
    dtype = torch.promote_types(rays.px.dtype, table.tw.dtype)
    sensors = SensorState.init(cfg, dtype=dtype, device=rays.px.device)
    for k, meta in enumerate(static_meta):
        rays, sensors = _surface_step(table.row(k), rays, cfg, sensors, meta)
    return rays, sensors, {}
