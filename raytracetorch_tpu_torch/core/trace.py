"""Trace loops, eager with autograd: the sequential chain and the
non-sequential bounce loop.

Counterpart of ``raytracetorch_tpu/core/trace.py``:

- ``trace_sequential`` visits each surface row once in table order with its
  statically specialized bound and physics formulas; dead rays are masked
  no-ops.
- ``trace_nonsequential`` runs the bounce loop: per bounce, ``bounce_step``
  intersects every row and merges the nearest valid hit in one pass
  (``valid & (t < best_t) & (intensity > 0)``, so the first of equal rows
  wins, the argmin's tie rule), applies the winner's physics, and records
  the FINAL winner's sensor crossing with the incoming intensity as weight.
  The loop stops after the first bounce in which no ray interacted (one
  host check per bounce, as the reference's ``.any()``); that gives the
  result of the full budget, because such a bounce changes nothing.
- ``nearest_hit`` is the no-grad all-row query behind ``Scene.ray_cast``.

Both loops record the moments and the irradiance grid (core/sensor.py),
and both read the ``[H, W]`` maps of pixelated phase plates through
``grids`` ({flat row: map}, ``Scene.side_grids``), as the reference's
loops do; a PHASE_GRID row reads its corners with kernel K4 on the card
(ops/phase_grid.py).  The optional streams of the JAX trace loops (opl,
field, path/hit recording, fuzzy apodization) are ROADMAP Queue 1 item 12
and raise; so do rows of the kinds the port lacks (GRIN, HALFSPACES,
stochastic Fresnel and scatter), through ``unsupported``.  No supported
kind draws random numbers, so the loops take no key.

These are the eager differentiable paths (``simulate``); the fused CUDA
kernels run the same functions (ops/fused_trace.py for the chain,
ops/fused_nonseq.py for the bounce loop), and their plain versions are
these loops over the flat rows with ``plain=True``.
"""

from __future__ import annotations

import torch

from ..constants import BIG
from ..geom import vec3 as v3
from ..rays.ray import Rays
from .intersect import intersect, normal_world
from .sensor import SensorConfig, SensorState
from .static_dispatch import TODO_FEATURES, apply_physics_one, unsupported


def _surface_step(row, rays: Rays, cfg: SensorConfig, sensors: SensorState,
                  static_meta, plain=False, grid=None):
    """Apply one surface interaction to the whole ray batch (masked).

    ``row`` is a SurfaceTable row or a FlatRow (a row of the fused kernel's
    flat table): only its float columns are read; the kinds come from
    ``static_meta``.  ``grid`` is the row's phase map (PHASE_GRID rows).
    ``plain=True`` bins the grid and reads the map's corners with their
    plain versions on any device."""
    res = intersect(row, rays.pos_c, rays.dir_c, static_meta)
    active = res['valid'] & (rays.intensity > 0)
    n_w = normal_world(row, res['hit_s'], static_meta)
    new_dir, imod = apply_physics_one(static_meta, row, res['hit_s'],
                                      rays.dir_c, n_w, rays.wavelength,
                                      grid, plain)
    new_pos = v3.fma(rays.pos_c, res['t'], rays.dir_c)
    if static_meta.sensor:
        # sensors record the surface-local hit and the INCOMING intensity
        w = torch.where(active, rays.intensity, 0.0)
        sensors = sensors.record(cfg, static_meta.slot, rays.ray_id,
                                 res['hit_s'], w, plain=plain)
    return rays.masked_update(active, new_pos, new_dir, imod), sensors


def trace_sequential(table, rays: Rays, cfg: SensorConfig = SensorConfig(),
                     static_meta=None, grids=None):
    """Ordered pass over every surface row; returns ``(rays, sensors,
    aux)`` (``aux`` is empty: the optional streams are not ported yet).
    ``grids`` maps each PHASE_GRID row to its ``[H, W]`` phase map."""
    if static_meta is None or len(static_meta) != table.n_surfaces:
        raise ValueError('trace_sequential needs one StaticRowMeta per row '
                         '(SequentialScene.static_meta())')
    dtype = torch.promote_types(rays.px.dtype, table.tw.dtype)
    sensors = SensorState.init(cfg, dtype=dtype, device=rays.px.device)
    for k, meta in enumerate(static_meta):
        rays, sensors = _surface_step(table.row(k), rays, cfg, sensors, meta,
                                      grid=(grids or {}).get(k))
    return rays, sensors, {}


def nearest_hit(table, pos, direction, static_meta):
    """All-row nearest-hit query under no_grad (the reference's
    ``Scene.ray_cast``).  ``pos``/``direction`` are component tuples of
    [N].  Returns ``(winner row [N], hit mask [N])``; of equal rows the
    first wins."""
    with torch.no_grad():
        ts = []
        for k, meta in enumerate(static_meta):
            res = intersect(table.row(k), pos, direction, meta)
            ts.append(torch.where(res['valid'], res['t'], BIG))
        t_all = torch.stack(ts)                       # [K, N]
        t_min, win = torch.min(t_all, dim=0)
    return win, t_min < BIG * 0.5


def bounce_step(rows, rays: Rays, cfg: SensorConfig, sensors: SensorState,
                static_meta, plain=False, grids=None):
    """One non-sequential bounce -> ``(rays, sensors, active [N])``.

    ``rows`` holds one row per table row (SurfaceTable rows or FlatRows);
    ``grids`` maps each PHASE_GRID row to its phase map.
    Each row's intersection and physics are computed once for all rays and
    where-merged into the running nearest hit; comparisons have no
    derivative, so gradients flow through the winner's computation alone.
    A nearer non-sensor winner zeroes an earlier sensor crossing."""
    pos, d = rays.pos_c, rays.dir_c
    best_t = torch.full_like(rays.intensity, BIG)
    new_pos, new_dir = pos, d
    imod_all = torch.ones_like(rays.intensity)
    active_any = torch.zeros_like(rays.intensity, dtype=torch.bool)
    zero = torch.zeros_like(rays.intensity)
    sens_hit = (zero, zero, zero)        # the winning sensor-local hit
    sens_w = zero                        # its weight (0: no sensor won)
    sens_slot = torch.zeros_like(rays.intensity, dtype=torch.int32)
    live = rays.intensity > 0
    for k, (row, meta) in enumerate(zip(rows, static_meta)):
        res = intersect(row, pos, d, meta)
        mask = (res['t'] < best_t) & res['valid'] & live
        best_t = torch.where(mask, res['t'], best_t)
        n_w = normal_world(row, res['hit_s'], meta)
        dir_k, imod_k = apply_physics_one(meta, row, res['hit_s'], d, n_w,
                                          rays.wavelength,
                                          (grids or {}).get(k), plain)
        new_pos = v3.where(mask, v3.fma(pos, res['t'], d), new_pos)
        new_dir = v3.where(mask, dir_k, new_dir)
        imod_all = torch.where(mask, imod_k, imod_all)
        active_any = active_any | mask
        if meta.sensor:
            sens_hit = v3.where(mask, res['hit_s'], sens_hit)
            sens_w = torch.where(mask, rays.intensity, sens_w)
            sens_slot = torch.where(mask, meta.slot, sens_slot)
        else:
            sens_w = torch.where(mask, 0.0, sens_w)
    sensors = sensors.record(cfg, sens_slot, rays.ray_id, sens_hit, sens_w,
                             plain=plain)
    rays = rays.masked_update(active_any, new_pos, new_dir, imod_all)
    return rays, sensors, active_any


def bounce_loop(rows, rays: Rays, n_bounces: int, cfg: SensorConfig,
                static_meta, dtype, plain=False, grids=None):
    """Up to ``n_bounces`` bounce steps, stopping after the first bounce in
    which no ray interacted -> ``(rays, sensors)``."""
    sensors = SensorState.init(cfg, dtype=dtype, device=rays.px.device)
    for _ in range(n_bounces):
        rays, sensors, act = bounce_step(rows, rays, cfg, sensors,
                                         static_meta, plain=plain,
                                         grids=grids)
        if not bool(act.any()):
            break
    return rays, sensors


def trace_nonsequential(table, rays: Rays, n_bounces: int,
                        cfg: SensorConfig = SensorConfig(), static_meta=None,
                        record_paths=False, record_hits=False,
                        track_field=False, E0=None, track_opl=False,
                        fuzzy_fns=None, grids=None):
    """Bounce loop within a budget of ``n_bounces`` (the reference's
    ``Scene.simulate``); returns ``(rays, sensors, aux)`` (``aux`` is
    empty: the optional streams are not ported yet and raise).  ``grids``
    maps each PHASE_GRID row to its ``[H, W]`` phase map."""
    if static_meta is None or len(static_meta) != table.n_surfaces:
        raise ValueError('trace_nonsequential needs one StaticRowMeta per '
                         'row (Scene.static_meta())')
    if (record_paths or record_hits or track_field or E0 is not None
            or track_opl or fuzzy_fns):
        raise NotImplementedError(
            'record_paths, record_hits, track_field, track_opl and fuzzy '
            f'apodization are {TODO_FEATURES}')
    for k, meta in enumerate(static_meta):
        why = unsupported(meta)
        if why:
            raise NotImplementedError(f'non-sequential trace, row {k}: {why}')
    rows = [table.row(k) for k in range(table.n_surfaces)]
    dtype = torch.promote_types(rays.px.dtype, table.tw.dtype)
    rays, sensors = bounce_loop(rows, rays, n_bounces, cfg, static_meta,
                                dtype, grids=grids)
    return rays, sensors, {}
