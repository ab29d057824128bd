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
(ops/phase_grid.py).  The deterministic optional streams of the JAX trace
loops are ported (``Streams``): ``track_opl`` (the optical path length
``aux['opl']`` and the index of the final medium ``aux['n_final']``),
``record_paths`` (``aux['paths']``) and ``record_hits`` (``aux['hits']``,
``aux['hit_weights']`` and, non-sequentially, ``aux['hit_slots']``), with
the JAX package's keys, shapes and meaning.  Fuzzy apodization
(``fuzzy_fns``, {row: callable}, ``Scene.fuzzy_fns``) multiplies a row's
intensity factor by its callable of the surface-local hit after the row's
physics (elements/aperture.py::call_fuzzy), in both loops, as the
reference's do; any callable runs here.  ``trace_sequential`` carries the
polarized field (``track_field``, the launch field ``E0``;
core/field.py): each row's physics sees the incoming field (the polarized
Fresnel reflectance), its sensor weight is ``intensity * |E|^2``, and the
field is transported after the row where it is active (through coated
interfaces and metal mirrors with their amplitudes); ``aux['field']`` and
``aux['field_power']`` hold the final state.  ``trace_nonsequential``
carries it the same way: each row's physics sees the field at the bounce's
start, the winner's sensor record weighs by ``intensity * |E|^2`` and the
winner transports the field.  A GRIN rod (core/grin.py) is one volumetric
interaction in both loops: its entry plane's hit runs the whole entry
coupling, RK4 through the profile and exit coupling, landing the ray at the
exit face (sequentially the row, non-sequentially the bounce it wins, for
rays travelling +z in the rod frame), with the in-medium optical path added
to ``opl``, the ambient index as the medium after it, the exit-face world
position recorded with weight 0 and, under the field, the field
parallel-transported along the ray.  Rows of the kinds the port lacks
(scatter) raise through ``unsupported``.  A solid's faces
(HALFSPACES) read their row's half-space columns in both loops, a flat
row's mask as float 0/1.

The Fresnel kinds FRESNEL_W and REFLECT_W are deterministic; FRESNEL draws
one uniform per ray (rays/draws.py).  ``trace_sequential`` takes the
caller's ``generator`` (one ``[N]`` stream per FRESNEL row, pre-drawn in
row order, ``[F, N]``) or the streams themselves (``uniforms``); the
non-sequential loops take ``generator`` (two Philox seed words drawn once)
or injected ``draws(bounce, row) -> [N]``, and each bounce draws the
counter-based value of (ray, bounce, row), so the host-side early stop
changes no draw.  A table with a FRESNEL row and no source of draws raises
ValueError: a trace never draws from a default seed.  A REFLECT_W row
defines a ghost path (utils/ghosts.py): a ray that misses it leaves the
sequential trace with intensity 0, as the JAX package's ``_surface_step``
kills it.

These are the eager differentiable paths (``simulate``); the fused CUDA
kernels run the same functions (ops/fused_trace.py for the chain,
ops/fused_nonseq.py for the bounce loop), and their plain versions are
these loops over the flat rows with ``plain=True``.
"""

from __future__ import annotations

import torch

from ..constants import BIG, PhysKind
from ..geom import vec3 as v3
from ..rays.draws import nonseq_draws, sequential_uniforms, stream_index
from ..elements.aperture import call_fuzzy
from ..rays.ray import Rays
from .field import FieldState, transport_field
from .grin import grin_interaction, grin_surface_step
from .intersect import intersect, normal_world
from .sensor import SensorConfig, SensorState
from .static_dispatch import apply_physics_one, medium_after, unsupported


class Streams:
    """The optional per-ray streams of a trace: the optical path length and
    the medium index (``track_opl``), the positions after each row or bounce
    (``record_paths``; a sequential trace's start with the launch
    position, ``launch``) and the hit records (``record_hits``).  ``aux()``
    returns them with the JAX package's keys and shapes."""

    def __init__(self, rays: Rays, record_paths=False, record_hits=False,
                 track_opl=False, launch=True):
        self.paths = (([v3.to_array(rays.pos_c)] if launch else [])
                      if record_paths else None)
        self.hits = [] if record_hits else None
        self.weights, self.slots = [], []
        self.opl = torch.zeros_like(rays.intensity) if track_opl else None
        self.n_cur = torch.ones_like(rays.intensity) if track_opl else None

    @staticmethod
    def of(rays, record_paths=False, record_hits=False, track_opl=False,
           launch=True):
        """``Streams`` when any stream is asked for, else None."""
        if record_paths or record_hits or track_opl:
            return Streams(rays, record_paths, record_hits, track_opl, launch)
        return None

    def surface(self, meta, row, prev: Rays, out: Rays, res, n_w, active,
                u=None, field=None):
        """A sequential row: opl += n_cur t where active, then the medium
        after the row (``medium_after``, a FRESNEL row's with its draw
        ``u`` and, under the field, the incoming ``field``); the position
        after the row; the RAW surface-local hit of every ray and, as its
        weight, the intensity after the row where active (0 elsewhere), on
        every row."""
        if self.opl is not None:
            self.opl = self.opl + torch.where(active, self.n_cur * res['t'],
                                              0.0)
            n_next = medium_after(meta, row, prev.dir_c, n_w,
                                  prev.wavelength, u, field)
            if n_next is not None:
                self.n_cur = torch.where(active, n_next, self.n_cur)
        if self.paths is not None:
            self.paths.append(v3.to_array(out.pos_c))
        if self.hits is not None:
            self.hits.append(v3.to_array(res['hit_s']))
            self.weights.append(torch.where(active, out.intensity, 0.0))

    def grin(self, row, out: Rays, active, t_entry, seg_opl):
        """A sequential GRIN row: opl += n_cur t + the in-medium path where
        active, then the ambient index ph[0]; the exit-face position after
        the row, recorded as the row's hit with weight 0."""
        if self.opl is not None:
            self.opl = self.opl + torch.where(active, self.n_cur * t_entry
                                              + seg_opl, 0.0)
            self.n_cur = torch.where(active, row.ph[..., 0], self.n_cur)
        if self.paths is not None:
            self.paths.append(v3.to_array(out.pos_c))
        if self.hits is not None:
            self.hits.append(v3.to_array(out.pos_c))
            self.weights.append(torch.zeros_like(out.intensity))

    def bounce(self, out: Rays, best_t, active, n_next, hit, weight, slot,
               grin_opl=None):
        """A non-sequential bounce: opl += n_cur best_t where a row won
        (plus ``grin_opl``, a winning rod's in-medium path), then the
        winner's medium ``n_next``; the position after the bounce; the
        winning sensor's local hit, its INCOMING intensity and its slot (0,
        0 and 0 where no sensor won)."""
        if self.opl is not None:
            self.opl = self.opl + torch.where(active, self.n_cur * best_t,
                                              0.0)
            if grin_opl is not None:
                self.opl = self.opl + grin_opl
            self.n_cur = torch.where(active, n_next, self.n_cur)
        self.settled(out, hit, weight, slot)

    def settled(self, out: Rays, hit=None, weight=None, slot=None):
        """Record one bounce in which nothing moves (after the loop
        stopped): the position unchanged, zero hits, weights and slots, as
        the JAX loop's dead branch records them."""
        if self.paths is not None:
            self.paths.append(v3.to_array(out.pos_c))
        if self.hits is not None:
            zero = torch.zeros_like(out.intensity)
            self.hits.append(v3.to_array(hit if hit is not None
                                         else (zero, zero, zero)))
            self.weights.append(weight if weight is not None else zero)
            self.slots.append(slot if slot is not None
                              else torch.zeros_like(zero, dtype=torch.int32))

    def aux(self):
        aux = {}
        if self.paths is not None:
            aux['paths'] = torch.stack(self.paths)
        if self.hits is not None:
            aux['hits'] = torch.stack(self.hits)
            aux['hit_weights'] = torch.stack(self.weights)
            if self.slots:
                aux['hit_slots'] = torch.stack(self.slots)
        if self.opl is not None:
            aux['opl'] = self.opl
            aux['n_final'] = self.n_cur
        return aux


def _surface_step(row, rays: Rays, cfg: SensorConfig, sensors: SensorState,
                  static_meta, plain=False, grid=None, streams=None, u=None,
                  fuzzy_fn=None, field=None):
    """Apply one surface interaction to the whole ray batch (masked) ->
    ``(rays, sensors, field)``.

    ``row`` is a SurfaceTable row or a FlatRow (a row of the fused kernel's
    flat table): only its float columns are read; the kinds come from
    ``static_meta``.  ``grid`` is the row's phase map (PHASE_GRID rows),
    ``u`` its ``[N]`` uniforms (FRESNEL rows), ``fuzzy_fn`` its apodization
    callable (None: none).  ``plain=True`` bins the grid
    and reads the map's corners with their plain versions on any device.
    ``streams`` (a ``Streams``) records the row.  A ray that misses a
    REFLECT_W row leaves the path: its intensity becomes 0.  ``field`` (a
    FieldState; None: no field) drives the polarized Fresnel reflectance,
    weighs the sensor record by |E|^2 and is transported where the row is
    active."""
    res = intersect(row, rays.pos_c, rays.dir_c, static_meta)
    active = res['valid'] & (rays.intensity > 0)
    n_w = normal_world(row, res['hit_s'], static_meta)
    new_dir, imod = apply_physics_one(static_meta, row, res['hit_s'],
                                      rays.dir_c, n_w, rays.wavelength,
                                      grid, plain, u, field)
    if fuzzy_fn is not None:
        imod = imod * call_fuzzy(fuzzy_fn, res['hit_s'])
    new_pos = v3.fma(rays.pos_c, res['t'], rays.dir_c)
    if static_meta.sensor:
        # sensors record the surface-local hit and the INCOMING intensity
        # (times the incoming |E|^2 under the field)
        w = torch.where(active, rays.intensity, 0.0)
        if field is not None:
            w = w * field.power()
        sensors = sensors.record(cfg, static_meta.slot, rays.ray_id,
                                 res['hit_s'], w, plain=plain)
    out = rays.masked_update(active, new_pos, new_dir, imod)
    if static_meta.ph == PhysKind.REFLECT_W:
        out = out.replace(intensity=torch.where(active, out.intensity, 0.0))
    if streams is not None:
        streams.surface(static_meta, row, rays, out, res, n_w, active, u,
                        field)
    if field is not None:
        field = field.masked(active, *transport_field(
            static_meta, row, rays.dir_c, new_dir, n_w, imod, field.r_c,
            field.i_c, rays.wavelength))
    return out, sensors, field


def surface_chain(rows, rays: Rays, cfg: SensorConfig, static_meta, dtype,
                  plain=False, grids=None, streams=None, uniforms=None,
                  fuzzy_fns=None, field=None):
    """The sequential chain over ``rows`` (one per static_meta entry) ->
    ``(rays, sensors)``, with a launch ``field`` (a FieldState) ``(rays,
    sensors, field)``; ``streams`` records every row; ``uniforms`` holds
    the FRESNEL rows' ``[F, N]`` draws in row order (rays/draws.py);
    ``fuzzy_fns`` maps a row to its apodization callable."""
    sensors = SensorState.init(cfg, dtype=dtype, device=rays.px.device)
    first = stream_index(static_meta)
    traced = field is not None
    for k, meta in enumerate(static_meta):
        if meta.ph == PhysKind.GRIN:
            rays, active, t_entry, seg_opl, field = grin_surface_step(
                rows[k], meta, rays, field)
            if streams is not None:
                streams.grin(rows[k], rays, active, t_entry, seg_opl)
            continue
        u = uniforms[first[k]] if k in first else None
        rays, sensors, field = _surface_step(
            rows[k], rays, cfg, sensors, meta, plain=plain,
            grid=(grids or {}).get(k), streams=streams, u=u,
            fuzzy_fn=(fuzzy_fns or {}).get(k), field=field)
    return (rays, sensors, field) if traced else (rays, sensors)


def trace_sequential(table, rays: Rays, cfg: SensorConfig = SensorConfig(),
                     static_meta=None, grids=None, record_paths=False,
                     record_hits=False, track_opl=False, track_field=False,
                     E0=None, fuzzy_fns=None, generator=None, uniforms=None):
    """Ordered pass over every surface row; returns ``(rays, sensors,
    aux)``.  ``grids`` maps each PHASE_GRID row to its ``[H, W]`` phase
    map.  A table with FRESNEL rows reads one ``[N]`` uniform stream per
    such row, in row order: ``uniforms`` (``[F, N]``) when given, else drawn
    from ``generator`` (a ``torch.Generator``; rays/draws.py::row_uniforms);
    with neither it raises ValueError.  ``fuzzy_fns`` maps a row to its
    apodization callable (either calling style).  ``aux`` holds the streams
    asked for (``Streams``): ``paths [K+1, N, 3]`` (the launch position, then the
    position after each row), ``hits [K, N, 3]`` and ``hit_weights [K, N]``,
    ``opl`` and ``n_final`` ``[N]``.  ``track_field=True`` carries the
    polarized field from ``E0`` (core/field.py::FieldState.init; None:
    x-linear): the sensor moments and grids weigh by ``intensity * |E|^2``
    and ``aux`` holds ``field`` (the final FieldState) and ``field_power``
    (its |E|^2); ``E0`` without ``track_field`` is ignored, as in the JAX
    package."""
    if static_meta is None or len(static_meta) != table.n_surfaces:
        raise ValueError('trace_sequential needs one StaticRowMeta per row '
                         '(SequentialScene.static_meta())')
    u = sequential_uniforms(static_meta, rays.n, rays.px.device, generator,
                            uniforms)
    dtype = torch.promote_types(rays.px.dtype, table.tw.dtype)
    streams = Streams.of(rays, record_paths, record_hits, track_opl)
    rows = [table.row(k) for k in range(table.n_surfaces)]
    res = surface_chain(rows, rays, cfg, static_meta, dtype, grids=grids,
                        streams=streams, uniforms=u, fuzzy_fns=fuzzy_fns,
                        field=(FieldState.init(rays, E0) if track_field
                               else None))
    aux = streams.aux() if streams is not None else {}
    if track_field:
        aux['field'] = res[2]
        aux['field_power'] = res[2].power()
    return res[0], res[1], aux


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
                static_meta, plain=False, grids=None, streams=None,
                draws=None, bounce=0, fuzzy_fns=None, field=None):
    """One non-sequential bounce -> ``(rays, sensors, active [N])``, with a
    ``field`` (a FieldState) ``(rays, sensors, active, field)``.

    ``rows`` holds one row per table row (SurfaceTable rows or FlatRows);
    ``grids`` maps each PHASE_GRID row to its phase map; ``draws(bounce,
    row) -> [N]`` gives a FRESNEL row's uniforms at bounce ``bounce``
    (rays/draws.py::NonseqDraws; every row draws its own, so drawing them
    all and selecting the winner's equals drawing the winner's alone).
    Each row's intersection and physics are computed once for all rays and
    where-merged into the running nearest hit; comparisons have no
    derivative, so gradients flow through the winner's computation alone.
    A nearer non-sensor winner zeroes an earlier sensor crossing.
    ``streams`` records the bounce: the winner's medium is written for
    every winner (a non-refracting one keeps ``n_cur``), so a nearer mirror
    overtaking a refracting candidate leaves no stale medium.
    ``fuzzy_fns`` maps a row to its apodization callable, which multiplies
    that row's factor before the merge.  Under the ``field`` every row's
    physics sees the field at the bounce's start, the sensor weight (and
    the recorded hit weight) is ``intensity * |E|^2`` of that field, and
    the winner's transport (core/field.py::transport_field) is merged like
    its direction."""
    pos, d = rays.pos_c, rays.dir_c
    best_t = torch.full_like(rays.intensity, BIG)
    new_pos, new_dir = pos, d
    imod_all = torch.ones_like(rays.intensity)
    active_any = torch.zeros_like(rays.intensity, dtype=torch.bool)
    zero = torch.zeros_like(rays.intensity)
    sens_hit = (zero, zero, zero)        # the winning sensor-local hit
    sens_w = zero                        # its weight (0: no sensor won)
    sens_slot = torch.zeros_like(rays.intensity, dtype=torch.int32)
    track_opl = streams is not None and streams.opl is not None
    n_next = streams.n_cur if track_opl else None
    live = rays.intensity > 0
    w_in = rays.intensity
    if field is not None:
        w_in = w_in * field.power()
        er_acc, ei_acc = field.r_c, field.i_c
    has_grin = any(m.ph == PhysKind.GRIN for m in static_meta)
    grin_opl = zero if has_grin and track_opl else None
    for k, (row, meta) in enumerate(zip(rows, static_meta)):
        res = intersect(row, pos, d, meta)
        if meta.ph == PhysKind.GRIN:
            # the rod's entry face winning the bounce makes the whole
            # entry -> RK4 -> exit step the bounce's interaction; a backward
            # ray never couples in (fwd): its hit is a miss
            g = grin_interaction(
                row, meta, d, res['hit_s'],
                Er=field.r_c if field is not None else None,
                Ei=field.i_c if field is not None else None)
            mask = (res['t'] < best_t) & res['valid'] & g[3] & live
            best_t = torch.where(mask, res['t'], best_t)
            new_pos = v3.where(mask, g[0], new_pos)
            new_dir = v3.where(mask, g[1], new_dir)
            imod_all = torch.where(mask, torch.where(g[2], 1.0, 0.0),
                                   imod_all)
            active_any = active_any | mask
            if field is not None:
                er_acc = v3.where(mask, g[5], er_acc)
                ei_acc = v3.where(mask, g[6], ei_acc)
            if track_opl:
                grin_opl = torch.where(mask, g[4], grin_opl)
                n_next = torch.where(mask, row.ph[..., 0], n_next)
            # a nearer rod win zeroes an earlier sensor crossing
            sens_w = torch.where(mask, 0.0, sens_w)
            continue
        mask = (res['t'] < best_t) & res['valid'] & live
        best_t = torch.where(mask, res['t'], best_t)
        if grin_opl is not None:
            # a nearer non-GRIN winner clears a stale rod in-medium path
            grin_opl = torch.where(mask, 0.0, grin_opl)
        n_w = normal_world(row, res['hit_s'], meta)
        u = draws(bounce, k) if meta.ph == PhysKind.FRESNEL else None
        dir_k, imod_k = apply_physics_one(meta, row, res['hit_s'], d, n_w,
                                          rays.wavelength,
                                          (grids or {}).get(k), plain, u,
                                          field)
        if k in (fuzzy_fns or {}):
            imod_k = imod_k * call_fuzzy(fuzzy_fns[k], res['hit_s'])
        new_pos = v3.where(mask, v3.fma(pos, res['t'], d), new_pos)
        new_dir = v3.where(mask, dir_k, new_dir)
        imod_all = torch.where(mask, imod_k, imod_all)
        active_any = active_any | mask
        if field is not None:
            er_k, ei_k = transport_field(meta, row, d, dir_k, n_w, imod_k,
                                         field.r_c, field.i_c,
                                         rays.wavelength)
            er_acc = v3.where(mask, er_k, er_acc)
            ei_acc = v3.where(mask, ei_k, ei_acc)
        if track_opl:
            n_k = medium_after(meta, row, d, n_w, rays.wavelength, u, field)
            n_next = torch.where(mask, n_k if n_k is not None
                                 else streams.n_cur, n_next)
        if meta.sensor:
            sens_hit = v3.where(mask, res['hit_s'], sens_hit)
            sens_w = torch.where(mask, w_in, sens_w)
            sens_slot = torch.where(mask, meta.slot, sens_slot)
        else:
            sens_w = torch.where(mask, 0.0, sens_w)
    sensors = sensors.record(cfg, sens_slot, rays.ray_id, sens_hit, sens_w,
                             plain=plain)
    rays = rays.masked_update(active_any, new_pos, new_dir, imod_all)
    if streams is not None:
        streams.bounce(rays, torch.where(active_any, best_t, 0.0), active_any,
                       n_next, sens_hit, sens_w, sens_slot, grin_opl)
    if field is None:
        return rays, sensors, active_any
    return rays, sensors, active_any, field.masked(active_any, er_acc,
                                                   ei_acc)


def bounce_loop(rows, rays: Rays, n_bounces: int, cfg: SensorConfig,
                static_meta, dtype, plain=False, grids=None, streams=None,
                draws=None, fuzzy_fns=None, field=None):
    """Up to ``n_bounces`` bounce steps, stopping after the first bounce in
    which no ray interacted -> ``(rays, sensors)``, with a launch ``field``
    (a FieldState) ``(rays, sensors, field)``.  ``streams`` records every
    bounce of the full budget: the bounces after the stop as settled
    (``Streams.settled``).  ``draws`` as for ``bounce_step`` (None: no row
    draws); the stop changes no draw, each being a function of its
    bounce.  ``fuzzy_fns`` as for ``bounce_step``."""
    sensors = SensorState.init(cfg, dtype=dtype, device=rays.px.device)
    traced = field is not None
    for b in range(n_bounces):
        res = bounce_step(rows, rays, cfg, sensors, static_meta, plain=plain,
                          grids=grids, streams=streams, draws=draws, bounce=b,
                          fuzzy_fns=fuzzy_fns, field=field)
        rays, sensors, act = res[:3]
        if traced:
            field = res[3]
        if not bool(act.any()):
            if streams is not None:
                for _ in range(b + 1, n_bounces):
                    streams.settled(rays)
            break
    return (rays, sensors, field) if traced else (rays, sensors)


def trace_nonsequential(table, rays: Rays, n_bounces: int,
                        cfg: SensorConfig = SensorConfig(), static_meta=None,
                        record_paths=False, record_hits=False,
                        track_field=False, E0=None, track_opl=False,
                        fuzzy_fns=None, grids=None, generator=None,
                        draws=None):
    """Bounce loop within a budget of ``n_bounces`` (the reference's
    ``Scene.simulate``); returns ``(rays, sensors, aux)``.  ``grids`` maps
    each PHASE_GRID row to its ``[H, W]`` phase map.  A table with FRESNEL
    rows draws from ``generator`` (two Philox seed words, drawn once) or
    from ``draws(bounce, row) -> [N]`` (injected;
    rays/draws.py::nonseq_draws); with neither it raises ValueError.
    ``fuzzy_fns`` as for ``trace_sequential``.  ``aux`` holds the streams
    asked for: ``paths [B, N, 3]`` (the position
    after each bounce of the full budget B), ``hits [B, N, 3]``,
    ``hit_weights [B, N]`` and ``hit_slots [B, N]`` int32 (the winning
    sensor's local hit, the incoming intensity (times |E|^2 under the
    field) and the slot; a nearer non-sensor winner zeroes the weight),
    ``opl`` and ``n_final`` ``[N]``.  ``track_field`` and ``E0`` as for
    ``trace_sequential`` (``bounce_step`` says what the field does in a
    bounce): ``aux`` then holds ``field`` and ``field_power``."""
    if static_meta is None or len(static_meta) != table.n_surfaces:
        raise ValueError('trace_nonsequential needs one StaticRowMeta per '
                         'row (Scene.static_meta())')
    for k, meta in enumerate(static_meta):
        why = unsupported(meta)
        if why:
            raise NotImplementedError(f'non-sequential trace, row {k}: {why}')
    rng = nonseq_draws(static_meta, rays.n, rays.px.device, generator, draws)
    rows = [table.row(k) for k in range(table.n_surfaces)]
    dtype = torch.promote_types(rays.px.dtype, table.tw.dtype)
    streams = Streams.of(rays, record_paths, record_hits, track_opl,
                         launch=False)
    res = bounce_loop(rows, rays, n_bounces, cfg, static_meta, dtype,
                      grids=grids, streams=streams, draws=rng,
                      fuzzy_fns=fuzzy_fns,
                      field=(FieldState.init(rays, E0) if track_field
                             else None))
    aux = streams.aux() if streams is not None else {}
    if track_field:
        aux['field'] = res[2]
        aux['field_power'] = res[2].power()
    return res[0], res[1], aux
