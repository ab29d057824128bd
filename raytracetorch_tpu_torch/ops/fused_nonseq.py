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
  ``fused_trace.EXT_LAUNCHES``, one with the streams in
  ``fused_trace.STREAM_LAUNCHES``).
- The deterministic streams go as in ops/fused_trace.py: K5's
  instantiation with them writes ``opl``, ``n_final`` and the per-bounce
  records of the full budget (the bounces after a ray left its loop
  settled, as the JAX loop's dead branch records them), ``FusedNonseqStreams``
  returns them, and its backward is K6 with the cotangents of ``opl`` and
  ``n_final``, or on a recording run the eager bounce loop under autograd
  (``fused_trace.plain_vjp``), as the reference's ``_fused_nonseq_bwd``
  recomputes through its XLA trace.
- The families of kinds (``fused_trace.families``: the Fresnel kinds,
  coatings and metal mirrors, the diffractive and ideal elements, fuzzy
  apodization, freeform surfaces, GRIN rods) run K5's and K6's family
  instantiation, which compiles them together, so a Scene may mix them (a
  table of one family runs its chain link, as in ops/fused_trace.py);
  each launch passes the table's families as a bit word and each family's
  side data (``side_buffers``, None where the table lacks the family), and
  counts once in each of its families' counters (``fused_trace.
  count_launch``).  FRESNEL draws the counter-based Philox value of (ray,
  bounce, row) under the trace's two seed words (drawn once from the
  caller's ``generator``: rays/draws.py), in K5, K6's replay and the plain
  versions alike, so K6 replays K5's branches by their counters.  As the
  reference's ``_fused_nonseq_bwd`` does, a recording run's backward
  raises on a drawing scene.  A fuzzy winner's factor is multiplied by its
  program's value, the scan refines a freeform row's roots onto its sag,
  and a GRIN rod's entry face wins only a ray travelling +z in the rod
  frame, the winner running the whole rod once (csrc/grin.cuh), where the
  JAX kernel runs it for every candidate row: in K5 and K6's replay
  alike.
- The polarized field (``track_field``, ``E0``; core/field.py) runs in the
  field's instantiations of K5 and K6, which read the table's families as
  the family instantiation does: one compiles every family but GRIN rods,
  and a table with a rod runs one that compiles every family, a winning rod
  carrying the field through its couplings and steps.  Their launches count
  in ``fused_trace.FIELD_LAUNCHES`` (a table with a rod's also in
  ``fused_trace.GRIN_LAUNCHES``).  The launch field is made in
  torch (``FieldState.init``, so ``E0``'s cotangent flows there) and
  enters the kernels as six planar streams; K5 returns the final field's
  six (``aux['field']``, ``aux['field_power']``) and K6 takes their
  cotangents and returns the launch field's.
- K6 keeps its checkpoints (``K6_CHECKPOINTS`` bounces of
  ``K6_STATE_WORDS`` words, with the field ``K6_FIELD_CHECKPOINTS`` of
  ``K6_FIELD_STATE_WORDS``) beside the families' side data and warp slots
  (32 ff columns a row with freeform surfaces) in at most
  ``MAX_SHARED_BYTES`` of shared memory a block (``k6_shared_bytes``): a
  table that needs more (about 32 freeform rows at 13 checkpoints) raises
  NotImplementedError when it would run backward (``check_freeform_shared``,
  ``check_field_shared``), on either device.
- K5 and K6 keep each thread's moment sums of at most ``MAX_MOMENT_PAIRS``
  (64) (slot, bundle) pairs (in local memory, the bucket of 64 of
  csrc/trace_nonseq_fwd.cu): a scene with more raises NotImplementedError
  before anything runs, on either device, where K1 and K2 take every pair
  of 8 slots and 18 bundles.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..core.field import FieldState
from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.table import FlatRow
from ..core.trace import Streams, bounce_loop
from ..rays.draws import NonseqDraws, needs_draws, nonseq_draws
from . import fused_trace
from .fused_trace import (COAT_SIDE, COMPS, FAM_COAT, FAM_DIFF,
                          FAM_FREEFORM, FAM_FUZZY, FF_SIDE, FIELD_KEYS,
                          NO_STREAMS, StreamFlags, THREADS,
                          backward_result, check_cotangents, check_inputs,
                          check_streams, coat_side, count_launch,
                          diffractive_kinds, dispersive, dispersive_kinds,
                          ext_kinds, ext_maps, families, family_args,
                          family_bits, ff_side, field_aux,
                          field_buffer, field_kinds, flat_inputs,
                          fresnel_kinds, fused_forward,
                          fuzzy_buffer, TraceMeta,
                          grin_of, grin_kinds,
                          grad_cols, grid_args, kernel, needs_grad, new_grid,
                          plain_vjp, plate_args, plate_buffers, plate_inputs,
                          plate_maps, plate_rows, ptr, saved_field,
                          saved_inputs, stream, stream_args, stream_aux,
                          stream_buffers, stream_cotangents,
                          table_and_map_cotangents, unpack)

NONSEQ_LAUNCHES = 0       # kernel launches by trace_nonseq_fwd_cuda (K5)
NONSEQ_BWD_LAUNCHES = 0   # kernel launches by trace_nonseq_bwd_cuda (K6)
# the (slot, bundle) pairs whose moment sums a thread of K5 and K6 holds
MAX_MOMENT_PAIRS = 64
# the shared memory a block may take on an H100 (227 KB), and K6's
# checkpointed bounces (kCkpt) of 9 words (the path length's instantiations)
MAX_SHARED_BYTES = 227 * 1024
K6_CHECKPOINTS, K6_STATE_WORDS = 13, 9
# K6's instantiation with the field: its checkpointed bounces (kFieldCkpt)
# of 15 words (the medium's and the incoming field's six after the state)
K6_FIELD_CHECKPOINTS, K6_FIELD_STATE_WORDS = 6, 15


def check_moment_pairs(cfg: SensorConfig):
    """Raise NotImplementedError when the scene's slots x bundles exceed
    the MAX_MOMENT_PAIRS sums a thread of K5 and K6 holds."""
    pairs = max(cfg.n_sensors, 1) * cfg.n_bundles
    if pairs > MAX_MOMENT_PAIRS:
        raise NotImplementedError(
            f'the fused non-sequential kernels hold at most '
            f'{MAX_MOMENT_PAIRS} (sensor slot, bundle) moment sums per ray; '
            f'got {max(cfg.n_sensors, 1)} slots x {cfg.n_bundles} bundles '
            f'= {pairs} (ROADMAP Queue 2 I): use Scene.simulate')


def k6_shared_bytes(static_meta, cfg: SensorConfig, n_bounces, field=None):
    """The shared memory of K6's family instantiation, or with ``field``
    (None: the ``TraceMeta``'s) of its field's
    (csrc/trace_nonseq_bwd.cu::shared_bytes): per row its table and kinds,
    the side data of the table's families (``families``: the side buffer,
    the programs' words, the exponent pairs; a GRIN rod has none, its data
    riding its flat row and its checkpoints local memory, with the field
    too: csrc/grin.cuh), its warp slots of the columns (``grad_cols``), the
    moment cotangent and the checkpoints (with the field fewer, of more
    words)."""
    field = field_kinds(static_meta) if field is None else field
    fam = families(static_meta)
    k = len(static_meta)
    cols = len(grad_cols((), True, dispersive(static_meta),
                         bool(fam & FAM_COAT), bool(fam & FAM_DIFF),
                         bool(fam & FAM_FREEFORM)))
    ck = min(max(n_bounces, 1),
             K6_FIELD_CHECKPOINTS if field else K6_CHECKPOINTS)
    words = K6_FIELD_STATE_WORDS if field else K6_STATE_WORDS
    programs = (len(static_meta.words) if fam & FAM_FUZZY else 0)
    return 4 * (k * (160 + 8 + (COAT_SIDE if fam & FAM_COAT else 0)
                     + (FF_SIDE if fam & FAM_FREEFORM else 0)) + programs
                + max(cfg.n_sensors, 1) * cfg.n_bundles * N_MOMENTS
                + 8 * k * cols + ck * words * THREADS)


def freeform_k6_shared_bytes(static_meta, cfg: SensorConfig, n_bounces):
    """``k6_shared_bytes`` of K6's family instantiation (freeform
    surfaces' 32 ff columns a row the largest of its families' part)."""
    return k6_shared_bytes(static_meta, cfg, n_bounces, field=False)


def check_freeform_shared(static_meta, cfg: SensorConfig, n_bounces):
    """Raise NotImplementedError when K6's family instantiation would need
    more than MAX_SHARED_BYTES a block."""
    need = freeform_k6_shared_bytes(static_meta, cfg, n_bounces)
    if need > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f'the fused non-sequential backward (K6) with these families of '
            f'kinds takes at most MAX_SHARED_BYTES = {MAX_SHARED_BYTES} '
            f'bytes of shared memory a block; this table of '
            f'{len(static_meta)} rows at {n_bounces} bounces needs {need} '
            f'(ROADMAP Queue 2 I)')


def field_k6_shared_bytes(static_meta, cfg: SensorConfig, n_bounces):
    """``k6_shared_bytes`` of K6's field instantiation: the field's
    checkpoints and the table's families' side data and columns
    together."""
    return k6_shared_bytes(static_meta, cfg, n_bounces, field=True)


def check_field_shared(static_meta, cfg: SensorConfig, n_bounces):
    """Raise NotImplementedError when K6's instantiation with the field
    would need more than MAX_SHARED_BYTES a block."""
    need = field_k6_shared_bytes(static_meta, cfg, n_bounces)
    if need > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f'the fused non-sequential backward (K6) with the field takes at '
            f'most MAX_SHARED_BYTES = {MAX_SHARED_BYTES} bytes of shared '
            f'memory a block; this table of {len(static_meta)} rows at '
            f'{n_bounces} bounces needs {need} (ROADMAP Queue 2 I)')


def trace_nonseq_fused(table, rays, cfg: SensorConfig, static_meta,
                       n_bounces, grids=None, track_opl=False,
                       record_paths=False, record_hits=False, generator=None,
                       fuzzy_fns=None, track_field=False, E0=None):
    """Fused bounce loop within ``n_bounces`` -> ``(rays, SensorState)``,
    differentiable with respect to the table, the 7 ray streams
    px..intensity and the phase maps of ``grids`` ({PHASE_GRID row:
    [H, W] map}) (first order).  With any of ``track_opl``,
    ``record_paths``, ``record_hits`` and ``track_field`` -> ``(rays,
    SensorState, aux)`` (core/trace.py::trace_nonsequential's ``aux``).  A
    table with FRESNEL rows draws under two Philox seed words drawn once
    from ``generator``; without it it raises ValueError.  ``fuzzy_fns`` as
    for ``fused_trace.trace_sequential_fused``.  ``track_field=True``
    carries the polarized field from ``E0`` (core/field.py::
    FieldState.init, made here in torch, so E0 and the launch directions
    get its cotangent): ``aux`` then holds ``field`` and ``field_power``,
    and the sensors weigh by |E|^2.

    CPU tensors run the plain versions; CUDA tensors launch K5 and, in
    backward, K6 (or raise: there is no fallback)."""
    flags = StreamFlags(track_opl, record_paths, record_hits, track_field)
    check_moment_pairs(cfg)
    static_meta = TraceMeta(static_meta, fuzzy_fns, track_field)
    flat, kinds = flat_inputs(table, rays, cfg, static_meta)
    key = draw_key(static_meta, generator)
    maps = plate_maps(static_meta, grids)
    comps = [getattr(rays, c) for c in COMPS]
    field = FieldState.init(rays, E0).streams() if track_field else ()
    if needs_grad(flat, rays, maps) or any(f.requires_grad for f in field):
        if track_field:
            check_field_shared(static_meta, cfg, n_bounces)
        elif families(static_meta):
            check_freeform_shared(static_meta, cfg, n_bounces)
        if flags.any or key is not None:
            outs = FusedNonseqStreams.apply(
                flat, kinds, cfg, static_meta, flags, n_bounces, key,
                *comps, rays.ray_id, *plate_inputs(rays, maps), *field)
            return unpack(outs, rays, cfg, flags, nonseq=True)
        return unpack(FusedNonseq.apply(flat, kinds, cfg, static_meta,
                                        n_bounces, *comps, rays.ray_id,
                                        *plate_inputs(rays, maps)),
                      rays, cfg)
    res = _forward(flat, kinds, rays, cfg, static_meta, n_bounces, maps,
                   flags, key, field or None)
    return (*res[:2], field_aux(res[2])) if flags.any else res


def draw_key(static_meta, generator=None):
    """The Philox key of a fused non-sequential trace: two 32-bit words
    drawn once from ``generator``; None when no row draws.  A drawing table
    without a generator raises ValueError (rays/draws.py::nonseq_draws)."""
    draws = nonseq_draws(static_meta, 0, None, generator)
    return draws.key if draws is not None else None


def _forward(flat, kinds, rays, cfg, static_meta, n_bounces, maps=None,
             flags=NO_STREAMS, key=None, field=None):
    if flat.device.type == 'cpu':
        return trace_nonseq_fused_plain(flat, rays, cfg, static_meta,
                                        n_bounces, maps, **flags.stream_kw(),
                                        key=key, field=field)
    return trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, n_bounces, maps,
                                 ext_kinds(static_meta), **flags.stream_kw(),
                                 fresnel=fresnel_kinds(static_meta), key=key,
                                 field=field, grin=grin_kinds(static_meta),
                                 **side_buffers(static_meta, flat.device))


def side_buffers(static_meta, device):
    """The K5 and K6 wrappers' family arguments of a trace beside the key:
    the coatings' side buffer, the diffractive kinds, the fuzzy programs and
    the freeform rows' pairs (None or False where the table lacks the
    family)."""
    return dict(coat=coat_side(static_meta, device),
                diff=diffractive_kinds(static_meta),
                fuzzy=fuzzy_buffer(static_meta, device),
                ff=ff_side(static_meta, device))


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
        ctx.n_bounces = n_bounces
        return fused_forward(ctx, _forward, flat_table, kinds, cfg, meta,
                             NO_STREAMS, None,
                             (px, py, pz, dx, dy, dz, intensity), ray_id,
                             plates, n_bounces)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        need = ctx.needs_input_grad
        res = _nonseq_backward(
            ctx, grads, need[:4] + (False,) + need[4:5] + (False,) + need[5:])
        return res[:4] + res[5:6] + res[7:]


class FusedNonseqStreams(torch.autograd.Function):
    """``FusedNonseq`` with the deterministic streams ``flags`` as outputs
    after the grid: ``opl`` and ``n_final`` [N], ``paths`` [B, N, 3],
    ``hits`` [B, N, 3], ``hit_weights`` [B, N] and ``hit_slots`` [B, N]
    (int32, no derivative), each when asked for, and with ``key``, the
    FRESNEL draws' two seed words (None: no row draws).  With
    ``flags.track_field`` the launch field's six streams follow the plates
    as inputs and the final field's six (``FIELD_KEYS``) follow the other
    streams as outputs.

    ``apply(flat_table, kinds, cfg, meta, flags, n_bounces, key, px, ...,
    ray_id, *plates, *field)``; its backward as ``FusedTraceStreams``'s,
    with K6 replaying the draws by their counters; a recording run on a
    drawing scene raises there."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, flags, n_bounces, key, px,
                py, pz, dx, dy, dz, intensity, ray_id, *plates):
        ctx.n_bounces = n_bounces
        n_field = 6 if flags.track_field else 0
        return fused_forward(ctx, _forward, flat_table, kinds, cfg, meta,
                             flags, key, (px, py, pz, dx, dy, dz, intensity),
                             ray_id, plates[:len(plates) - n_field],
                             n_bounces, field=plates[len(plates) - n_field:])

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return _nonseq_backward(ctx, grads, ctx.needs_input_grad)


def _nonseq_backward(ctx, grads, need):
    """``FusedNonseqStreams``'s backward (``FusedNonseq``'s with ``need``
    holding False for the flags) -> the cotangents of its inputs."""
    flat, kinds, rays, maps = saved_inputs(ctx)
    field = saved_field(ctx)
    g_rays, g_moments, g_grid, g_aux = stream_cotangents(ctx, grads)
    g_field = [g_aux.get(k) for k in FIELD_KEYS]
    # the launch field's inputs come last: the plates' need before them
    need_field = need[len(need) - ctx.n_field:] if field else ()
    need = need[:len(need) - ctx.n_field]
    need_table, need_rays = need[0], any(need[7:14])
    need_maps, need_wl = any(need[16:]), len(need) > 15 and need[15]
    if ctx.flags.records and ctx.draws is not None:
        raise NotImplementedError(
            'gradients through a recording run (record_paths, record_hits) '
            'of the fused non-sequential trace of a stochastic (FRESNEL) '
            'scene: as in the JAX package, use simulate() for such design '
            'loops, or fresnel=\'weighted\'')
    if ctx.flags.records:
        fused_trace.RECORD_RECOMPUTES += 1
        res = plain_vjp(
            lambda f, r, m, fld=None: _loop(f, r, ctx.cfg, ctx.meta,
                                            ctx.n_bounces, m, ctx.flags,
                                            plain=False, field=fld),
            flat, rays, g_rays, g_moments, g_grid, maps, need_wl, g_aux,
            field=field)
    elif flat.device.type == 'cuda':
        res = trace_nonseq_bwd_cuda(
            flat, kinds, rays, ctx.cfg, ctx.n_bounces, g_rays, g_moments,
            need_table, need_rays, g_grid=g_grid, maps=maps,
            need_maps=need_maps, ext=ext_kinds(ctx.meta),
            disp=dispersive(ctx.meta), need_wavelength=need_wl,
            g_opl=g_aux.get('opl'), g_nfinal=g_aux.get('n_final'),
            opl=ctx.flags.track_opl, fresnel=fresnel_kinds(ctx.meta),
            key=ctx.draws, field=field, g_field=g_field,
            grin=grin_kinds(ctx.meta), **side_buffers(ctx.meta, flat.device))
    else:
        res = trace_nonseq_bwd_plain(
            flat, rays, ctx.cfg, ctx.meta, ctx.n_bounces, g_rays, g_moments,
            g_grid=g_grid, maps=maps, need_wavelength=need_wl,
            g_opl=g_aux.get('opl'), g_nfinal=g_aux.get('n_final'),
            key=ctx.draws, field=field, g_field=g_field)
    if field is None:
        return backward_result(res, maps, need, 7)
    return backward_result(res[:-1], maps, need, 7) + tuple(
        g if n else None for g, n in zip(res[-1], need_field))


def _loop(flat_table, rays, cfg, static_meta, n_bounces, maps=None,
          flags=NO_STREAMS, plain=True, key=None, draws=None, field=None):
    """The eager bounce loop of core/trace.py over the rows of the flat
    table -> ``(rays, SensorState)``, with ``flags``' streams ``(rays,
    SensorState, aux)``; FRESNEL rows draw Philox under ``key``, or from
    ``draws(bounce, row)`` when given; a ``TraceMeta``'s callables apodize
    their rows; ``field`` (six streams, with ``flags.track_field``) is the
    launch field, and ``aux`` holds the final one's as ``FIELD_KEYS``.
    ``plain=False`` runs K3's and K4's kernels on CUDA tensors, as the
    eager ``Scene.simulate`` does."""
    streams = Streams.of(rays, **flags.stream_kw(), launch=False)
    rows = [FlatRow(flat_table[k]) for k in range(len(static_meta))]
    rng = None
    if needs_draws(static_meta):
        if key is None and draws is None:
            raise ValueError('a table with FRESNEL rows needs the Philox key '
                             'of its draws')
        rng = NonseqDraws(rays.n, rays.px.device, key=key, fn=draws)
    res = bounce_loop(
        rows, rays, n_bounces, cfg, static_meta, torch.float32, plain=plain,
        grids=dict(zip(plate_rows(static_meta), maps or ())), streams=streams,
        draws=rng, fuzzy_fns=getattr(static_meta, 'fuzzy', None),
        field=FieldState(*field) if flags.track_field else None)
    if not flags.any:
        return res
    aux = streams.aux() if streams is not None else {}
    if flags.track_field:
        aux.update(zip(FIELD_KEYS, res[2].streams()))
    return res[0], res[1], aux


def trace_nonseq_fused_plain(flat_table, rays, cfg: SensorConfig,
                             static_meta, n_bounces, maps=None,
                             track_opl=False, record_paths=False,
                             record_hits=False, key=None, draws=None,
                             field=None):
    """K5's function in plain torch: the eager bounce loop over the rows of
    the flat table the kernel reads, with the phase maps ``maps`` of its
    PHASE_GRID rows (in row order) and the FRESNEL draws' Philox ``key`` ->
    ``(rays, SensorState)``, with any stream ``(rays, SensorState, aux)``.
    ``draws(bounce, row) -> [N]`` replaces the Philox draws (the tests feed
    the JAX package's; K5 itself draws by counter only).  A ``TraceMeta``
    ``static_meta`` applies its fuzzy callables themselves.  ``field``, the
    launch field's six streams (None: no field), traces the field: ``aux``
    then holds the final field's six as ``FIELD_KEYS``."""
    return _loop(flat_table, rays, cfg, static_meta, n_bounces, maps,
                 StreamFlags(track_opl, record_paths, record_hits,
                             field is not None), key=key, draws=draws,
                 field=field)


def trace_nonseq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                           n_bounces, g_rays, g_moments, g_grid=None,
                           maps=None, need_wavelength=False, g_opl=None,
                           g_nfinal=None, key=None, field=None,
                           g_field=None, draws=None):
    """K6's function in plain torch: re-run ``trace_nonseq_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments,
    ``g_grid`` that of the [S, H, W] grid and ``g_opl`` / ``g_nfinal``
    those of the ``opl`` and ``n_final`` streams (each None for zero).
    Returns ``(g_flat [K, 160], 7 input-ray cotangents)``, with phase maps
    their cotangents third, and with ``need_wavelength`` the wavelength's
    cotangent fourth (the maps' then ``()`` without maps).  ``key``: the
    forward's Philox key (``draws`` as for ``trace_nonseq_fused_plain``).
    A ``TraceMeta`` ``static_meta`` applies its fuzzy callables themselves.
    With ``field``, the launch field's six streams,
    ``g_field`` holds the final field's six cotangents (each None for zero),
    and the launch field's six cotangents come last."""
    g_aux = {k: g for k, g in (('opl', g_opl), ('n_final', g_nfinal))
             if g is not None}
    flags = StreamFlags(bool(g_aux), False, False, field is not None)
    if field is not None:
        g_aux.update(zip(FIELD_KEYS, g_field or (None,) * 6))
    return plain_vjp(
        lambda flat, r, m, fld=None: _loop(flat, r, cfg, static_meta,
                                           n_bounces, m, flags, key=key,
                                           draws=draws, field=fld),
        flat_table, rays, g_rays, g_moments, g_grid, maps, need_wavelength,
        g_aux, field=field)


def trace_nonseq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces, maps=None, ext=False, track_opl=False,
                          record_paths=False, record_hits=False,
                          fresnel=False, key=None, coat=None, diff=False,
                          fuzzy=None, ff=None, field=None, grin=None):
    """Launch K5 on the current stream -> ``(rays, SensorState)``, with any
    stream ``(rays, SensorState, aux)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``, ``maps`` the PHASE_GRID rows' [H, W] maps
    in row order; all on one CUDA device.  ``ext``: the table has the
    extended kinds (``fused_trace.ext_kinds``).  The streams run K5's
    instantiation with them, whatever ``ext``; ``fresnel`` (the table has a
    Fresnel kind, ``fused_trace.fresnel_kinds``) a family.  ``key`` is the
    FRESNEL draws' two
    Philox seed words, None when no row draws; its caller derives it from
    the table's static metadata (``draw_key``).  The families (``coat``,
    ``diff``, ``fuzzy``, ``ff``, ``grin``) as for
    ``fused_trace.trace_seq_fwd_cuda``: the family instantiation, which
    also takes the streams.  ``field``, the launch field's six [N] streams
    (None: no field), runs the field's instantiation with the same families
    (no ``grin``); ``aux`` then holds the final field's six streams as
    ``FIELD_KEYS``.  More than MAX_MOMENT_PAIRS slots x bundles raise
    NotImplementedError."""
    global NONSEQ_LAUNCHES
    flags = StreamFlags(track_opl, record_paths, record_hits,
                        field is not None)
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_fwd_cuda')
    check_moment_pairs(cfg)
    _check_bounces(n_bounces)
    grin = grin_of(kinds, grin)
    fam = family_bits(fresnel, coat, diff, fuzzy, ff, grin)
    key_args = _key_args(fam, fresnel, key, k, device, coat, fuzzy, ff)
    plates = plate_buffers(ext_maps(maps, ext or flags.any or fam), rays,
                           device)
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in COMPS]
    partials = torch.empty(-(-n // THREADS), n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    grid = new_grid(cfg, device)
    bufs = stream_buffers(flags, n_bounces, n, device, nonseq=True)
    f_in = field_buffer(field, n, device) if field is not None else None
    f_out = torch.empty_like(f_in) if field is not None else None
    if n > 0:
        args = (flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in COMPS),
                rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                partials.data_ptr(), n_slots, n_bundles,
                *grid_args(cfg, grid if cfg.grid_shape else None),
                *plate_args(plates))
        with torch.cuda.device(device):
            if field is not None:
                rc = kernel('rtt_trace_nonseq_fwd_field')(
                    *args, *stream_args(bufs, nonseq=True), *key_args,
                    f_in.data_ptr(), f_out.data_ptr(), int(n_bounces), n,
                    stream(device))
            elif fam or flags.any:
                rc = kernel('rtt_trace_nonseq_fwd_streams')(
                    *args, *stream_args(bufs, nonseq=True), *key_args,
                    int(n_bounces), n, stream(device))
            else:
                rc = kernel('rtt_trace_nonseq_fwd')(
                    *args, int(ext), int(n_bounces), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_fwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_LAUNCHES += 1
        count_launch(fam, field is not None, flags.any, ext)
    out = rays.replace(**dict(zip(COMPS, outs)))
    sensors = SensorState(moments=partials.sum(dim=0), grid=grid)
    if flags.any:
        aux = stream_aux(bufs)
        if field is not None:
            aux.update(zip(FIELD_KEYS, f_out if n > 0 else f_in))
        return out, sensors, aux
    return out, sensors


def trace_nonseq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                          n_bounces, g_rays, g_moments, need_table=True,
                          need_rays=True, g_grid=None, replay=False,
                          maps=None, need_maps=True, ext=False, disp=None,
                          need_wavelength=False, g_opl=None, g_nfinal=None,
                          opl=False, fresnel=False, key=None, coat=None,
                          diff=False, fuzzy=None, ff=None, field=None,
                          g_field=None, grin=None):
    """Launch K6 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, with phase maps (or the extended kinds)
    their cotangents (or None) next, with ``need_wavelength`` the
    wavelength's cotangent next, with ``field`` the launch field's six
    cotangents next, and with ``replay=True`` last the rays at the state
    the kernel's forward replay ended at (K5's output, bit for bit), with
    ``field`` followed by the replay's final field (six streams).

    Inputs as for ``trace_nonseq_fwd_cuda``; ``g_rays`` holds the
    cotangents of the 7 output streams (None for zero), ``g_moments`` that
    of the [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each
    None for zero).  ``need_table`` / ``need_rays`` / ``need_maps`` /
    ``need_wavelength`` say which cotangents to compute; the kernel skips
    the others.  ``ext`` as for ``trace_nonseq_fwd_cuda``, ``disp`` as for
    ``fused_trace.trace_seq_bwd_cuda`` (a dispersive table and the
    wavelength's cotangent take the instantiation with dispersion), and
    ``opl``, ``g_opl`` and ``g_nfinal`` too (K5 ran with ``track_opl``: the
    instantiation with the optical path length, whatever ``ext``), and
    the families (``fresnel``, ``key``, ``coat``, ``diff``, ``fuzzy``,
    ``ff``, ``grin``) as for ``trace_nonseq_fwd_cuda``: the family
    instantiation (which replays K5's draws by their counters and also takes
    the path length), whose table cotangent adds the columns of
    ``fused_trace.trace_seq_bwd_cuda``'s, and ``field`` too (the field's
    instantiation with those families), with ``g_field`` the final field's
    six cotangents (each None for zero)."""
    global NONSEQ_BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_nonseq_bwd_cuda')
    check_moment_pairs(cfg)
    _check_bounces(n_bounces)
    grin = grin_of(kinds, grin)
    fam = family_bits(fresnel, coat, diff, fuzzy, ff, grin)
    opl = opl or field is not None
    key_args = _key_args(fam, fresnel, key, k, device, coat, fuzzy, ff)
    ext = ext or need_wavelength or opl or bool(fam)
    if disp is None:
        disp = ext and dispersive_kinds(kinds)
    plates = plate_buffers(ext_maps(maps, ext), rays, device)
    g_rays, g_mom, g_grid = check_cotangents(g_rays, g_moments, g_grid, cfg,
                                             n, device)
    g_opl, g_nfinal = check_streams((g_opl, g_nfinal), n, device)
    cols = grad_cols(plates, ext, disp, coat is not None, diff, ff is not None)

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
    f_in = field_buffer(field, n, device) if field is not None else None
    g_fout = c_field = f_end = None
    if field is not None:
        if any(g is not None for g in g_field or ()):
            g_fout = field_buffer(
                [torch.zeros(n, device=device) if g is None else g
                 for g in g_field], n, device)
        c_field = torch.zeros_like(f_in)
        f_end = torch.empty_like(f_in) if replay else None
    if n > 0 and (need_table or need_rays or replay or g_maps is not None
                  or need_wavelength or field is not None):
        args = (flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in COMPS),
                rays.ray_id.data_ptr(), *map(ptr, g_rays),
                g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                ptr(partials), *map(ptr, ends or (None,) * 7), n_slots,
                n_bundles, *grid_args(cfg, g_grid), *plate_args(plates),
                ptr(g_maps), ptr(g_wl), int(ext and disp))
        with torch.cuda.device(device):
            if field is not None:
                rc = kernel('rtt_trace_nonseq_bwd_field')(
                    *args, ptr(g_opl), ptr(g_nfinal), *key_args,
                    f_in.data_ptr(), ptr(g_fout), c_field.data_ptr(),
                    ptr(f_end), int(n_bounces), n, stream(device))
            elif fam or opl:
                rc = kernel('rtt_trace_nonseq_bwd_opl')(
                    *args, ptr(g_opl), ptr(g_nfinal), *key_args,
                    int(n_bounces), n, stream(device))
            else:
                rc = kernel('rtt_trace_nonseq_bwd')(
                    *args, int(ext), int(n_bounces), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_nonseq_bwd launch failed with CUDA '
                               f'error {rc}')
        NONSEQ_BWD_LAUNCHES += 1
        count_launch(fam, field is not None, opl, ext)
    res = table_and_map_cotangents(k, cols, partials, outs, plates, g_maps,
                                   device, g_wl)
    if field is not None:
        res += (tuple(c_field),)
    if replay:
        res += (rays.replace(**dict(zip(COMPS, ends))),)
        if field is not None:
            res += (tuple(f_end),)
    return res


def _key_args(fam, fresnel, key, k, device, coat=None, fuzzy=None, ff=None):
    """The C arguments of K5's and K6's family and field instantiations
    after the streams: the Philox key's two words (0 when no row draws),
    then ``fused_trace.family_args`` of the families ``fam``."""
    if key is not None and not fresnel:
        raise ValueError('a Philox key is read only by the family '
                         'instantiation with the Fresnel kinds')
    k0, k1 = key if key is not None else (0, 0)
    return (int(k0) & 0xFFFFFFFF, int(k1) & 0xFFFFFFFF,
            *family_args(fam, k, device, coat, fuzzy, ff))


def _check_bounces(n_bounces):
    if n_bounces < 0:
        raise ValueError(f'n_bounces must be >= 0, got {n_bounces}')
