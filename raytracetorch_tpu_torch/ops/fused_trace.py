"""Fused sequential trace: the CUDA kernels K1 (forward) and K2 (backward),
their plain versions, and the autograd Function that joins them; and the
registry that builds every CUDA library of the package.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py``, sequential part,
for the main-path kinds and pixelated phase plates, with every other
optional stream off:

- ``trace_sequential_pallas_v2`` (TPU kernel ``_kernel_v2``, chain body
  ``_chain_pure``) -> kernel K1, ``csrc/trace_seq_fwd.cu``;
- ``trace_sequential_pallas_v2_bwd`` (TPU kernel ``_kernel_v2_bwd``) ->
  kernel K2, ``csrc/trace_seq_bwd.cu``;
- the ``custom_vjp`` ``fused_trace_grad`` with ``_fused_fwd`` and
  ``_fused_bwd`` -> ``FusedTrace``;
- ``trace_sequential_pallas`` (TPU kernel ``_kernel``, the chain with every
  stream off) -> ``trace_sequential_v1``, which launches K1's kernel with
  the grid, the maps and the wavelength off.

Each kernel's source holds the notes on its design and bounds.  In this
module:

- ``trace_sequential_fused`` is the entry point.  When grad is enabled and
  the table or a ray stream requires grad it goes through ``FusedTrace``;
  otherwise it runs the forward alone.  CPU tensors run the plain versions;
  CUDA tensors launch the kernels or raise.  Rows of kinds the kernels lack
  raise NotImplementedError before anything runs.
- ``trace_sequential_fused_plain`` and ``trace_seq_bwd_plain`` are the two
  kernels' functions in plain torch: the eager chain of core/trace.py over
  the rows of the flat table, and its autograd.
- ``trace_seq_fwd_cuda`` and ``trace_seq_bwd_cuda`` launch the kernels and
  count their launches in ``LAUNCHES`` and ``BWD_LAUNCHES``; a launch of
  the instantiation with the extended kinds also in ``EXT_LAUNCHES``.
- With ``cfg.grid_shape`` set, K1 also bins the sensor hits into the
  ``[S, H, W]`` irradiance grid (kernel K3's device function) and K2 routes
  the grid's cotangent back into the incoming intensities.
- With phase plates (``grids``, {PHASE_GRID row: [H, W] map}, as
  ``Scene.side_grids`` gives them), the kernels take the maps as one
  concatenated float32 buffer with an int32 (offset, H, W) row per map, the
  row's map index in its kinds row, and the rays' wavelength (kernel K4's
  device functions read the corners; K2 scatters their cotangents).
  Without a plate none of these is passed and the kernels run their
  instantiation without plate code.
- A scene with a kind of the mixed-surface and asphere scenes (an even
  asphere, a rectangular volume bound, a cylindrical lens's edge bound), a
  convex solid's half-spaces (HALFSPACES: the planes ride the row's
  ``hp_n``, ``hp_d`` and ``hp_mask`` columns, the mask as float 0/1), a
  single cone's nappe (CONE_NAPPE) or a dispersive medium (``ext_kinds``)
  runs a third instantiation, with
  plate code and those kinds (``ext=True`` at the wrappers; maps as with
  plates, possibly none, and always the rays' wavelength).  Its K2 and K6
  add the asphere coefficients' cotangents (``EXT_GRAD_COLS``).  K2 and K6
  take a dispersive table in a fourth instantiation, which adds the
  dispersion coefficients' cotangents (``DISP_GRAD_COLS``) and returns the
  wavelength's when it is asked for (``need_wavelength``; a plate scene
  whose wavelength requires grad runs it in backward for that).  The
  instantiations without the extended kinds hold none of that code.
- ``plain_vjp`` is the shared body of the plain backward versions
  (``trace_seq_bwd_plain`` here, ``trace_nonseq_bwd_plain`` in
  ops/fused_nonseq.py): ``torch.autograd.grad`` of a plain forward.
- The deterministic streams of the JAX kernels (``track_opl``,
  ``record_paths``, ``record_hits``; ``StreamFlags``) run in an
  instantiation of their own of each of K1, K2, K5 and K6, built on the one
  with the extended kinds and dispersion, which takes every scene (its
  launches count in ``STREAM_LAUNCHES``, not in ``EXT_LAUNCHES``).  A
  forward with any stream returns ``(rays, SensorState, aux)``, with the
  JAX package's keys and shapes; without one ``(rays, SensorState)``, as
  before.  K1 writes the records planar ([K + 1, 3, N] positions, [K, 3, N]
  hits) and the wrapper returns permuted views of JAX's shapes.
  ``FusedTraceStreams`` is ``FusedTrace`` with the streams as outputs.
  Its backward follows the reference's ``_fused_bwd``: with ``track_opl``
  alone K2 takes the cotangents of ``opl`` and ``n_final``; a recording run
  (``record_paths`` or ``record_hits``) recomputes its backward through the
  eager chain with autograd (``plain_vjp``, counted in
  ``RECORD_RECOMPUTES``), because K2, like the TPU reverse kernel, carries
  no cotangent streams for the O(K N) records; K2 is not tried on such a
  run.  That is the reference's design, not a fallback.
- The families of kinds (``families``: the Fresnel kinds, coatings and
  metal mirrors, the diffractive and ideal elements, fuzzy apodization,
  freeform surfaces and GRIN rods, each a ``FAM_*`` bit) run in one more
  instantiation of each of K1, K2, K5 and K6, the family instantiation,
  built on the one with the streams (K1, K5) or the path length (K2, K6),
  so that every other instantiation keeps its code.  It compiles every
  family together, so a table may mix them as the JAX kernels take them (a
  GRIN rod beside a coated lens, a DOE and a fuzzy pupil); the launch
  passes the table's families as a bit word and each family's side data,
  None where the table lacks it.  A table that the chain of family links
  took before (the Fresnel kinds; coatings; the diffractive kinds; fuzzy
  programs, each with the families below it; GRIN rods alone) runs that
  link's instantiation, chosen in the C launcher from the bits
  (csrc/trace_seq_common.cuh::fam_link): the family instantiation ran such
  tables 1.1-2.2x slower.  A launch counts once in the counter of
  each family it ran with: ``FRESNEL_LAUNCHES``, ``COAT_LAUNCHES``,
  ``DIFF_LAUNCHES``, ``FUZZY_LAUNCHES``, ``FREEFORM_LAUNCHES``,
  ``GRIN_LAUNCHES`` (not in ``STREAM_LAUNCHES`` or ``EXT_LAUNCHES``).  Per
  family:

  - The Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W; ``fresnel_kinds``).
    FRESNEL's Monte-Carlo branch reads the trace's draws (rays/draws.py):
    K1, K2 and their plain versions the ``[F, N]`` uniform streams
    pre-drawn from the caller's generator (or injected), in row order, the
    same streams the eager chain reads; K5, K6 and theirs the counter-based
    Philox draw of (ray, bounce, row) under two seed words.  The streams
    travel into ``FusedTraceStreams`` as an input without derivative (the
    choice has none), and a recording run's eager recompute reuses them.  A
    scene with a drawing row runs ``FusedTraceStreams`` even without
    streams.
  - Thin-film coatings and metal mirrors (a stack on a Fresnel row, a metal
    REFLECT row; ``coating_kinds``).  A row's layer count and flags ride its
    kinds row's physics column from bit ``COAT_SHIFT`` on; the layers'
    extinction and a dispersive metal's knots go in a ``[K, 20]`` side
    buffer (``coat_side``); K2 and K6 add the layer thicknesses' cotangents
    (``COAT_GRAD_COLS``).
  - The diffractive and ideal elements (LINEAR, GRATING, DOE, MLA rows and
    the ELLIPSE bound; ``diffractive_kinds``).  A DOE row's term count and
    efficiency flag ride its kinds row's physics column from bit
    ``DOE_SHIFT`` on; K2 and K6 add its 8 ``ff`` coefficients' cotangents
    (``FF_GRAD_COLS``) after the coat columns.
  - Fuzzy apodization (``fuzzy_fns``, {row: component-style callable};
    ``fuzzy_kinds``).  ``TraceMeta`` carries the callables beside the rows'
    static metadata and traces them into programs (ops/fuzzy_program.py),
    which the kernels take as one int32 buffer (``fuzzy_buffer``) and
    interpret per ray: K1 and K5 multiply a row's factor by the program's
    value at the surface-local hit, K2 and K6 add the adjoint of that
    multiply to the hit's cotangent with the program's forward-mode
    partials.  The plain versions call the callables themselves.  A
    callable outside the op set or its limits, or a legacy ``[N, 3]`` one,
    raises NotImplementedError on either device.
  - Freeform surfaces (``FreeformLens`` and ``ZernikeLens`` faces, a row
    with ``meta.ff``; ``freeform_kinds``).  A freeform row's kinds row has
    the surface ``SURF_FREEFORM``, its exponent pairs ride a ``[K,
    FF_SIDE]`` int32 side buffer (``ff_side``) and its coefficients its
    ``ff`` columns; K2 and K6 reduce 32 ``ff`` columns a row
    (``FF_TERM_COLS``) in place of a DOE row's 8.  ``trace_sequential_v1``
    routes a freeform table there too.
  - GRIN rods (``GrinRod``, a GRIN row: core/grin.py; ``grin_kinds``, and
    ``grin_rows`` of the kinds tensor in the wrappers).  A rod's RK4 step
    count rides its kinds row's last column; its cotangents land in
    ph[0:6] (n_ambient, c0, c2, c4, cz, L) and the pose columns, all among
    ``EXT_GRAD_COLS``.  A trace of GRIN rows under the field (ROADMAP
    Queue 1 position 4b) or with more than ``MAX_GRIN_STEPS`` steps raises
    NotImplementedError on either device (``check_grin_kinds``); the eager
    traces take them.  ``trace_sequential_v1`` refuses GRIN rows, as the
    TPU kernel it stands for does.
- The polarized field (``track_field``, ``E0``; core/field.py) runs in one
  more instantiation of each of K1, K2, K5 and K6, which compiles every
  family but GRIN rods and reads the table's families as the family
  instantiation does; its launches count in ``FIELD_LAUNCHES`` alone.  The
  launch field is made in torch (``FieldState.init``, so ``E0``'s
  cotangent flows there) and enters the kernels as six planar streams; K1
  returns the six of the final field (``aux['field']``,
  ``aux['field_power']``) and K2 takes their cotangents and returns the
  launch field's.  A JONES row's static bits (chromatic, crystal) ride its
  kinds row's physics column from bit ``COAT_SHIFT`` on (``jones_bits``);
  its cotangents land in ph[0:5] and Rw, columns the kernels already
  reduce.  Coated interfaces and metal mirrors take their stacks' and
  metals' amplitudes in the field's transport and their polarized R (and
  T) in the weights (csrc/field.cuh); a coated SNELL row, whose stack acts
  on the field alone, carries its coating bits (``coat_bits``) in a trace
  with the field only.  The thicknesses' cotangents land in
  ``COAT_GRAD_COLS``.
- The kernels take up to ``MAX_BUNDLES`` (18) bundles, the JAX kernels'
  limit (n_bundles * 7 <= 128).  K5 and K6 keep per-thread moment sums of
  at most 64 (slot, bundle) pairs: more raise NotImplementedError
  (ops/fused_nonseq.py).
- ``build`` compiles the six libraries (K1, K2, K3 in ops/grid.py, K4 in
  ops/phase_grid.py, K5 and K6 in ops/fused_nonseq.py), one nvcc each,
  started together.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..constants import MAX_FF_TERMS, PhysKind, SBKind, VBKind
from ..core.field import FieldState
from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.static_dispatch import (DIFFRACTIVE_KINDS, FRESNEL_KINDS,
                                    coat_acts, field_coat_acts, unsupported)
from ..core.table import ROW_OFFSETS, ROW_WIDTH, FlatRow, flatten_table_rows
from ..core.trace import Streams, surface_chain
from ..rays.draws import draws_per_ray, sequential_uniforms
from ..rays.ray import Rays
from . import fuzzy_program, nvcc_build

LAUNCHES = 0          # kernel launches by trace_seq_fwd_cuda (K1)
BWD_LAUNCHES = 0      # kernel launches by trace_seq_bwd_cuda (K2)
V1_LAUNCHES = 0       # K1's kernel launched by trace_sequential_v1
# launches of K1, K2, K5 and K6 (each also counted above or in
# ops/fused_nonseq.py) in their instantiation with the extended kinds
EXT_LAUNCHES = 0
# launches of K1, K2, K5 and K6 (each also counted above or in
# ops/fused_nonseq.py) in their instantiation with the streams
STREAM_LAUNCHES = 0
# backward passes of recording runs recomputed through the eager trace
# (FusedTraceStreams and FusedNonseqStreams)
RECORD_RECOMPUTES = 0
# launches of K1, K2, K5 and K6 (each also counted above or in
# ops/fused_nonseq.py) in their family instantiation, one counter a family
# (a launch counts in each family it ran with): the Fresnel kinds, the
# coatings, the diffractive kinds, fuzzy programs, freeform surfaces and
# GRIN rods
FRESNEL_LAUNCHES = 0
COAT_LAUNCHES = 0
DIFF_LAUNCHES = 0
FUZZY_LAUNCHES = 0
FREEFORM_LAUNCHES = 0
GRIN_LAUNCHES = 0
# launches of K1, K2, K5 and K6 (each also counted above or in
# ops/fused_nonseq.py) in their instantiation with the field
FIELD_LAUNCHES = 0

THREADS = 256         # rays per block (kThreads in the CUDA sources)
KIND_WIDTH = 8        # ph, sb, vb, surface, sensor, slot, invert, map
# the surface column: the quadric solver, the plane fast path, or the
# quadric's roots refined onto an even asphere or a freeform sag
SURF_QUADRIC, SURF_PLANE, SURF_ASPHERE, SURF_FREEFORM = 0, 1, 2, 3
# A freeform row's exponent pairs, in a side buffer of FF_SIDE int32 words a
# row (csrc/freeform.cuh): the term count (0: not a freeform row), then each
# pair packed as i | j << 16, so an exponent is at most FF_MAX_EXPONENT.
FF_SIDE = 1 + MAX_FF_TERMS
FF_MAX_EXPONENT = 0xffff
# A dispersive row's two DispModels ride the physics column: the in side's
# in bits DISP_SHIFT and DISP_SHIFT + 1, the out side's in the two above
# (only the instantiations that take dispersion read them).
DISP_SHIFT = 8
# A coated or metal row's static coating data rides the physics column
# above the dispersion bits: its layer count from bit COAT_SHIFT (4 bits),
# then whether it is a metal mirror, whose metal disperses (its knots in the
# side buffer), and whose stack absorbs (csrc/thin_film.cuh).
COAT_SHIFT = 12
COAT_METAL, COAT_METAL_NK, COAT_ABSORBING = 1 << 4, 1 << 5, 1 << 6
COAT_SIDE = 20        # side-buffer floats a row: extinction x 8, knots 6 + 6
# A DOE row's static data rides the physics column above the coating's bits:
# its radial term count from bit DOE_SHIFT (4 bits), then its efficiency
# flag.
DOE_SHIFT = 20
DOE_EFFICIENCY = 1 << 4
# A JONES row's static bits ride the physics column where a coated row's
# coating bits ride theirs (a JONES row has no coating): bit 0 chromatic,
# bits 1-2 its crystal, 1 + its index in JONES_CRYSTALS (0: none;
# csrc/field.cuh::jones_delta).
JONES_CRYSTALS = ('QUARTZ', 'MGF2', 'CALCITE')
# The six planar streams of the field (core/field.py::FieldState), as the
# autograd Functions' outputs and the kernels' [6, N] buffers name them.
FIELD_KEYS = tuple('field_' + f for f in FieldState.FIELDS)
# A GRIN row's RK4 step count rides its kinds row's last column (the map
# column, a PHASE_GRID row's alone).  K2 and K6 recompute a rod's steps
# from checkpoints in a per-thread array sized for MAX_GRIN_STEPS
# (csrc/grin.cuh::kMaxGrinSteps; ROADMAP Queue 2 I).
MAX_GRIN_STEPS = 256
# The families of kinds of the family instantiation, bits of its runtime
# word (csrc/trace_seq_common.cuh kFam*): the Fresnel kinds, the coatings
# and metal mirrors, the diffractive and ideal elements, fuzzy programs,
# freeform surfaces, GRIN rods.
FAM_FRESNEL, FAM_COAT, FAM_DIFF, FAM_FUZZY, FAM_FREEFORM, FAM_GRIN = (
    1, 2, 4, 8, 16, 32)
# The rows hold their kinds in one block of shared memory and the kernels
# loop over them: 64 rows fill K2's and K6's 128-register budget's shared
# memory with their warp slots (ROADMAP Queue 2 I).
MAX_ROWS = 64
MAX_SLOTS = 8
# The JAX kernels' limit, n_bundles * 7 <= 128: K1's per-warp moment
# partials in shared memory hold 8 x 8 x 18 x 7 floats (32 KB) then.
MAX_BUNDLES = 18
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
# The flat-table columns whose cotangent can be nonzero for the kernels'
# kinds: q[0:5], Rw[0:9], tw[0:3], ph[0:2].  Everything else (n_sign, Rs,
# ts, the bounds) enters the chain only through comparisons and selects.
# A PHASE_GRID row adds ph[2:6] (order, design wavelength, half extents):
# PLATE_GRAD_COLS, the kernels' columns when the scene has a plate.
GRAD_COLS = tuple(ROW_OFFSETS[name] + j
                  for name, size in (('q', 5), ('Rw', 9), ('tw', 3), ('ph', 2))
                  for j in range(size))
PLATE_GRAD_COLS = GRAD_COLS + tuple(ROW_OFFSETS['ph'] + j
                                    for j in range(2, 6))
# The instantiation with the extended kinds (``ext_kinds``) adds an even
# asphere's coefficients asph[0:4]: its c and (1 + k) c^2 reach q[0] and
# q[2], already among the columns.
EXT_GRAD_COLS = PLATE_GRAD_COLS + tuple(ROW_OFFSETS['asph'] + j
                                        for j in range(4))
# A table with a dispersive row adds its 12 dispersion coefficients, the
# Cauchy B or the Sellmeier B1..C3 of each side (reduced by K2 and K6 after
# the other columns, and only for dispersive rows).
DISP_GRAD_COLS = tuple(ROW_OFFSETS['disp'] + j for j in range(12))
# The instantiation with the coatings adds the 8 layer thicknesses (the
# coat columns' odd entries; the layers' indices are static), after the
# dispersion columns of a dispersive table.  A metal row's own index ph[0:2]
# and ambient ph[2] are already among the columns.
COAT_GRAD_COLS = tuple(ROW_OFFSETS['coat'] + 2 * j + 1 for j in range(8))
# The instantiation with the diffractive kinds adds a DOE row's 8 radial
# phase coefficients ff[0:8], after the coat columns (reduced only for DOE
# rows).  LINEAR's, GRATING's and MLA's parameters ph[0:6] are already among
# the columns.
FF_GRAD_COLS = tuple(ROW_OFFSETS['ff'] + j for j in range(8))
# The instantiation with freeform surfaces reduces all MAX_FF_TERMS ff
# columns in their place (a freeform row's coefficients, a DOE row's in the
# first 8): a Zernike plate of Noll terms 4..28 spans 28 monomials.  Its
# base conic and even-asphere terms reach q[0], q[2] and asph[0:4], already
# among the columns.
FF_TERM_COLS = tuple(ROW_OFFSETS['ff'] + j for j in range(MAX_FF_TERMS))

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_GRID = [_P, _I, _I, _F]      # grid (or its cotangent), H, W, half extent
# maps, their (offset, H, W), wavelength; the extended kinds (0 or 1)
_PLATES = [_P, _P, _P]
_EXT = [_I]
# K2's and K6's wavelength cotangent (or null) and whether the table has a
# dispersive row (its partials then hold DISP_GRAD_COLS too)
_WAVE = [_P, _I]
# K1's and K5's stream outputs: opl, n_final, paths, hits, hit weights (K5:
# and hit slots); K2's and K6's stream cotangents: g_opl, g_nfinal
_STREAMS = [_P] * 5
_OPL = [_P, _P]
# the family instantiation's side data (each null where the table lacks
# its family) and its families' bits: K1's and K2's [F, N] uniform streams
# and their count F (K5's and K6's two Philox seed words in their place),
# the coated rows' side buffer, the fuzzy programs' buffer and its words,
# the freeform rows' exponent pairs, the FAM_* bits (0: the instantiation
# with the streams or the path length)
_U = ctypes.c_uint
_UNIFORMS = [_P, _I, _P, _P, _I, _P, _U]
_KEY = [ctypes.c_uint32, ctypes.c_uint32, _P, _P, _I, _P, _U]
# the field's buffers: K1's launch and final field; K2's launch field, the
# final field's cotangent and the launch field's ([6, N] each); K6's then
# the replay's final field or null
_FIELD_FWD = [_P, _P]
_FIELD_BWD = [_P, _P, _P]
# rows, slots, bundles, bounces, code (0 no plate code, 1 plate code, 2 plate
# code and the extended kinds, 3 those and a dispersive table, 4 the streams
# or the path length, 5 the family instantiation, 6 the field's), the
# programs' words, the FAM_* bits, out: resident blocks per SM
_OCCUPANCY = [_I, _I, _I, _I, _I, _I, _U, ctypes.POINTER(ctypes.c_int)]
# library name -> (source, {C entry point: argtypes})
_LIBRARIES = {
    'trace_seq_fwd': ('trace_seq_fwd.cu', {
        'rtt_trace_seq_fwd': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
        + _PLATES + _EXT + [_L, _P],
        'rtt_trace_seq_fwd_streams': [_P, _P, _I] + [_P] * 16 + [_I, _I]
        + _GRID + _PLATES + _STREAMS + _UNIFORMS + [_L, _P],
        'rtt_trace_seq_fwd_field': [_P, _P, _I] + [_P] * 16 + [_I, _I]
        + _GRID + _PLATES + _STREAMS + _UNIFORMS + _FIELD_FWD + [_L, _P],
        'rtt_trace_seq_fwd_occupancy': _OCCUPANCY}),
    'trace_seq_bwd': ('trace_seq_bwd.cu', {
        'rtt_trace_seq_bwd': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
        + _PLATES + [_P] + _WAVE + _EXT + [_L, _P],
        'rtt_trace_seq_bwd_opl': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
        + _PLATES + [_P] + _WAVE + _OPL + _UNIFORMS + [_L, _P],
        'rtt_trace_seq_bwd_field': [_P, _P, _I] + [_P] * 24 + [_I, _I]
        + _GRID + _PLATES + [_P] + _WAVE + _OPL + _UNIFORMS + _FIELD_BWD
        + [_L, _P],
        'rtt_trace_seq_bwd_occupancy': _OCCUPANCY}),
    'grid_bin': ('grid_bin.cu', {
        'rtt_grid_bin': [_P, _P, _P, _P, _I, _L, _P, _I, _I, _I, _F, _P],
        'rtt_grid_gather': [_P, _P, _P, _P, _I, _L, _P, _I, _I, _I, _F,
                            _P]}),
    'grid_corners': ('grid_corners.cu', {
        'rtt_grid_corners': [_P, _I, _I, _P, _P, _L, _P, _P, _P, _P, _P],
        'rtt_grid_corners_bwd': [_P, _P, _P, _P, _P, _P, _L, _P, _I, _I,
                                 _P]}),
    'trace_nonseq_fwd': ('trace_nonseq_fwd.cu', {
        'rtt_trace_nonseq_fwd': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
        + _PLATES + _EXT + [_I, _L, _P],
        'rtt_trace_nonseq_fwd_streams': [_P, _P, _I] + [_P] * 16 + [_I, _I]
        + _GRID + _PLATES + _STREAMS + [_P] + _KEY + [_I, _L, _P],
        'rtt_trace_nonseq_fwd_field': [_P, _P, _I] + [_P] * 16 + [_I, _I]
        + _GRID + _PLATES + _STREAMS + [_P] + _KEY + _FIELD_FWD
        + [_I, _L, _P],
        'rtt_trace_nonseq_fwd_occupancy': _OCCUPANCY,
        'rtt_philox4x32': [_P, _P, _P, _I, _P]}),
    'trace_nonseq_bwd': ('trace_nonseq_bwd.cu', {
        'rtt_trace_nonseq_bwd': [_P, _P, _I] + [_P] * 31 + [_I, _I] + _GRID
        + _PLATES + [_P] + _WAVE + _EXT + [_I, _L, _P],
        'rtt_trace_nonseq_bwd_opl': [_P, _P, _I] + [_P] * 31 + [_I, _I]
        + _GRID + _PLATES + [_P] + _WAVE + _OPL + _KEY + [_I, _L, _P],
        'rtt_trace_nonseq_bwd_field': [_P, _P, _I] + [_P] * 31 + [_I, _I]
        + _GRID + _PLATES + [_P] + _WAVE + _OPL + _KEY + _FIELD_BWD
        + [_P, _I, _L, _P],
        'rtt_trace_nonseq_bwd_occupancy': _OCCUPANCY,
        'rtt_trace_nonseq_bwd_smem': [_I] * 6 + [_U, _I,
                                                  ctypes.POINTER(
                                                      ctypes.c_longlong)]}),
}
_fns = {}


def _check_limits(n_rows, cfg: SensorConfig):
    n_slots = max(cfg.n_sensors, 1)
    if not 0 < n_rows <= MAX_ROWS or n_slots > MAX_SLOTS \
            or not 0 < cfg.n_bundles <= MAX_BUNDLES:
        raise NotImplementedError(
            f'the fused kernel takes 1..{MAX_ROWS} rows, up to {MAX_SLOTS} '
            f'sensor slots and 1..{MAX_BUNDLES} bundles; got {n_rows} rows, '
            f'{n_slots} slots and {cfg.n_bundles} bundles')
    return n_slots


def plate_rows(static_meta):
    """The PHASE_GRID rows, in table order (the order of the maps)."""
    return tuple(k for k, m in enumerate(static_meta)
                 if m.ph == PhysKind.PHASE_GRID)


def ext_kinds(static_meta):
    """Whether a row has a kind that only the kernels' instantiation with
    the extended kinds (and those built on it) takes: an even asphere, a
    rectangular volume bound, a cylindrical lens's edge bound, a solid's
    half-spaces, a cone's nappe or a dispersive medium."""
    return any(m.asph or m.disp or m.vb in (VBKind.RECT, VBKind.CYL_EDGE,
                                            VBKind.HALFSPACES)
               or m.sb == SBKind.CONE_NAPPE for m in static_meta)


def fresnel_kinds(static_meta):
    """Whether a row has a Fresnel kind (FRESNEL, FRESNEL_W, REFLECT_W), a
    family of the kernels' family instantiation."""
    return any(m.ph in FRESNEL_KINDS for m in static_meta)


def coating_kinds(static_meta):
    """Whether a row's thin-film stack or metal substrate acts
    (``coat_acts``; in a trace with the field ``field_coat_acts``), a family
    of the kernels' family instantiation."""
    return any(coat_bits(m, field_kinds(static_meta)) for m in static_meta)


def diffractive_kinds(static_meta):
    """Whether a row is a diffractive or ideal element (LINEAR, GRATING,
    DOE, MLA) or has an ELLIPSE bound, a family of the kernels' family
    instantiation."""
    return any(m.ph in DIFFRACTIVE_KINDS or m.sb == SBKind.ELLIPSE
               for m in static_meta)


def fuzzy_kinds(static_meta):
    """Whether the trace applies fuzzy apodization (a ``TraceMeta`` with
    callables), a family of the kernels' family instantiation."""
    return bool(getattr(static_meta, 'fuzzy', None))


def freeform_kinds(static_meta):
    """Whether a row is a freeform surface (``meta.ff``), a family of the
    kernels' family instantiation."""
    return any(m.ff for m in static_meta)


def grin_kinds(static_meta):
    """Whether a row is a GRIN rod, a family of the kernels' family
    instantiation."""
    return any(m.ph == PhysKind.GRIN for m in static_meta)


def families(static_meta):
    """The ``FAM_*`` bits of the families of kinds a trace's table has:
    the family instantiation runs it when any is set (and the field's reads
    them)."""
    return ((FAM_FRESNEL if fresnel_kinds(static_meta) else 0)
            | (FAM_COAT if coating_kinds(static_meta) else 0)
            | (FAM_DIFF if diffractive_kinds(static_meta) else 0)
            | (FAM_FUZZY if fuzzy_kinds(static_meta) else 0)
            | (FAM_FREEFORM if freeform_kinds(static_meta) else 0)
            | (FAM_GRIN if grin_kinds(static_meta) else 0))


def check_grin_kinds(static_meta):
    """Raise NotImplementedError when a fused trace of GRIN rows carries
    the polarized field, which the kernels' field instantiation does not
    take through a rod (ROADMAP Queue 1 position 4b).  The eager traces
    take it."""
    if grin_kinds(static_meta) and field_kinds(static_meta):
        raise NotImplementedError(
            'the fused trace takes no GRIN rod under the polarized field '
            'until ROADMAP Queue 1 position 4b: use simulate')


def field_kinds(static_meta):
    """Whether the trace carries the polarized field (a ``TraceMeta`` with
    ``field``), which only the kernels' instantiation with the field
    takes."""
    return bool(getattr(static_meta, 'field', False))


def ff_side(static_meta, device):
    """The ``[K, FF_SIDE]`` int32 side buffer of freeform surfaces: per row
    its term count and its exponent pairs packed as ``i | j << 16`` (zeros
    for a row that is not freeform); None when no row is freeform.  An
    exponent above FF_MAX_EXPONENT raises NotImplementedError."""
    if not freeform_kinds(static_meta):
        return None
    rows = []
    for k, m in enumerate(static_meta):
        pw = m.ff or ()
        if len(pw) > MAX_FF_TERMS:
            raise NotImplementedError(
                f'row {k}: {len(pw)} freeform terms, over MAX_FF_TERMS = '
                f'{MAX_FF_TERMS}')
        if any(not 0 <= e <= FF_MAX_EXPONENT for ij in pw for e in ij):
            raise NotImplementedError(
                f'row {k}: a freeform exponent outside 0..FF_MAX_EXPONENT '
                f'= {FF_MAX_EXPONENT} (the side buffer packs each pair '
                f'into one int32 word)')
        words = [len(pw)] + [i | j << 16 for i, j in pw]
        rows.append(words + [0] * (FF_SIDE - len(words)))
    return torch.tensor(rows, dtype=torch.int32, device=device)


class TraceMeta(tuple):
    """A fused trace's static row metadata (one StaticRowMeta a row) with
    its fuzzy apodization: ``fuzzy``, {row: component-style callable}, and
    ``words``, their packed programs (ops/fuzzy_program.py::pack; None
    without a callable); ``field``, whether the trace carries the polarized
    field.  Building it traces the callables, so one that the kernels cannot
    run raises NotImplementedError on either device."""

    def __new__(cls, static_meta, fuzzy_fns=None, field=False):
        self = super().__new__(cls, static_meta)
        self.fuzzy = dict(fuzzy_fns or {})
        self.words = fuzzy_program.pack(self.fuzzy, len(self))
        self.field = bool(field)
        return self


def fuzzy_buffer(static_meta, device):
    """The int32 program buffer of a ``TraceMeta``'s callables on
    ``device``; None without a callable."""
    return fuzzy_program.buffer(getattr(static_meta, 'words', None), device)


def doe_bits(m):
    """A DOE row's term count and efficiency flag in its kinds row's physics
    column (shifted by DOE_SHIFT); 0 for every other row."""
    if m.ph != PhysKind.DOE:
        return 0
    n_terms, efficiency = m.doe
    return (n_terms | (DOE_EFFICIENCY if efficiency else 0)) << DOE_SHIFT


def jones_bits(m):
    """A JONES row's static bits in its kinds row's physics column (shifted
    by COAT_SHIFT): chromatic in bit 0, its crystal (1 + its index in
    JONES_CRYSTALS) in bits 1-2; 0 for every other row."""
    if m.ph != PhysKind.JONES:
        return 0
    crystal = (JONES_CRYSTALS.index(m.jones_bire) + 1
               if m.jones_bire is not None else 0)
    return (int(m.jones_chrom) | crystal << 1) << COAT_SHIFT


def coat_bits(m, field=False):
    """A row's coating data in its kinds row's physics column (shifted by
    COAT_SHIFT): 0 unless its stack or metal acts (``coat_acts``; with
    ``field``, a trace with the polarized field, ``field_coat_acts``)."""
    if not (field_coat_acts(m) if field else coat_acts(m)):
        return 0
    return ((m.n_coat | (COAT_METAL if m.metal else 0)
             | (COAT_METAL_NK if m.metal_nk is not None else 0)
             | (COAT_ABSORBING if m.coat_k is not None else 0))
            << COAT_SHIFT)


def coat_side(static_meta, device):
    """The ``[K, COAT_SIDE]`` float32 side buffer of the coatings: per row
    its layers' extinction coefficients (8, zeros for a dielectric stack)
    and a dispersive metal's 6 n and 6 k knots on METAL_GRID_UM (zeros
    otherwise); None when no row's coating acts (``coating_kinds``)."""
    if not coating_kinds(static_meta):
        return None
    rows = []
    for m in static_meta:
        ks = list(m.coat_k or ())
        nk = m.metal_nk or ((0.0,) * 6, (0.0,) * 6)
        rows.append(ks + [0.0] * (8 - len(ks)) + list(nk[0]) + list(nk[1]))
    return torch.tensor(rows, dtype=torch.float32, device=device)


def dispersive(static_meta):
    """Whether a row refracts at per-ray indices (``dispersive_iors``)."""
    return any(m.disp for m in static_meta)


def dispersive_kinds(kinds):
    """Whether a kinds tensor of ``kind_rows`` has a dispersive row (its
    physics column carries DispModels): one small read of the tensor, for
    the K2 and K6 wrappers when their caller does not say."""
    return bool((kinds[:, 0] >> DISP_SHIFT).any())


def grin_rows(kinds):
    """Whether a kinds tensor of ``kind_rows`` has a GRIN row (its physics
    column's kind below the dispersion bits): one copy of the [K, 8] tensor
    to the host, which picks the K1, K2, K5 and K6 wrappers' instantiation
    when their caller does not say."""
    mask = (1 << DISP_SHIFT) - 1
    return any((row[0] & mask) == PhysKind.GRIN for row in kinds.tolist())


def kind_rows(static_meta, cfg: SensorConfig):
    """[K, KIND_WIDTH] int rows the kernels read; raises NotImplementedError
    for anything the kernels do not take.  The surface column holds
    SURF_QUADRIC, SURF_PLANE, SURF_ASPHERE or SURF_FREEFORM (a freeform
    row, whose base is an asphere's); a dispersive row's physics
    column adds its two DispModels from bit DISP_SHIFT on, a coated or
    metal row's coating data from bit COAT_SHIFT on (``coat_bits``) and a
    DOE row's term count and efficiency flag from bit DOE_SHIFT on
    (``doe_bits``); the last column is a PHASE_GRID row's map index or a
    GRIN row's RK4 step count (0 for every other row)."""
    n_slots = _check_limits(len(static_meta), cfg)
    maps = {k: j for j, k in enumerate(plate_rows(static_meta))}
    rows = []
    for k, m in enumerate(static_meta):
        why = unsupported(m)
        if why:
            raise NotImplementedError(f'fused trace, row {k}: {why}')
        if m.sensor and not 0 <= m.slot < n_slots:
            raise ValueError(f'row {k}: sensor slot {m.slot} outside '
                             f'0..{n_slots - 1}')
        if m.ph == PhysKind.GRIN and m.grin_steps > MAX_GRIN_STEPS:
            raise NotImplementedError(
                f'fused trace, row {k}: a GRIN rod of {m.grin_steps} RK4 '
                f'steps, over MAX_GRIN_STEPS = {MAX_GRIN_STEPS} (ROADMAP '
                f'Queue 2 I): use simulate')
        # a row is freeform (its ff columns the monomials' coefficients) or
        # DOE (its ff columns the radial phase's), never both
        surf = (SURF_FREEFORM if m.ff else SURF_ASPHERE if m.asph
                else SURF_PLANE if m.plane else SURF_QUADRIC)
        ph = (m.ph | coat_bits(m, field_kinds(static_meta)) | doe_bits(m)
              | jones_bits(m))
        if m.disp:
            ph |= (m.dispm[0] << DISP_SHIFT) | (m.dispm[1] << DISP_SHIFT + 2)
        last = m.grin_steps if m.ph == PhysKind.GRIN else maps.get(k, 0)
        rows.append([ph, m.sb, m.vb, surf, int(m.sensor), m.slot,
                     int(m.invert), last])
    return rows


def plate_maps(static_meta, grids):
    """The ``[H, W]`` maps of the PHASE_GRID rows, in row order, from
    ``grids`` ({row: map}); raises if a plate row has none.

    None when no row has a plate's kinds (PHASE_GRID physics, the RECT
    bound), the extended kinds (``ext_kinds``), a coating that acts
    (``coating_kinds``: a stack reads the rays' wavelength), a diffractive
    kind (``diffractive_kinds``: a grating and a DOE read it), fuzzy
    apodization or a freeform surface (``fuzzy_kinds``, ``freeform_kinds``)
    or the field: the kernels then run their instantiation without plate
    code.  Such a scene without a plate gives ``()``."""
    grids = grids or {}
    missing = [k for k in plate_rows(static_meta) if k not in grids]
    if missing:
        raise ValueError(f'PHASE_GRID rows {missing} have no phase map: '
                         f'pass grids={{row: map}} (Scene.side_grids)')
    if not (any(m.ph == PhysKind.PHASE_GRID or m.sb == SBKind.RECT
                for m in static_meta) or ext_kinds(static_meta)
            or coating_kinds(static_meta)
            or diffractive_kinds(static_meta) or fuzzy_kinds(static_meta)
            or freeform_kinds(static_meta) or field_kinds(static_meta)):
        return None
    return tuple(grids[k] for k in plate_rows(static_meta))


class StreamFlags(collections.namedtuple(
        'StreamFlags', ('track_opl', 'record_paths', 'record_hits',
                        'track_field'), defaults=(False,))):
    """Which optional streams a fused trace computes: the deterministic
    ones and the polarized field."""

    @property
    def any(self):
        return (self.track_opl or self.record_paths or self.record_hits
                or self.track_field)

    @property
    def records(self):
        return self.record_paths or self.record_hits

    def stream_kw(self):
        """The deterministic streams' flags by name."""
        return dict(track_opl=self.track_opl, record_paths=self.record_paths,
                    record_hits=self.record_hits)

    def keys(self, nonseq=False):
        """The keys of the streams' outputs, in the order of the autograd
        Functions' outputs (the field's six as ``FIELD_KEYS``, which
        ``field_aux`` gathers into ``aux['field']``)."""
        return ((('opl', 'n_final') if self.track_opl else ())
                + (('paths',) if self.record_paths else ())
                + ((('hits', 'hit_weights')
                    + (('hit_slots',) if nonseq else ()))
                   if self.record_hits else ())
                + (FIELD_KEYS if self.track_field else ()))


NO_STREAMS = StreamFlags(False, False, False)


def field_aux(aux):
    """``aux`` with the field's six ``FIELD_KEYS`` streams gathered into
    ``aux['field']`` (a FieldState) and ``aux['field_power']`` (its
    |E|^2), as core/trace.py::trace_sequential returns them."""
    if FIELD_KEYS[0] not in aux:
        return aux
    aux = dict(aux)
    field = FieldState(*(aux.pop(k) for k in FIELD_KEYS))
    aux['field'], aux['field_power'] = field, field.power()
    return aux


def trace_sequential_fused(table, rays, cfg: SensorConfig, static_meta,
                           grids=None, track_opl=False, record_paths=False,
                           record_hits=False, generator=None, uniforms=None,
                           fuzzy_fns=None, track_field=False, E0=None):
    """Fused trace -> ``(rays, SensorState)``, differentiable with respect
    to the table, the 7 ray streams px..intensity and the phase maps of
    ``grids`` ({PHASE_GRID row: [H, W] map}).  With any of ``track_opl``,
    ``record_paths`` and ``record_hits`` -> ``(rays, SensorState, aux)``
    (core/trace.py::trace_sequential's ``aux``).  A table with FRESNEL rows
    reads ``uniforms`` ([F, N], one stream per such row in row order) or
    streams drawn from ``generator`` (rays/draws.py), as the eager
    ``trace_sequential`` does; with neither it raises ValueError.
    ``fuzzy_fns`` ({row: callable}) must hold component-style callables
    within the kernels' op set (``TraceMeta``).  ``track_field=True`` carries
    the polarized field from ``E0`` (core/field.py::FieldState.init, made
    here in torch, so E0 and the launch directions get its cotangent):
    ``aux`` then holds ``field`` and ``field_power``, and the sensors weigh
    by |E|^2, through coated interfaces and metal mirrors too.

    CPU tensors run the plain versions; CUDA tensors launch the kernels (or
    raise: there is no fallback)."""
    flags = StreamFlags(track_opl, record_paths, record_hits, track_field)
    static_meta = TraceMeta(static_meta, fuzzy_fns, track_field)
    flat, kinds_t = flat_inputs(table, rays, cfg, static_meta)
    u = sequential_uniforms(static_meta, rays.n, rays.px.device, generator,
                            uniforms)
    draws = u if u.shape[0] else None
    maps = plate_maps(static_meta, grids)
    comps = [getattr(rays, c) for c in COMPS]
    field = FieldState.init(rays, E0).streams() if track_field else ()
    if needs_grad(flat, rays, maps) or any(f.requires_grad for f in field):
        if flags.any or draws is not None:
            outs = FusedTraceStreams.apply(flat, kinds_t, cfg, static_meta,
                                           flags, draws,
                                           *comps, rays.ray_id,
                                           *plate_inputs(rays, maps), *field)
            return unpack(outs, rays, cfg, flags)
        return unpack(FusedTrace.apply(flat, kinds_t, cfg, static_meta,
                                       *comps, rays.ray_id,
                                       *plate_inputs(rays, maps)),
                      rays, cfg)
    res = _forward(flat, kinds_t, rays, cfg, static_meta, maps, flags, draws,
                   field or None)
    return (*res[:2], field_aux(res[2])) if flags.any else res


def trace_sequential_v1(table, rays, cfg: SensorConfig, static_meta):
    """The fused trace with every stream off -> ``(rays, SensorState,
    {})``: the counterpart of ``trace_sequential_pallas`` (TPU kernel
    ``_kernel``), forward only.

    Its contract is the TPU kernel's: no irradiance grid, no stochastic
    (FRESNEL), GRIN or phase-grid rows, at
    most 8 sensor slots; FRESNEL_W and REFLECT_W take K1's instantiation
    with the Fresnel kinds, coated and metal rows the one with the
    coatings, the diffractive and ideal elements theirs, freeform surfaces
    theirs.  Its function is
    K1's with the grid and the maps off, so on CUDA tensors it launches
    K1's kernel so (counted in ``V1_LAUNCHES``; a RECT bound takes its
    instantiation with plate code, with no map, and the extended kinds
    theirs, which reads the wavelength of a dispersive row); CPU tensors run
    the plain version.  On a dispersive row it follows the chain and
    refracts at each ray's index, where the TPU kernel refracts at the
    d-line index (ROADMAP Queue 3)."""
    global V1_LAUNCHES
    if cfg.grid_shape:
        raise ValueError('trace_sequential_v1 takes no irradiance grid: use '
                         'trace_sequential_fused')
    if plate_rows(static_meta):
        raise ValueError('trace_sequential_v1 takes no phase-grid rows: use '
                         'trace_sequential_fused')
    if draws_per_ray(static_meta):
        raise ValueError('trace_sequential_v1 takes no stochastic (FRESNEL) '
                         'rows: use trace_sequential_fused')
    if grin_kinds(static_meta):
        raise ValueError('trace_sequential_v1 takes no GRIN rows (as the TPU '
                         'kernel it stands for): use trace_sequential_fused')
    flat, kinds_t = flat_inputs(table, rays, cfg, static_meta)
    if flat.device.type == 'cpu':
        out, sensors = trace_sequential_fused_plain(flat, rays, cfg,
                                                    static_meta)
    else:
        out, sensors, launched = _seq_fwd_launch(
            flat, kinds_t, rays, cfg, plate_maps(static_meta, None),
            'trace_sequential_v1', ext_kinds(static_meta),
            fresnel=fresnel_kinds(static_meta),
            coat=coat_side(static_meta, flat.device),
            diff=diffractive_kinds(static_meta),
            fuzzy=fuzzy_buffer(static_meta, flat.device),
            ff=ff_side(static_meta, flat.device))
        V1_LAUNCHES += launched
    return out, sensors, {}


def unpack(outs, rays, cfg, flags=NO_STREAMS, nonseq=False):
    """The outputs of ``FusedTrace`` or ``FusedNonseq`` -> ``(rays,
    SensorState)``; of their ``...Streams`` versions with ``flags`` ->
    ``(rays, SensorState, aux)``."""
    grid = outs[8] if cfg.grid_shape else SensorState.init(
        cfg, device=outs[7].device).grid
    res = (rays.replace(**dict(zip(COMPS, outs[:7]))),
           SensorState(moments=outs[7], grid=grid))
    if not flags.any:
        return res
    first = 9 if cfg.grid_shape else 8
    return res + (field_aux(dict(zip(flags.keys(nonseq), outs[first:]))),)


def flat_inputs(table, rays, cfg, static_meta):
    """The flat [K, 160] table and the [K, 8] int32 kinds on the rays'
    device, for K1 and K5; raises before anything runs on rows or limits
    the kernels do not take (a JONES row outside a trace with the field and
    the GRIN rows of ``check_grin_kinds`` among them)."""
    kinds = kind_rows(static_meta, cfg)
    check_grin_kinds(static_meta)
    if not field_kinds(static_meta) and any(m.ph == PhysKind.JONES
                                            for m in static_meta):
        raise NotImplementedError(
            'polarizer/waveplate (JONES) surfaces act on the tracked '
            'E-field: trace with track_field=True (an unpolarized ensemble '
            'has no per-ray Jones action)')
    device = rays.px.device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no fused trace for device {device}')
    return (flatten_table_rows(table),
            torch.tensor(kinds, dtype=torch.int32, device=device))


def needs_grad(flat, rays, maps=None):
    """Whether a fused trace runs under autograd: the table, a ray stream, a
    phase map or (when the kernels read it: ``maps`` not None) the
    wavelength requires grad."""
    return torch.is_grad_enabled() and (
        flat.requires_grad
        or any(getattr(rays, c).requires_grad for c in COMPS)
        or any(m.requires_grad for m in maps or ())
        or (maps is not None and rays.wavelength is not None
            and rays.wavelength.requires_grad))


def plate_inputs(rays, maps):
    """The trailing tensor arguments of ``FusedTrace`` and ``FusedNonseq``:
    ``(wavelength, *maps)`` with plate code (``plate_maps`` not None, which
    the extended kinds, dispersion among them, always have), none
    without."""
    return (wavelength_of(rays), *maps) if maps is not None else ()


def split_plates(plates):
    """``plate_inputs`` -> ``(wavelength, maps)``, both None without plate
    code."""
    return (plates[0], plates[1:]) if plates else (None, None)


def wavelength_of(rays):
    """The rays' wavelength stream (zeros, unset, where they carry none)."""
    if rays.wavelength is None:
        return torch.zeros_like(rays.px)
    return rays.wavelength


def _forward(flat, kinds, rays, cfg, static_meta, maps=None,
             flags=NO_STREAMS, uniforms=None, field=None):
    if flat.device.type == 'cpu':
        return trace_sequential_fused_plain(flat, rays, cfg, static_meta,
                                            maps, **flags.stream_kw(),
                                            uniforms=uniforms, field=field)
    return trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps,
                              ext_kinds(static_meta), **flags.stream_kw(),
                              fresnel=fresnel_kinds(static_meta),
                              uniforms=uniforms,
                              coat=coat_side(static_meta, flat.device),
                              diff=diffractive_kinds(static_meta),
                              fuzzy=fuzzy_buffer(static_meta, flat.device),
                              ff=ff_side(static_meta, flat.device),
                              field=field, grin=grin_kinds(static_meta))


def _rays_of(comps, ray_id, wavelength):
    # the fused trace reads the wavelength (phase plates, dispersion) and
    # returns it unchanged
    return Rays(**dict(zip(COMPS, comps)), ray_id=ray_id,
                wavelength=wavelength)


class FusedTrace(torch.autograd.Function):
    """The fused trace with its backward: K1 forward, K2 backward on CUDA
    tensors; the plain versions on CPU tensors.

    Counterpart of ``fused_trace_grad`` / ``_fused_fwd`` / ``_fused_bwd``.
    Like ``_fused_fwd`` it keeps only its inputs (table, input rays, phase
    maps) as residuals; the backward re-runs the chain.  The wavelength is
    read (phase plates, dispersion) and gets the cotangent of that reading
    when it requires grad, which K2 computes in its instantiation with the
    extended kinds; it is not an output, so its identity pass-through is
    left to autograd.  Like the JAX ``custom_vjp`` it has no higher-order
    or forward-mode rule.

    ``apply(flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz, intensity,
    ray_id, *plates)`` -> the 7 output ray streams, ``moments [S, B, 7]``
    and, when ``cfg.grid_shape`` is set, ``grid [S, H, W]``.  ``plates`` is
    empty without a phase plate, else ``(wavelength, *maps)``
    (``plate_inputs``), the maps being the PHASE_GRID rows' in row order
    (``plate_maps``); their cotangents and the wavelength's come from
    K2."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz,
                intensity, ray_id, *plates):
        return fused_forward(ctx, _forward, flat_table, kinds, cfg, meta,
                             NO_STREAMS, None,
                             (px, py, pz, dx, dy, dz, intensity), ray_id,
                             plates)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        need = ctx.needs_input_grad
        res = _fused_backward(ctx, grads,
                              need[:4] + (False, False) + need[4:])
        return res[:4] + res[6:]


class FusedTraceStreams(torch.autograd.Function):
    """``FusedTrace`` with the deterministic streams ``flags``
    (``StreamFlags``) as outputs after the grid: ``opl`` and ``n_final``
    [N], ``paths`` [K + 1, N, 3], ``hits`` [K, N, 3] and ``hit_weights``
    [K, N] (each when asked for), and with ``uniforms``, the FRESNEL rows'
    ``[F, N]`` draws (None: no row draws; no derivative), which forward and
    backward both read.  With ``flags.track_field`` the launch field's six
    streams follow the plates as inputs and the final field's six
    (``FIELD_KEYS``) follow the other streams as outputs.

    ``apply(flat_table, kinds, cfg, meta, flags, uniforms, px, ..., ray_id,
    *plates, *field)``.  Backward: with ``track_opl`` alone (or no stream),
    K2 (or its plain version) with the cotangents of ``opl`` and
    ``n_final``; a
    recording run recomputes through the eager chain with autograd, on the
    same draws, as the reference's ``_fused_bwd`` does through its XLA trace
    (``plain_vjp``, ``RECORD_RECOMPUTES``)."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, flags, uniforms, px, py,
                pz, dx, dy, dz, intensity, ray_id, *plates):
        n_field = 6 if flags.track_field else 0
        return fused_forward(ctx, _forward, flat_table, kinds, cfg, meta,
                             flags, uniforms,
                             (px, py, pz, dx, dy, dz, intensity), ray_id,
                             plates[:len(plates) - n_field],
                             field=plates[len(plates) - n_field:])

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        return _fused_backward(ctx, grads, ctx.needs_input_grad)


def fused_forward(ctx, forward, flat_table, kinds, cfg, meta, flags, draws,
                  comps, ray_id, plates, *extra, field=()):
    """The shared forward of the fused autograd Functions: runs ``forward``
    (``_forward`` here, ops/fused_nonseq.py's there, ``extra`` its bounce
    budget) with the trace's ``draws`` (the sequential ``[F, N]`` uniforms,
    the non-sequential Philox key, or None) and the launch ``field`` (six
    streams; none without the field), saves the inputs and returns the
    outputs: the 7 ray streams, the moments, the grid (when
    ``cfg.grid_shape`` is set) and the streams of ``flags``."""
    wavelength, maps = split_plates(plates)
    res = forward(flat_table, kinds, _rays_of(comps, ray_id, wavelength),
                  cfg, meta, *extra, maps, flags, draws,
                  **({'field': tuple(field)} if field else {}))
    out, sensors = res[:2]
    ctx.save_for_backward(flat_table, kinds, *comps, ray_id, *plates,
                          *field)
    ctx.n_field = len(field)
    ctx.cfg, ctx.meta, ctx.flags, ctx.draws = cfg, meta, flags, draws
    ctx.set_materialize_grads(False)
    grid = (sensors.grid,) if cfg.grid_shape else ()
    aux = res[2] if flags.any else {}
    streams = tuple(aux[k] for k in flags.keys('hit_slots' in aux))
    if 'hit_slots' in aux:
        ctx.mark_non_differentiable(aux['hit_slots'])
    return (*(getattr(out, c) for c in COMPS), sensors.moments, *grid,
            *streams)


def saved_inputs(ctx):
    """The saved inputs of a fused autograd Function -> ``(flat, kinds,
    rays, maps)`` (the launch field, saved after them: ``saved_field``)."""
    saved = ctx.saved_tensors
    flat, kinds, *comps, ray_id = saved[:10]
    wavelength, maps = split_plates(saved[10:len(saved) - ctx.n_field])
    return flat, kinds, _rays_of(comps, ray_id, wavelength), maps


def saved_field(ctx):
    """The saved launch field of a fused autograd Function (six streams), or
    None without the field."""
    n = ctx.n_field
    return tuple(ctx.saved_tensors[-n:]) if n else None


def stream_cotangents(ctx, grads):
    """The cotangents of a fused Function's outputs -> ``(g_rays, g_moments,
    g_grid, g_aux)``, ``g_aux`` keyed as ``aux`` (None for zero)."""
    first = 9 if ctx.cfg.grid_shape else 8
    g_grid = grads[8] if ctx.cfg.grid_shape else None
    nonseq = hasattr(ctx, 'n_bounces')
    return (grads[:7], grads[7], g_grid,
            dict(zip(ctx.flags.keys(nonseq), grads[first:])))


def _fused_backward(ctx, grads, need):
    """``FusedTraceStreams``'s backward (``FusedTrace``'s with ``need``
    holding False for the flags) -> the cotangents of its inputs."""
    global RECORD_RECOMPUTES
    flat, kinds, rays, maps = saved_inputs(ctx)
    field = saved_field(ctx)
    g_rays, g_moments, g_grid, g_aux = stream_cotangents(ctx, grads)
    # the launch field's inputs come last: the plates' need before them
    need_field = need[len(need) - ctx.n_field:] if field else ()
    need = need[:len(need) - ctx.n_field]
    need_table, need_rays = need[0], any(need[6:13])
    need_maps, need_wl = any(need[15:]), len(need) > 14 and need[14]
    if ctx.flags.records:
        RECORD_RECOMPUTES += 1
        res = plain_vjp(
            lambda f, r, m, fld=None: _chain(f, r, ctx.cfg, ctx.meta, m,
                                             ctx.flags, plain=False,
                                             uniforms=ctx.draws, field=fld),
            flat, rays, g_rays, g_moments, g_grid, maps, need_wl, g_aux,
            field=field)
    elif flat.device.type == 'cuda':
        res = trace_seq_bwd_cuda(flat, kinds, rays, ctx.cfg, g_rays,
                                 g_moments, need_table, need_rays,
                                 g_grid=g_grid, maps=maps,
                                 need_maps=need_maps,
                                 ext=ext_kinds(ctx.meta),
                                 disp=dispersive(ctx.meta),
                                 need_wavelength=need_wl,
                                 g_opl=g_aux.get('opl'),
                                 g_nfinal=g_aux.get('n_final'),
                                 opl=ctx.flags.track_opl,
                                 fresnel=fresnel_kinds(ctx.meta),
                                 uniforms=ctx.draws,
                                 coat=coat_side(ctx.meta, flat.device),
                                 diff=diffractive_kinds(ctx.meta),
                                 fuzzy=fuzzy_buffer(ctx.meta, flat.device),
                                 ff=ff_side(ctx.meta, flat.device),
                                 field=field,
                                 g_field=[g_aux.get(k) for k in FIELD_KEYS],
                                 grin=grin_kinds(ctx.meta))
    else:
        res = trace_seq_bwd_plain(flat, rays, ctx.cfg, ctx.meta, g_rays,
                                  g_moments, g_grid=g_grid, maps=maps,
                                  need_wavelength=need_wl,
                                  g_opl=g_aux.get('opl'),
                                  g_nfinal=g_aux.get('n_final'),
                                  uniforms=ctx.draws, field=field,
                                  g_field=[g_aux.get(k) for k in FIELD_KEYS])
    if field is None:
        return backward_result(res, maps, need, 6)
    g_field = res[-1]
    return backward_result(res[:-1], maps, need, 6) + tuple(
        g if n else None for g, n in zip(g_field, need_field))


def backward_result(res, maps, need, first):
    """A backward's result ``res`` (``plain_vjp``'s layout) -> the
    cotangents of a fused Function's inputs, whose 7 ray streams start at
    input ``first``; None for every input not needing one."""
    g_flat, g_in = res[:2]
    g_in = [g if n else None
            for g, n in zip(g_in or (None,) * 7, need[first:first + 7])]
    return ((g_flat if need[0] else None,) + (None,) * (first - 1)
            + (*g_in, None) + plate_cotangents(res, maps, need[first + 8:]))


def plate_cotangents(res, maps, need):
    """The trailing cotangents of ``FusedTrace`` and ``FusedNonseq`` for
    their ``plate_inputs``: the wavelength's (the fourth item of a
    backward's result ``res``, when ``need[0]`` asked for it) and the maps'
    (its third)."""
    if maps is None:
        return ()
    g_maps = (res[2] if len(res) > 2 else None) or (None,) * len(maps)
    return (res[3] if need[0] else None,
            *(g if n else None for g, n in zip(g_maps, need[1:])))


def _chain(flat_table, rays, cfg, static_meta, maps=None, flags=NO_STREAMS,
           plain=True, uniforms=None, field=None):
    """The eager chain of core/trace.py over the rows of the flat table ->
    ``(rays, SensorState)``, with ``flags``' streams ``(rays, SensorState,
    aux)``; ``uniforms`` holds the FRESNEL rows' ``[F, N]`` draws; a
    ``TraceMeta``'s callables apodize their rows; ``field`` (six streams,
    with ``flags.track_field``) is the launch field, and ``aux`` holds the
    final one's as ``FIELD_KEYS``.  ``plain=False`` runs K3's and K4's
    kernels on CUDA tensors, as the eager ``simulate`` does."""
    streams = Streams.of(rays, **flags.stream_kw())
    rows = [FlatRow(flat_table[k]) for k in range(len(static_meta))]
    uniforms = sequential_uniforms(static_meta, rays.n, rays.px.device,
                                   uniforms=uniforms)
    res = surface_chain(
        rows, rays, cfg, static_meta, torch.float32, plain=plain,
        grids=dict(zip(plate_rows(static_meta), maps or ())), streams=streams,
        uniforms=uniforms, fuzzy_fns=getattr(static_meta, 'fuzzy', None),
        field=FieldState(*field) if flags.track_field else None)
    if not flags.any:
        return res
    aux = streams.aux() if streams is not None else {}
    if flags.track_field:
        aux.update(zip(FIELD_KEYS, res[2].streams()))
    return res[0], res[1], aux


def trace_sequential_fused_plain(flat_table, rays, cfg: SensorConfig,
                                 static_meta, maps=None, track_opl=False,
                                 record_paths=False, record_hits=False,
                                 uniforms=None, field=None):
    """K1's function in plain torch: the eager chain of core/trace.py over
    the rows of the flat table the kernel reads, with the phase maps
    ``maps`` of its PHASE_GRID rows (in row order) and the FRESNEL rows'
    ``[F, N]`` ``uniforms`` -> ``(rays, SensorState)``, with any stream
    ``(rays, SensorState, aux)``.  A ``TraceMeta`` ``static_meta`` applies
    its fuzzy callables themselves.  ``field``, the launch field's six
    streams (None: no field), traces the field: ``aux`` then holds the
    final field's six as ``FIELD_KEYS``."""
    return _chain(flat_table, rays, cfg, static_meta, maps,
                  StreamFlags(track_opl, record_paths, record_hits,
                              field is not None),
                  uniforms=uniforms, field=field)


def trace_seq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                        g_rays, g_moments, g_grid=None, maps=None,
                        need_wavelength=False, g_opl=None, g_nfinal=None,
                        uniforms=None, field=None, g_field=None):
    """K2's function in plain torch: re-run ``trace_sequential_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments,
    ``g_grid`` that of the [S, H, W] grid and ``g_opl`` / ``g_nfinal``
    those of the ``opl`` and ``n_final`` streams (each None for zero; either
    given runs the chain with ``track_opl``).  Returns ``(g_flat [K, 160],
    7 input-ray cotangents)``, with phase maps their cotangents third, and
    with ``need_wavelength`` the wavelength's cotangent fourth (the maps'
    then ``()`` without maps).  ``uniforms``: the forward's FRESNEL
    draws.  A ``TraceMeta`` ``static_meta`` applies its fuzzy callables
    themselves.  With ``field``, the launch field's six streams, ``g_field``
    holds the final field's six cotangents (each None for zero), and the
    launch field's six cotangents come last."""
    g_aux = {k: g for k, g in (('opl', g_opl), ('n_final', g_nfinal))
             if g is not None}
    flags = StreamFlags(bool(g_aux), False, False, field is not None)
    if field is not None:
        g_aux.update(zip(FIELD_KEYS, g_field or (None,) * 6))
    return plain_vjp(
        lambda flat, r, m, fld=None: _chain(flat, r, cfg, static_meta, m,
                                            flags, uniforms=uniforms,
                                            field=fld),
        flat_table, rays, g_rays, g_moments, g_grid, maps, need_wavelength,
        g_aux, field=field)


def plain_vjp(forward, flat_table, rays, g_rays, g_moments, g_grid,
              maps=None, need_wavelength=False, g_aux=None, field=None):
    """``torch.autograd.grad`` of ``forward(flat, rays, maps) -> (rays,
    SensorState[, aux])`` at ``(flat_table, rays, maps)`` with the
    cotangents of ``trace_seq_bwd_plain`` and ``g_aux``, those of the
    streams' ``aux`` by key (None or missing: zero) -> ``(g_flat, 7
    input-ray cotangents)``, with maps their cotangents third, and with
    ``need_wavelength`` the wavelength's cotangent fourth; zeros where the
    output does not depend on an input.  It is also the backward of
    ``FusedTraceStreams`` and ``FusedNonseqStreams`` on a recording run,
    with the eager trace as ``forward``, as the reference's ``_fused_bwd``
    recomputes through its XLA trace.  With ``field`` (the launch field's
    six streams) ``forward`` takes them fourth, and their cotangents come
    last."""
    with torch.enable_grad():
        flat = flat_table.detach().requires_grad_(True)
        comps = [getattr(rays, c).detach().requires_grad_(True)
                 for c in COMPS]
        maps_in = [m.detach().requires_grad_(True) for m in maps or ()]
        wl = [wavelength_of(rays).detach().requires_grad_(True)
              for _ in range(int(need_wavelength))]
        r_in = rays.replace(**dict(zip(COMPS, comps)))
        if need_wavelength:
            r_in = r_in.replace(wavelength=wl[0])
        field_in = [f.detach().requires_grad_(True) for f in field or ()]
        res = forward(flat, r_in, tuple(maps_in),
                      *((tuple(field_in),) if field is not None else ()))
        out, sensors = res[:2]
        aux = res[2] if len(res) > 2 else {}
        g_aux = g_aux or {}
        pairs = [(o, g) for o, g in zip(
            [*(getattr(out, c) for c in COMPS), sensors.moments,
             sensors.grid, *(aux[k] for k in g_aux)],
            [*g_rays, g_moments, g_grid, *g_aux.values()])
            if g is not None and o.requires_grad]
        inputs = [flat, *comps, *maps_in, *wl, *field_in]
        grads = (torch.autograd.grad([o for o, _ in pairs],
                                     inputs, [g for _, g in pairs],
                                     allow_unused=True)
                 if pairs else [None] * len(inputs))
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, inputs)]
    g_field = ()
    if field is not None:
        g_field = (tuple(grads[-len(field_in):]),)
        grads = grads[:-len(field_in)]
    if need_wavelength:
        return (grads[0], tuple(grads[1:8]), tuple(grads[8:-1]), grads[-1],
                *g_field)
    if maps is not None:
        return grads[0], tuple(grads[1:8]), tuple(grads[8:]), *g_field
    return grads[0], tuple(grads[1:8]), *g_field


def build():
    """Compile the package's six CUDA libraries (one nvcc each, started
    together; once per source hash) and bind their C entry points.  Returns
    ``{library: (log, seconds)}`` of the nvcc runs (seconds 0.0 when already
    built)."""
    with concurrent.futures.ThreadPoolExecutor(len(_LIBRARIES)) as pool:
        futures = {name: pool.submit(nvcc_build.build_library, name, [src])
                   for name, (src, _) in _LIBRARIES.items()}
    logs = {}
    for name, fut in futures.items():
        path, log, seconds = fut.result()
        lib = ctypes.CDLL(str(path))
        for symbol, argtypes in _LIBRARIES[name][1].items():
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _fns[symbol] = fn
        logs[name] = (log, seconds)
    return logs


def kernel(symbol):
    """The bound C entry point ``symbol``, building the libraries first."""
    if symbol not in _fns:
        build()
    return _fns[symbol]


def blocks_per_sm(library, n_rows, cfg: SensorConfig, plates, n_bounces=0,
                  ext=False, disp=False, streams=False, fresnel=False,
                  coat=False, diff=False, fuzzy_words=0, freeform=False,
                  field=False, grin=False):
    """Resident blocks per SM of the instantiation of K1
    (``library='trace_seq_fwd'``), K2 (``'trace_seq_bwd'``), K5
    (``'trace_nonseq_fwd'``) or K6
    (``'trace_nonseq_bwd'``, with its bounce budget ``n_bounces``) that a
    launch with ``n_rows`` rows, ``cfg``'s slots and bundles and, with
    ``plates``, plate code (with ``ext``, also the extended kinds; with
    ``disp`` too, on a table with a dispersive row; with ``streams``, the
    instantiation with the streams, on a table with a dispersive row when
    ``disp``; with any of the families ``fresnel``, ``coat``, ``diff``,
    ``fuzzy_words`` (programs of that many words), ``freeform`` and
    ``grin``, the family instantiation with those families, likewise; with
    ``field``, the field's with those families, likewise) runs, at that
    launch's dynamic shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` on the current
    device)."""
    out = ctypes.c_int(0)
    fam = ((FAM_FRESNEL if fresnel else 0) | (FAM_COAT if coat else 0)
           | (FAM_DIFF if diff else 0) | (FAM_FUZZY if fuzzy_words else 0)
           | (FAM_FREEFORM if freeform else 0) | (FAM_GRIN if grin else 0))
    code = (6 if field else 5 if fam else 4 if streams
            else (3 if disp else 2) if ext else int(bool(plates)))
    rc = kernel(f'rtt_{library}_occupancy')(
        n_rows, max(cfg.n_sensors, 1), cfg.n_bundles, int(n_bounces), code,
        int(fuzzy_words), fam, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f'{library} occupancy query failed with CUDA '
                           f'error {rc}')
    return out.value


def check(t, name, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def check_inputs(flat_table, kinds, rays, cfg, name):
    """Shared checks of the K1, K2, K5 and K6 wrappers -> (device, K, N, slots,
    bundles)."""
    device = flat_table.device
    if device.type != 'cuda':
        raise ValueError(f'{name} needs CUDA tensors, got {device}')
    k, n = flat_table.shape[0], rays.n
    n_slots = _check_limits(k, cfg)
    check(flat_table, 'table', torch.float32, (k, ROW_WIDTH), device)
    check(kinds, 'kinds', torch.int32, (k, KIND_WIDTH), device)
    for c in COMPS:
        check(getattr(rays, c), c, torch.float32, (n,), device)
    check(rays.ray_id, 'ray_id', torch.int32, (n,), device)
    return device, k, n, n_slots, cfg.n_bundles


def stream(device):
    """The current CUDA stream of ``device``, as the C entry points take
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def grid_args(cfg: SensorConfig, grid):
    """The (pointer, H, W, half extent) C arguments of a grid or of its
    cotangent (a null pointer for None)."""
    h, w = cfg.grid_shape if cfg.grid_shape else (0, 0)
    return (None if grid is None else grid.data_ptr(), h, w,
            float(cfg.grid_half_extent))


def new_grid(cfg: SensorConfig, device):
    """The zeroed [S, H, W] grid a kernel bins into ([S, 0, 0] with none)."""
    h, w = cfg.grid_shape if cfg.grid_shape else (0, 0)
    return torch.zeros(max(cfg.n_sensors, 1), h, w, dtype=torch.float32,
                       device=device)


class PlateBuffers:
    """The phase maps as the kernels read them: ``maps``, every map
    flattened and concatenated (float32); ``desc``, an int32 [P, 3] row
    (offset, H, W) per map; ``wavelength``, the rays' [N] stream.  With no
    map (a RECT bound without a plate) ``maps`` and ``desc`` hold one zero
    entry each, which no row reads: non-null pointers select the kernels'
    instantiation with plate code."""

    def __init__(self, maps, rays, device):
        self.shapes = [tuple(m.shape) for m in maps]
        for j, (m, shape) in enumerate(zip(maps, self.shapes)):
            if m.dim() != 2 or 0 in shape:
                raise ValueError(f'phase map {j} must be a non-empty '
                                 f'[H, W] map, got shape {shape}')
            if m.device != device:
                raise ValueError(f'phase map {j} is on {m.device}, '
                                 f'expected {device}')
        sizes = [h * w for h, w in self.shapes]
        self.offsets = [sum(sizes[:j]) for j in range(len(sizes))]
        self.maps = torch.cat([m.detach().reshape(-1).to(torch.float32)
                               for m in maps]
                              or [torch.zeros(1, device=device)])
        self.desc = torch.tensor(
            [[o, h, w] for o, (h, w) in zip(self.offsets, self.shapes)]
            or [[0, 0, 0]], dtype=torch.int32, device=device)
        self.wavelength = wavelength_of(rays)
        check(self.wavelength, 'wavelength', torch.float32, (rays.n,),
              device)

    def args(self):
        """The (maps, desc, wavelength) C arguments."""
        return (self.maps.data_ptr(), self.desc.data_ptr(),
                self.wavelength.data_ptr())

    def split(self, flat):
        """A buffer laid out as ``maps`` -> one [H, W] view per map."""
        return tuple(flat[o:o + h * w].view(h, w)
                     for o, (h, w) in zip(self.offsets, self.shapes))


def plate_buffers(maps, rays, device):
    """``PlateBuffers`` of ``maps``, or None without plate code (``maps``
    None)."""
    return PlateBuffers(maps, rays, device) if maps is not None else None


def plate_args(plates):
    """The plate C arguments of a launch (null pointers without plate
    code)."""
    return plates.args() if plates is not None else (None, None, None)


def ext_maps(maps, ext):
    """The maps a launch passes: with the extended kinds (which run with
    plate code) at least ``()``."""
    return () if ext and maps is None else maps


def grad_cols(plates, ext, disp=False, coat=False, diff=False,
              freeform=False):
    """The table columns whose cotangents K2 and K6 reduce (``disp``: the
    table has a dispersive row, which only the extended kinds take; the
    families of the family and field instantiations: ``coat``, the coatings,
    add the layer thicknesses after them; ``diff``, the diffractive kinds,
    a DOE row's coefficients after those; ``freeform``, freeform surfaces,
    all 32 ff columns in their place)."""
    if ext:
        return (EXT_GRAD_COLS + (DISP_GRAD_COLS if disp else ())
                + (COAT_GRAD_COLS if coat else ())
                + (FF_TERM_COLS if freeform
                   else FF_GRAD_COLS if diff else ()))
    return PLATE_GRAD_COLS if plates is not None else GRAD_COLS


def trace_seq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                       maps=None, ext=False, track_opl=False,
                       record_paths=False, record_hits=False,
                       fresnel=False, uniforms=None,
                       coat=None, diff=False, fuzzy=None, ff=None,
                       field=None, grin=None):
    """Launch K1 on the current stream -> ``(rays, SensorState)``, with any
    stream ``(rays, SensorState, aux)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``, ``maps`` the PHASE_GRID rows' [H, W] maps
    in row order; all on one CUDA device.  ``ext``: the table has the
    extended kinds (``ext_kinds``).  The streams run K1's instantiation
    with them, whatever ``ext``; ``fresnel`` (the table has a Fresnel kind,
    ``fresnel_kinds``) the one with the Fresnel kinds, which also takes the
    streams.  ``uniforms`` holds the table's FRESNEL rows' [F, N] draws, one
    stream per such row in row order (None: no row draws); its caller
    derives them from the table's static metadata
    (rays/draws.py::sequential_uniforms).  The families run the family
    instantiation, which also takes the streams, with each family's side
    data (``family_args``): ``coat``, the ``[K, 20]`` side buffer of
    ``coat_side`` (None: no row's coating acts); ``diff`` (the table has a
    diffractive kind, ``diffractive_kinds``); ``fuzzy``, the int32 program
    buffer of ``fuzzy_buffer`` (None: no row is fuzzy); ``ff``, the int32
    exponent pairs of ``ff_side`` (None: no row is freeform); ``grin`` (the
    table has a GRIN row, ``grin_kinds``; None: read it off ``kinds``,
    ``grin_rows``, one copy to the host).  ``field``, the launch field's six
    [N] streams (None: no field), runs the field's instantiation with the
    same families (no ``grin``: ``check_grin_args``); ``aux`` then holds
    the final field's six streams as ``FIELD_KEYS``."""
    global LAUNCHES
    flags = StreamFlags(track_opl, record_paths, record_hits,
                        field is not None)
    res = _seq_fwd_launch(flat_table, kinds, rays, cfg, maps,
                          'trace_seq_fwd_cuda', ext, flags, fresnel, uniforms,
                          coat, diff, fuzzy, ff, field, grin)
    LAUNCHES += res[-1]
    return res[:-1]


def family_bits(fresnel=False, coat=None, diff=False, fuzzy=None, ff=None,
                grin=False):
    """The ``FAM_*`` bits of a K1, K2, K5 or K6 wrapper's family arguments
    (0: no family, the instantiation with the streams or the path
    length)."""
    return ((FAM_FRESNEL if fresnel else 0)
            | (FAM_COAT if coat is not None else 0)
            | (FAM_DIFF if diff else 0)
            | (FAM_FUZZY if fuzzy is not None else 0)
            | (FAM_FREEFORM if ff is not None else 0)
            | (FAM_GRIN if grin else 0))


def family_args(fam, k, device, coat=None, fuzzy=None, ff=None):
    """The side data's C arguments of the family and field instantiations
    after the draws: the side buffer ``coat`` (checked to be a contiguous
    float32 [K, COAT_SIDE] tensor on ``device``), the program buffer
    ``fuzzy`` and its words, the exponent pairs ``ff`` (a contiguous int32
    [K, FF_SIDE] tensor), each null for None, then the ``FAM_*`` bits
    ``fam``."""
    if coat is not None:
        check(coat, 'coat side buffer', torch.float32, (k, COAT_SIDE), device)
    if ff is not None:
        check(ff, 'freeform exponent pairs', torch.int32, (k, FF_SIDE),
              device)
    return (ptr(coat), *fuzzy_args(fuzzy, k, device), ptr(ff), fam)


def draw_args(fresnel, uniforms, n, device):
    """The K1 and K2 wrappers' draw arguments: the [F, N] ``uniforms``
    (None: no row draws) checked to be a contiguous float32 tensor on
    ``device`` -> the (pointer, F) C arguments."""
    if uniforms is None or uniforms.shape[0] == 0:
        return None, 0
    if not fresnel:
        raise ValueError('uniforms are read only by the family '
                         'instantiation with the Fresnel kinds')
    check(uniforms, 'uniforms', torch.float32, (uniforms.shape[0], n),
          device)
    return uniforms.data_ptr(), uniforms.shape[0]


def count_launch(fam, field=False, streams=False, ext=False):
    """Count a K1, K2, K5 or K6 launch in its instantiation's counters: the
    field's in ``FIELD_LAUNCHES``, the family instantiation's in each of its
    families' (``fam``), the streams' (or path length's) in
    ``STREAM_LAUNCHES``, the extended kinds' in ``EXT_LAUNCHES``."""
    global EXT_LAUNCHES, STREAM_LAUNCHES, FRESNEL_LAUNCHES, COAT_LAUNCHES
    global DIFF_LAUNCHES, FUZZY_LAUNCHES, FREEFORM_LAUNCHES, FIELD_LAUNCHES
    global GRIN_LAUNCHES
    if field:
        FIELD_LAUNCHES += 1
    elif fam:
        FRESNEL_LAUNCHES += bool(fam & FAM_FRESNEL)
        COAT_LAUNCHES += bool(fam & FAM_COAT)
        DIFF_LAUNCHES += bool(fam & FAM_DIFF)
        FUZZY_LAUNCHES += bool(fam & FAM_FUZZY)
        FREEFORM_LAUNCHES += bool(fam & FAM_FREEFORM)
        GRIN_LAUNCHES += bool(fam & FAM_GRIN)
    elif streams:
        STREAM_LAUNCHES += 1
    else:
        EXT_LAUNCHES += int(ext)


def fuzzy_args(fuzzy, k, device):
    """The program buffer's C arguments (pointer, words): ``fuzzy`` checked
    to be a contiguous int32 tensor on ``device`` of K to MAX_WORDS words;
    (null, 0) for None."""
    if fuzzy is None:
        return None, 0
    words = fuzzy.shape[0] if fuzzy.dim() == 1 else -1
    if not k <= words <= fuzzy_program.MAX_WORDS:
        raise ValueError(f'the fuzzy program buffer holds {k} to '
                         f'{fuzzy_program.MAX_WORDS} words, got shape '
                         f'{tuple(fuzzy.shape)}')
    check(fuzzy, 'fuzzy programs', torch.int32, (words,), device)
    return fuzzy.data_ptr(), words


def stream_buffers(flags, rows, n, device, nonseq=False):
    """K1's (``rows`` = K) or K5's (``rows`` = the bounce budget) stream
    outputs, planar: ``{key: tensor}`` with ``paths`` [K + 1 or B, 3, N],
    ``hits`` [K or B, 3, N], ``hit_weights`` and (K5) ``hit_slots`` [K or
    B, N] (int32), ``opl`` and ``n_final`` [N]."""
    def new(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=device)
    bufs = {}
    if flags.track_opl:
        bufs.update(opl=new(n), n_final=new(n))
    if flags.record_paths:
        bufs['paths'] = new(rows + (0 if nonseq else 1), 3, n)
    if flags.record_hits:
        bufs.update(hits=new(rows, 3, n), hit_weights=new(rows, n))
        if nonseq:
            bufs['hit_slots'] = new(rows, n, dtype=torch.int32)
    return bufs


def stream_args(bufs, nonseq=False):
    """The stream pointers of K1's or K5's instantiation with the streams
    (null where not wanted)."""
    keys = ('opl', 'n_final', 'paths', 'hits', 'hit_weights')
    return tuple(ptr(bufs.get(k)) for k in
                 keys + (('hit_slots',) if nonseq else ()))


def stream_aux(bufs):
    """``aux`` of the stream buffers: the planar records as views of the
    JAX package's [rows, N, 3]."""
    return {k: v.permute(0, 2, 1) if k in ('paths', 'hits') else v
            for k, v in bufs.items()}


def field_buffer(field, n, device):
    """The launch field's six [N] streams as the kernels read them: one
    contiguous float32 [6, N] tensor on ``device``."""
    if len(field) != 6:
        raise ValueError(f'the field has six streams, got {len(field)}')
    buf = torch.stack([f.detach().to(torch.float32) for f in field])
    check(buf, 'field', torch.float32, (6, n), device)
    return buf


def _seq_fwd_launch(flat_table, kinds, rays, cfg, maps, name, ext=False,
                    flags=NO_STREAMS, fresnel=False, uniforms=None,
                    coat=None, diff=False, fuzzy=None, ff=None, field=None,
                    grin=None):
    """K1's launch -> ``(rays, SensorState, launches)``, with any stream
    ``(rays, SensorState, aux, launches)``."""
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, name)
    grin = check_grin_args(kinds, grin, field)
    fam = family_bits(fresnel, coat, diff, fuzzy, ff, grin)
    draws = draw_args(fresnel, uniforms, n, device)
    side = family_args(fam, k, device, coat, fuzzy, ff)
    plates = plate_buffers(ext_maps(maps, ext or flags.any or fam), rays,
                           device)
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in COMPS]
    n_blocks = -(-n // THREADS)
    partials = torch.empty(n_blocks, n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    grid = new_grid(cfg, device)
    bufs = stream_buffers(flags, k, n, device)
    f_in = field_buffer(field, n, device) if field is not None else None
    f_out = torch.empty_like(f_in) if field is not None else None
    launched = 0
    if n > 0:
        args = (flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in COMPS),
                rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                partials.data_ptr(), n_slots, n_bundles,
                *grid_args(cfg, grid if cfg.grid_shape else None),
                *plate_args(plates))
        with torch.cuda.device(device):
            if field is not None:
                rc = kernel('rtt_trace_seq_fwd_field')(
                    *args, *stream_args(bufs), *draws, *side,
                    f_in.data_ptr(), f_out.data_ptr(), n, stream(device))
            elif fam or flags.any:
                rc = kernel('rtt_trace_seq_fwd_streams')(
                    *args, *stream_args(bufs), *draws, *side, n,
                    stream(device))
            else:
                rc = kernel('rtt_trace_seq_fwd')(*args, int(ext), n,
                                                 stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_fwd launch failed with CUDA '
                               f'error {rc}')
        launched = 1
        count_launch(fam, field is not None, flags.any, ext)
    out = rays.replace(**dict(zip(COMPS, outs)))
    sensors = SensorState(moments=partials.sum(dim=0), grid=grid)
    if flags.any:
        aux = stream_aux(bufs)
        if field is not None:
            aux.update(zip(FIELD_KEYS, f_out if n > 0 else f_in))
        return out, sensors, aux, launched
    return out, sensors, launched


def trace_seq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig, g_rays,
                       g_moments, need_table=True, need_rays=True,
                       g_grid=None, maps=None, need_maps=True, ext=False,
                       disp=None, need_wavelength=False, g_opl=None,
                       g_nfinal=None, opl=False, fresnel=False,
                       uniforms=None, coat=None, diff=False, fuzzy=None,
                       ff=None, field=None, g_field=None, grin=None):
    """Launch K2 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, with phase maps (or the extended
    kinds) their cotangents (or None) third, with ``need_wavelength``
    the wavelength's cotangent fourth, and with ``field`` the launch
    field's six cotangents last.

    Inputs as for ``trace_seq_fwd_cuda``; ``g_rays`` holds the cotangents
    of the 7 output streams (None for zero), ``g_moments`` that of the
    [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each None
    for zero).  ``need_table`` / ``need_rays`` / ``need_maps`` /
    ``need_wavelength`` say which cotangents to compute; the kernel skips
    the others.  ``ext`` as for ``trace_seq_fwd_cuda``; ``disp``: the table
    has a dispersive row (``dispersive``; None: read it off ``kinds``).  A
    dispersive table and the wavelength's cotangent take the kernel's
    instantiation with dispersion, which also has the extended kinds,
    whatever ``ext``.  ``opl`` (K1 ran with ``track_opl``) takes the
    instantiation with the optical path length, whatever ``ext``, with
    ``g_opl`` and ``g_nfinal`` the cotangents of K1's ``opl`` and
    ``n_final`` (None for zero).  The families (``fresnel``, ``uniforms``,
    ``coat``, ``diff``, ``fuzzy``, ``ff``, ``grin``) as for
    ``trace_seq_fwd_cuda``: the family instantiation (which also takes the
    path length), reading K1's draws and side data, whose table cotangent
    adds the layer thicknesses' (``COAT_GRAD_COLS``, with ``coat``) and
    then all 32 ff columns' (``FF_TERM_COLS``, with ``ff``) or a DOE row's
    coefficients' (``FF_GRAD_COLS``, with ``diff``); it reverses a fuzzy
    row's factor with the program's partials, a freeform row's Newton steps
    and a rod's RK4 steps from checkpoints (csrc/grin.cuh).  ``field`` as
    there: the field's instantiation with those families, with ``g_field``
    the final field's six cotangents (each None for zero)."""
    global BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_seq_bwd_cuda')
    grin = check_grin_args(kinds, grin, field)
    fam = family_bits(fresnel, coat, diff, fuzzy, ff, grin)
    opl = opl or field is not None
    ext = ext or need_wavelength or opl or bool(fam)
    draws = draw_args(fresnel, uniforms, n, device)
    side = family_args(fam, k, device, coat, fuzzy, ff)
    if disp is None:
        disp = ext and dispersive_kinds(kinds)
    plates = plate_buffers(ext_maps(maps, ext), rays, device)
    g_rays, g_mom, g_grid = check_cotangents(g_rays, g_moments, g_grid, cfg,
                                             n, device)
    g_opl, g_nfinal = check_streams((g_opl, g_nfinal), n, device)
    cols = grad_cols(plates, ext, disp, coat is not None, diff, ff is not None)
    outs = ([torch.empty(n, dtype=torch.float32, device=device)
             for _ in COMPS] if need_rays else None)
    partials = (torch.empty(-(-n // THREADS), k, len(cols),
                            dtype=torch.float32, device=device)
                if need_table else None)
    g_maps = (torch.zeros_like(plates.maps)
              if plates is not None and need_maps else None)
    g_wl = (torch.empty(n, dtype=torch.float32, device=device)
            if need_wavelength else None)
    f_in = field_buffer(field, n, device) if field is not None else None
    g_fout = c_field = None
    if field is not None:
        if any(g is not None for g in g_field or ()):
            g_fout = field_buffer(
                [torch.zeros(n, device=device) if g is None else g
                 for g in g_field], n, device)
        c_field = torch.zeros_like(f_in)
    if n > 0 and (need_table or need_rays or g_maps is not None
                  or need_wavelength or field is not None):
        args = (flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in COMPS),
                rays.ray_id.data_ptr(), *map(ptr, g_rays),
                g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                ptr(partials), n_slots, n_bundles,
                *grid_args(cfg, g_grid), *plate_args(plates),
                ptr(g_maps), ptr(g_wl), int(ext and disp))
        with torch.cuda.device(device):
            if field is not None:
                rc = kernel('rtt_trace_seq_bwd_field')(
                    *args, ptr(g_opl), ptr(g_nfinal), *draws, *side,
                    f_in.data_ptr(), ptr(g_fout), c_field.data_ptr(), n,
                    stream(device))
            elif fam or opl:
                rc = kernel('rtt_trace_seq_bwd_opl')(
                    *args, ptr(g_opl), ptr(g_nfinal), *draws, *side, n,
                    stream(device))
            else:
                rc = kernel('rtt_trace_seq_bwd')(*args, int(ext), n,
                                                 stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_bwd launch failed with CUDA '
                               f'error {rc}')
        BWD_LAUNCHES += 1
        count_launch(fam, field is not None, opl, ext)
    res = table_and_map_cotangents(k, cols, partials, outs, plates, g_maps,
                                   device, g_wl)
    return res + (tuple(c_field),) if field is not None else res


def check_grin_args(kinds, grin=None, field=None):
    """Whether the K1, K2, K5 and K6 wrappers run GRIN rods (in the family
    instantiation): ``grin``, or with None whether ``kinds`` has a GRIN row
    (``grin_rows``); raises if the field's instantiation would get one
    (ROADMAP Queue 1 position 4b; ``check_grin_kinds`` says so for a
    trace)."""
    if grin is None:
        grin = grin_rows(kinds)
    if grin and field is not None:
        raise ValueError('the field\'s instantiation takes no GRIN rods '
                         '(ROADMAP Queue 1 position 4b)')
    return grin


def check_streams(grads, n, device):
    """The K2 and K6 wrappers' stream cotangents (``g_opl``, ``g_nfinal``),
    made contiguous and checked (None stays None)."""
    grads = [None if g is None else g.contiguous() for g in grads]
    for name, g in zip(('g_opl', 'g_nfinal'), grads):
        if g is not None:
            check(g, name, torch.float32, (n,), device)
    return grads


def ptr(t):
    """A tensor's data pointer for a C argument (null for None)."""
    return None if t is None else t.data_ptr()


def check_cotangents(g_rays, g_moments, g_grid, cfg, n, device):
    """The K2 and K6 wrappers' cotangent inputs, made contiguous (autograd
    may hand expanded, stride-0 ones; the kernels read them densely) and
    checked -> (g_rays, g_moments, g_grid); zero moments for None."""
    g_rays = [None if g is None else g.contiguous() for g in g_rays]
    for c, g in zip(COMPS, g_rays):
        if g is not None:
            check(g, f'g_{c}', torch.float32, (n,), device)
    n_slots = max(cfg.n_sensors, 1)
    mom_shape = (n_slots, cfg.n_bundles, N_MOMENTS)
    g_mom = (torch.zeros(mom_shape, dtype=torch.float32, device=device)
             if g_moments is None else g_moments.contiguous())
    check(g_mom, 'g_moments', torch.float32, mom_shape, device)
    if g_grid is not None:
        g_grid = g_grid.contiguous()
        check(g_grid, 'g_grid', torch.float32,
              (n_slots, *cfg.grid_shape), device)
    return g_rays, g_mom, g_grid


def table_and_map_cotangents(k, cols, partials, outs, plates, g_maps,
                             device, g_wl=None):
    """The K2 and K6 wrappers' results: ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, with plates the maps' cotangents (or
    None) third, and the wavelength's cotangent ``g_wl`` fourth when
    given."""
    g_flat = None
    if partials is not None:
        g_flat = torch.zeros(k, ROW_WIDTH, dtype=torch.float32,
                             device=device)
        g_flat[:, list(cols)] = partials.sum(dim=0)
    res = (g_flat, tuple(outs) if outs is not None else None)
    if plates is not None:
        res += (None if g_maps is None else plates.split(g_maps),)
    if g_wl is not None:
        res += (g_wl,)
    return res
