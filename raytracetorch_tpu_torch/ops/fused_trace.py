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
  count their launches in ``LAUNCHES`` and ``BWD_LAUNCHES``.
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
- ``plain_vjp`` is the shared body of the plain backward versions
  (``trace_seq_bwd_plain`` here, ``trace_nonseq_bwd_plain`` in
  ops/fused_nonseq.py): ``torch.autograd.grad`` of a plain forward.
- ``build`` compiles the six libraries (K1, K2, K3 in ops/grid.py, K4 in
  ops/phase_grid.py, K5 and K6 in ops/fused_nonseq.py), one nvcc each,
  started together.
"""

from __future__ import annotations

import concurrent.futures
import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..constants import PhysKind, SBKind
from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.static_dispatch import unsupported
from ..core.table import ROW_OFFSETS, ROW_WIDTH, FlatRow, flatten_table_rows
from ..core.trace import _surface_step
from ..rays.ray import Rays
from . import nvcc_build

LAUNCHES = 0          # kernel launches by trace_seq_fwd_cuda (K1)
BWD_LAUNCHES = 0      # kernel launches by trace_seq_bwd_cuda (K2)
V1_LAUNCHES = 0       # K1's kernel launched by trace_sequential_v1

THREADS = 256         # rays per block (kThreads in the CUDA sources)
KIND_WIDTH = 8        # ph, sb, vb, plane, sensor, slot, invert, map
MAX_ROWS = 64
MAX_SLOTS = 8
MAX_BUNDLES = 8
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

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_GRID = [_P, _I, _I, _F]      # grid (or its cotangent), H, W, half extent
_PLATES = [_P, _P, _P]        # maps, their (offset, H, W), wavelength
# library name -> (source, {C entry point: argtypes})
_LIBRARIES = {
    'trace_seq_fwd': ('trace_seq_fwd.cu', {
        'rtt_trace_seq_fwd': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
        + _PLATES + [_L, _P]}),
    'trace_seq_bwd': ('trace_seq_bwd.cu', {
        'rtt_trace_seq_bwd': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
        + _PLATES + [_P, _L, _P]}),
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
        + _PLATES + [_I, _L, _P]}),
    'trace_nonseq_bwd': ('trace_nonseq_bwd.cu', {
        'rtt_trace_nonseq_bwd': [_P, _P, _I] + [_P] * 31 + [_I, _I] + _GRID
        + _PLATES + [_P, _I, _L, _P]}),
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


def kind_rows(static_meta, cfg: SensorConfig):
    """[K, KIND_WIDTH] int rows the kernels read; raises NotImplementedError
    for anything the kernels do not take.  The last column is a PHASE_GRID
    row's map index (0 for every other row)."""
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
        rows.append([m.ph, m.sb, m.vb, int(m.plane), int(m.sensor), m.slot,
                     int(m.invert), maps.get(k, 0)])
    return rows


def plate_maps(static_meta, grids):
    """The ``[H, W]`` maps of the PHASE_GRID rows, in row order, from
    ``grids`` ({row: map}); raises if a plate row has none.

    None when no row has a plate's kinds (PHASE_GRID physics, the RECT
    bound): the kernels then run their instantiation without plate code.  A
    RECT-bounded row without a plate gives ``()``."""
    grids = grids or {}
    missing = [k for k in plate_rows(static_meta) if k not in grids]
    if missing:
        raise ValueError(f'PHASE_GRID rows {missing} have no phase map: '
                         f'pass grids={{row: map}} (Scene.side_grids)')
    if not any(m.ph == PhysKind.PHASE_GRID or m.sb == SBKind.RECT
               for m in static_meta):
        return None
    return tuple(grids[k] for k in plate_rows(static_meta))


def trace_sequential_fused(table, rays, cfg: SensorConfig, static_meta,
                           grids=None):
    """Fused trace -> ``(rays, SensorState)``, differentiable with respect
    to the table, the 7 ray streams px..intensity and the phase maps of
    ``grids`` ({PHASE_GRID row: [H, W] map}).

    CPU tensors run the plain versions; CUDA tensors launch the kernels (or
    raise: there is no fallback)."""
    flat, kinds_t = flat_inputs(table, rays, cfg, static_meta)
    maps = plate_maps(static_meta, grids)
    comps = [getattr(rays, c) for c in COMPS]
    if needs_grad(flat, rays, maps):
        return unpack(FusedTrace.apply(flat, kinds_t, cfg, tuple(static_meta),
                                       *comps, rays.ray_id,
                                       *plate_inputs(rays, maps)),
                      rays, cfg)
    return _forward(flat, kinds_t, rays, cfg, static_meta, maps)


def trace_sequential_v1(table, rays, cfg: SensorConfig, static_meta):
    """The fused trace with every stream off -> ``(rays, SensorState,
    {})``: the counterpart of ``trace_sequential_pallas`` (TPU kernel
    ``_kernel``), forward only.

    Its contract is the TPU kernel's: no irradiance grid, no stochastic,
    GRIN or phase-grid rows (the port has no stochastic or GRIN kind, so
    ``unsupported`` refuses those), at most 8 sensor slots.  Its function is
    K1's with the grid, the maps and the wavelength off, so on CUDA tensors
    it launches K1's kernel so (counted in ``V1_LAUNCHES``; a RECT bound
    takes its instantiation with plate code, with no map); CPU tensors run
    the plain version."""
    global V1_LAUNCHES
    if cfg.grid_shape:
        raise ValueError('trace_sequential_v1 takes no irradiance grid: use '
                         'trace_sequential_fused')
    if plate_rows(static_meta):
        raise ValueError('trace_sequential_v1 takes no phase-grid rows: use '
                         'trace_sequential_fused')
    flat, kinds_t = flat_inputs(table, rays, cfg, static_meta)
    if flat.device.type == 'cpu':
        out, sensors = trace_sequential_fused_plain(flat, rays, cfg,
                                                    static_meta)
    else:
        out, sensors, launched = _seq_fwd_launch(
            flat, kinds_t, rays, cfg, plate_maps(static_meta, None),
            'trace_sequential_v1')
        V1_LAUNCHES += launched
    return out, sensors, {}


def unpack(outs, rays, cfg):
    """The outputs of ``FusedTrace`` or ``FusedNonseq`` -> ``(rays,
    SensorState)``."""
    grid = outs[8] if cfg.grid_shape else SensorState.init(
        cfg, device=outs[7].device).grid
    return (rays.replace(**dict(zip(COMPS, outs[:7]))),
            SensorState(moments=outs[7], grid=grid))


def flat_inputs(table, rays, cfg, static_meta):
    """The flat [K, 160] table and the [K, 8] int32 kinds on the rays'
    device, for K1 and K5; raises before anything runs on rows or limits
    the kernels do not take."""
    kinds = kind_rows(static_meta, cfg)
    device = rays.px.device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no fused trace for device {device}')
    return (flatten_table_rows(table),
            torch.tensor(kinds, dtype=torch.int32, device=device))


def needs_grad(flat, rays, maps=None):
    """Whether a fused trace runs under autograd: the table, a ray stream or
    a phase map requires grad."""
    return torch.is_grad_enabled() and (
        flat.requires_grad
        or any(getattr(rays, c).requires_grad for c in COMPS)
        or any(m.requires_grad for m in maps or ()))


def plate_inputs(rays, maps):
    """The trailing tensor arguments of ``FusedTrace`` and ``FusedNonseq``:
    ``(wavelength, *maps)`` with plate code (``plate_maps`` not None), none
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


def _forward(flat, kinds, rays, cfg, static_meta, maps=None):
    if flat.device.type == 'cpu':
        return trace_sequential_fused_plain(flat, rays, cfg, static_meta,
                                            maps)
    return trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps)


def _rays_of(comps, ray_id, wavelength):
    # the fused trace reads the wavelength (phase plates) and returns it
    # unchanged
    return Rays(**dict(zip(COMPS, comps)), ray_id=ray_id,
                wavelength=wavelength)


class FusedTrace(torch.autograd.Function):
    """The fused trace with its backward: K1 forward, K2 backward on CUDA
    tensors; the plain versions on CPU tensors.

    Counterpart of ``fused_trace_grad`` / ``_fused_fwd`` / ``_fused_bwd``.
    Like ``_fused_fwd`` it keeps only its inputs (table, input rays, phase
    maps) as residuals; the backward re-runs the chain.  The wavelength is
    read (phase plates) but gets no cotangent; it is not an output, so its
    identity pass-through is left to autograd.  Like the JAX ``custom_vjp``
    it has no higher-order or forward-mode rule.

    ``apply(flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz, intensity,
    ray_id, *plates)`` -> the 7 output ray streams, ``moments [S, B, 7]``
    and, when ``cfg.grid_shape`` is set, ``grid [S, H, W]``.  ``plates`` is
    empty without a phase plate, else ``(wavelength, *maps)``
    (``plate_inputs``), the maps being the PHASE_GRID rows' in row order
    (``plate_maps``); their cotangents come from K2."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz,
                intensity, ray_id, *plates):
        comps = (px, py, pz, dx, dy, dz, intensity)
        wavelength, maps = split_plates(plates)
        out, sensors = _forward(flat_table, kinds,
                                _rays_of(comps, ray_id, wavelength), cfg,
                                meta, maps)
        ctx.save_for_backward(flat_table, kinds, *comps, ray_id, *plates)
        ctx.cfg, ctx.meta = cfg, meta
        ctx.set_materialize_grads(False)
        grid = (sensors.grid,) if cfg.grid_shape else ()
        return (*(getattr(out, c) for c in COMPS), sensors.moments, *grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        flat, kinds, *comps, ray_id = ctx.saved_tensors[:10]
        wavelength, maps = split_plates(ctx.saved_tensors[10:])
        rays = _rays_of(comps, ray_id, wavelength)
        g_rays, g_moments = grads[:7], grads[7]
        g_grid = grads[8] if ctx.cfg.grid_shape else None
        need = ctx.needs_input_grad
        need_table, need_rays = need[0], any(need[4:11])
        need_maps = any(need[13:])
        if flat.device.type == 'cuda':
            res = trace_seq_bwd_cuda(flat, kinds, rays, ctx.cfg, g_rays,
                                     g_moments, need_table, need_rays,
                                     g_grid=g_grid, maps=maps,
                                     need_maps=need_maps)
        else:
            res = trace_seq_bwd_plain(flat, rays, ctx.cfg, ctx.meta, g_rays,
                                      g_moments, g_grid=g_grid, maps=maps)
        g_flat, g_in = res[:2]
        g_in = [g if n else None
                for g, n in zip(g_in or (None,) * 7, need[4:11])]
        return (g_flat if need_table else None, None, None, None, *g_in,
                None, *map_cotangents(res, maps, need[13:]))


def map_cotangents(res, maps, need):
    """The trailing cotangents of ``FusedTrace`` and ``FusedNonseq`` for
    their ``plate_inputs`` (None for the wavelength), from the third item
    of a backward's result ``res``."""
    if maps is None:
        return ()
    g_maps = (res[2] if len(res) > 2 else None) or (None,) * len(maps)
    return (None, *(g if n else None for g, n in zip(g_maps, need)))


def trace_sequential_fused_plain(flat_table, rays, cfg: SensorConfig,
                                 static_meta, maps=None):
    """K1's function in plain torch: the eager chain of core/trace.py over
    the rows of the flat table the kernel reads, with the phase maps
    ``maps`` of its PHASE_GRID rows (in row order)."""
    grids = dict(zip(plate_rows(static_meta), maps or ()))
    sensors = SensorState.init(cfg, dtype=torch.float32,
                               device=rays.px.device)
    for k, meta in enumerate(static_meta):
        rays, sensors = _surface_step(FlatRow(flat_table[k]), rays, cfg,
                                      sensors, meta, plain=True,
                                      grid=grids.get(k))
    return rays, sensors


def trace_seq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                        g_rays, g_moments, g_grid=None, maps=None):
    """K2's function in plain torch: re-run ``trace_sequential_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments and
    ``g_grid`` that of the [S, H, W] grid (each None for zero).  Returns
    ``(g_flat [K, 160], 7 input-ray cotangents)``, and with phase maps
    their cotangents third."""
    return plain_vjp(
        lambda flat, r, m: trace_sequential_fused_plain(flat, r, cfg,
                                                        static_meta, m),
        flat_table, rays, g_rays, g_moments, g_grid, maps)


def plain_vjp(forward, flat_table, rays, g_rays, g_moments, g_grid,
              maps=None):
    """``torch.autograd.grad`` of ``forward(flat, rays, maps) -> (rays,
    SensorState)`` at ``(flat_table, rays, maps)`` with the cotangents of
    ``trace_seq_bwd_plain`` -> ``(g_flat, 7 input-ray cotangents)``, and
    with maps their cotangents third; zeros where the output does not
    depend on an input."""
    with torch.enable_grad():
        flat = flat_table.detach().requires_grad_(True)
        comps = [getattr(rays, c).detach().requires_grad_(True)
                 for c in COMPS]
        maps_in = [m.detach().requires_grad_(True) for m in maps or ()]
        out, sensors = forward(flat, rays.replace(**dict(zip(COMPS, comps))),
                               tuple(maps_in))
        pairs = [(o, g) for o, g in zip(
            [*(getattr(out, c) for c in COMPS), sensors.moments,
             sensors.grid],
            [*g_rays, g_moments, g_grid])
            if g is not None and o.requires_grad]
        inputs = [flat, *comps, *maps_in]
        res = (torch.autograd.grad([o for o, _ in pairs],
                                   inputs, [g for _, g in pairs],
                                   allow_unused=True)
               if pairs else [None] * len(inputs))
    res = [torch.zeros_like(x) if g is None else g
           for g, x in zip(res, inputs)]
    if maps is not None:
        return res[0], tuple(res[1:8]), tuple(res[8:])
    return res[0], tuple(res[1:8])


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


def trace_seq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig,
                       maps=None):
    """Launch K1 on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``, ``maps`` the PHASE_GRID rows' [H, W] maps
    in row order; all on one CUDA device."""
    global LAUNCHES
    out, sensors, launched = _seq_fwd_launch(flat_table, kinds, rays, cfg,
                                             maps, 'trace_seq_fwd_cuda')
    LAUNCHES += launched
    return out, sensors


def _seq_fwd_launch(flat_table, kinds, rays, cfg, maps, name):
    """K1's launch -> ``(rays, SensorState, launches)``."""
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, name)
    plates = plate_buffers(maps, rays, device)
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in COMPS]
    n_blocks = -(-n // THREADS)
    partials = torch.empty(n_blocks, n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    grid = new_grid(cfg, device)
    launched = 0
    if n > 0:
        fn = kernel('rtt_trace_seq_fwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                    partials.data_ptr(), n_slots, n_bundles,
                    *grid_args(cfg, grid if cfg.grid_shape else None),
                    *plate_args(plates), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_fwd launch failed with CUDA '
                               f'error {rc}')
        launched = 1
    out = rays.replace(**dict(zip(COMPS, outs)))
    return out, SensorState(moments=partials.sum(dim=0), grid=grid), launched


def trace_seq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig, g_rays,
                       g_moments, need_table=True, need_rays=True,
                       g_grid=None, maps=None, need_maps=True):
    """Launch K2 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, and with phase maps their cotangents
    (or None) third.

    Inputs as for ``trace_seq_fwd_cuda``; ``g_rays`` holds the cotangents
    of the 7 output streams (None for zero), ``g_moments`` that of the
    [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each None
    for zero).  ``need_table`` / ``need_rays`` / ``need_maps`` say which
    cotangents to compute; the kernel skips the others."""
    global BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_seq_bwd_cuda')
    plates = plate_buffers(maps, rays, device)
    g_rays, g_mom, g_grid = check_cotangents(g_rays, g_moments, g_grid, cfg,
                                             n, device)
    cols = PLATE_GRAD_COLS if plates is not None else GRAD_COLS
    outs = ([torch.empty(n, dtype=torch.float32, device=device)
             for _ in COMPS] if need_rays else None)
    partials = (torch.empty(-(-n // THREADS), k, len(cols),
                            dtype=torch.float32, device=device)
                if need_table else None)
    g_maps = (torch.zeros_like(plates.maps)
              if plates is not None and need_maps else None)
    if n > 0 and (need_table or need_rays or g_maps is not None):
        fn = kernel('rtt_trace_seq_bwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *map(ptr, g_rays),
                    g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                    ptr(partials), n_slots, n_bundles,
                    *grid_args(cfg, g_grid), *plate_args(plates),
                    ptr(g_maps), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_bwd launch failed with CUDA '
                               f'error {rc}')
        BWD_LAUNCHES += 1
    return table_and_map_cotangents(k, cols, partials, outs, plates, g_maps,
                                    device)


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
                             device):
    """The K2 and K6 wrappers' results: ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``, and with plates the maps' cotangents
    (or None) third."""
    g_flat = None
    if partials is not None:
        g_flat = torch.zeros(k, ROW_WIDTH, dtype=torch.float32,
                             device=device)
        g_flat[:, list(cols)] = partials.sum(dim=0)
    res = (g_flat, tuple(outs) if outs is not None else None)
    if plates is not None:
        res += (None if g_maps is None else plates.split(g_maps),)
    return res
