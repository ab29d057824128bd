"""Fused sequential trace: the CUDA kernels K1 (forward) and K2 (backward),
their plain versions, and the autograd Function that joins them; and the
registry that builds every CUDA library of the package.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py``, sequential part,
for the main-path kinds with every optional stream off:

- ``trace_sequential_pallas_v2`` (TPU kernel ``_kernel_v2``, chain body
  ``_chain_pure``) -> kernel K1, ``csrc/trace_seq_fwd.cu``;
- ``trace_sequential_pallas_v2_bwd`` (TPU kernel ``_kernel_v2_bwd``) ->
  kernel K2, ``csrc/trace_seq_bwd.cu``;
- the ``custom_vjp`` ``fused_trace_grad`` with ``_fused_fwd`` and
  ``_fused_bwd`` -> ``FusedTrace``.

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
- ``plain_vjp`` is the shared body of the plain backward versions
  (``trace_seq_bwd_plain`` here, ``trace_nonseq_bwd_plain`` in
  ops/fused_nonseq.py): ``torch.autograd.grad`` of a plain forward.
- ``build`` compiles the five libraries (K1, K2, K3 in ops/grid.py, K5 and
  K6 in ops/fused_nonseq.py), one nvcc each, started together.
"""

from __future__ import annotations

import concurrent.futures
import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.static_dispatch import unsupported
from ..core.table import ROW_OFFSETS, ROW_WIDTH, FlatRow, flatten_table_rows
from ..core.trace import _surface_step
from ..rays.ray import Rays
from . import nvcc_build

LAUNCHES = 0          # kernel launches by trace_seq_fwd_cuda (K1)
BWD_LAUNCHES = 0      # kernel launches by trace_seq_bwd_cuda (K2)

THREADS = 256         # rays per block (kThreads in the CUDA sources)
KIND_WIDTH = 8        # ph, sb, vb, plane, sensor, slot, invert, pad
MAX_ROWS = 64
MAX_SLOTS = 8
MAX_BUNDLES = 8
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
# The flat-table columns whose cotangent can be nonzero for the kernels'
# kinds: q[0:5], Rw[0:9], tw[0:3], ph[0:2].  Everything else (n_sign, Rs,
# ts, the bounds) enters the chain only through comparisons and selects.
GRAD_COLS = tuple(ROW_OFFSETS[name] + j
                  for name, size in (('q', 5), ('Rw', 9), ('tw', 3), ('ph', 2))
                  for j in range(size))

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_GRID = [_P, _I, _I, _F]      # grid (or its cotangent), H, W, half extent
# library name -> (source, {C entry point: argtypes})
_LIBRARIES = {
    'trace_seq_fwd': ('trace_seq_fwd.cu', {
        'rtt_trace_seq_fwd': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
        + [_L, _P]}),
    'trace_seq_bwd': ('trace_seq_bwd.cu', {
        'rtt_trace_seq_bwd': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
        + [_L, _P]}),
    'grid_bin': ('grid_bin.cu', {
        'rtt_grid_bin': [_P, _P, _P, _P, _I, _L, _P, _I, _I, _I, _F, _P],
        'rtt_grid_gather': [_P, _P, _P, _P, _I, _L, _P, _I, _I, _I, _F,
                            _P]}),
    'trace_nonseq_fwd': ('trace_nonseq_fwd.cu', {
        'rtt_trace_nonseq_fwd': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
        + [_I, _L, _P]}),
    'trace_nonseq_bwd': ('trace_nonseq_bwd.cu', {
        'rtt_trace_nonseq_bwd': [_P, _P, _I] + [_P] * 31 + [_I, _I] + _GRID
        + [_I, _L, _P]}),
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


def kind_rows(static_meta, cfg: SensorConfig):
    """[K, KIND_WIDTH] int rows the kernels read; raises NotImplementedError
    for anything the kernels do not take."""
    n_slots = _check_limits(len(static_meta), cfg)
    rows = []
    for k, m in enumerate(static_meta):
        why = unsupported(m)
        if why:
            raise NotImplementedError(f'fused trace, row {k}: {why}')
        if m.sensor and not 0 <= m.slot < n_slots:
            raise ValueError(f'row {k}: sensor slot {m.slot} outside '
                             f'0..{n_slots - 1}')
        rows.append([m.ph, m.sb, m.vb, int(m.plane), int(m.sensor), m.slot,
                     int(m.invert), 0])
    return rows


def trace_sequential_fused(table, rays, cfg: SensorConfig, static_meta):
    """Fused trace -> ``(rays, SensorState)``, differentiable with respect
    to the table and the 7 ray streams px..intensity.

    CPU tensors run the plain versions; CUDA tensors launch the kernels (or
    raise: there is no fallback)."""
    flat, kinds_t = flat_inputs(table, rays, cfg, static_meta)
    comps = [getattr(rays, c) for c in COMPS]
    if needs_grad(flat, rays):
        return unpack(FusedTrace.apply(flat, kinds_t, cfg, tuple(static_meta),
                                       *comps, rays.ray_id), rays, cfg)
    return _forward(flat, kinds_t, rays, cfg, static_meta)


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


def needs_grad(flat, rays):
    """Whether a fused trace runs under autograd."""
    return torch.is_grad_enabled() and (
        flat.requires_grad
        or any(getattr(rays, c).requires_grad for c in COMPS))


def _forward(flat, kinds, rays, cfg, static_meta):
    if flat.device.type == 'cpu':
        return trace_sequential_fused_plain(flat, rays, cfg, static_meta)
    return trace_seq_fwd_cuda(flat, kinds, rays, cfg)


def _rays_of(comps, ray_id):
    # the fused trace neither reads nor returns the wavelength stream
    return Rays(**dict(zip(COMPS, comps)), ray_id=ray_id, wavelength=None)


class FusedTrace(torch.autograd.Function):
    """The fused trace with its backward: K1 forward, K2 backward on CUDA
    tensors; the plain versions on CPU tensors.

    Counterpart of ``fused_trace_grad`` / ``_fused_fwd`` / ``_fused_bwd``.
    Like ``_fused_fwd`` it keeps only its inputs (table and input rays) as
    residuals; the backward re-runs the chain.  The wavelength is not an
    output, so its identity pass-through is left to autograd.  Like the JAX
    ``custom_vjp`` it has no higher-order or forward-mode rule.

    ``apply(flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz, intensity,
    ray_id)`` -> the 7 output ray streams, ``moments [S, B, 7]`` and, when
    ``cfg.grid_shape`` is set, ``grid [S, H, W]``."""

    @staticmethod
    def forward(ctx, flat_table, kinds, cfg, meta, px, py, pz, dx, dy, dz,
                intensity, ray_id):
        comps = (px, py, pz, dx, dy, dz, intensity)
        out, sensors = _forward(flat_table, kinds, _rays_of(comps, ray_id),
                                cfg, meta)
        ctx.save_for_backward(flat_table, kinds, *comps, ray_id)
        ctx.cfg, ctx.meta = cfg, meta
        ctx.set_materialize_grads(False)
        grid = (sensors.grid,) if cfg.grid_shape else ()
        return (*(getattr(out, c) for c in COMPS), sensors.moments, *grid)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        flat, kinds, *comps, ray_id = ctx.saved_tensors
        rays = _rays_of(comps, ray_id)
        g_rays, g_moments = grads[:7], grads[7]
        g_grid = grads[8] if ctx.cfg.grid_shape else None
        need = ctx.needs_input_grad
        need_table, need_rays = need[0], any(need[4:11])
        if flat.device.type == 'cuda':
            g_flat, g_in = trace_seq_bwd_cuda(flat, kinds, rays, ctx.cfg,
                                              g_rays, g_moments, need_table,
                                              need_rays, g_grid=g_grid)
        else:
            g_flat, g_in = trace_seq_bwd_plain(flat, rays, ctx.cfg, ctx.meta,
                                               g_rays, g_moments,
                                               g_grid=g_grid)
        g_in = [g if n else None
                for g, n in zip(g_in or (None,) * 7, need[4:11])]
        return (g_flat if need_table else None, None, None, None, *g_in,
                None)


def trace_sequential_fused_plain(flat_table, rays, cfg: SensorConfig,
                                 static_meta):
    """K1's function in plain torch: the eager chain of core/trace.py over
    the rows of the flat table the kernel reads."""
    sensors = SensorState.init(cfg, dtype=torch.float32,
                               device=rays.px.device)
    for k, meta in enumerate(static_meta):
        rays, sensors = _surface_step(FlatRow(flat_table[k]), rays, cfg,
                                      sensors, meta, plain=True)
    return rays, sensors


def trace_seq_bwd_plain(flat_table, rays, cfg: SensorConfig, static_meta,
                        g_rays, g_moments, g_grid=None):
    """K2's function in plain torch: re-run ``trace_sequential_fused_plain``
    under grad and take ``torch.autograd.grad``.

    ``g_rays`` holds the cotangents of the 7 output streams px..intensity
    (None for zero), ``g_moments`` that of the [S, B, 7] moments and
    ``g_grid`` that of the [S, H, W] grid (each None for zero).  Returns
    ``(g_flat [K, 160], 7 input-ray cotangents)``."""
    return plain_vjp(
        lambda flat, r: trace_sequential_fused_plain(flat, r, cfg,
                                                     static_meta),
        flat_table, rays, g_rays, g_moments, g_grid)


def plain_vjp(forward, flat_table, rays, g_rays, g_moments, g_grid):
    """``torch.autograd.grad`` of ``forward(flat, rays) -> (rays,
    SensorState)`` at ``(flat_table, rays)`` with the cotangents of
    ``trace_seq_bwd_plain`` -> ``(g_flat, 7 input-ray cotangents)``, zeros
    where the output does not depend on an input."""
    with torch.enable_grad():
        flat = flat_table.detach().requires_grad_(True)
        comps = [getattr(rays, c).detach().requires_grad_(True)
                 for c in COMPS]
        out, sensors = forward(flat, rays.replace(**dict(zip(COMPS, comps))))
        pairs = [(o, g) for o, g in zip(
            [*(getattr(out, c) for c in COMPS), sensors.moments,
             sensors.grid],
            [*g_rays, g_moments, g_grid])
            if g is not None and o.requires_grad]
        inputs = [flat, *comps]
        res = (torch.autograd.grad([o for o, _ in pairs],
                                   inputs, [g for _, g in pairs],
                                   allow_unused=True)
               if pairs else [None] * len(inputs))
    res = [torch.zeros_like(x) if g is None else g
           for g, x in zip(res, inputs)]
    return res[0], tuple(res[1:])


def build():
    """Compile the package's five CUDA libraries (one nvcc each, started
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


def trace_seq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig):
    """Launch K1 on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``; all on one CUDA device."""
    global LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_seq_fwd_cuda')
    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in COMPS]
    n_blocks = -(-n // THREADS)
    partials = torch.empty(n_blocks, n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    grid = new_grid(cfg, device)
    if n > 0:
        fn = kernel('rtt_trace_seq_fwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                    partials.data_ptr(), n_slots, n_bundles,
                    *grid_args(cfg, grid if cfg.grid_shape else None), n,
                    stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_fwd launch failed with CUDA '
                               f'error {rc}')
        LAUNCHES += 1
    out = rays.replace(**dict(zip(COMPS, outs)))
    return out, SensorState(moments=partials.sum(dim=0), grid=grid)


def trace_seq_bwd_cuda(flat_table, kinds, rays, cfg: SensorConfig, g_rays,
                       g_moments, need_table=True, need_rays=True,
                       g_grid=None):
    """Launch K2 on the current stream -> ``(g_flat [K, 160] or None, 7
    input-ray cotangents or None)``.

    Inputs as for ``trace_seq_fwd_cuda``; ``g_rays`` holds the cotangents
    of the 7 output streams (None for zero), ``g_moments`` that of the
    [S, B, 7] moments and ``g_grid`` that of the [S, H, W] grid (each None
    for zero).  ``need_table`` / ``need_rays`` say which cotangents to
    compute; the kernel skips the others."""
    global BWD_LAUNCHES
    device, k, n, n_slots, n_bundles = check_inputs(
        flat_table, kinds, rays, cfg, 'trace_seq_bwd_cuda')
    # autograd may hand expanded (stride-0) cotangents: the kernel reads
    # them densely
    g_rays = [None if g is None else g.contiguous() for g in g_rays]
    for c, g in zip(COMPS, g_rays):
        if g is not None:
            check(g, f'g_{c}', torch.float32, (n,), device)
    mom_shape = (n_slots, n_bundles, N_MOMENTS)
    g_mom = (torch.zeros(mom_shape, dtype=torch.float32, device=device)
             if g_moments is None else g_moments.contiguous())
    check(g_mom, 'g_moments', torch.float32, mom_shape, device)
    if g_grid is not None:
        g_grid = g_grid.contiguous()
        check(g_grid, 'g_grid', torch.float32,
              (n_slots, *cfg.grid_shape), device)

    outs = ([torch.empty(n, dtype=torch.float32, device=device)
             for _ in COMPS] if need_rays else None)
    partials = (torch.empty(-(-n // THREADS), k, len(GRAD_COLS),
                            dtype=torch.float32, device=device)
                if need_table else None)
    if n > 0 and (need_table or need_rays):
        def ptr(t):
            return None if t is None else t.data_ptr()
        fn = kernel('rtt_trace_seq_bwd')
        with torch.cuda.device(device):
            rc = fn(flat_table.data_ptr(), kinds.data_ptr(), k,
                    *(getattr(rays, c).data_ptr() for c in COMPS),
                    rays.ray_id.data_ptr(), *map(ptr, g_rays),
                    g_mom.data_ptr(), *map(ptr, outs or (None,) * 7),
                    ptr(partials), n_slots, n_bundles,
                    *grid_args(cfg, g_grid), n, stream(device))
        if rc != 0:
            raise RuntimeError(f'trace_seq_bwd launch failed with CUDA '
                               f'error {rc}')
        BWD_LAUNCHES += 1
    g_flat = None
    if need_table:
        g_flat = torch.zeros(k, ROW_WIDTH, dtype=torch.float32,
                             device=device)
        g_flat[:, list(GRAD_COLS)] = partials.sum(dim=0)
    return g_flat, (tuple(outs) if need_rays else None)
