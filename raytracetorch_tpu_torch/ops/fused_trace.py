"""Fused sequential forward trace: the CUDA kernel K1, its plain version and
the dispatcher between them.

Counterpart of ``raytracetorch_tpu/ops/pallas_trace.py::
trace_sequential_pallas_v2`` (TPU kernel ``_kernel_v2``, chain body
``_chain_pure``) for the main-path kinds with every optional stream off.
The kernel (``csrc/trace_seq_fwd.cu``, notes on its design and bounds
there) walks every table row per ray in one pass and writes the final ray
state and per-block moment partials once.

- ``trace_sequential_fused`` is the entry point: for CPU tensors it runs
  ``trace_sequential_fused_plain``; for CUDA tensors it launches the kernel
  or raises.  Rows of kinds the kernel lacks raise NotImplementedError
  before either runs.
- ``trace_sequential_fused_plain`` is the same function in plain torch: the
  eager chain of core/trace.py over the rows of the flat table.
- ``trace_seq_fwd_cuda`` launches the kernel and counts its launches in
  ``LAUNCHES``.

Forward only: the backward kernel K2 is ROADMAP Queue 2.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.sensor import N_MOMENTS, SensorConfig, SensorState
from ..core.static_dispatch import unsupported
from ..core.table import ROW_WIDTH, FlatRow, flatten_table_rows
from ..core.trace import _surface_step
from . import nvcc_build

LAUNCHES = 0          # kernel launches by trace_seq_fwd_cuda

THREADS = 256         # rays per block (kThreads in the CUDA source)
KIND_WIDTH = 8        # ph, sb, vb, plane, sensor, slot, invert, pad
MAX_ROWS = 64
MAX_SLOTS = 8
MAX_BUNDLES = 8
SOURCE = 'trace_seq_fwd.cu'

_lib = None


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
    """[K, KIND_WIDTH] int rows the kernel reads; raises NotImplementedError
    for anything the kernel does not take."""
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
    """Fused forward trace -> ``(rays, SensorState)``.

    CPU tensors run the plain version; CUDA tensors launch the kernel (or
    raise: there is no fallback)."""
    kinds = kind_rows(static_meta, cfg)
    flat = flatten_table_rows(table)
    device = rays.px.device
    if device.type == 'cpu':
        return trace_sequential_fused_plain(flat, rays, cfg, static_meta)
    if device.type == 'cuda':
        kinds_t = torch.tensor(kinds, dtype=torch.int32, device=device)
        return trace_seq_fwd_cuda(flat, kinds_t, rays, cfg)
    raise ValueError(f'no fused trace for device {device}')


def trace_sequential_fused_plain(flat_table, rays, cfg: SensorConfig,
                                 static_meta):
    """The kernel's function in plain torch: the eager chain of
    core/trace.py over the rows of the flat table the kernel reads."""
    sensors = SensorState.init(cfg, dtype=torch.float32,
                               device=rays.px.device)
    for k, meta in enumerate(static_meta):
        rays, sensors = _surface_step(FlatRow(flat_table[k]), rays, cfg,
                                      sensors, meta)
    return rays, sensors


def build():
    """Compile the kernel (once per source hash) and bind its C entry
    point.  Returns ``(log, seconds)`` of the nvcc run (seconds 0.0 when the
    library was already built)."""
    global _lib
    path, log, seconds = nvcc_build.build_library('trace_seq_fwd', [SOURCE])
    lib = ctypes.CDLL(str(path))
    fn = lib.rtt_trace_seq_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 16
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return log, seconds


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} is {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def trace_seq_fwd_cuda(flat_table, kinds, rays, cfg: SensorConfig):
    """Launch the kernel on the current stream -> ``(rays, SensorState)``.

    ``flat_table`` is the [K, 160] float32 table, ``kinds`` the [K, 8]
    int32 rows of ``kind_rows``; all on one CUDA device."""
    global LAUNCHES
    device = flat_table.device
    if device.type != 'cuda':
        raise ValueError(f'trace_seq_fwd_cuda needs CUDA tensors, got '
                         f'{device}')
    k = flat_table.shape[0]
    n = rays.n
    n_slots, n_bundles = _check_limits(k, cfg), cfg.n_bundles
    _check(flat_table, 'table', torch.float32, (k, ROW_WIDTH), device)
    _check(kinds, 'kinds', torch.int32, (k, KIND_WIDTH), device)
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
    for c in comps:
        _check(getattr(rays, c), c, torch.float32, (n,), device)
    _check(rays.ray_id, 'ray_id', torch.int32, (n,), device)

    outs = [torch.empty(n, dtype=torch.float32, device=device)
            for _ in comps]
    n_blocks = -(-n // THREADS)
    partials = torch.empty(n_blocks, n_slots, n_bundles, N_MOMENTS,
                           dtype=torch.float32, device=device)
    if n > 0:
        if _lib is None:
            build()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _lib.rtt_trace_seq_fwd(
                flat_table.data_ptr(), kinds.data_ptr(), k,
                *(getattr(rays, c).data_ptr() for c in comps),
                rays.ray_id.data_ptr(), *(o.data_ptr() for o in outs),
                partials.data_ptr(), n_slots, n_bundles, n, stream)
        if rc != 0:
            raise RuntimeError(f'trace_seq_fwd launch failed with CUDA '
                               f'error {rc}')
        LAUNCHES += 1
    out = rays.replace(**dict(zip(comps, outs)))
    return out, SensorState(moments=partials.sum(dim=0))
