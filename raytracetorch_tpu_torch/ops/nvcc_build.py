"""Build the package's CUDA sources into shared libraries at first use.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) from the
sources under ``csrc/`` into ``_build/`` (listed in ``.gitignore``), with a
plain C entry point that callers bind with ``ctypes``.  The file name carries
a hash of the sources, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing is
compiled at import time.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

PKG_DIR = pathlib.Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc_path():
    """nvcc on PATH, else the CUDA toolkit's default location."""
    path = shutil.which('nvcc')
    if path is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        path = '/usr/local/cuda/bin/nvcc'
    if path is None:
        raise RuntimeError('nvcc not found: building the CUDA kernels needs '
                           'the CUDA toolkit')
    return path


def build_library(name, sources):
    """Compile ``csrc/<sources>`` into ``_build/lib<name>-<hash>.so``.

    Returns ``(path, log, seconds)``: ``log`` is nvcc's output (ptxas
    register and spill counts), ``seconds`` the compile time (0.0 when the
    library was already built)."""
    srcs = [CSRC_DIR / s for s in sources]
    flags = NVCC_FLAGS
    h = hashlib.sha256(' '.join(flags).encode())
    for s in srcs + sorted(CSRC_DIR.glob('*.cuh')):
        h.update(s.read_bytes())
    out = BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'
    log_path = out.with_suffix('.log')
    if out.exists() and log_path.exists():
        return out, log_path.read_text(), 0.0
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *flags, '-o', str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}):\n'
                           f'{" ".join(cmd)}\n{log}')
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log, seconds


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r'Function properties for (\S+)')
_PTXAS_FRAME = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                          r'(\d+) bytes spill loads')
_PTXAS_REGS = re.compile(r'Used (\d+) registers')


def ptxas_usage(log):
    """Each kernel's resources from an nvcc log with ``-Xptxas -v`` ->
    ``{mangled kernel name: {'registers', 'stack', 'spill_stores',
    'spill_loads'}}`` (bytes, per thread)."""
    usage, name, props = {}, None, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            usage[name] = dict(registers=None, stack=0, spill_stores=0,
                               spill_loads=0)
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PTXAS_FRAME.search(line)
        if m and name is not None and props == name:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = _PTXAS_REGS.search(line)
        if m and name is not None:
            usage[name]['registers'] = int(m.group(1))
            name = None
    return usage
