"""Kernel-only A/B of this checkout's fused kernels against another
checkout's sources, on an NVIDIA card.

Run from the repository's root on a machine with a CUDA card, the other
checkout's ``raytracetorch_tpu_torch/csrc`` unpacked beside it (for the
parent commit: ``git archive HEAD raytracetorch_tpu_torch/csrc | tar -x -C
_chip/parent``, in the git-ignored ``_chip/``):

    python3 chip_ab.py _chip/parent/raytracetorch_tpu_torch/csrc

It builds this checkout's six libraries as chip_smoke.py does and the other
tree's four trace libraries (K1, K2, K5, K6; one nvcc each, all started
together), then:

- compares the two builds' SASS kernel by kernel (``chip_smoke.
  sass_digests``: addresses, encodings, spacing and the anonymous
  namespace's hash stripped) and their ptxas lines;
- records the C arguments of every K1, K2, K5 and K6 launch of one grad
  step (``simulate_fused`` with the ray positions under grad) on each case
  of ``CASES`` at 1M rays, keeping every tensor of the launching frames
  alive, and times each launch with this build's and the other's entry
  point in turns: 6 rounds of 20 CUDA events each, the order reversed
  every other round; it reports the median of the round medians of each
  and their ratio.  The other build is bound with this checkout's argument
  types, but for the entry points of the family and field instantiations,
  whose arguments changed when the chain of family instantiations (one
  template flag each, built one on another) became one family
  instantiation: ``parent_call`` maps such a launch onto the chain's entry
  point (``PARENT_ARGTYPES``), with the chain's zeroed side buffer and
  program buffer where the family instantiation passes none.  A launch
  that runs one of the chain's links in this build is also timed in the
  family instantiation (``family_call``: ``family_ms``), the one a table
  that mixes families runs.

Cases that run a kind the other tree lacks time different work there
(its kernels take other branches), so their ratios say nothing; a launch
that mixes GRIN rods with another family has no counterpart in the chain
and is timed in this build alone.  Prints
the card's name and power limit, one JSON line per part, and writes them to
``chiprun_out/chip_ab.json``.
"""
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import chip_smoke as cs

TRACE = ('trace_seq_fwd', 'trace_seq_bwd', 'trace_nonseq_fwd',
         'trace_nonseq_bwd')
ROUNDS, EVENTS = 6, 20


def cases(rt, torch, dev, n):
    """[(label, scene, params, rays, simulate_fused kwargs)]: each earlier
    instantiation of the extended kinds' family on its section's scene,
    sequential (K1, K2) and as a Scene (K5, K6)."""
    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)
    out = [('ext_mixed', cs.mixed_scene(rt), None,
            cs.sample_rays(rt, torch, n, dev, 1), {}),
           ('ext_mixed_scene', cs.mixed_scene(rt, cs.EXT_BOUNCES), None,
            cs.sample_rays(rt, torch, n, dev, 1), {})]
    for label, nb in (('disp_achromat', None), ('disp_achromat_scene', 12)):
        sc = cs.disp_case(rt, 'achromat_abbe', nb)[0]
        out.append((label, sc, None, cs.disp_rays(rt, torch, 'achromat_abbe',
                                                  n, dev, 2), {}))
    out += [('streams_bench', cs.bench_scene(rt), None,
             cs.sample_rays(rt, torch, n, dev, 3), dict(track_opl=True)),
            ('streams_naive', cs.naive_scene(rt), None,
             cs.sample_rays(rt, torch, n, dev, 3), dict(track_opl=True)),
            ('fresnel_bench', cs.fresnel_scene(rt, True), None,
             cs.sample_rays(rt, torch, n, dev, 4), dict(generator=gen(5))),
            ('fresnel_naive', cs.fresnel_scene(rt, True, cs.NS_BOUNCES), None,
             cs.sample_rays(rt, torch, n, dev, 4), dict(generator=gen(5)))]
    for label, make, name in (
            ('coat_singlet', cs.coating_case, 'coated_w'),
            ('coat_telescope', cs.coating_case, 'telescope'),
            ('diff_hybrid', cs.diffractive_case, 'hybrid'),
            ('diff_scene', cs.diffractive_case, 'scene'),
            ('fuzzy_gauss', cs.fuzzy_case, 'gauss'),
            ('fuzzy_lorentz_scene', cs.fuzzy_case, 'lorentz_scene'),
            ('ff_ex19', cs.freeform_case, 'ex19'),
            ('ff_ex19_scene', cs.freeform_case, 'ex19_scene')):
        sc, p, r = make(rt, torch, name, n, dev, 6)[:3]
        out.append((label, sc, p, r, {}))
    for name in ('bounds', 'lightpipe', 'wedge'):
        sc, p, r, _ = cs.solid_case(rt, torch, name, n, dev, 11)
        out.append((f'solid_{name}', sc, p, r, {}))
    for name in ('quarter', 'mixed', 'ns'):
        out.append((f'grin_{name}', cs.grin_scene(rt, name), None,
                    cs.grin_rays(rt, torch, name, n, dev, 12), {}))
    # the field in the non-sequential scene (section 19)
    for name in ('naive', 'fold', 'coated'):
        sc, p, r, e0, _ = cs.field_ns_case(rt, torch, name, n, dev, 13)
        out.append((f'field_ns_{name}', sc, p, r,
                    dict(track_field=True, E0=e0,
                         generator=torch.Generator(device=dev)
                         .manual_seed(14))))
    # section 21: families mixed in one table (this build alone)
    for name in cs.MIX_SEQ_CASES + cs.MIX_NS_CASES + cs.MIX_FIELD_CASES:
        sc = cs.mix_scene(rt, name, torch)
        kw = {}
        if name in cs.MIX_FIELD_CASES:
            kw.update(track_field=True, E0=list(cs.MIX_E0))
        meta = sc.static_meta()
        if sc.sequential and any(m.ph == 4 for m in meta):
            kw['uniforms'] = cs.mix_uniforms(torch, meta, n, dev)
        out.append((f'mix_{name}', sc, None,
                    cs.mix_rays(rt, torch, name, n, dev), kw))
    return out


# The chain's entry points of the family and field instantiations (the
# parent's argument types, ops/fused_trace.py before the collapse).
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32 = ctypes.c_uint32
_GRID, _PLATES, _STREAMS, _OPL = [_P, _I, _I, ctypes.c_float], [_P] * 3, \
    [_P] * 5, [_P, _P]
_WAVE = [_P, _I]
_CHAIN_U = [_P, _I, _I, _P, _I, _P, _I, _P]
_CHAIN_K = [_U32, _U32, _I, _P, _I, _P, _I, _P]
PARENT_ARGTYPES = {
    'rtt_trace_seq_fwd_streams': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
    + _PLATES + _STREAMS + _CHAIN_U + [_L, _P],
    'rtt_trace_seq_fwd_field': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
    + _PLATES + _STREAMS + _CHAIN_U + [_P, _P] + [_L, _P],
    'rtt_trace_seq_fwd_grin': [_P, _P, _I] + [_P] * 16 + [_I, _I] + _GRID
    + _PLATES + _STREAMS + [_L, _P],
    'rtt_trace_seq_bwd_opl': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
    + _PLATES + [_P] + _WAVE + _OPL + _CHAIN_U + [_L, _P],
    'rtt_trace_seq_bwd_field': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
    + _PLATES + [_P] + _WAVE + _OPL + _CHAIN_U + [_P, _P, _P] + [_L, _P],
    'rtt_trace_seq_bwd_grin': [_P, _P, _I] + [_P] * 24 + [_I, _I] + _GRID
    + _PLATES + [_P] + _WAVE + _OPL + [_L, _P],
    'rtt_trace_nonseq_fwd_streams': [_P, _P, _I] + [_P] * 16 + [_I, _I]
    + _GRID + _PLATES + _STREAMS + [_P] + _CHAIN_K + [_I, _L, _P],
    'rtt_trace_nonseq_fwd_field': [_P, _P, _I] + [_P] * 16 + [_I, _I]
    + _GRID + _PLATES + _STREAMS + [_P] + [_U32, _U32, _P] + [_P, _P]
    + [_I, _L, _P],
    'rtt_trace_nonseq_fwd_grin': [_P, _P, _I] + [_P] * 16 + [_I, _I]
    + _GRID + _PLATES + _STREAMS + [_P] + [_I, _L, _P],
    'rtt_trace_nonseq_bwd_opl': [_P, _P, _I] + [_P] * 31 + [_I, _I] + _GRID
    + _PLATES + [_P] + _WAVE + _OPL + _CHAIN_K + [_I, _L, _P],
    'rtt_trace_nonseq_bwd_field': [_P, _P, _I] + [_P] * 31 + [_I, _I]
    + _GRID + _PLATES + [_P] + _WAVE + _OPL + [_U32, _U32, _P]
    + [_P, _P, _P, _P] + [_I, _L, _P],
    'rtt_trace_nonseq_bwd_grin': [_P, _P, _I] + [_P] * 31 + [_I, _I]
    + _GRID + _PLATES + [_P] + _WAVE + _OPL + [_I, _L, _P],
}
# where the family's side data start in each changed entry point's
# arguments, counted from the end (after them: the field's buffers, then
# n_bounces (K5, K6), n and the stream)
_TAIL = {'rtt_trace_seq_fwd_streams': 2, 'rtt_trace_seq_fwd_field': 4,
         'rtt_trace_seq_bwd_opl': 2, 'rtt_trace_seq_bwd_field': 5,
         'rtt_trace_nonseq_fwd_streams': 3, 'rtt_trace_nonseq_fwd_field': 5,
         'rtt_trace_nonseq_bwd_opl': 3, 'rtt_trace_nonseq_bwd_field': 7}


def family_call(torch, sym, args, n_rows, keep):
    """This build's launch ``sym`` with ``args`` moved from a chain link
    into the family instantiation (its families plus the freeform bit, with
    a zero pairs buffer: no row is freeform; K2's and K6's partials widened
    to the freeform columns), or None where it runs the family
    instantiation already (or the field's)."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    if sym not in _TAIL:
        return None
    tail = _TAIL[sym]
    at = len(args) - tail - 1   # the fam word
    fam = args[at]
    # csrc/trace_seq_common.cuh::fam_link: the chain's links (GRIN rods
    # alone: K1's and K2's); K5's and K6's field instantiation on the
    # Fresnel kinds and coatings alone (field_coat_alone)
    coat = ft.FAM_FRESNEL | ft.FAM_COAT
    links = (coat, coat | ft.FAM_DIFF, coat | ft.FAM_DIFF | ft.FAM_FUZZY)
    if 'field' in sym:
        if 'nonseq' not in sym or (fam & ~coat) != 0:
            return None
    elif not ((fam == ft.FAM_GRIN and 'nonseq' not in sym)
              or fam == ft.FAM_FRESNEL
              or (fam and any((fam & ~link) == 0 for link in links))):
        return None
    keep.append(torch.zeros(n_rows, ft.FF_SIDE, dtype=torch.int32,
                            device='cuda'))
    args = list(args)
    args[at - 1] = keep[-1].data_ptr()
    args[at] = fam | ft.FAM_FREEFORM
    if 'bwd' in sym:
        n = args[-2]
        keep.append(torch.empty(-(-n // 256) * n_rows * 160,
                                device='cuda'))
        args[26] = keep[-1].data_ptr()
    return tuple(args)


def parent_call(torch, sym, args, n_rows, keep):
    """(the chain's symbol, its arguments) of this build's launch ``sym``
    with ``args``, or None where the chain has no instantiation for it (a
    GRIN rod beside another family, or under the field).  The chain's
    freeform and fuzzy instantiations read a side buffer and a program
    buffer whatever the table: zeros and -1s, kept alive in ``keep``."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    if sym not in _TAIL:
        return sym, args
    tail = _TAIL[sym]
    head, side, rest = (args[:len(args) - tail - 7],
                        args[len(args) - tail - 7:len(args) - tail],
                        args[len(args) - tail:])
    draw0, draw1, coat, fuzzy, words, ff, fam = side
    field = 'field' in sym
    if fam & ft.FAM_GRIN:
        if fam != ft.FAM_GRIN or field:
            return None
        return sym.rsplit('_', 1)[0] + '_grin', head + rest
    if field or fam & (ft.FAM_DIFF | ft.FAM_FUZZY | ft.FAM_FREEFORM):
        # the chain's diffractive, fuzzy, freeform and field links read a
        # side buffer; the freeform and field links a program buffer too
        if coat is None:
            keep.append(torch.zeros(n_rows, ft.COAT_SIDE, device='cuda'))
            coat = keep[-1].data_ptr()
        if fuzzy is None and (ff is not None or field):
            keep.append(torch.full((n_rows,), -1, dtype=torch.int32,
                                   device='cuda'))
            fuzzy, words = keep[-1].data_ptr(), n_rows
        if ff is None and field and 'nonseq' not in sym:
            keep.append(torch.zeros(n_rows, ft.FF_SIDE, dtype=torch.int32,
                                    device='cuda'))
            ff = keep[-1].data_ptr()
    if field and 'nonseq' in sym:
        if fam & (ft.FAM_DIFF | ft.FAM_FUZZY | ft.FAM_FREEFORM):
            return None
        return sym, head + (draw0, draw1, coat) + rest
    diff = int(bool(fam & (ft.FAM_DIFF | ft.FAM_FUZZY | ft.FAM_FREEFORM))
               or field)
    fresnel = int(bool(fam & ft.FAM_FRESNEL) or coat is not None)
    if fuzzy is None:
        words = 0
    return sym, head + (draw0, draw1, fresnel, coat, diff, fuzzy, words,
                        ff) + rest


def build_other(csrc, name, out_dir):
    from raytracetorch_tpu_torch.ops import nvcc_build
    out = os.path.join(out_dir, f'lib{name}-other.so')
    res = subprocess.run([nvcc_build.nvcc_path(), *nvcc_build.NVCC_FLAGS,
                          '-o', out, os.path.join(csrc, name + '.cu')],
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    return out, res.stdout + res.stderr


def main():
    import re
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print('chip_ab: needs a CUDA card and the other csrc directory',
              file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import raytracetorch_tpu_torch as rt
    from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build
    other = os.path.abspath(sys.argv[1])
    out_dir = os.path.join(cs.ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    results = {'card': cs.nvidia_smi_line(), 'other': other}

    def emit(key, value):
        results[key] = value
        print(json.dumps({key: value}), flush=True)
        with open(os.path.join(out_dir, 'chip_ab.json'), 'w') as f:
            json.dump(results, f, indent=1)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(TRACE)) as pool:
        futures = {n: pool.submit(build_other, other, n, out_dir)
                   for n in TRACE}
        logs = fused_trace.build()
        built = {n: f.result() for n, f in futures.items()}
    emit('build_seconds', time.perf_counter() - t0)

    def strip(usage):
        return {re.sub(cs._NS_HASH, 'NS', k): v for k, v in usage.items()}
    sass, ptxas = {}, {}
    for n in TRACE:
        mine = cs.sass_digests(nvcc_build.library_path(
            n, [fused_trace._LIBRARIES[n][0]]))
        theirs = cs.sass_digests(built[n][0])
        sass[n] = dict(kernels=len(mine),
                       equal=sorted(k for k in mine
                                    if theirs.get(k) == mine[k]),
                       differ=sorted(k for k in mine
                                     if theirs.get(k) != mine[k]))
        a, b = (strip(nvcc_build.ptxas_usage(logs[n][0])),
                strip(nvcc_build.ptxas_usage(built[n][1])))
        ptxas[n] = {k: dict(this=a[k], other=b.get(k)) for k in a
                    if a[k] != b.get(k)}
    emit('sass', sass)
    emit('ptxas_changed', ptxas)

    other_fns = {}
    for n in TRACE:
        lib = ctypes.CDLL(built[n][0])
        syms = dict(fused_trace._LIBRARIES[n][1])
        syms.update({k: v for k, v in PARENT_ARGTYPES.items()
                     if k.startswith(f'rtt_{n}_')})
        for sym, argtypes in syms.items():
            fn = getattr(lib, sym, None)
            if fn is None:
                continue
            fn.argtypes = PARENT_ARGTYPES.get(sym, argtypes)
            fn.restype = ctypes.c_int
            other_fns[sym] = fn
    launches = [s for n in TRACE for s in fused_trace._LIBRARIES[n][1]
                if not any(w in s for w in ('occupancy', 'smem', 'philox'))]
    records = []

    def recorder(sym, fn):
        def call(*args):
            frames, f = [], sys._getframe(1)
            while f is not None and len(frames) < 4:
                frames.append(dict(f.f_locals))
                f = f.f_back
            records.append((sym, args, frames))
            return fn(*args)
        return call

    def time_launch(fn, args):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rc = fn(*args)
        b.record()
        b.synchronize()
        cs.check(rc == 0, f'launch returned {rc}')
        return a.elapsed_time(b)

    dev = torch.device('cuda')
    for label, sc, params, rays, kw in cases(rt, torch, dev, cs.N_MAIN):
        params = sc.init_params(dev) if params is None else params
        saved = dict(fused_trace._fns)
        for sym in launches:
            fused_trace._fns[sym] = recorder(sym, saved[sym])
        del records[:]
        try:
            r = rays.replace(px=rays.px.clone().requires_grad_(True))
            out, sens, *_ = sc.simulate_fused(params, r, **kw)
            ((sens.moments ** 2).sum() * 1e-9
             + (out.px * out.dx).sum() * 1e-6).backward()
            torch.cuda.synchronize()
        finally:
            fused_trace._fns.update(saved)
        res = {}
        for i, (sym, args, _) in enumerate(records):
            keep = []
            mapped = parent_call(torch, sym, args, args[2], keep)
            if mapped is None:
                fns = {'this': saved[sym]}
                calls = {'this': args}
            else:
                fns = {'this': saved[sym], 'other': other_fns[mapped[0]]}
                calls = {'this': args, 'other': mapped[1]}
            fam_args = family_call(torch, sym, args, args[2], keep)
            if fam_args is not None:
                fns['family'] = saved[sym]
                calls['family'] = fam_args
            for w, fn in fns.items():
                for _ in range(2):
                    time_launch(fn, calls[w])
            rounds = []
            for k in range(ROUNDS):
                order = list(fns) if k % 2 == 0 else list(fns)[::-1]
                rounds.append({w: statistics.median(
                    time_launch(fns[w], calls[w]) for _ in range(EVENTS))
                    for w in order})
            med = {w: statistics.median(rd[w] for rd in rounds)
                   for w in fns}
            spread = {w: (max(rd[w] for rd in rounds)
                          - min(rd[w] for rd in rounds)) / med[w]
                      for w in fns}
            res[f'{i}_{sym}'] = dict(
                this_ms=med['this'], other_ms=med.get('other'),
                family_ms=med.get('family'),
                ratio=(med['this'] / med['other'] if 'other' in med
                       else None),
                spread=spread, other_symbol=mapped and mapped[0],
                rounds=rounds)
        emit(label, res)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
