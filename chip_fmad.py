"""The kernels with freeform surfaces and with GRIN rods built with and
without -fmad=false, against their plain versions and the eager trace, on
an NVIDIA card.

Run from the repository's root on a machine with a CUDA card:

    python3 chip_fmad.py

It builds the six libraries as chip_smoke.py does, then again with
-fmad=false (other files of raytracetorch_tpu_torch/_build/, bound in place
of the first in the same process), and with each build measures:

- K1 (K5 on the Scene) with freeform surfaces against its plain version on
  chip_smoke.py section 15's five cases at 2,999 and 100,000 rays: the rays
  whose outputs (and example 20's path lengths) differ in any bit;
- K1 and K5 with GRIN rods against their plain versions on section 20's
  five cases (the turning-point rod among them) at the same sizes, with the
  path length: the rays whose outputs or path lengths differ in any bit;
- example 20's wavefront RMS^2 and its gradient in z1 through simulate_fused
  against the eager trace at 1M rays on four ray sets, the first section
  15b's (chip_smoke.fused_vs_eager): each run's RMS, the gradients' relative
  error in norm, and the fused gradient against the eager adjoint taken at
  the fused run's values.

Example 20's prescription is measured once, with the first build, so both
builds trace one plate.  Prints the card's name and power limit, one JSON
line per build and last {"ok": ...}; exits 1 unless K1 and K5 built with
-fmad=false equal their plain versions bit for bit (with freeform
surfaces and GRIN rods) and example 20's fused and eager gradients then
agree within chip_smoke.GRAD_RTOL in norm.
"""
import json
import os
import sys

import chip_smoke as cs

EX20_RAY_SETS = 4
BITWISE_RAYS = (cs.N_SMALL, 100_000)


def bitwise(rt, torch, dev, terms):
    """{case_rays: rays whose K1 (K5) output differs from the plain
    version's in any bit}."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    out = {}
    for name in cs.FREEFORM_CASES:
        for n in BITWISE_RAYS:
            sc, p, rays, cfg, nonseq = cs.freeform_case(
                rt, torch, name, n, dev, cs.FREEFORM_SEED + 11, terms)
            meta, flat, kinds, maps, coat, prog, ff = cs.freeform_inputs(
                rt, torch, sc, p, rays, cfg)
            ext = fused_trace.ext_kinds(meta)
            opl = name.startswith('ex20')
            if nonseq:
                rk = fused_nonseq.trace_nonseq_fwd_cuda(
                    flat, kinds, rays, cfg, sc.n_bounces, maps, ext,
                    coat=coat, fuzzy=prog, ff=ff)
                rp = fused_nonseq.trace_nonseq_fused_plain(
                    flat, rays, cfg, meta, sc.n_bounces, maps)
            else:
                rk = fused_trace.trace_seq_fwd_cuda(
                    flat, kinds, rays, cfg, maps, ext, track_opl=opl,
                    coat=coat, fuzzy=prog, ff=ff)
                rp = fused_trace.trace_sequential_fused_plain(
                    flat, rays, cfg, meta, maps, track_opl=opl)
            differ = torch.zeros(n, dtype=torch.bool, device=dev)
            for c in fused_trace.COMPS:
                differ |= getattr(rk[0], c) != getattr(rp[0], c)
            if opl:
                differ |= rk[2]['opl'] != rp[2]['opl']
            out[f'{name}_{n}'] = int(differ.sum())
    for name in cs.GRIN_SEQ_CASES + cs.GRIN_NS_CASES:
        for n in BITWISE_RAYS:
            sc = cs.grin_scene(rt, name)
            p = sc.init_params(dev)
            rays = cs.grin_rays(rt, torch, name, n, dev, cs.GRIN_SEED + 11)
            meta, cfg, flat, kinds, maps, ext = cs.grin_inputs(rt, torch, sc,
                                                               p)
            if name in cs.GRIN_NS_CASES:
                rk = fused_nonseq.trace_nonseq_fwd_cuda(
                    flat, kinds, rays, cfg, sc.n_bounces, maps, ext,
                    track_opl=True)
                rp = fused_nonseq.trace_nonseq_fused_plain(
                    flat, rays, cfg, meta, sc.n_bounces, maps, track_opl=True)
            else:
                rk = fused_trace.trace_seq_fwd_cuda(
                    flat, kinds, rays, cfg, maps, ext, track_opl=True)
                rp = fused_trace.trace_sequential_fused_plain(
                    flat, rays, cfg, meta, maps, track_opl=True)
            differ = rk[2]['opl'] != rp[2]['opl']
            for c in fused_trace.COMPS:
                differ |= getattr(rk[0], c) != getattr(rp[0], c)
            out[f'grin_{name}_{n}'] = int(differ.sum())
    return out


def ex20_paths(rt, torch, dev, terms):
    """chip_smoke.fused_vs_eager on example 20 at 1M rays, one dict (without
    the gradients) per ray set."""
    out = []
    for k in range(EX20_RAY_SETS):
        sc, params, rays, _, _ = cs.freeform_case(
            rt, torch, 'ex20', cs.N_MAIN, dev, cs.FREEFORM_SEED + 13 + k,
            terms)
        res = cs.fused_vs_eager(rt, torch, sc, params, rays, 'z1', True)
        out.append({key: v for key, v in res.items()
                    if 'grads' not in key and 'launches' not in key})
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_fmad: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA card', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(cs.ROOT, 'raytracetorch_tpu_torch')):
        print('chip_fmad: run it from a checkout of the repository',
              file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    import raytracetorch_tpu_torch as rt
    from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build
    dev = torch.device('cuda')
    print(cs.nvidia_smi_line(), flush=True)
    terms, results = None, {}
    for fmad in (True, False):
        if not fmad:
            nvcc_build.NVCC_FLAGS = nvcc_build.NVCC_FLAGS + ('-fmad=false',)
            fused_trace._fns.clear()
        logs = fused_trace.build()
        if terms is None:
            terms = cs.ex20_prescription(rt, torch, dev)[0]
        res = dict(fmad=fmad,
                   nvcc_seconds={k: v[1] for k, v in logs.items()},
                   differing_rays=bitwise(rt, torch, dev, terms),
                   ex20=ex20_paths(rt, torch, dev, terms))
        print(json.dumps(res), flush=True)
        results[fmad] = res
    exact = results[False]
    ok = (all(v == 0 for v in exact['differing_rays'].values())
          and all(r['norm_err'] < cs.GRAD_RTOL for r in exact['ex20']))
    print(json.dumps({'ok': ok}), flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
