#!/usr/bin/env python3
"""Device-time profile of the PyTorch port's kernels and entry points on one
CUDA card.

Run from the root of a checkout:  python3 chip_profile.py

For each call below it runs the call once to warm up, then torch.profiler
(CPU and CUDA activities) over 5 calls, and prints one JSON line with, per
call: the summed device time of every device operation, the device time of
the named kernel, the number of device operations, and the host wall time
of the profiled calls (slowed by the profiler itself), so busy = device
time / wall time.  The calls, at 1M rays on the scenes of chip_smoke.py:

- the kernel wrappers: K1 (with and without the 256 x 256 grid), K2,
  K3 on the bench spot, K5 on the naive scene (8 bounces, grid) and K6 on
  the same scene with the cotangents of a spot and grid loss (also at 16M
  rays); K4's gather and scatter on the 256 x 256 ring-former map, and K1,
  K2, K5 and K6 with that plate (chip_smoke.py section 7);
- the end-to-end calls: ``SequentialScene.simulate_fused``, the fused grad
  step, ``Scene.simulate_fused``, its grad step (K5 + K6), the eager
  ``Scene.simulate`` and the deep-optics grad step (the ring former, the
  map the only trainable leaf: K1 + K2).

The last line names the card and its power limit as nvidia-smi gives
them.  A call whose profile holds no device time reports null there.
"""

import json
import os
import sys
import time

import chip_smoke as cs

REPS = 5


def profile(torch, fn, kernel_key):
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / REPS

    def dev_us(e):
        return (getattr(e, 'self_device_time_total', None)
                or getattr(e, 'self_cuda_time_total', 0) or 0)

    dev = [e for e in prof.key_averages()
           if str(getattr(e, 'device_type', '')).endswith('CUDA')]
    total = sum(dev_us(e) for e in dev) / 1e3 / REPS
    kern = [e for e in dev if kernel_key and kernel_key in e.key]
    return dict(
        device_ms=total or None,
        kernel_device_ms=(sum(dev_us(e) for e in kern) / 1e3 / REPS
                          if kern else None),
        device_ops=sum(e.count for e in dev) / REPS,
        wall_ms=wall_ms, busy=(total / wall_ms if total else None))


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_profile: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    if not os.path.isdir(os.path.join(cs.ROOT, 'raytracetorch_tpu_torch')):
        print('chip_profile: run it from a checkout', file=sys.stderr)
        return 2
    import raytracetorch_tpu_torch as rt
    from raytracetorch_tpu_torch.ops import (fused_nonseq, fused_trace, grid,
                                             phase_grid)

    dev = torch.device('cuda')
    fused_trace.build()
    n = cs.N_MAIN
    scene, gscene, nscene = (cs.bench_scene(rt), cs.grid_scene(rt),
                             cs.naive_scene(rt))
    params, nparams = scene.init_params(dev), nscene.init_params(dev)
    meta, cfg, gcfg = (scene.static_meta(), scene.sensor_config(),
                       gscene.sensor_config())
    flat = rt.flatten_table_rows(scene.build_table(params))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    ncfg, nmeta = nscene.sensor_config(), nscene.static_meta()
    nflat = rt.flatten_table_rows(nscene.build_table(nparams))
    nkinds = torch.tensor(fused_trace.kind_rows(nmeta, ncfg),
                          dtype=torch.int32, device=dev)
    rays = cs.sample_rays(rt, torch, n, dev, cs.SEED)
    spot, _ = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    ones = torch.ones_like(spot.px)
    g_mom = torch.randn(1, 1, 7, device=dev)
    p_grad = scene.init_params(dev)
    for k in ('c1', 'c2'):
        p_grad['lens'][k].requires_grad_(True)

    def grad_step():
        _, s, _ = scene.simulate_fused(p_grad, rays)
        rt.spot_size_loss(s).backward()

    w = torch.randn(1, *cs.GRID, device=dev)
    np_grad = nscene.init_params(dev)
    for k in ('c1', 'c2'):
        np_grad['lens'][k].requires_grad_(True)

    def ns_grad_step():
        _, s, _ = nscene.simulate_fused(np_grad, rays)
        ((s.grid * w).sum() + s.spot_rms(0)[0]).backward()

    rays16 = cs.sample_rays(rt, torch, cs.N_LARGE, dev, cs.SEED)

    # the deep-optics calls: the ring former with the 256 x 256 map
    do_seq = cs.ring_scene(rt)
    do_ns = cs.ring_scene(rt, bounces=cs.DO_BOUNCES, grid=True)
    do_rays = cs.ring_rays(rt, torch, n, dev, cs.SEED)
    plate = {}
    for key, sc in (('seq', do_seq), ('ns', do_ns)):
        pp = cs.ring_params(sc, dev)
        pmeta, pcfg = sc.static_meta(), sc.sensor_config()
        plate[key] = (rt.flatten_table_rows(sc.build_table(pp)),
                      torch.tensor(fused_trace.kind_rows(pmeta, pcfg),
                                   dtype=torch.int32, device=dev), pcfg,
                      fused_trace.plate_maps(pmeta, sc.side_grids(pp)))
    cmap = plate['seq'][3][0]
    civ, ciu = cs.plate_cells(torch, do_rays, cs.DO_MAP)
    g_c = tuple(torch.randn(n, device=dev) for _ in range(4))
    do_grad_p = cs.ring_params(do_seq, dev, grad=True)

    def do_grad_step():
        out, _, _ = do_seq.simulate_fused(do_grad_p, do_rays)
        cs.ring_loss(torch, out).backward()

    calls = {
        'k1': (lambda: fused_trace.trace_seq_fwd_cuda(flat, kinds, rays,
                                                      cfg),
               'trace_seq_fwd_kernel'),
        'k1_grid': (lambda: fused_trace.trace_seq_fwd_cuda(flat, kinds, rays,
                                                           gcfg),
                    'trace_seq_fwd_kernel'),
        'k2': (lambda: fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, (None,) * 7, g_mom), 'trace_seq_bwd'),
        'k3_spot': (lambda: grid.bin_grid_cuda(spot.px, spot.py, ones, 0,
                                               gcfg), 'grid_bin_kernel'),
        'k5': (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
            nflat, nkinds, rays, ncfg, nscene.n_bounces),
            'trace_nonseq_fwd_kernel'),
        'k6': (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            nflat, nkinds, rays, ncfg, nscene.n_bounces, (None,) * 7, g_mom,
            g_grid=w), 'trace_nonseq_bwd_kernel'),
        'k6_16m': (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            nflat, nkinds, rays16, ncfg, nscene.n_bounces, (None,) * 7,
            g_mom, g_grid=w), 'trace_nonseq_bwd_kernel'),
        'simulate_fused': (lambda: scene.simulate_fused(params, rays),
                           'trace_seq_fwd_kernel'),
        'grad_step_fused': (grad_step, 'trace_seq_bwd'),
        'scene_simulate_fused': (lambda: nscene.simulate_fused(nparams,
                                                               rays),
                                 'trace_nonseq_fwd_kernel'),
        'scene_grad_step_fused': (ns_grad_step, 'trace_nonseq_bwd_kernel'),
        'scene_simulate_eager': (lambda: nscene.simulate(nparams, rays),
                                 'grid_bin_kernel'),
        'k4': (lambda: phase_grid.grid_corners_cuda(cmap, civ, ciu),
               'grid_corners_kernel'),
        'k4_scatter': (lambda: phase_grid.grid_corners_bwd_cuda(
            g_c, civ, ciu, cs.DO_MAP), 'grid_corners_bwd_kernel'),
        'k1_plate': (lambda: fused_trace.trace_seq_fwd_cuda(
            *plate['seq'][:2], do_rays, *plate['seq'][2:]),
            'trace_seq_fwd_kernel'),
        'k2_plate': (lambda: fused_trace.trace_seq_bwd_cuda(
            *plate['seq'][:2], do_rays, plate['seq'][2], (None,) * 7, g_mom,
            maps=plate['seq'][3]), 'trace_seq_bwd'),
        'k5_plate': (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
            *plate['ns'][:2], do_rays, plate['ns'][2], cs.DO_BOUNCES,
            plate['ns'][3]), 'trace_nonseq_fwd_kernel'),
        'k6_plate': (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            *plate['ns'][:2], do_rays, plate['ns'][2], cs.DO_BOUNCES,
            (None,) * 7, g_mom, g_grid=w, maps=plate['ns'][3]),
            'trace_nonseq_bwd_kernel'),
        'deep_optics_grad_step_fused': (do_grad_step, 'trace_seq_bwd'),
    }
    out = {'n': n, 'reps': REPS}
    for name, (fn, key) in calls.items():
        out[name] = profile(torch, fn, key)
    print(json.dumps({'phase': 'profile', **out}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
