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

- the four kernel wrappers: K1 (with and without the 256 x 256 grid), K2,
  K3 on the bench spot, and K5 on the naive scene (8 bounces, grid);
- the end-to-end calls: ``SequentialScene.simulate_fused``, the fused grad
  step, ``Scene.simulate_fused`` and the eager ``Scene.simulate``.

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
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace, grid

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
        'simulate_fused': (lambda: scene.simulate_fused(params, rays),
                           'trace_seq_fwd_kernel'),
        'grad_step_fused': (grad_step, 'trace_seq_bwd'),
        'scene_simulate_fused': (lambda: nscene.simulate_fused(nparams,
                                                               rays),
                                 'trace_nonseq_fwd_kernel'),
        'scene_simulate_eager': (lambda: nscene.simulate(nparams, rays),
                                 'grid_bin_kernel'),
    }
    out = {'n': n, 'reps': REPS}
    for name, (fn, key) in calls.items():
        out[name] = profile(torch, fn, key)
    print(json.dumps({'phase': 'profile', **out}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
