#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the CUDA kernel from the sources in the checkout, checks it
against its plain PyTorch version, drives the main path (the 1M-ray singlet
scene through ``SequentialScene.simulate_fused``) once with the kernel's
launch counter reset, checks the result against the repo's anchors, checks
eager gradients on the card against the CPU, and times the kernel, its
plain version and the end-to-end calls with CUDA events.

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero.  Then come the kernel summary line, the card's name and
power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
N_MAIN = 1_000_000
N_SMALL = 2_999
N_LARGE = 16_000_000
# Anchors of the bench scene: BENCH_r05.json records spot_rms 0.16907 for
# the JAX package at 1M rays; the paraxial focal length is 20.513.
SPOT_RMS_REF, SPOT_RMS_TOL = 0.1691, 0.002
FOCAL_REF, FOCAL_TOL = 20.513, 1e-3
# Kernel vs plain: positions and directions to atol/rtol 1e-5 (f32 rounding
# of a 5-surface chain; the kernel contracts multiply-adds, eager torch
# does not), at most 10 rays per 1M whose hit flips at a bound's rim, and
# each moment to 2e-4 of its scale (f32 summation order over 1M terms).
POS_TOL = 1e-5
FLIPS_PER_MILLION = 10
MOMENT_RTOL = 2e-4
GRAD_RTOL = 1e-3


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def emit(phase, **kw):
    print(json.dumps({'phase': phase, **kw}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def nvcc_version():
    from raytracetorch_tpu_torch.ops.nvcc_build import nvcc_path
    out = subprocess.run([nvcc_path(), '--version'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


def bench_scene(rt):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       ior_media=1.0, name='lens'),
        rt.CircularAperture(radius=5.0, name='stop'),
        rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                         name='sensor'),
    ])


def sample_rays(rt, torch, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    src = rt.CollimatedDisk.make(radius=4.0, translation=[0.0, 0.0, -10.0])
    return src.sample(gen, n, device)


def two_bundle_table(rt, torch, device):
    """A hand-built 6-row table: a tilted mirror disk (REFLECT), a small
    off-axis absorbing disk (BLOCK), a sensor, a spherical lens face (SNELL,
    HEMI bound), an inverted stop, and a second sensor."""
    from raytracetorch_tpu_torch.constants import PhysKind, SBKind, VBKind
    from raytracetorch_tpu_torch.elements.base import compose_world
    from raytracetorch_tpu_torch.geom.surfaces import q_plane, q_quadric
    from raytracetorch_tpu_torch.geom.transform import rodrigues

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    def plane(z, rot=(0.0, 0.0, 0.0), **kw):
        Rw, tw, Rs, ts = compose_world(rodrigues(t(rot)), t([0.0, 0.0, z]))
        q, s = q_plane(torch.float32, device)
        return rt.SurfaceRec(q=q, n_sign=s, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                             is_plane=True, **kw)

    Rw, tw, Rs, ts = compose_world(rodrigues(t([0.0, 0.0, 0.0])),
                                   t([0.0, 0.0, 8.0]))
    q, s = q_quadric(t(0.05), 0.0)
    recs = [
        plane(0.0, rot=(0.3, 0.0, 0.0), sb_kind=SBKind.DISK, sb=(1.0,),
              ph_kind=PhysKind.REFLECT),
        plane(4.0, sb_kind=SBKind.DISK, sb=(0.25, 2.0, 0.0),
              ph_kind=PhysKind.BLOCK),
        plane(6.0, sb_kind=SBKind.DISK, sb=(400.0,), is_sensor=True,
              sensor_slot=0),
        rt.SurfaceRec(q=q, n_sign=s, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                      sb_kind=SBKind.HEMI, sb=(0.05,),
                      vb_kind=VBKind.APER_R2, vb=(25.0,),
                      ph_kind=PhysKind.SNELL, ph=(1.5, 1.0)),
        plane(12.0, sb_kind=SBKind.DISK, sb=(9.0,), sb_invert=True,
              ph_kind=PhysKind.APERTURE),
        plane(30.0, sb_kind=SBKind.DISK, sb=(400.0,), is_sensor=True,
              sensor_slot=1),
    ]
    table = rt.stack_records(recs, [0] * len(recs), list(range(len(recs))),
                             device=device)
    meta = [rt.StaticRowMeta(r.ph_kind, r.sb_kind, r.vb_kind, r.is_sensor,
                             r.sb_invert, plane=r.is_plane,
                             slot=r.sensor_slot) for r in recs]
    cfg = rt.SensorConfig(n_sensors=2, n_bundles=2)
    return table, meta, cfg


def two_bundle_rays(rt, torch, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = rt.CollimatedDisk.make(radius=3.0, translation=[0.0, 0.0, -10.0],
                               ray_id=0).sample(gen, n // 2, device)
    b = rt.CollimatedDisk.make(radius=3.0, translation=[0.5, 0.0, -10.0],
                               rotation=[0.05, 0.0, 0.0],
                               ray_id=1).sample(gen, n - n // 2, device)
    return rt.Rays.concatenate([a, b])


def moment_scale(torch, m):
    """Per-moment magnitude scale: the moment itself for the positive
    moments, the Cauchy-Schwarz bound for the signed ones (sum wx can be
    near zero while its terms are not)."""
    w, wx, wy, wx2, wy2, wxy, cnt = m.unbind(-1)
    return torch.stack([w.abs(), (w * wx2).abs().sqrt(),
                        (w * wy2).abs().sqrt(), wx2.abs(), wy2.abs(),
                        (wx2 * wy2).abs().sqrt(), cnt.abs()], dim=-1)


def compare(torch, out_k, s_k, out_p, s_p):
    """Kernel vs plain -> dict of worst errors; raises on a breach."""
    n = out_k.px.shape[0]
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz')
    bad = out_k.intensity != out_p.intensity
    for c in comps:
        a, b = getattr(out_k, c), getattr(out_p, c)
        bad |= (a - b).abs() > POS_TOL + POS_TOL * b.abs()
        bad |= ~torch.isfinite(a)
    n_flip = int(bad.sum())
    allowed = math.ceil(FLIPS_PER_MILLION * n / 1e6)
    keep = ~bad
    max_err = max(float((getattr(out_k, c) - getattr(out_p, c))[keep]
                        .abs().max()) if n else 0.0 for c in comps)
    mk, mp = s_k.moments, s_p.moments
    bound = MOMENT_RTOL * torch.maximum(moment_scale(torch, mp), mp.abs())
    mom_err = (mk - mp).abs()
    worst = float((mom_err / bound.clamp(min=1e-30)).max())
    res = dict(n=n, flipped=n_flip, flips_allowed=allowed,
               max_abs_err=max_err, moment_err_over_bound=worst,
               max_moment_abs_err=float(mom_err.max()))
    check(n_flip <= allowed, f'{n_flip} rays differ (allowed {allowed})')
    check(bool((mom_err <= bound + 1e-6).all()),
          f'moments differ: {mk.tolist()} vs {mp.tolist()}')
    return res


def time_ms(torch, fn, warmup=3, reps=20):
    """Median ms of ``reps`` calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return ts


def time_pair(torch, kernel_fn, plain_fn, reps=20):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    reps/2 calls per turn -> (kernel ms median, plain ms median, runs)."""
    half = reps // 2
    p1 = time_ms(torch, plain_fn, reps=half)
    k1 = time_ms(torch, kernel_fn, reps=half)
    k2 = time_ms(torch, kernel_fn, reps=half)
    p2 = time_ms(torch, plain_fn, reps=half)
    k, p = k1 + k2, p1 + p2
    return statistics.median(k), statistics.median(p), k, p


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA card', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, 'raytracetorch_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository',
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import raytracetorch_tpu_torch as rt
    from raytracetorch_tpu_torch.ops import fused_trace

    dev = torch.device('cuda')
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)

    # 1. device
    emit('device', name=name, nvidia_smi=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version(),
         tf32=[torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32])

    # 2. build
    t0 = time.perf_counter()
    log, nvcc_s = fused_trace.build()
    ptxas = [ln.strip() for ln in log.splitlines()
             if 'registers' in ln or 'spill' in ln]
    emit('build', seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_s,
         ptxas=ptxas)

    # 3. kernel vs plain on the card
    scene = bench_scene(rt)
    meta, cfg = scene.static_meta(), scene.sensor_config()
    params = scene.init_params(dev)
    flat = rt.flatten_table_rows(scene.build_table(params))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                         dtype=torch.int32, device=dev)
    cases = {}
    for n in (N_SMALL, N_MAIN):
        rays = sample_rays(rt, torch, n, dev, SEED + n)
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays,
                                                              cfg, meta)
        torch.cuda.synchronize()
        cases[f'bench_{n}'] = compare(torch, out_k, s_k, out_p, s_p)
    table2, meta2, cfg2 = two_bundle_table(rt, torch, dev)
    flat2 = rt.flatten_table_rows(table2)
    kinds2 = torch.tensor(fused_trace.kind_rows(meta2, cfg2),
                          dtype=torch.int32, device=dev)
    for n in (N_SMALL, N_MAIN):
        rays = two_bundle_rays(rt, torch, n, dev, SEED + 7 + n)
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat2, kinds2, rays, cfg2)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat2, rays, cfg2, meta2)
        torch.cuda.synchronize()
        res = compare(torch, out_k, s_k, out_p, s_p)
        # every kind of the table did work: reflected, blocked, both sensors
        res['reflected'] = int((out_k.dz < 0).sum())
        res['blocked'] = int((out_k.intensity == 0).sum())
        res['sensor_weights'] = s_k.moments[:, :, 0].tolist()
        check(res['reflected'] > 0 and res['blocked'] > 0
              and bool((s_k.moments[:, :, 0] > 0).all()),
              f'two-bundle table did not exercise every row: {res}')
        cases[f'two_bundle_{n}'] = res
    emit('kernel_vs_plain', **cases)

    # 4. main path, counted
    scene = bench_scene(rt)
    params = scene.init_params(dev)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED)
    torch.cuda.synchronize()
    fused_trace.LAUNCHES = 0
    out, sens, _ = scene.simulate_fused(params, rays)
    torch.cuda.synchronize()
    launches = fused_trace.LAUNCHES
    rms = float(sens.spot_rms(0)[0])
    cen = sens.centroid(0)[0].tolist()
    f = float(-1.0 / scene.paraxial(params)[1, 0])
    finite = all(bool(torch.isfinite(getattr(out, c)).all())
                 for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'))
    emit('main_path', launches=launches, n=N_MAIN, spot_rms=rms,
         centroid=cen, focal_length=f, finite=finite,
         shape=list(out.pos.shape), hits=float(sens.moments[0, 0, 6]))
    check(launches >= 1, 'simulate_fused did not launch the kernel')
    check(finite and list(out.pos.shape) == [N_MAIN, 3], 'bad ray output')
    check(abs(rms - SPOT_RMS_REF) < SPOT_RMS_TOL, f'spot_rms {rms}')
    check(max(abs(c) for c in cen) < 1e-3, f'centroid {cen}')
    check(abs(f - FOCAL_REF) < FOCAL_TOL, f'focal length {f}')

    # 5. eager gradient on the card vs the CPU
    grads = {}
    for where in ('cuda', 'cpu'):
        p = scene.init_params(where)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        _, s, _ = scene.simulate(p, rays.to(where))
        loss = rt.spot_size_loss(s)
        loss.backward()
        grads[where] = [float(p['lens'][k].grad) for k in ('c1', 'c2')]
        grads[where + '_loss'] = float(loss.detach())
    rel = [abs(a - b) / abs(b) for a, b in zip(grads['cuda'], grads['cpu'])]
    emit('eager_grad', n=N_MAIN, **grads, rel_err=rel)
    check(all(math.isfinite(g) for g in grads['cuda']), 'non-finite grad')
    check(max(rel) < GRAD_RTOL, f'card vs CPU gradients differ: {rel}')

    # 6. timing
    timing = {'card': card}
    for n in (N_MAIN, N_LARGE):
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        k_ms, p_ms, k_runs, p_runs = time_pair(
            torch,
            lambda: fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg),
            lambda: fused_trace.trace_sequential_fused_plain(flat, rays,
                                                             cfg, meta))
        timing[f'n{n}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                               kernel_rays_per_s=n / (k_ms * 1e-3),
                               plain_rays_per_s=n / (p_ms * 1e-3),
                               kernel_runs=k_runs, plain_runs=p_runs)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 2)
    p_grad = scene.init_params(dev)
    for k in ('c1', 'c2'):
        p_grad['lens'][k].requires_grad_(True)

    def grad_step():
        _, s, _ = scene.simulate(p_grad, rays)
        rt.spot_size_loss(s).backward()

    e2e = {
        'simulate_fused_ms': time_ms(
            torch, lambda: scene.simulate_fused(params, rays)),
        'simulate_eager_ms': time_ms(
            torch, lambda: scene.simulate(params, rays)),
        'grad_step_eager_ms': time_ms(torch, grad_step),
    }
    for key, runs in e2e.items():
        timing[key] = statistics.median(runs)
        timing[key + '_runs'] = runs
    timing['trace_rays_per_s_fused'] = N_MAIN / (
        timing['simulate_fused_ms'] * 1e-3)
    emit('timing', **timing)

    summary = {'kernels': [{
        'name': 'trace_seq_fwd', 'route': 'cuda',
        'source': 'raytracetorch_tpu_torch/csrc/trace_seq_fwd.cu',
        'replaces': 'raytracetorch_tpu/ops/pallas_trace.py:489',
        'launches': launches,
        'max_abs_err': cases[f'bench_{N_MAIN}']['max_abs_err'],
        'ms': timing[f'n{N_MAIN}']['kernel_ms'],
        'plain_ms': timing[f'n{N_MAIN}']['plain_ms'],
    }]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
