#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the four CUDA libraries from the sources in the checkout (K1, the
fused sequential forward; K2, its hand-written adjoint; K3, irradiance-grid
binning; K5, the fused non-sequential bounce loop; one nvcc each, started
together) and checks each kernel against its plain PyTorch version, K1 and
K2 also with a 256 x 256 grid.  Then it drives five paths, each with every
launch counter reset just before it and read just after: the forward main
path (the 1M-ray singlet scene through ``SequentialScene.simulate_fused``),
the gradient main path (the same call under grad, then ``spot_size_loss``
and ``backward()``), the design loop (the reference's singlet design by
``fit_lbfgs`` through ``simulate_fused`` at 1M rays), the non-sequential
main path (the singlet traced as a ``Scene`` with a 256 x 256 grid through
``Scene.simulate_fused``), and the same scene through the eager
``Scene.simulate``, whose grid binning launches K3.  It checks each against
the repo's anchors and against the eager paths, and times the kernels,
their plain versions, a library call where one computes the same function,
and the end-to-end calls with CUDA events.

Each phase prints one JSON line; any failed check raises, so the script
exits non-zero.  Then come the kernel summary line (each kernel's launches
on its main path, error, time, plain time, the bound of its work on this
card and, for K3, a library call's time), the card's name and power limit
as nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
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
# K2 vs its plain version (autograd of the eager chain).  A ray disagrees if
# any of its 7 input cotangents differs by more than BWD_TOL * (|plain| +
# the scale of its group), the group scale being the largest |plain| over
# all rays of the position, direction or intensity streams: f32 rounding of
# the adjoint chain (the kernel contracts multiply-adds, eager torch does
# not) and cotangents that vanish in exact arithmetic (d/d pz of a ray that
# starts parallel to z) are noise at that scale; on an H100 the worst ray
# reads 5.5e-6 of it at 1M rays.  At most BWD_FLIPS_PER_MILLION rays may
# disagree, for the rays whose branch flips at a bound's rim, as in the
# forward.  The table cotangent is a sum over all rays: each column to
# TAB_RTOL of the scale of its field (the largest |plain| over the q, Rw, tw
# or ph columns of all rows), for f32 sums of 1M terms in another order
# (2e-7 of the scale on an H100).
BWD_TOL = 1e-5
BWD_FLIPS_PER_MILLION = 10
TAB_RTOL = 1e-4
# The design loop: the reference's singlet (tests/test_optimize_singlet.py)
DESIGN_STEPS = 25
# Irradiance grids: the bench spot on a 256 x 256 grid over [-1, 1]^2
# (benchmarks/suite.py grid_256_1M).  K3 alone, unit weights: bit for bit
# (each bin a sum of integers, exact in f32).  Random weights: each bin
# within GRID_RAND_RTOL of the grid's largest bin (float atomics add in a
# run-dependent order).  A fused kernel's grid: its total to
# GRID_TOTAL_RTOL of the plain total (K1) or NS_GRID_TOTAL_RTOL (K5), and
# sum |grid_k - grid_p| / total <= GRID_SHARE: a ray whose hit an FMA ulp
# moves across a bin edge moves its weight to the next bin.  The same rays
# take their neighbour bin's cotangent in K2, so the intensity cotangent may
# differ on a GRID_SHARE share of the rays.
GRID, GRID_E = (256, 256), 1.0
GRID_RAND_RTOL = 1e-5
GRID_TOTAL_RTOL = 1e-6
GRID_SHARE = 2e-3
# K5 vs its plain version (tests/test_pallas.py test_nonseq_fused_*): rays
# with |dpos| > NS_POS_TOL or |dintensity| > NS_INT_TOL number at most
# max(3, NS_MISMATCH_SHARE * N) (a hit that flips at a rim changes the
# ray's later bounces); moments to NS_MOMENT_RTOL of their scale.
NS_POS_TOL, NS_INT_TOL = 1e-4, 1e-5
NS_MISMATCH_SHARE = 1e-4
NS_MOMENT_RTOL = 1e-4
NS_GRID_TOTAL_RTOL = 1e-5
NS_BOUNCES = 8
# The non-sequential trace of an ordered system equals the sequential
# trace (tests/test_nonsequential.py): spot RMS to NS_SPOT_RTOL.
NS_SPOT_RTOL = 1e-3
# H100 SXM datasheet peaks for the bound of each kernel's work: HBM bytes/s
# and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def design_scene(rt):
    """The reference's optimization lens: f ~ 99.6, target plane z=100."""
    return rt.SequentialScene([rt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        c1_grad=True, c2_grad=True, name='lens')])


def design_loss(torch, scene, rays, target_z=100.0):
    """Mean squared transverse error of the final rays at z = target_z."""
    def loss(p):
        out, _, _ = scene.simulate_fused(p, rays)
        t = (target_z - out.pz) / (out.dz + 1e-6)
        x = out.px + t * out.dx
        y = out.py + t * out.dy
        return torch.mean(x * x + y * y)
    return loss


def random_cotangents(torch, n, cfg, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    g_rays = tuple(torch.randn(n, generator=gen, device=device)
                   for _ in range(7))
    g_mom = torch.randn(max(cfg.n_sensors, 1), cfg.n_bundles, 7,
                        generator=gen, device=device)
    return g_rays, g_mom


def compare_ray_cotangents(torch, g_k, g_p, intensity_allowed=0):
    """Per-ray cotangents, kernel vs plain (7 streams px..intensity) ->
    dict; raises on a breach.  ``intensity_allowed`` rays may differ in the
    intensity cotangent alone (a grid cotangent read from a neighbour bin)."""
    groups = ((0, 1, 2), (3, 4, 5), (6,))
    n = g_p[0].shape[0]
    bad = [torch.zeros(n, dtype=torch.bool, device=g_p[0].device)
           for _ in groups]
    max_err, worst = 0.0, 0.0
    for grp, bad_g in zip(groups, bad):
        scale = max(float(g_p[j].abs().max()) if n else 0.0 for j in grp)
        for j in grp:
            err = (g_k[j] - g_p[j]).abs()
            bound = BWD_TOL * (g_p[j].abs() + scale)
            bad_g |= (err > bound) | ~torch.isfinite(g_k[j])
            if n:
                max_err = max(max_err, float(err.max()))
                worst = max(worst, float(err.max()) / max(scale, 1e-30))
    n_bad = int((bad[0] | bad[1] | bad[2]).sum())
    allowed = math.ceil(BWD_FLIPS_PER_MILLION * n / 1e6)
    res = dict(n=n, rays_differ=n_bad, allowed=allowed,
               max_abs_err=max_err, max_err_over_scale=worst)
    if intensity_allowed:
        n_geom, n_int = int((bad[0] | bad[1]).sum()), int(bad[2].sum())
        res.update(position_direction_differ=n_geom, intensity_differ=n_int,
                   intensity_allowed=max(allowed, intensity_allowed))
        check(n_geom <= allowed,
              f'{n_geom} rays have other position or direction cotangents '
              f'(allowed {allowed})')
        check(n_int <= max(allowed, intensity_allowed),
              f'{n_int} rays have other intensity cotangents')
    else:
        check(n_bad <= allowed,
              f'{n_bad} rays have other cotangents (allowed {allowed})')
    return res


def compare_table_cotangents(torch, fused_trace, g_k, g_p):
    """Table cotangent [K, 160], kernel vs plain -> dict; raises on a
    breach.  Outside GRAD_COLS both must be exactly zero."""
    offs = list(fused_trace.GRAD_COLS)
    fields = (offs[0:5], offs[5:14], offs[14:17], offs[17:19])
    worst = 0.0
    for cols in fields:
        scale = float(g_p[:, cols].abs().max())
        err = float((g_k[:, cols] - g_p[:, cols]).abs().max())
        check(err <= TAB_RTOL * scale,
              f'table cotangent columns {cols} differ by {err} '
              f'(scale {scale})')
        worst = max(worst, err / max(scale, 1e-30))
    outside = [c for c in range(g_p.shape[1]) if c not in offs]
    check(float(g_k[:, outside].abs().max()) == 0.0
          and float(g_p[:, outside].abs().max()) == 0.0,
          'nonzero table cotangent outside GRAD_COLS')
    return dict(table_err_over_scale=worst,
                table_max_abs_err=float((g_k - g_p).abs().max()),
                rows_with_grad=int((g_p.abs().sum(1) > 0).sum()))


def grid_scene(rt):
    """The bench scene with the 256 x 256 grid of benchmarks/suite.py."""
    scene = bench_scene(rt)
    scene.grid_shape, scene.grid_half_extent = GRID, GRID_E
    return scene


def naive_scene(rt, stop_z=0.0, n_bounces=NS_BOUNCES):
    """BASELINE.json's naive scene: the bench singlet traced as a
    non-sequential Scene (benchmarks/suite.py naive_scene_1M_8bounce), with
    the 256 x 256 grid.  ``stop_z=10`` is the ordered variant of
    tests/test_nonsequential.py, which a sequential trace must match."""
    scene = rt.Scene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       ior_media=1.0, name='lens'),
        rt.CircularAperture(radius=5.0, translation=[0.0, 0.0, stop_z],
                            name='stop'),
        rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                         name='sensor'),
    ], n_bounces=n_bounces)
    scene.grid_shape, scene.grid_half_extent = GRID, GRID_E
    return scene


def mirror_fold_scene(rt):
    """A spherical mirror (R = -40) folds collimated rays back through a
    sensor behind their source, which no z-ordered trace can follow
    (tests/test_pallas.py test_nonseq_fused_grid_parity); 32 x 32 grid over
    [-4, 4]^2."""
    scene = rt.Scene([
        rt.SphericalMirror(c1=-0.025, d=0.0, translation=[0.0, 0.0, 40.0],
                           name='mirror'),
        rt.SensorElement(radius=10.0, translation=[0.0, 0.0, 0.5],
                         name='sensor'),
    ], n_bounces=4)
    scene.grid_shape, scene.grid_half_extent = (32, 32), 4.0
    return scene


def mirror_fold_rays(rt, torch, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    src = rt.CollimatedDisk.make(radius=2.0, translation=[0.0, 0.0, 1.0])
    return src.sample(gen, n, device)


def compare_grid(torch, g_k, g_p, total_rtol):
    """A fused kernel's grid vs its plain version's -> dict; raises on a
    breach (module notes: GRID_SHARE)."""
    total = float(g_p.sum())
    total_err = abs(float(g_k.sum()) - total)
    share = float((g_k - g_p).abs().sum()) / max(abs(total), 1e-30)
    res = dict(grid_total=total, grid_total_abs_err=total_err,
               grid_l1_share=share, grid_max_abs_err=float(
                   (g_k - g_p).abs().max()))
    check(total_err <= total_rtol * abs(total),
          f'grid totals differ: {float(g_k.sum())} vs {total}')
    check(share <= GRID_SHARE, f'grids differ: L1 share {share}')
    return res


def compare_nonseq(torch, out_k, s_k, out_p, s_p):
    """K5 (or the eager bounce loop) vs the plain bounce loop -> dict;
    raises on a breach (module notes: NS_*)."""
    n = out_p.px.shape[0]
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz')
    dpos = torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                        for c in comps[:3]]).amax(0)
    bad = ((dpos > NS_POS_TOL)
           | ((out_k.intensity - out_p.intensity).abs() > NS_INT_TOL))
    for c in comps + ('intensity',):
        bad |= ~torch.isfinite(getattr(out_k, c))
    n_bad = int(bad.sum())
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * n))
    keep = ~bad
    max_err = max(float((getattr(out_k, c) - getattr(out_p, c))[keep]
                        .abs().max()) if n else 0.0 for c in comps)
    mk, mp = s_k.moments, s_p.moments
    bound = NS_MOMENT_RTOL * torch.maximum(moment_scale(torch, mp), mp.abs())
    mom_err = (mk - mp).abs()
    res = dict(n=n, mismatched=n_bad, mismatch_allowed=allowed,
               max_abs_err=max_err,
               moment_err_over_bound=float(
                   (mom_err / bound.clamp(min=1e-30)).max()))
    check(n_bad <= allowed, f'{n_bad} rays differ (allowed {allowed})')
    check(bool((mom_err <= bound + 1e-6).all()),
          f'moments differ: {mk.tolist()} vs {mp.tolist()}')
    res.update(compare_grid(torch, s_k.grid, s_p.grid, NS_GRID_TOTAL_RTOL))
    return res


# Float32 operations per ray of one table row, counted in the kernels'
# sources (csrc/trace_seq_common.cuh): the intersection with its bounds,
# and the normal, physics, update and sensor terms of a row that is
# applied.  Each kernel's bound is the larger of its bytes over the HBM
# rate and these operations over the float32 rate.
def intersect_ops(meta):
    return ((83 if meta.plane else 122) + (22 if meta.sb else 0)
            + (22 if meta.vb else 0))


def apply_ops(meta):
    from raytracetorch_tpu_torch.constants import PhysKind
    physics = {PhysKind.SNELL: 26, PhysKind.REFLECT: 13,
               PhysKind.APERTURE: 8}.get(meta.ph, 0)
    return 7 + (0 if meta.plane else 34) + physics + (13 if meta.sensor
                                                      else 0)


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it) of work of n_bytes and n_ops."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def table_bytes(meta):
    return len(meta) * (160 + 8) * 4


def grid_bytes(cfg):
    if not cfg.grid_shape:
        return 0
    return max(cfg.n_sensors, 1) * cfg.grid_shape[0] * cfg.grid_shape[1] * 4


def nonseq_work(rt, torch, scene, params, rays):
    """K5's data-dependent work on these rays: the row scans it runs (one per
    ray and bounce begun with intensity > 0 and a hit in the last bounce)
    and the winners per row, counted with the plain bounce loop."""
    from raytracetorch_tpu_torch.core.trace import bounce_step, nearest_hit
    table = scene.build_table(params)
    meta = scene.static_meta()
    rows = [table.row(k) for k in range(table.n_surfaces)]
    cfg = rt.SensorConfig(n_sensors=scene.n_sensors, n_bundles=1)
    sens = rt.SensorState.init(cfg, device=rays.px.device)
    going = rays.intensity > 0
    scans, wins = 0, [0] * len(meta)
    with torch.no_grad():
        for _ in range(scene.n_bounces):
            if not bool(going.any()):
                break
            scans += int(going.sum())
            win, _ = nearest_hit(table, rays.pos_c, rays.dir_c, meta)
            rays, sens, act = bounce_step(rows, rays, cfg, sens, meta,
                                          plain=True)
            for k in range(len(meta)):
                wins[k] += int((act & going & (win == k)).sum())
            going = going & act & (rays.intensity > 0)
    return scans, wins


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


def time_pair(torch, kernel_fn, plain_fn, reps=20, warmup=3):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    reps/2 calls per turn -> (kernel ms median, plain ms median, runs)."""
    half = reps // 2
    p1 = time_ms(torch, plain_fn, warmup, half)
    k1 = time_ms(torch, kernel_fn, warmup, half)
    k2 = time_ms(torch, kernel_fn, warmup, half)
    p2 = time_ms(torch, plain_fn, warmup, half)
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
    from raytracetorch_tpu_torch.core.sensor import bin_indices
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace, grid

    def reset_counters():
        fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
        fused_nonseq.NONSEQ_LAUNCHES = 0
        grid.GRID_LAUNCHES = grid.GATHER_LAUNCHES = 0

    def counters():
        return dict(trace_seq_fwd=fused_trace.LAUNCHES,
                    trace_seq_bwd=fused_trace.BWD_LAUNCHES,
                    trace_nonseq_fwd=fused_nonseq.NONSEQ_LAUNCHES,
                    grid_bin=grid.GRID_LAUNCHES,
                    grid_gather=grid.GATHER_LAUNCHES)

    dev = torch.device('cuda')
    card = nvidia_smi_line()
    device_name = torch.cuda.get_device_name(0)

    # 1. device
    emit('device', name=device_name, nvidia_smi=card,
         count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version(),
         tf32=[torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32])

    # 2. build: the four libraries, one nvcc each, started together
    t0 = time.perf_counter()
    logs = fused_trace.build()
    emit('build', seconds=time.perf_counter() - t0,
         nvcc_seconds={k: v[1] for k, v in logs.items()},
         ptxas={k: [ln.strip() for ln in v[0].splitlines()
                    if 'registers' in ln or 'spill' in ln]
                for k, v in logs.items()})

    # 3. K1 vs plain on the card
    scene = bench_scene(rt)
    meta, cfg = scene.static_meta(), scene.sensor_config()
    params = scene.init_params(dev)
    flat = rt.flatten_table_rows(scene.build_table(params))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                         dtype=torch.int32, device=dev)
    table2, meta2, cfg2 = two_bundle_table(rt, torch, dev)
    flat2 = rt.flatten_table_rows(table2)
    kinds2 = torch.tensor(fused_trace.kind_rows(meta2, cfg2),
                          dtype=torch.int32, device=dev)
    cases = {}
    for n in (N_SMALL, N_MAIN):
        rays = sample_rays(rt, torch, n, dev, SEED + n)
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays,
                                                              cfg, meta)
        torch.cuda.synchronize()
        cases[f'bench_{n}'] = compare(torch, out_k, s_k, out_p, s_p)
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

    # 3b. K2 vs plain on the card, seeded random cotangents
    bwd_cases = {}
    for case, (fl, kd, me, cf, make) in {
            'bench': (flat, kinds, meta, cfg, sample_rays),
            'two_bundle': (flat2, kinds2, meta2, cfg2, two_bundle_rays),
    }.items():
        for n in (N_SMALL, N_MAIN):
            rays = make(rt, torch, n, dev, SEED + 11 + n)
            g_rays, g_mom = random_cotangents(torch, n, cf, dev, SEED + n)
            gt_k, gr_k = fused_trace.trace_seq_bwd_cuda(fl, kd, rays, cf,
                                                        g_rays, g_mom)
            gt_p, gr_p = fused_trace.trace_seq_bwd_plain(fl, rays, cf, me,
                                                         g_rays, g_mom)
            torch.cuda.synchronize()
            res = compare_ray_cotangents(torch, gr_k, gr_p)
            res.update(compare_table_cotangents(torch, fused_trace, gt_k,
                                                gt_p))
            check(res['rows_with_grad'] >= (4 if case == 'two_bundle'
                                            else 2),
                  f'{case}: too few rows with a table cotangent: {res}')
            bwd_cases[f'{case}_{n}'] = res
    emit('kernel_vs_plain_bwd', **bwd_cases)

    # 3c. K3 alone vs plain: 1M hits on two slots, some outside +-e
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    gcfg = rt.SensorConfig(n_sensors=2, grid_shape=GRID,
                           grid_half_extent=GRID_E)
    hx = torch.randn(N_MAIN, generator=gen, device=dev) * 0.6
    hy = torch.randn(N_MAIN, generator=gen, device=dev) * 0.6
    hslot = torch.randint(0, 2, (N_MAIN,), generator=gen, device=dev,
                          dtype=torch.int32)
    ones = torch.ones(N_MAIN, device=dev)
    hw = torch.rand(N_MAIN, generator=gen, device=dev)
    g_unit_k = grid.bin_grid_cuda(hx, hy, ones, hslot, gcfg)
    g_unit_p = grid.bin_grid_slots_plain(hx, hy, ones, hslot, gcfg)
    g_rand_k = grid.bin_grid_cuda(hx, hy, hw, hslot, gcfg)
    g_rand_p = grid.bin_grid_slots_plain(hx, hy, hw, hslot, gcfg)
    ct = torch.randn(2, *GRID, generator=gen, device=dev)
    gather_k = grid.grid_gather_cuda(ct, hx, hy, hslot, gcfg)
    ix, iy = bin_indices(GRID, GRID_E, hx, hy)
    gather_p = ct[hslot.long(), iy, ix]
    torch.cuda.synchronize()
    rand_err = float((g_rand_k - g_rand_p).abs().max())
    rand_scale = float(g_rand_p.abs().max())
    grid_res = dict(
        n=N_MAIN, outside=int(((hx.abs() > GRID_E)
                               | (hy.abs() > GRID_E)).sum()),
        unit_equal=bool(torch.equal(g_unit_k, g_unit_p)),
        unit_total=float(g_unit_k.sum()), rand_max_abs_err=rand_err,
        rand_err_over_max_bin=rand_err / rand_scale,
        gather_equal=bool(torch.equal(gather_k, gather_p)))
    emit('grid_bin', **grid_res)
    check(grid_res['unit_equal'] and grid_res['unit_total'] == N_MAIN,
          'K3 with unit weights differs from its plain version')
    check(rand_err <= GRID_RAND_RTOL * rand_scale,
          f'K3 with random weights: {rand_err} of {rand_scale}')
    check(grid_res['gather_equal'], "K3's gather differs from ct[s, iy, ix]")
    check(grid_res['outside'] > 0, 'no hit outside the grid')

    # 3d. K1 with the 256 x 256 grid vs plain; and nothing else changes
    gscene = grid_scene(rt)
    gcfg1 = gscene.sensor_config()
    fwd_grid = {}
    for n in (N_SMALL, N_MAIN):
        rays = sample_rays(rt, torch, n, dev, SEED + n)
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, gcfg1)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays,
                                                              gcfg1, meta)
        out_0, s_0 = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
        torch.cuda.synchronize()
        res = compare(torch, out_k, s_k, out_p, s_p)
        res.update(compare_grid(torch, s_k.grid, s_p.grid, GRID_TOTAL_RTOL))
        res['same_as_without_grid'] = bool(
            torch.equal(out_k.px, out_0.px) and torch.equal(out_k.dz, out_0.dz)
            and torch.equal(s_k.moments, s_0.moments))
        check(res['same_as_without_grid'],
              'K1 with a grid changed its rays or moments')
        fwd_grid[f'bench_{n}'] = res
    emit('fwd_grid', **fwd_grid)

    # 3e. K2 with the grid's cotangent: d/d(rays, table) of
    # sum(grid * W) + spot_rms, K2 vs plain, then through FusedTrace
    bwd_grid = {}
    w_grid = torch.randn(1, *GRID, generator=torch.Generator(
        device=dev).manual_seed(SEED + 31), device=dev)
    for n in (N_SMALL, N_MAIN):
        rays = sample_rays(rt, torch, n, dev, SEED + 11 + n)
        _, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, gcfg1,
                                                          meta)
        mom = s_p.moments.detach().requires_grad_(True)
        (g_mom,) = torch.autograd.grad(
            rt.SensorState(moments=mom, grid=s_p.grid).spot_rms(0)[0], mom)
        gt_k, gr_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, gcfg1, (None,) * 7, g_mom, g_grid=w_grid)
        gt_p, gr_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, gcfg1, meta, (None,) * 7, g_mom, g_grid=w_grid)
        torch.cuda.synchronize()
        res = compare_ray_cotangents(torch, gr_k, gr_p,
                                     intensity_allowed=math.ceil(
                                         GRID_SHARE * n))
        res.update(compare_table_cotangents(torch, fused_trace, gt_k, gt_p))
        res['intensity_cotangent_norm'] = float(gr_k[6].norm())
        check(res['intensity_cotangent_norm'] > 0, 'no grid cotangent')
        bwd_grid[f'bench_{n}'] = res

    def grid_loss_grads(simulate):
        p = gscene.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        r = rays.replace(intensity=rays.intensity.clone().requires_grad_(True))
        _, s, _ = simulate(p, r)
        loss = (s.grid * w_grid).sum() + s.spot_rms(0)[0]
        loss.backward()
        return [float(p['lens'][k].grad) for k in ('c1', 'c2')], \
            r.intensity.grad

    reset_counters()
    g_fused, gi_fused = grid_loss_grads(gscene.simulate_fused)
    torch.cuda.synchronize()
    bwd_grid_launches = counters()
    g_eager, gi_eager = grid_loss_grads(gscene.simulate)
    zeros = torch.zeros_like(gi_fused)
    res = compare_ray_cotangents(
        torch, (zeros,) * 6 + (gi_fused,), (zeros,) * 6 + (gi_eager,),
        intensity_allowed=math.ceil(GRID_SHARE * N_MAIN))
    rel = [abs(a - b) / abs(b) for a, b in zip(g_fused, g_eager)]
    bwd_grid['fused_trace'] = dict(launches=bwd_grid_launches,
                                   grad_fused=g_fused, grad_eager=g_eager,
                                   rel_err=rel, intensity_grads=res)
    emit('bwd_grid', **bwd_grid)
    check(bwd_grid_launches['trace_seq_fwd'] == 1
          and bwd_grid_launches['trace_seq_bwd'] == 1,
          f'the grid loss launched {bwd_grid_launches}')
    check(max(rel) < GRAD_RTOL, f'fused vs eager gradients differ: {rel}')

    # 3f. K5 vs plain on the naive scene and the mirror fold
    ns_cases = {}
    for case, (make_scene, make_rays) in {
            'naive': (naive_scene, sample_rays),
            'mirror_fold': (mirror_fold_scene, mirror_fold_rays)}.items():
        nsc = make_scene(rt)
        ncfg, nmeta = nsc.sensor_config(), nsc.static_meta()
        nflat = rt.flatten_table_rows(nsc.build_table(nsc.init_params(dev)))
        nkinds = torch.tensor(fused_trace.kind_rows(nmeta, ncfg),
                              dtype=torch.int32, device=dev)
        for n in (N_SMALL, N_MAIN):
            rays = make_rays(rt, torch, n, dev, SEED + 41 + n)
            out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
                nflat, nkinds, rays, ncfg, nsc.n_bounces)
            out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
                nflat, rays, ncfg, nmeta, nsc.n_bounces)
            torch.cuda.synchronize()
            res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
            res['sensor_weight'] = float(s_k.moments[0, 0, 0])
            check(res['grid_total'] > 0.5 * n, f'{case}: few sensor hits')
            ns_cases[f'{case}_{n}'] = res
    emit('nonseq_fwd', **ns_cases)

    # 4. forward main path, counted
    scene = bench_scene(rt)
    params = scene.init_params(dev)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED)
    torch.cuda.synchronize()
    fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
    out, sens, _ = scene.simulate_fused(params, rays)
    torch.cuda.synchronize()
    launches = fused_trace.LAUNCHES
    bwd_launches_fwd = fused_trace.BWD_LAUNCHES
    rms = float(sens.spot_rms(0)[0])
    cen = sens.centroid(0)[0].tolist()
    f = float(-1.0 / scene.paraxial(params)[1, 0])
    finite = all(bool(torch.isfinite(getattr(out, c)).all())
                 for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'))
    emit('main_path', launches=launches, bwd_launches=bwd_launches_fwd,
         n=N_MAIN, spot_rms=rms, centroid=cen, focal_length=f,
         finite=finite, shape=list(out.pos.shape),
         hits=float(sens.moments[0, 0, 6]))
    check(launches == 1 and bwd_launches_fwd == 0,
          'simulate_fused did not launch K1 alone')
    check(finite and list(out.pos.shape) == [N_MAIN, 3], 'bad ray output')
    check(abs(rms - SPOT_RMS_REF) < SPOT_RMS_TOL, f'spot_rms {rms}')
    check(max(abs(c) for c in cen) < 1e-3, f'centroid {cen}')
    check(abs(f - FOCAL_REF) < FOCAL_TOL, f'focal length {f}')

    # 4b. gradient main path, counted: simulate_fused -> spot_size_loss ->
    # backward with c1, c2 requiring grad; then the same on eager simulate
    def lens_grads(simulate):
        p = scene.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        _, s, _ = simulate(p, rays)
        loss = rt.spot_size_loss(s)
        loss.backward()
        return ([float(p['lens'][k].grad) for k in ('c1', 'c2')],
                float(loss.detach()))

    torch.cuda.synchronize()
    fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
    g_fused, loss_fused = lens_grads(scene.simulate_fused)
    torch.cuda.synchronize()
    grad_launches = (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES)
    g_eager, loss_eager = lens_grads(scene.simulate)
    rel = [abs(a - b) / abs(b) for a, b in zip(g_fused, g_eager)]

    # the ray-gradient repair: a loss on output rays and moments, with
    # rays.px and rays.dx requiring grad
    def ray_grads(simulate):
        r = rays.replace(px=rays.px.clone().requires_grad_(True),
                         dx=rays.dx.clone().requires_grad_(True))
        o, s, _ = simulate(scene.init_params(dev), r)
        loss = (o.pz.mean() + o.px.square().mean()
                + rt.spot_size_loss(s))
        loss.backward()
        return r.px.grad, r.dx.grad

    rg_fused, rg_eager = ray_grads(scene.simulate_fused), \
        ray_grads(scene.simulate)
    torch.cuda.synchronize()
    zeros = torch.zeros_like(rays.px)
    ray_res = compare_ray_cotangents(
        torch, (rg_fused[0], zeros, zeros, rg_fused[1], zeros, zeros, zeros),
        (rg_eager[0], zeros, zeros, rg_eager[1], zeros, zeros, zeros))
    emit('main_path_grad', n=N_MAIN, k1_launches=grad_launches[0],
         k2_launches=grad_launches[1], grad_fused=g_fused,
         grad_eager=g_eager, rel_err=rel, loss_fused=loss_fused,
         loss_eager=loss_eager, ray_grads=ray_res,
         ray_grad_norm=[float(g.norm()) for g in rg_fused])
    check(grad_launches == (1, 1),
          f'the grad step launched K1, K2 {grad_launches} times, not once')
    check(all(math.isfinite(g) for g in g_fused), 'non-finite grad')
    check(max(rel) < GRAD_RTOL, f'fused vs eager gradients differ: {rel}')
    check(all(float(g.abs().max()) > 0 for g in rg_fused),
          'no ray gradient through simulate_fused')

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

    # 5b. the design loop, counted: L-BFGS through simulate_fused at 1M rays
    dscene = design_scene(rt)
    dparams = dscene.init_params(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drays = rt.CollimatedDisk.make(radius=5.0,
                                   translation=[0.0, 0.0, -10.0]).sample(
        gen, N_MAIN, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
    p_opt, losses = rt.fit_lbfgs(design_loss(torch, dscene, drays), dparams,
                                 trainable=dscene.trainable(),
                                 steps=DESIGN_STEPS)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    design_launches = (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES)
    # the first fit in a process pays a one-time cost: time a second run
    t0 = time.perf_counter()
    rt.fit_lbfgs(design_loss(torch, dscene, drays), dparams,
                 trainable=dscene.trainable(), steps=DESIGN_STEPS)
    torch.cuda.synchronize()
    design_warm_s = time.perf_counter() - t0
    lens = p_opt['lens']
    ratio = float(lens['c1']) / float(lens['c2'])
    f_opt = float(dscene.elements[0].f(lens))
    l0, lf = float(losses[0]), float(losses[-1])
    emit('design_loop', n=N_MAIN, steps=DESIGN_STEPS,
         k1_launches=design_launches[0], k2_launches=design_launches[1],
         seconds_first=design_s, seconds_warm=design_warm_s,
         loss_start=l0, loss_end=lf,
         c1=float(lens['c1']), c2=float(lens['c2']), c1_over_c2=ratio,
         focal_length=f_opt, t=float(lens['t']),
         ior_glass=float(lens['ior_glass']))
    check(design_launches[1] > 0, 'the design loop did not launch K2')
    check(lf < 0.02 * l0, f'L-BFGS did not converge: {l0} -> {lf}')
    check(-7.5 < ratio < -4.5, f'c1/c2 {ratio}')
    check(95.0 < f_opt < 106.0, f'focal length {f_opt}')
    check(torch.equal(lens['t'], dparams['lens']['t'])
          and torch.equal(lens['ior_glass'], dparams['lens']['ior_glass']),
          'a non-trainable leaf moved')

    # 5c. the non-sequential main path, counted: Scene.simulate_fused at
    # 1M rays, 8 bounces, 256 x 256 grid
    nscene = naive_scene(rt)
    nparams = nscene.init_params(dev)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED)
    torch.cuda.synchronize()
    reset_counters()
    n_out, n_sens, _ = nscene.simulate_fused(nparams, rays)
    torch.cuda.synchronize()
    ns_launches = counters()
    n_rms = float(n_sens.spot_rms(0)[0])
    n_finite = all(bool(torch.isfinite(getattr(n_out, c)).all())
                   for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'))
    # the ordered variant against the sequential trace of the same elements
    oscene = naive_scene(rt, stop_z=10.0)
    oparams = oscene.init_params(dev)
    _, o_sens, _ = oscene.simulate_fused(oparams, rays)
    _, q_sens, _ = oscene.to_sequential(oparams).simulate_fused(oparams,
                                                                 rays)
    o_rms, q_rms = float(o_sens.spot_rms(0)[0]), float(q_sens.spot_rms(0)[0])
    # a budget of 100 bounces gives the same result as 8
    b_out, b_sens, _ = naive_scene(rt, n_bounces=100).simulate_fused(
        nparams, rays)
    same_100 = (all(torch.equal(getattr(b_out, c), getattr(n_out, c))
                    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz',
                              'intensity'))
                and torch.equal(b_sens.moments, n_sens.moments)
                and torch.equal(b_sens.grid, n_sens.grid))
    fscene = mirror_fold_scene(rt)
    f_out, f_sens, _ = fscene.simulate_fused(
        fscene.init_params(dev), mirror_fold_rays(rt, torch, N_MAIN, dev,
                                                  SEED))
    fold_dz, fold_rms = float(f_out.dz.mean()), float(f_sens.spot_rms(0)[0])
    ns_main = dict(
        n=N_MAIN, bounces=nscene.n_bounces, launches=ns_launches,
        spot_rms=n_rms, centroid=n_sens.centroid(0)[0].tolist(),
        finite=n_finite, shape=list(n_out.pos.shape),
        grid_total=float(n_sens.grid.sum()),
        sensor_weight=float(n_sens.moments[0, 0, 0]),
        ordered_spot_rms=o_rms, sequential_spot_rms=q_rms,
        budget_100_equal=same_100, fold_mean_dz=fold_dz,
        fold_spot_rms=fold_rms)
    emit('nonseq_main', **ns_main)
    check(ns_launches['trace_nonseq_fwd'] == 1
          and sum(ns_launches.values()) == 1,
          f'Scene.simulate_fused launched {ns_launches}, not K5 once')
    check(n_finite and ns_main['shape'] == [N_MAIN, 3], 'bad ray output')
    check(abs(n_rms - SPOT_RMS_REF) < SPOT_RMS_TOL, f'spot_rms {n_rms}')
    check(ns_main['grid_total'] == ns_main['sensor_weight'],
          'grid total and sensor weight differ')
    check(abs(o_rms - q_rms) <= NS_SPOT_RTOL * q_rms,
          f'ordered scene: non-sequential {o_rms} vs sequential {q_rms}')
    check(same_100, 'a budget of 100 bounces changed the result')
    check(fold_dz < 0.0 and 1.0 < fold_rms < 2.0,
          f'mirror fold: mean dz {fold_dz}, spot rms {fold_rms}')

    # 5d. the same scene through the eager bounce loop, counted: its grid
    # binning launches K3 once per bounce
    torch.cuda.synchronize()
    reset_counters()
    e_out, e_sens, _ = nscene.simulate(nparams, rays)
    torch.cuda.synchronize()
    eager_launches = counters()
    res = compare_nonseq(torch, e_out, e_sens, n_out, n_sens)
    emit('nonseq_eager', launches=eager_launches,
         spot_rms=float(e_sens.spot_rms(0)[0]), vs_fused=res)
    check(eager_launches['grid_bin'] >= 1
          and eager_launches['trace_nonseq_fwd'] == 0,
          f'Scene.simulate launched {eager_launches}')

    # 6. timing
    timing = {'card': card}
    g_mom1 = torch.randn(1, 1, 7, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    no_rays = (None,) * 7
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
    # K2 vs the plain backward, with the moment cotangent of a spot loss;
    # the plain backward keeps the whole eager graph, which may not fit at
    # 16M rays: then the largest N of 8M, 4M, 2M that fits is timed too
    bwd_n, n = [N_MAIN, N_LARGE], N_LARGE
    while bwd_n:
        n = bwd_n.pop(0)
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        try:
            k_ms, p_ms, k_runs, p_runs = time_pair(
                torch,
                lambda: fused_trace.trace_seq_bwd_cuda(
                    flat, kinds, rays, cfg, no_rays, g_mom1),
                lambda: fused_trace.trace_seq_bwd_plain(
                    flat, rays, cfg, meta, no_rays, g_mom1))
        except torch.cuda.OutOfMemoryError:
            timing[f'bwd_n{n}'] = dict(plain_out_of_memory=True)
            torch.cuda.empty_cache()
            if n > 2_000_000:
                bwd_n.append(n // 2)
            continue
        timing[f'bwd_n{n}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                   kernel_runs=k_runs, plain_runs=p_runs)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 2)
    p_grad = scene.init_params(dev)
    for k in ('c1', 'c2'):
        p_grad['lens'][k].requires_grad_(True)

    def grad_step(simulate):
        def step():
            _, s, _ = simulate(p_grad, rays)
            rt.spot_size_loss(s).backward()
        return step

    e2e = {
        'simulate_fused_ms': time_ms(
            torch, lambda: scene.simulate_fused(params, rays)),
        'simulate_eager_ms': time_ms(
            torch, lambda: scene.simulate(params, rays)),
        'grad_step_eager_ms': time_ms(torch, grad_step(scene.simulate)),
        'grad_step_fused_ms': time_ms(torch,
                                      grad_step(scene.simulate_fused)),
    }
    for key, runs in e2e.items():
        timing[key] = statistics.median(runs)
        timing[key + '_runs'] = runs
    timing['trace_rays_per_s_fused'] = N_MAIN / (
        timing['simulate_fused_ms'] * 1e-3)

    # K1 with and without the grid, in turns
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 1)
    g_ms, ng_ms, g_runs, ng_runs = time_pair(
        torch,
        lambda: fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, gcfg1),
        lambda: fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg))
    timing['k1_grid'] = dict(with_grid_ms=g_ms, without_grid_ms=ng_ms,
                             with_grid_runs=g_runs, without_grid_runs=ng_runs)
    # K5 against its plain version, naive scene, 8 bounces, 256 x 256 grid
    ncfg, nmeta = nscene.sensor_config(), nscene.static_meta()
    nflat = rt.flatten_table_rows(nscene.build_table(nparams))
    nkinds = torch.tensor(fused_trace.kind_rows(nmeta, ncfg),
                          dtype=torch.int32, device=dev)
    # (the plain loop takes ~8 s at 16M rays: 4 timed calls, 1 warm-up)
    for n, reps, warm in ((N_MAIN, 20, 3), (N_LARGE, 4, 1)):
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        k_ms, p_ms, k_runs, p_runs = time_pair(
            torch,
            lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                nflat, nkinds, rays, ncfg, NS_BOUNCES),
            lambda: fused_nonseq.trace_nonseq_fused_plain(
                nflat, rays, ncfg, nmeta, NS_BOUNCES), reps=reps,
            warmup=warm)
        timing[f'nonseq_n{n}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                      kernel_runs=k_runs, plain_runs=p_runs)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 2)
    ns_e2e = {
        'scene_simulate_fused_ms': time_ms(
            torch, lambda: nscene.simulate_fused(nparams, rays)),
        'scene_simulate_eager_ms': time_ms(
            torch, lambda: nscene.simulate(nparams, rays)),
    }
    for key, runs in ns_e2e.items():
        timing[key] = statistics.median(runs)
        timing[key + '_runs'] = runs
    # K3 alone on the bench spot (the sensor hits of 1M rays, unit weights,
    # one slot): the kernel, its plain version and one index_put_ call
    out_s, _ = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    spot_x, spot_y = out_s.px, out_s.py
    spot_w = torch.ones_like(spot_x)
    g_k = grid.bin_grid_cuda(spot_x, spot_y, spot_w, 0, gcfg1)
    ix, iy = bin_indices(GRID, GRID_E, spot_x, spot_y)
    flat_idx = iy * GRID[1] + ix
    g_lib = torch.zeros(GRID[0] * GRID[1], device=dev)
    k3_ms, k3_plain_ms, k3_runs, k3_plain_runs = time_pair(
        torch, lambda: grid.bin_grid_cuda(spot_x, spot_y, spot_w, 0, gcfg1),
        lambda: grid.bin_grid_slots_plain(spot_x, spot_y, spot_w, 0, gcfg1))
    lib_runs = time_ms(torch, lambda: g_lib.index_put_(
        (flat_idx,), spot_w, accumulate=True))
    timing['grid_bin_spot'] = dict(
        kernel_ms=k3_ms, plain_ms=k3_plain_ms, library_ms=statistics.median(
            lib_runs), kernel_runs=k3_runs, plain_runs=k3_plain_runs,
        library_runs=lib_runs, cells_hit=int((g_k > 0).sum()),
        hits=float(g_k.sum()))
    timing['grid_bin_random'] = dict(zip(
        ('kernel_ms', 'plain_ms'), time_pair(
            torch, lambda: grid.bin_grid_cuda(hx, hy, hw, hslot, gcfg),
            lambda: grid.bin_grid_slots_plain(hx, hy, hw, hslot, gcfg))[:2]))
    emit('timing', **timing)

    # the bound of each kernel's work at 1M rays on this card
    n = N_MAIN
    k1_ops = n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
    k1_bytes = n * (32 + 28) + table_bytes(meta)
    scans, wins = nonseq_work(rt, torch, nscene, nparams,
                              sample_rays(rt, torch, n, dev, SEED + 1))
    k5_ops = (scans * sum(intersect_ops(m) for m in nmeta)
              + sum(w * apply_ops(m) for w, m in zip(wins, nmeta)))
    bounds = {
        # K2: 8 input streams, the moment cotangent, 7 ray cotangents out,
        # the table cotangent; a forward sweep and an adjoint of about
        # twice its size: 3x K1's operations (csrc/trace_seq_bwd.cu)
        'trace_seq_bwd': bound(n * (32 + 28) + table_bytes(meta),
                               3 * k1_ops),
        'trace_seq_fwd': bound(k1_bytes, k1_ops),
        # K3: x, y, w of every hit in, the grid out; ~13 operations per
        # hit (bin, clip, address, the atomic add)
        'grid_bin': bound(n * 12 + grid_bytes(gcfg1), n * 13),
        'trace_nonseq_fwd': bound(n * (32 + 28) + table_bytes(nmeta)
                                  + grid_bytes(ncfg), k5_ops),
    }
    emit('bounds', n=n, k1_ops=k1_ops, k5_row_scans=scans,
         k5_winners_per_row=wins, k5_ops=k5_ops,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})

    bwd_main = bwd_cases[f'bench_{N_MAIN}']

    def entry(name, source, line, launches_, err, ms, plain_ms,
              library_ms=None):
        return {'name': name, 'route': 'cuda',
                'source': f'raytracetorch_tpu_torch/csrc/{source}',
                'replaces': f'raytracetorch_tpu/ops/pallas_trace.py:{line}',
                'launches': launches_, 'max_abs_err': err, 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': bounds[name][0],
                'bound_by': bounds[name][1], 'library_ms': library_ms}

    summary = {'kernels': [
        entry('trace_seq_fwd', 'trace_seq_fwd.cu', 489, launches,
              cases[f'bench_{N_MAIN}']['max_abs_err'],
              timing[f'n{N_MAIN}']['kernel_ms'],
              timing[f'n{N_MAIN}']['plain_ms']),
        entry('trace_seq_bwd', 'trace_seq_bwd.cu', 1712, grad_launches[1],
              bwd_main['max_abs_err'], timing[f'bwd_n{N_MAIN}']['kernel_ms'],
              timing[f'bwd_n{N_MAIN}']['plain_ms']),
        entry('grid_bin', 'grid_bin.cu', 331, eager_launches['grid_bin'],
              rand_err, timing['grid_bin_spot']['kernel_ms'],
              timing['grid_bin_spot']['plain_ms'],
              timing['grid_bin_spot']['library_ms']),
        entry('trace_nonseq_fwd', 'trace_nonseq_fwd.cu', 1029,
              ns_launches['trace_nonseq_fwd'],
              ns_cases[f'naive_{N_MAIN}']['max_abs_err'],
              timing[f'nonseq_n{N_MAIN}']['kernel_ms'],
              timing[f'nonseq_n{N_MAIN}']['plain_ms']),
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
