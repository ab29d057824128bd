#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the five CUDA libraries from the sources in the checkout (K1, the
fused sequential forward; K2, its hand-written adjoint; K3, irradiance-grid
binning; K5, the fused non-sequential bounce loop; K6, its hand-written
adjoint; one nvcc each, started together) and checks each kernel against
its plain PyTorch version, K1 and K2 also with a 256 x 256 grid, K6 on the
naive scene, the mirror fold and a 25-bounce two-mirror cavity, and K6's
forward replay against K5 bit for bit.  Then it drives seven paths, each
with every launch counter reset just before it and read just after: the
forward main path (the 1M-ray singlet scene through
``SequentialScene.simulate_fused``), the gradient main path (the same call
under grad, then ``spot_size_loss`` and ``backward()``), the design loop
(the reference's singlet design by ``fit_lbfgs`` through ``simulate_fused``
at 1M rays), the non-sequential main path (the singlet traced as a
``Scene`` with a 256 x 256 grid through ``Scene.simulate_fused``), the same
scene through the eager ``Scene.simulate``, whose grid binning launches K3,
the non-sequential gradient path (``Scene.simulate_fused`` under grad, a
spot and grid loss, ``backward()``: K5 then K6), and the non-sequential
design loop (the reference's singlet as a ``Scene``, ``fit_lbfgs`` through
``Scene.simulate_fused``).  It checks each against the repo's anchors and
against the eager paths, and times the kernels, their plain versions, a
library call where one computes the same function, and the end-to-end
calls with CUDA events.

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
# K6 vs its plain version (autograd of the eager bounce loop), each ray's
# cotangents under K2's BWD_TOL rule, at most max(3, NS_MISMATCH_SHARE * N)
# rays outside it (rim flips, as K5's), GRID_SHARE * N in the intensity
# cotangent alone with a grid; the table under TAB_RTOL.  Both are compared
# on the rays whose forward K5 and the plain loop trace alike: on the naive
# scene and the mirror fold all but max(3, NS_MISMATCH_SHARE * N) of them.
# The two-mirror cavity is rounding-chaotic (a reflection near a mirror's
# vertex leaves the self-intersection root at ~6e-6 after the quadratic
# formula's cancellation, about the world-scale epsilon, so another rounding
# re-hits the mirror): about a third of its rays end elsewhere under another
# rounding (tests/test_torch_nonseq_grad.py), so there the count of such
# rays is reported, not bounded.
# K6's checkpointed bounces per thread (kCkpt in csrc/trace_nonseq_bwd.cu).
K6_CHECKPOINTS = 8
# Deep optics: the ring former of examples/28_deep_optics_plate.py, a
# PhaseGridPlate (half extents 4) and a sensor (radius 10) at z = 40, lit by
# a collimated disk of radius 3 at z = -3, lam 0.5876 um; every ray should
# land on the circle of radius 2.  The 1M-ray paths use a 256 x 256 map (the
# largest the TPU kernels take) holding the example's closed form, an axicon
# plus a focusing term: dphi/dr = (R - r) / (L lam_mm) cycles per mm.  The
# design loop is the example as published: a 32 x 32 map from zero, its
# 30,000 rays (the reference's draws with key 0, rays/reference_prng.py),
# Adam for 800 steps at lr 1.5; its anchors are the residual RMS and the
# learned radial slope alpha + beta r against R / (L lam_mm) and
# -1 / (L lam_mm).
DO_HX, DO_L, DO_RING, DO_LAM = 4.0, 40.0, 2.0, 0.5876
DO_MAP, DO_SMALL_MAP = (256, 256), (32, 32)
DO_BOUNCES = 3
DO_DESIGN_RAYS, DO_DESIGN_STEPS, DO_DESIGN_LR = 30_000, 800, 1.5
DO_RMS_MAX = 0.12
DO_SLOPE_RTOL = 0.15
# K4 alone: its gather bit for bit; its scatter, and every map cotangent of
# K2 or K6 against its plain version, each cell within GRID_RAND_RTOL of the
# largest |cell| (float atomics add in a run-dependent order).  Fused vs
# eager map gradients on the card: each cell within GRAD_RTOL of the largest.
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
    """Seeded cotangents of the 7 ray streams, the moments and, with a
    grid, the grid (else None) -> (g_rays, g_mom, g_grid)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g_rays = tuple(torch.randn(n, generator=gen, device=device)
                   for _ in range(7))
    g_mom = torch.randn(max(cfg.n_sensors, 1), cfg.n_bundles, 7,
                        generator=gen, device=device)
    g_grid = (torch.randn(max(cfg.n_sensors, 1), *cfg.grid_shape,
                          generator=gen, device=device)
              if cfg.grid_shape else None)
    return g_rays, g_mom, g_grid


def compare_ray_cotangents(torch, g_k, g_p, intensity_allowed=0,
                           allowed=None):
    """Per-ray cotangents, kernel vs plain (7 streams px..intensity) ->
    dict; raises on a breach.  ``allowed`` rays may differ (default
    BWD_FLIPS_PER_MILLION), ``intensity_allowed`` in the intensity
    cotangent alone (a grid cotangent read from a neighbour bin).  Per group
    (position, direction, intensity) it reports the scale (the largest
    |plain|), the median |plain|, and the worst error over the scale on all
    rays and on the rays inside the bound."""
    groups = ((0, 1, 2), (3, 4, 5), (6,))
    n = g_p[0].shape[0]
    bad = [torch.zeros(n, dtype=torch.bool, device=g_p[0].device)
           for _ in groups]
    errs, scales = [], []
    for grp, bad_g in zip(groups, bad):
        scale = max(float(g_p[j].abs().max()) if n else 0.0 for j in grp)
        scales.append(scale)
        for j in grp:
            err = (g_k[j] - g_p[j]).abs()
            errs.append(err)
            bound = BWD_TOL * (g_p[j].abs() + scale)
            bad_g |= (err > bound) | ~torch.isfinite(g_k[j])
    any_bad = bad[0] | bad[1] | bad[2]
    n_bad = int(any_bad.sum())
    if allowed is None:
        allowed = math.ceil(BWD_FLIPS_PER_MILLION * n / 1e6)
    groups_res = {}
    for name, grp, scale in zip(('position', 'direction', 'intensity'),
                                groups, scales):
        err = max((float(errs[j].max()) if n else 0.0) for j in grp)
        err_in = max((float(errs[j][~any_bad].max()) if n > n_bad else 0.0)
                     for j in grp)
        groups_res[name] = dict(
            scale=scale,
            median_abs=(float(torch.cat([g_p[j] for j in grp]).abs()
                              .median()) if n else 0.0),
            max_err_over_scale=err / max(scale, 1e-30),
            max_err_in_bound_over_scale=err_in / max(scale, 1e-30))
    res = dict(n=n, rays_differ=n_bad, allowed=allowed,
               max_abs_err=max((float(e.max()) if n else 0.0) for e in errs),
               max_err_over_scale=max(g['max_err_over_scale']
                                      for g in groups_res.values()),
               groups=groups_res)
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


def compare_table_cotangents(torch, fused_trace, g_k, g_p, plates=False):
    """Table cotangent [K, 160], kernel vs plain -> dict; raises on a
    breach.  Outside GRAD_COLS (PLATE_GRAD_COLS with phase plates) both must
    be exactly zero."""
    offs = list(fused_trace.PLATE_GRAD_COLS if plates
                else fused_trace.GRAD_COLS)
    fields = (offs[0:5], offs[5:14], offs[14:17], offs[17:19]) + (
        (offs[19:23],) if plates else ())
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


def cavity_scene(rt):
    """Two facing spherical mirrors 40 apart and an off-axis sensor between
    them, 25 bounces, no grid (tests/test_pallas.py::
    test_nonseq_bwd_scan_large_budget): rays live beyond K6's 8 checkpoints.
    Rays: ``mirror_fold_rays``."""
    return rt.Scene([
        rt.SphericalMirror(c1=-0.02, d=0.0, translation=[0.0, 0.0, 40.0],
                           c1_grad=True, name='m1'),
        rt.SphericalMirror(c1=0.02, d=0.0, translation=[0.0, 0.0, 0.0],
                           rotation=[0.0, math.pi, 0.0], name='m2'),
        rt.SensorElement(radius=3.0, translation=[6.0, 0.0, 20.0],
                         name='sensor'),
    ], n_bounces=25)


def compare_k6(rt, torch, scene, rays, seed, chaotic=False):
    """K6 vs its plain version on ``scene`` with seeded cotangents of the
    rays, the moments and the grid, on the rays whose forward K5 and the
    plain loop trace alike -> dict; raises on a breach (module notes: K6).
    ``chaotic``: report, do not bound, the rays that trace apart."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    cfg, meta, nb = scene.sensor_config(), scene.static_meta(), \
        scene.n_bounces
    dev = rays.px.device
    flat = rt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    out_k, _ = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, nb)
    out_p, _ = fused_nonseq.trace_nonseq_fused_plain(flat, rays, cfg, meta,
                                                     nb)
    dpos = torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                        for c in ('px', 'py', 'pz')]).amax(0)
    same = ((dpos <= NS_POS_TOL)
            & ((out_k.intensity - out_p.intensity).abs() <= NS_INT_TOL))
    n, n_sub = rays.n, int(same.sum())
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * n))
    if not chaotic:
        check(n - n_sub <= allowed,
              f'{n - n_sub} rays trace apart in K5 and plain')
    sub = rt.Rays(**{f: getattr(rays, f)[same].contiguous()
                     for f in rays.__dataclass_fields__})
    g_rays, g_mom, g_grid = random_cotangents(torch, n_sub, cfg, dev, seed)
    gt_k, gr_k = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, sub, cfg, nb, g_rays, g_mom, g_grid=g_grid)
    gt_p, gr_p = fused_nonseq.trace_nonseq_bwd_plain(
        flat, sub, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid)
    torch.cuda.synchronize()
    res = dict(forward_differ=n - n_sub)
    res.update(compare_ray_cotangents(
        torch, gr_k, gr_p, allowed=allowed,
        intensity_allowed=(math.ceil(GRID_SHARE * n_sub)
                           if cfg.grid_shape else 0)))
    res.update(compare_table_cotangents(torch, fused_trace, gt_k, gt_p))
    # the first row's curvature, q[0:3]: a mirror's c1 in the mirror scenes
    res['row0_curvature_cotangent'] = float(gt_k[0, :3].abs().sum())
    return res


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


def ring_map(shape, device):
    """The ring former's closed-form phase map (cycles) on an [H, W] grid
    over the plate: phi(r) = (R r - r^2 / 2) / (L lam_mm)."""
    import torch
    h, w = shape
    y = torch.linspace(-DO_HX, DO_HX, h, dtype=torch.float64, device=device)
    x = torch.linspace(-DO_HX, DO_HX, w, dtype=torch.float64, device=device)
    r = torch.sqrt(y[:, None] ** 2 + x[None, :] ** 2)
    return ((DO_RING * r - 0.5 * r * r) / (DO_L * DO_LAM * 1e-3)).float()


def ring_scene(rt, shape=DO_MAP, bounces=None, grid=False):
    """The ring former (examples/28_deep_optics_plate.py): a SequentialScene,
    or with ``bounces`` a Scene; ``grid`` adds a 256 x 256 irradiance grid
    over the sensor's [-4, 4]^2."""
    els = [rt.PhaseGridPlate(half_x=DO_HX, half_y=DO_HX, shape=shape,
                             name='plate'),
           rt.SensorElement(radius=10.0, translation=[0.0, 0.0, DO_L],
                            name='det')]
    scene = (rt.SequentialScene(els) if bounces is None
             else rt.Scene(els, n_bounces=bounces))
    if grid:
        scene.grid_shape, scene.grid_half_extent = GRID, DO_HX
    return scene


def ring_params(scene, device, grad=False):
    """The scene's params with the closed-form map (requiring grad if
    ``grad``: the map is then the only trainable leaf)."""
    p = scene.init_params(device)
    shape = tuple(p['plate']['grid'].shape)
    p['plate']['grid'] = ring_map(shape, device).requires_grad_(grad)
    return p


def ring_rays(rt, torch, n, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    src = rt.CollimatedDisk.make(radius=3.0, translation=[0.0, 0.0, -3.0],
                                 wavelength=DO_LAM)
    return src.sample(gen, n, device)


def rim_rays(rt, torch, n, device, seed):
    """Collimated rays over a disk of radius 5.5 at z = -3: on the ring
    former's plate (half extents 4) some cross beyond its far rims, where a
    map of 34 pixels and more clamps its corner reads, and some miss it."""
    gen = torch.Generator(device=device).manual_seed(seed)
    src = rt.CollimatedDisk.make(radius=5.5, translation=[0.0, 0.0, -3.0],
                                 wavelength=DO_LAM)
    return src.sample(gen, n, device)


def ring_loss(torch, out):
    """The example's loss: the intensity-weighted mean of (r - R)^2."""
    r = torch.sqrt(out.px ** 2 + out.py ** 2 + 1e-12)
    w = out.intensity
    return torch.sum(w * (r - DO_RING) ** 2) / torch.clamp(torch.sum(w),
                                                           min=1e-9)


def radial_slope(grid):
    """The example's check of a learned map: its radial slope dphi/dr fitted
    as alpha + beta r over the lit annulus 0.8 < r < 2.8 -> (alpha, beta,
    relative error of alpha against R k, of beta against -k), k = 1 /
    (L lam_mm)."""
    import numpy as np
    n = grid.shape[0]
    xs = np.linspace(-DO_HX, DO_HX, n)
    X, Y = np.meshgrid(xs, xs, indexing='xy')
    rr = np.sqrt(X ** 2 + Y ** 2)
    gy, gx = np.gradient(grid, xs, xs)
    dphidr = (gx * X + gy * Y) / np.maximum(rr, 1e-9)
    lit = (rr > 0.8) & (rr < 2.8)
    A = np.stack([np.ones(lit.sum()), rr[lit]], -1)
    (alpha, beta), *_ = np.linalg.lstsq(A, dphidr[lit], rcond=None)
    k = 1.0 / (DO_L * DO_LAM * 1e-3)
    return (float(alpha), float(beta),
            abs(alpha - DO_RING * k) / (DO_RING * k), abs(beta + k) / k)


def plate_cells(torch, rays, shape):
    """The cells (iv, iu) that K4 reads for rays crossing the plate at z = 0
    (core/physics.py::phase_grid_dir on the rays' own x, y)."""
    from raytracetorch_tpu_torch.core.physics import corner_clip
    h, w = shape
    u = ((rays.px + DO_HX) / (2 * DO_HX) * (w - 1)).clamp(0, corner_clip(w))
    v = ((rays.py + DO_HX) / (2 * DO_HX) * (h - 1)).clamp(0, corner_clip(h))
    return v.to(torch.int32), u.to(torch.int32)


def compare_maps(torch, g_k, g_p, rtol=GRID_RAND_RTOL):
    """Map cotangents, kernel vs plain: each cell within ``rtol`` of the
    largest |cell| -> dict; raises on a breach (module notes: K4)."""
    errs, scales = [], []
    for a, b in zip(g_k, g_p):
        scales.append(float(b.abs().max()))
        errs.append(float((a - b).abs().max()))
        check(scales[-1] > 0, 'a zero map cotangent')
        check(bool(torch.isfinite(a).all()), 'a non-finite map cotangent')
        check(errs[-1] <= rtol * scales[-1],
              f'map cotangents differ by {errs[-1]} (scale {scales[-1]})')
    return dict(map_max_abs_err=max(errs), map_scale=min(scales),
                map_err_over_scale=max(e / s for e, s in zip(errs, scales)))


def compare_plate_bwd(rt, torch, scene, params, rays, seed, nonseq=False):
    """K2 (or K6 with ``nonseq``) on a scene with a plate against its plain
    version, with seeded cotangents of the rays, the moments and the grid:
    ray cotangents under BWD_TOL, the table under TAB_RTOL over
    PLATE_GRAD_COLS, the maps per ``compare_maps`` -> dict."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    cfg, meta = scene.sensor_config(), scene.static_meta()
    dev = rays.px.device
    flat = rt.flatten_table_rows(scene.build_table(params))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    maps = fused_trace.plate_maps(meta, scene.side_grids(params))
    maps = tuple(m.detach() for m in maps)
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, dev, seed)
    if nonseq:
        nb = scene.n_bounces
        gt_k, gr_k, gm_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps)
        gt_p, gr_p, gm_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps)
    else:
        gt_k, gr_k, gm_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps)
        gt_p, gr_p, gm_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps)
    torch.cuda.synchronize()
    res = compare_ray_cotangents(
        torch, gr_k, gr_p, allowed=(max(3, math.ceil(
            NS_MISMATCH_SHARE * rays.n)) if nonseq else None),
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if cfg.grid_shape else 0))
    res.update(compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        plates=True))
    res.update(compare_maps(torch, gm_k, gm_p))
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
               PhysKind.APERTURE: 8,
               PhysKind.PHASE_GRID: 130}.get(meta.ph, 0)
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
    ray and bounce begun with intensity > 0 and a hit in the last bounce),
    the winners per row, the largest number of bounces a ray won, and the
    bounces K6 replays for the earlier segments of the rays that live beyond
    its 8 checkpoints (8 + 16 + ... + 8m for a ray of m earlier segments),
    counted with the plain bounce loop."""
    from raytracetorch_tpu_torch.core.trace import bounce_step, nearest_hit
    table = scene.build_table(params)
    meta = scene.static_meta()
    grids = {k: m.detach() for k, m in scene.side_grids(params).items()}
    rows = [table.row(k) for k in range(table.n_surfaces)]
    cfg = rt.SensorConfig(n_sensors=scene.n_sensors, n_bundles=1)
    sens = rt.SensorState.init(cfg, device=rays.px.device)
    going = rays.intensity > 0
    lives = torch.zeros_like(rays.intensity, dtype=torch.int32)
    scans, wins = 0, [0] * len(meta)
    with torch.no_grad():
        for _ in range(scene.n_bounces):
            if not bool(going.any()):
                break
            scans += int(going.sum())
            win, _ = nearest_hit(table, rays.pos_c, rays.dir_c, meta)
            rays, sens, act = bounce_step(rows, rays, cfg, sens, meta,
                                          plain=True, grids=grids)
            for k in range(len(meta)):
                wins[k] += int((act & going & (win == k)).sum())
            lives += (act & going).int()
            going = going & act & (rays.intensity > 0)
    m = (lives - 1).clamp(min=0) // K6_CHECKPOINTS
    replayed = int((K6_CHECKPOINTS // 2 * m * (m + 1)).sum())
    return scans, wins, int(lives.max()), replayed


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
    t_start = time.perf_counter()
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
    from raytracetorch_tpu_torch.ops import (fused_nonseq, fused_trace, grid,
                                             phase_grid)
    from raytracetorch_tpu_torch.rays import reference_prng

    def reset_counters():
        fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
        fused_trace.V1_LAUNCHES = 0
        fused_nonseq.NONSEQ_LAUNCHES = fused_nonseq.NONSEQ_BWD_LAUNCHES = 0
        grid.GRID_LAUNCHES = grid.GATHER_LAUNCHES = 0
        phase_grid.CORNER_LAUNCHES = phase_grid.CORNER_BWD_LAUNCHES = 0

    def counters():
        return dict(trace_seq_fwd=fused_trace.LAUNCHES,
                    trace_seq_bwd=fused_trace.BWD_LAUNCHES,
                    trace_seq_v1=fused_trace.V1_LAUNCHES,
                    trace_nonseq_fwd=fused_nonseq.NONSEQ_LAUNCHES,
                    trace_nonseq_bwd=fused_nonseq.NONSEQ_BWD_LAUNCHES,
                    grid_bin=grid.GRID_LAUNCHES,
                    grid_gather=grid.GATHER_LAUNCHES,
                    grid_corners=phase_grid.CORNER_LAUNCHES,
                    grid_corners_bwd=phase_grid.CORNER_BWD_LAUNCHES)

    def only(launched, **want):
        """Whether exactly the counters in ``want`` moved, by those
        counts."""
        return all(launched[k] == want.get(k, 0) for k in launched)

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

    # 2. build: the six libraries, one nvcc each, started together
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
            g_rays, g_mom, _ = random_cotangents(torch, n, cf, dev, SEED + n)
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

    # 5e. K6 vs its plain version on three scenes, with seeded cotangents of
    # the rays, the moments and the grid, on the rays whose forward K5 and
    # the plain loop trace alike (module notes: K6)
    ns_scenes = {'naive': (naive_scene, sample_rays),
                 'mirror_fold': (mirror_fold_scene, mirror_fold_rays),
                 'cavity': (cavity_scene, mirror_fold_rays)}
    ns_bwd = {}
    for case, (make_scene, make_rays) in ns_scenes.items():
        nsc = make_scene(rt)
        for n in (N_SMALL, N_MAIN):
            rays = make_rays(rt, torch, n, dev, SEED + 51 + n)
            res = compare_k6(rt, torch, nsc, rays, SEED + 61 + n,
                             chaotic=case == 'cavity')
            if case != 'naive':
                check(res['row0_curvature_cotangent'] > 0,
                      f'{case}: no cotangent for the mirror curvature')
            if case == 'cavity' and n == N_MAIN:
                _, _, res['max_live_bounces'], res['replayed_bounces'] = \
                    nonseq_work(rt, torch, nsc, nsc.init_params(dev), rays)
                check(res['max_live_bounces'] > K6_CHECKPOINTS,
                      'no cavity ray lives beyond the 8 checkpoints')
            ns_bwd[f'{case}_{n}'] = res
    emit('nonseq_bwd', **ns_bwd)

    # 5f. K6's forward replay equals K5's output, bit for bit, on every ray
    replay = {}
    for case, (make_scene, make_rays) in ns_scenes.items():
        nsc = make_scene(rt)
        ncfg, nmeta, nb = nsc.sensor_config(), nsc.static_meta(), \
            nsc.n_bounces
        nflat = rt.flatten_table_rows(nsc.build_table(nsc.init_params(dev)))
        nkinds = torch.tensor(fused_trace.kind_rows(nmeta, ncfg),
                              dtype=torch.int32, device=dev)
        rays = make_rays(rt, torch, N_MAIN, dev, SEED + 71)
        out_k, _ = fused_nonseq.trace_nonseq_fwd_cuda(nflat, nkinds, rays,
                                                      ncfg, nb)
        _, _, ends = fused_nonseq.trace_nonseq_bwd_cuda(
            nflat, nkinds, rays, ncfg, nb, (None,) * 7, None,
            need_table=False, need_rays=False, replay=True)
        torch.cuda.synchronize()
        differ = torch.zeros(N_MAIN, dtype=torch.bool, device=dev)
        for c in fused_trace.COMPS:
            a, b = getattr(ends, c), getattr(out_k, c)
            differ |= ~((a == b) | (torch.isnan(a) & torch.isnan(b)))
        replay[case] = int(differ.sum())
    emit('nonseq_replay', n=N_MAIN, rays_differ=replay)
    check(not any(replay.values()), f'K6 replays another state: {replay}')

    # 5g. the non-sequential gradient path, counted: Scene.simulate_fused
    # under grad, spot RMS + sum(grid * W), backward; then the eager loop
    ns_w = torch.randn(1, *GRID, generator=torch.Generator(
        device=dev).manual_seed(SEED + 81), device=dev)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 3)

    def nonseq_grads(simulate):
        p = nscene.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        r = rays.replace(px=rays.px.clone().requires_grad_(True),
                         dx=rays.dx.clone().requires_grad_(True))
        _, s, _ = simulate(p, r)
        ((s.grid * ns_w).sum() + s.spot_rms(0)[0]).backward()
        return ([p['lens'][k].grad for k in ('c1', 'c2')],
                (r.px.grad, r.dx.grad))

    torch.cuda.synchronize()
    reset_counters()
    ng_fused, nr_fused = nonseq_grads(nscene.simulate_fused)
    torch.cuda.synchronize()
    ns_grad_launches = counters()
    ng_eager, nr_eager = nonseq_grads(nscene.simulate)
    ng_100, nr_100 = nonseq_grads(naive_scene(rt, n_bounces=100)
                                  .simulate_fused)
    rel = [float((a - b).abs() / b.abs()) for a, b in zip(ng_fused,
                                                          ng_eager)]
    zeros = torch.zeros_like(rays.px)
    ray_res = compare_ray_cotangents(
        torch, (nr_fused[0], zeros, zeros, nr_fused[1], zeros, zeros, zeros),
        (nr_eager[0], zeros, zeros, nr_eager[1], zeros, zeros, zeros),
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * N_MAIN)))
    same_100 = all(torch.equal(a, b) for a, b in zip(ng_fused + list(nr_fused),
                                                    ng_100 + list(nr_100)))
    emit('nonseq_grad_main', n=N_MAIN, launches=ns_grad_launches,
         grad_fused=[float(g) for g in ng_fused],
         grad_eager=[float(g) for g in ng_eager], rel_err=rel,
         ray_grads=ray_res, budget_100_equal=same_100)
    check(ns_grad_launches['trace_nonseq_fwd'] == 1
          and ns_grad_launches['trace_nonseq_bwd'] == 1
          and sum(ns_grad_launches.values()) == 2,
          f'the non-sequential grad step launched {ns_grad_launches}')
    check(max(rel) < GRAD_RTOL, f'fused vs eager gradients differ: {rel}')
    check(all(float(g.abs().max()) > 0 for g in nr_fused),
          'no ray gradient through Scene.simulate_fused')
    check(same_100, 'a budget of 100 bounces changed the gradients')

    # 5h. the non-sequential design loop, counted: the design singlet as a
    # Scene, L-BFGS through Scene.simulate_fused at 1M rays
    nd_scene = dscene.to_base()
    nd_scene.n_bounces = NS_BOUNCES
    evals = [0]

    def counted(loss_fn):
        def loss(p):
            evals[0] += 1
            return loss_fn(p)
        return loss

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    nd_opt, nd_losses = rt.fit_lbfgs(
        counted(design_loss(torch, nd_scene, drays)), dparams,
        trainable=nd_scene.trainable(), steps=DESIGN_STEPS)
    torch.cuda.synchronize()
    nd_s = time.perf_counter() - t0
    nd_launches = counters()
    t0 = time.perf_counter()
    rt.fit_lbfgs(design_loss(torch, nd_scene, drays), dparams,
                 trainable=nd_scene.trainable(), steps=DESIGN_STEPS)
    torch.cuda.synchronize()
    nd_warm_s = time.perf_counter() - t0
    nd_lens = nd_opt['lens']
    nd_ratio = float(nd_lens['c1']) / float(nd_lens['c2'])
    nd_f = float(dscene.elements[0].f(nd_lens))
    emit('nonseq_design', n=N_MAIN, steps=DESIGN_STEPS, evaluations=evals[0],
         launches=nd_launches, seconds_first=nd_s, seconds_warm=nd_warm_s,
         loss_start=float(nd_losses[0]), loss_end=float(nd_losses[-1]),
         c1=float(nd_lens['c1']), c2=float(nd_lens['c2']),
         c1_over_c2=nd_ratio, sequential_c1_over_c2=ratio,
         focal_length=nd_f, sequential_focal_length=f_opt)
    check(nd_launches['trace_nonseq_fwd'] == evals[0]
          and nd_launches['trace_nonseq_bwd'] == evals[0]
          and sum(nd_launches.values()) == 2 * evals[0],
          f'{evals[0]} evaluations launched {nd_launches}')
    check(-7.5 < nd_ratio < -4.5, f'non-sequential c1/c2 {nd_ratio}')
    check(95.0 < nd_f < 106.0, f'non-sequential focal length {nd_f}')

    # 7. deep optics.  7a: K4 alone against its plain version on the cells
    # that 1M ring-former rays read on the 256 x 256 and the 32 x 32 map, and
    # on 2,999 cells partly outside the map (clamped reads)
    do_rays = ring_rays(rt, torch, N_MAIN, dev, SEED + 91)
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    corner_cases, corner_inputs = {}, {}
    for shape in (DO_MAP, DO_SMALL_MAP):
        civ, ciu = plate_cells(torch, do_rays, shape)
        corner_inputs[shape] = (ring_map(shape, dev), civ, ciu)
    corner_inputs['clamped'] = (
        torch.randn(*DO_SMALL_MAP, generator=gen, device=dev),
        torch.randint(-3, 36, (N_SMALL,), generator=gen, device=dev,
                      dtype=torch.int32),
        torch.randint(-3, 36, (N_SMALL,), generator=gen, device=dev,
                      dtype=torch.int32))
    for key, (cmap, civ, ciu) in corner_inputs.items():
        c_k = phase_grid.grid_corners_cuda(cmap, civ, ciu)
        c_p = phase_grid.grid_corners_plain(cmap, civ, ciu)
        g_c = tuple(torch.randn(civ.shape[0], generator=gen, device=dev)
                    for _ in range(4))
        s_k = phase_grid.grid_corners_bwd_cuda(g_c, civ, ciu, cmap.shape)
        s_p = phase_grid.grid_corners_bwd_plain(g_c, civ, ciu, cmap.shape)
        torch.cuda.synchronize()
        res = dict(n=int(civ.shape[0]), shape=list(cmap.shape),
                   cells_read=int(torch.unique(civ * 1000 + ciu).numel()),
                   gather_equal=all(torch.equal(a, b)
                                    for a, b in zip(c_k, c_p)))
        check(res['gather_equal'], f'K4 gather differs ({key})')
        res.update(compare_maps(torch, (s_k,), (s_p,)))
        corner_cases['x'.join(map(str, cmap.shape)) if key != 'clamped'
                     else key] = res
    emit('grid_corners', **corner_cases)

    # 7b. K1 and K5 with the 256 x 256 plate against their plain versions
    # (the Scene with 3 bounces and the 256 x 256 irradiance grid), and K1
    # with a 40 x 40 plate lit beyond its rims (clamped corner reads)
    do_seq = ring_scene(rt)
    do_ns = ring_scene(rt, bounces=DO_BOUNCES, grid=True)
    do_rim = ring_scene(rt, shape=(40, 40))
    do_p = ring_params(do_seq, dev)
    do_np = ring_params(do_ns, dev)
    do_rp = ring_params(do_rim, dev)
    plate_fwd = {}
    for case, sc, pp in (('sequential', do_seq, do_p),
                         ('scene', do_ns, do_np), ('rim', do_rim, do_rp)):
        cfg_c, meta_c = sc.sensor_config(), sc.static_meta()
        flat_c = rt.flatten_table_rows(sc.build_table(pp))
        kinds_c = torch.tensor(fused_trace.kind_rows(meta_c, cfg_c),
                               dtype=torch.int32, device=dev)
        maps_c = fused_trace.plate_maps(meta_c, sc.side_grids(pp))
        for n in (N_SMALL, N_MAIN):
            rays = (rim_rays if case == 'rim' else ring_rays)(
                rt, torch, n, dev, SEED + 93 + n)
            if case != 'scene':
                out_k, s_k = fused_trace.trace_seq_fwd_cuda(
                    flat_c, kinds_c, rays, cfg_c, maps_c)
                out_p, s_p = fused_trace.trace_sequential_fused_plain(
                    flat_c, rays, cfg_c, meta_c, maps_c)
                torch.cuda.synchronize()
                res = compare(torch, out_k, s_k, out_p, s_p)
            else:
                out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
                    flat_c, kinds_c, rays, cfg_c, sc.n_bounces, maps_c)
                out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
                    flat_c, rays, cfg_c, meta_c, sc.n_bounces, maps_c)
                torch.cuda.synchronize()
                res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
            if case == 'rim':
                res['beyond_rims'] = int(((rays.px.abs() >= DO_HX)
                                          | (rays.py.abs() >= DO_HX)).sum())
                check(res['beyond_rims'] > 0, 'no ray beyond the rims')
            else:
                res['ring_rms'] = math.sqrt(float(ring_loss(torch, out_k)))
                check(res['ring_rms'] < DO_RMS_MAX,
                      f'{case}: the closed-form map misses the ring: {res}')
            plate_fwd[f'{case}_{n}'] = res
    emit('plate_fwd', **plate_fwd)

    # 7c. K2 and K6 with the plate against their plain versions
    plate_bwd = {}
    for n in (N_SMALL, N_MAIN):
        rays = ring_rays(rt, torch, n, dev, SEED + 95 + n)
        plate_bwd[f'sequential_{n}'] = compare_plate_bwd(
            rt, torch, do_seq, do_p, rays, SEED + 96 + n)
        plate_bwd[f'scene_{n}'] = compare_plate_bwd(
            rt, torch, do_ns, do_np, rays, SEED + 97 + n, nonseq=True)
        plate_bwd[f'rim_{n}'] = compare_plate_bwd(
            rt, torch, do_rim, do_rp, rim_rays(rt, torch, n, dev,
                                               SEED + 99 + n), SEED + 98 + n)
    emit('plate_bwd', **plate_bwd)

    # 7d. the deep-optics forward path, counted: the ring former at 1M rays
    # through SequentialScene.simulate_fused (K1 once, K4's device functions
    # inside it)
    torch.cuda.synchronize()
    reset_counters()
    do_out, do_sens, _ = do_seq.simulate_fused(do_p, do_rays)
    torch.cuda.synchronize()
    do_fwd_launches = counters()
    do_rms = math.sqrt(float(ring_loss(torch, do_out)))
    do_finite = all(bool(torch.isfinite(getattr(do_out, c)).all())
                    for c in fused_trace.COMPS)
    emit('deep_optics_main', n=N_MAIN, map=list(DO_MAP),
         launches=do_fwd_launches, ring_rms=do_rms, finite=do_finite,
         shape=list(do_out.pos.shape),
         sensor_weight=float(do_sens.moments[0, 0, 0]))
    check(only(do_fwd_launches, trace_seq_fwd=1),
          f'the deep-optics forward launched {do_fwd_launches}')
    check(do_finite and list(do_out.pos.shape) == [N_MAIN, 3],
          'bad ray output')
    check(do_rms < DO_RMS_MAX, f'ring residual {do_rms}')

    # 7e. the deep-optics grad step, counted: the map is the only leaf that
    # requires grad; the example's loss, backward (K1 + K2 once each)
    def ring_grad(scene, simulate):
        p = ring_params(scene, dev, grad=True)
        out, _, _ = simulate(p, do_rays)
        loss = ring_loss(torch, out)
        loss.backward()
        return p['plate']['grid'].grad, float(loss.detach())

    torch.cuda.synchronize()
    reset_counters()
    gm_fused, do_loss = ring_grad(do_seq, do_seq.simulate_fused)
    torch.cuda.synchronize()
    do_grad_launches = counters()
    reset_counters()
    gm_eager, do_loss_eager = ring_grad(do_seq, do_seq.simulate)
    torch.cuda.synchronize()
    do_eager_launches = counters()
    map_vs_eager = compare_maps(torch, (gm_fused,), (gm_eager,), GRAD_RTOL)
    emit('deep_optics_grad', n=N_MAIN, launches=do_grad_launches,
         loss=do_loss, loss_eager=do_loss_eager,
         map_grad_norm=float(gm_fused.norm()), vs_eager=map_vs_eager)
    check(only(do_grad_launches, trace_seq_fwd=1, trace_seq_bwd=1),
          f'the deep-optics grad step launched {do_grad_launches}')

    # 7f. the same through the eager trace on the card, counted: K4's gather
    # once for the plate row, its scatter once in backward
    emit('deep_optics_eager', launches=do_eager_launches,
         loss=do_loss_eager)
    check(only(do_eager_launches, grid_corners=1, grid_corners_bwd=1),
          f'the eager deep-optics step launched {do_eager_launches}')

    # 7g. the plate as a Scene, counted: Scene.simulate_fused forward (K5
    # once) and grad (K5 + K6 once each); the ordered Scene equals the
    # sequential trace
    torch.cuda.synchronize()
    reset_counters()
    dn_out, dn_sens, _ = do_ns.simulate_fused(do_np, do_rays)
    torch.cuda.synchronize()
    dn_fwd_launches = counters()
    reset_counters()
    gn_fused, dn_loss = ring_grad(do_ns, do_ns.simulate_fused)
    torch.cuda.synchronize()
    dn_grad_launches = counters()
    gn_eager, _ = ring_grad(do_ns, do_ns.simulate)
    dn_vs_seq = compare_nonseq(
        torch, dn_out, dn_sens, do_out,
        rt.SensorState(moments=do_sens.moments, grid=dn_sens.grid))
    dn_rms = math.sqrt(float(ring_loss(torch, dn_out)))
    emit('deep_optics_scene', n=N_MAIN, bounces=DO_BOUNCES,
         fwd_launches=dn_fwd_launches, grad_launches=dn_grad_launches,
         ring_rms=dn_rms, sequential_ring_rms=do_rms,
         grid_total=float(dn_sens.grid.sum()), vs_sequential=dn_vs_seq,
         map_grad_vs_eager=compare_maps(torch, (gn_fused,), (gn_eager,),
                                        GRAD_RTOL),
         map_grad_vs_sequential=compare_maps(torch, (gn_fused,), (gm_fused,),
                                             GRAD_RTOL))
    check(only(dn_fwd_launches, trace_nonseq_fwd=1),
          f'Scene.simulate_fused launched {dn_fwd_launches}')
    check(only(dn_grad_launches, trace_nonseq_fwd=1, trace_nonseq_bwd=1),
          f'the Scene grad step launched {dn_grad_launches}')
    check(abs(dn_rms - do_rms) <= NS_SPOT_RTOL * do_rms,
          f'ordered Scene ring residual {dn_rms} vs sequential {do_rms}')

    # 7h. the design loop of example 28 as published, counted: 32 x 32 map
    # from zero, its 30,000 rays, Adam (800 steps, lr 1.5) through
    # SequentialScene.simulate_fused
    ds = ring_scene(rt, shape=DO_SMALL_MAP)
    ds_rays = reference_prng.collimated_disk(
        reference_prng.prng_key(0), DO_DESIGN_RAYS, 3.0, (0.0, 0.0, -3.0),
        DO_LAM, device=dev)
    ds_evals = [0]

    def ds_loss(p):
        ds_evals[0] += 1
        out, _, _ = ds.simulate_fused(p, ds_rays)
        return ring_loss(torch, out)

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    ds_p, ds_hist = rt.fit(ds_loss, ds.init_params(dev),
                           trainable=ds.trainable(), steps=DO_DESIGN_STEPS,
                           lr=DO_DESIGN_LR)
    torch.cuda.synchronize()
    ds_s = time.perf_counter() - t0
    ds_launches = counters()
    ds_rms = math.sqrt(float(ds_hist[-1]))
    alpha, beta, alpha_err, beta_err = radial_slope(
        ds_p['plate']['grid'].detach().cpu().numpy())
    emit('deep_optics_design', n=DO_DESIGN_RAYS, steps=DO_DESIGN_STEPS,
         evaluations=ds_evals[0], launches=ds_launches, seconds=ds_s,
         rms_start=math.sqrt(float(ds_hist[0])), rms_end=ds_rms,
         alpha=alpha, beta=beta, alpha_rel_err=alpha_err,
         beta_rel_err=beta_err)
    check(only(ds_launches, trace_seq_fwd=ds_evals[0],
               trace_seq_bwd=ds_evals[0]),
          f'{ds_evals[0]} evaluations launched {ds_launches}')
    check(ds_rms < DO_RMS_MAX, f'design ring residual {ds_rms}')
    check(alpha_err < DO_SLOPE_RTOL and beta_err < DO_SLOPE_RTOL,
          f'learned slope {alpha} + {beta} r off by {alpha_err}, {beta_err}')

    # 7i. K0's counterpart, counted: trace_sequential_v1 on the bench scene
    # at 1M rays launches K1's kernel with every stream off, equal bit for
    # bit to K1 without a grid, and matches the plain version
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 98)
    table_b = scene.build_table(scene.init_params(dev))
    torch.cuda.synchronize()
    reset_counters()
    v1_out, v1_sens, _ = rt.trace_sequential_v1(table_b, rays, cfg, meta)
    torch.cuda.synchronize()
    v1_launches = counters()
    k1_out, k1_sens = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    v1_p, v1_sp = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                           meta)
    torch.cuda.synchronize()
    v1_res = compare(torch, v1_out, v1_sens, v1_p, v1_sp)
    v1_res['same_as_k1'] = (
        all(torch.equal(getattr(v1_out, c), getattr(k1_out, c))
            for c in fused_trace.COMPS)
        and torch.equal(v1_sens.moments, k1_sens.moments))
    emit('trace_v1', launches=v1_launches, **v1_res)
    check(only(v1_launches, trace_seq_v1=1),
          f'trace_sequential_v1 launched {v1_launches}')
    check(v1_res['same_as_k1'], 'trace_sequential_v1 differs from K1')

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
    # K6 against its plain version on the same scene, with the cotangents of
    # the spot and grid loss; the plain backward keeps the eager graph of
    # every bounce (~9 GB per 1M rays), so at 16M it is tried once and its
    # out-of-memory error recorded
    k6_args = ((None,) * 7, g_mom1)
    for n, reps, warm in ((N_MAIN, 8, 1), (N_LARGE, 4, 1)):
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        k_runs = time_ms(torch, lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            nflat, nkinds, rays, ncfg, NS_BOUNCES, *k6_args, g_grid=ns_w),
            warm, 2 * reps if n == N_MAIN else 20)
        res = dict(kernel_ms=statistics.median(k_runs), kernel_runs=k_runs)
        try:
            k_ms, p_ms, k_runs, p_runs = time_pair(
                torch,
                lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                    nflat, nkinds, rays, ncfg, NS_BOUNCES, *k6_args,
                    g_grid=ns_w),
                lambda: fused_nonseq.trace_nonseq_bwd_plain(
                    nflat, rays, ncfg, nmeta, NS_BOUNCES, *k6_args,
                    g_grid=ns_w), reps=reps, warmup=warm)
            res.update(paired_kernel_ms=k_ms, plain_ms=p_ms,
                       paired_kernel_runs=k_runs, plain_runs=p_runs)
        except torch.cuda.OutOfMemoryError:
            res['plain_out_of_memory'] = True
            torch.cuda.empty_cache()
        timing[f'nonseq_bwd_n{n}'] = res
    csc = cavity_scene(rt)
    cflat = rt.flatten_table_rows(csc.build_table(csc.init_params(dev)))
    ckinds = torch.tensor(fused_trace.kind_rows(csc.static_meta(),
                                                csc.sensor_config()),
                          dtype=torch.int32, device=dev)
    rays = mirror_fold_rays(rt, torch, N_MAIN, dev, SEED + 1)
    c_runs = time_ms(torch, lambda: fused_nonseq.trace_nonseq_bwd_cuda(
        cflat, ckinds, rays, csc.sensor_config(), csc.n_bounces, (None,) * 7,
        g_mom1))
    timing['nonseq_bwd_cavity'] = dict(kernel_ms=statistics.median(c_runs),
                                       kernel_runs=c_runs)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 2)
    ns_grad_p = nscene.init_params(dev)
    for k in ('c1', 'c2'):
        ns_grad_p['lens'][k].requires_grad_(True)

    def ns_grad_step():
        _, s, _ = nscene.simulate_fused(ns_grad_p, rays)
        ((s.grid * ns_w).sum() + s.spot_rms(0)[0]).backward()

    ns_e2e = {
        'scene_simulate_fused_ms': time_ms(
            torch, lambda: nscene.simulate_fused(nparams, rays)),
        'scene_simulate_eager_ms': time_ms(
            torch, lambda: nscene.simulate(nparams, rays)),
        'scene_grad_step_fused_ms': time_ms(torch, ns_grad_step),
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
    timing['nonseq_design_warm_s'] = nd_warm_s
    # K4 alone at 1M cells of the ring-former rays, on the 256 x 256 and the
    # 32 x 32 map: gather and scatter against their plain versions and the
    # library calls (four advanced-index reads at precomputed clamped cells;
    # four index_put_ with accumulate)
    for shape in (DO_MAP, DO_SMALL_MAP):
        cmap, civ, ciu = corner_inputs[shape]
        g_c = tuple(torch.randn(N_MAIN, device=dev) for _ in range(4))
        cells = phase_grid._cells(shape, civ, ciu)
        v0, v1, u0, u1 = cells
        pairs = ((v0, u0), (v0, u1), (v1, u0), (v1, u1))
        g_lib = torch.zeros(shape, device=dev)

        def lib_scatter():
            for g, cell in zip(g_c, pairs):
                g_lib.index_put_(cell, g, accumulate=True)
        k_ms, p_ms, k_runs, p_runs = time_pair(
            torch, lambda: phase_grid.grid_corners_cuda(cmap, civ, ciu),
            lambda: phase_grid.grid_corners_plain(cmap, civ, ciu))
        lib_runs = time_ms(torch, lambda: [cmap[cell] for cell in pairs])
        kb_ms, pb_ms, kb_runs, pb_runs = time_pair(
            torch, lambda: phase_grid.grid_corners_bwd_cuda(g_c, civ, ciu,
                                                            shape),
            lambda: phase_grid.grid_corners_bwd_plain(g_c, civ, ciu, shape))
        libb_runs = time_ms(torch, lib_scatter)
        timing['corners_' + 'x'.join(map(str, shape))] = dict(
            kernel_ms=k_ms, plain_ms=p_ms,
            library_ms=statistics.median(lib_runs), bwd_kernel_ms=kb_ms,
            bwd_plain_ms=pb_ms, bwd_library_ms=statistics.median(libb_runs),
            kernel_runs=k_runs, plain_runs=p_runs, library_runs=lib_runs,
            bwd_kernel_runs=kb_runs, bwd_plain_runs=pb_runs,
            bwd_library_runs=libb_runs)
    # K1, K2, K5 and K6 with the 256 x 256 plate at 1M rays against their
    # plain versions (the Scene: 3 bounces, 256 x 256 irradiance grid)
    rays = ring_rays(rt, torch, N_MAIN, dev, SEED + 1)
    plate_flat, plate_kinds, plate_maps = {}, {}, {}
    for case, sc, pp in (('sequential', do_seq, do_p),
                         ('scene', do_ns, do_np)):
        plate_flat[case] = rt.flatten_table_rows(sc.build_table(pp))
        plate_kinds[case] = torch.tensor(
            fused_trace.kind_rows(sc.static_meta(), sc.sensor_config()),
            dtype=torch.int32, device=dev)
        plate_maps[case] = tuple(m.detach() for m in fused_trace.plate_maps(
            sc.static_meta(), sc.side_grids(pp)))
    pf, pk, pm = (plate_flat['sequential'], plate_kinds['sequential'],
                  plate_maps['sequential'])
    sf, sk, sm = (plate_flat['scene'], plate_kinds['scene'],
                  plate_maps['scene'])
    scfg, smeta = do_seq.sensor_config(), do_seq.static_meta()
    ncfg_p, nmeta_p = do_ns.sensor_config(), do_ns.static_meta()
    w_p = torch.randn(1, *GRID, device=dev)
    plate_timing = {
        'k1': (lambda: fused_trace.trace_seq_fwd_cuda(pf, pk, rays, scfg, pm),
               lambda: fused_trace.trace_sequential_fused_plain(
                   pf, rays, scfg, smeta, pm), 20, 3),
        'k2': (lambda: fused_trace.trace_seq_bwd_cuda(
            pf, pk, rays, scfg, no_rays, g_mom1, maps=pm),
            lambda: fused_trace.trace_seq_bwd_plain(
                pf, rays, scfg, smeta, no_rays, g_mom1, maps=pm), 20, 3),
        'k5': (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
            sf, sk, rays, ncfg_p, DO_BOUNCES, sm),
            lambda: fused_nonseq.trace_nonseq_fused_plain(
                sf, rays, ncfg_p, nmeta_p, DO_BOUNCES, sm), 20, 3),
        'k6': (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            sf, sk, rays, ncfg_p, DO_BOUNCES, no_rays, g_mom1, g_grid=w_p,
            maps=sm),
            lambda: fused_nonseq.trace_nonseq_bwd_plain(
                sf, rays, ncfg_p, nmeta_p, DO_BOUNCES, no_rays, g_mom1,
                g_grid=w_p, maps=sm), 8, 1),
    }
    for key, (kfn, pfn, reps, warm) in plate_timing.items():
        k_ms, p_ms, k_runs, p_runs = time_pair(torch, kfn, pfn, reps=reps,
                                               warmup=warm)
        timing[f'plate_{key}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                      kernel_runs=k_runs, plain_runs=p_runs)
    # K0's counterpart against its plain version, bench scene, 1M rays
    rays_b = sample_rays(rt, torch, N_MAIN, dev, SEED + 1)
    k_ms, p_ms, k_runs, p_runs = time_pair(
        torch, lambda: rt.trace_sequential_v1(table_b, rays_b, cfg, meta),
        lambda: fused_trace.trace_sequential_fused_plain(flat, rays_b, cfg,
                                                         meta))
    timing['v1'] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs,
                        plain_runs=p_runs)
    # the deep-optics end-to-end metrics: the grad step at 1M rays on the
    # 256 x 256 map (fused and eager) and the design loop of example 28
    do_grad_p = ring_params(do_seq, dev, grad=True)

    def do_step(simulate):
        def step():
            out, _, _ = simulate(do_grad_p, do_rays)
            ring_loss(torch, out).backward()
        return step
    for key, fn in (('deep_optics_grad_step_fused_ms',
                     do_step(do_seq.simulate_fused)),
                    ('deep_optics_grad_step_eager_ms',
                     do_step(do_seq.simulate)),
                    ('deep_optics_scene_grad_step_fused_ms',
                     do_step(do_ns.simulate_fused))):
        runs = time_ms(torch, fn)
        timing[key] = statistics.median(runs)
        timing[key + '_runs'] = runs
    timing['deep_optics_design_s'] = ds_s
    emit('timing', **timing)

    # the bound of each kernel's work at 1M rays on this card
    n = N_MAIN
    k1_ops = n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
    k1_bytes = n * (32 + 28) + table_bytes(meta)
    scans, wins, _, replayed = nonseq_work(
        rt, torch, nscene, nparams, sample_rays(rt, torch, n, dev, SEED + 1))
    scan_ops = sum(intersect_ops(m) for m in nmeta)
    win_ops = [w * (intersect_ops(m) + apply_ops(m))
               for w, m in zip(wins, nmeta)]
    k5_ops = (scans * scan_ops
              + sum(w * apply_ops(m) for w, m in zip(wins, nmeta)))
    # K6: K5's replay; per winning bounce the winner's recompute and its
    # adjoint, about twice the forward's size (the rows that lose the argmin
    # have a zero adjoint); each segment-replay bounce a scan and the
    # average winner's physics (csrc/trace_nonseq_bwd.cu)
    k6_ops = (k5_ops + 3 * sum(win_ops) + replayed * (
        scan_ops + sum(w * apply_ops(m) for w, m in zip(wins, nmeta))
        / max(sum(wins), 1)))
    # with the 256 x 256 plate: K1 also reads the wavelength and the corners
    # (in L2); K2 also scatters into the map's cotangent; K5 and K6 on the
    # plate Scene with its 256 x 256 irradiance grid
    map_bytes = DO_MAP[0] * DO_MAP[1] * 4
    p_ops = n * sum(intersect_ops(m) + apply_ops(m) for m in smeta)
    p_scans, p_wins, _, p_replayed = nonseq_work(
        rt, torch, do_ns, do_np, ring_rays(rt, torch, n, dev, SEED + 1))
    p_scan_ops = sum(intersect_ops(m) for m in nmeta_p)
    p_k5_ops = (p_scans * p_scan_ops
                + sum(w * apply_ops(m) for w, m in zip(p_wins, nmeta_p)))
    p_k6_ops = (p_k5_ops + 3 * sum(
        w * (intersect_ops(m) + apply_ops(m))
        for w, m in zip(p_wins, nmeta_p)) + p_replayed * (
        p_scan_ops + sum(w * apply_ops(m) for w, m in zip(p_wins, nmeta_p))
        / max(sum(p_wins), 1)))
    plate_bounds = {
        'k1': bound(n * (36 + 28) + table_bytes(smeta) + map_bytes, p_ops),
        'k2': bound(n * (36 + 28) + table_bytes(smeta) + 3 * map_bytes,
                    3 * p_ops),
        'k5': bound(n * (36 + 28) + table_bytes(nmeta_p) + map_bytes
                    + grid_bytes(ncfg_p), p_k5_ops),
        'k6': bound(n * (36 + 28) + table_bytes(nmeta_p) + 3 * map_bytes
                    + grid_bytes(ncfg_p) + len(nmeta_p) * 23 * 4, p_k6_ops),
    }
    bounds = {
        # K4: 8 B of cell indices in and 16 B of corners out per cell, the
        # map read once; ~20 operations per cell (clamps, addresses).  Its
        # scatter moves the same bytes and reads and writes the map
        'grid_corners': bound(n * 24 + map_bytes, n * 20),
        'grid_corners_bwd': bound(n * 24 + 2 * map_bytes, n * 24),
        # K0's counterpart runs K1's kernel on the same work
        'trace_seq_v1': bound(k1_bytes, k1_ops),
        # K6, as timed: 8 input streams and 7 ray cotangents out (the spot
        # and grid loss gives no ray cotangents in), the table, the moment
        # and grid cotangents in, the table cotangent out
        'trace_nonseq_bwd': bound(n * (32 + 28) + table_bytes(nmeta)
                                  + grid_bytes(ncfg)
                                  + len(nmeta) * 19 * 4, k6_ops),
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
         k5_winners_per_row=wins, k5_ops=k5_ops, k6_ops=k6_ops,
         k6_replayed_bounces=replayed, plate_k1_ops=p_ops,
         plate_k5_row_scans=p_scans, plate_k5_winners_per_row=p_wins,
         plate_k5_ops=p_k5_ops, plate_k6_ops=p_k6_ops,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()},
         plate={k: dict(bound_ms=v[0], bound_by=v[1])
                for k, v in plate_bounds.items()})

    bwd_main = bwd_cases[f'bench_{N_MAIN}']
    emit('elapsed', seconds=time.perf_counter() - t_start)

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
        entry('trace_nonseq_bwd', 'trace_nonseq_bwd.cu', 2157,
              ns_grad_launches['trace_nonseq_bwd'],
              ns_bwd[f'naive_{N_MAIN}']['max_abs_err'],
              timing[f'nonseq_bwd_n{N_MAIN}']['kernel_ms'],
              timing[f'nonseq_bwd_n{N_MAIN}']['plain_ms']),
        entry('grid_corners', 'grid_corners.cu', 439,
              do_eager_launches['grid_corners'],
              max(corner_cases[key]['map_max_abs_err']
                  for key in corner_cases),
              timing['corners_256x256']['kernel_ms'],
              timing['corners_256x256']['plain_ms'],
              timing['corners_256x256']['library_ms']),
        entry('trace_seq_v1', 'trace_seq_fwd.cu', 81,
              v1_launches['trace_seq_v1'], v1_res['max_abs_err'],
              timing['v1']['kernel_ms'], timing['v1']['plain_ms']),
    ]}
    print(json.dumps(summary))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
