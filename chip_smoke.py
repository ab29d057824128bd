#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

It builds the six CUDA libraries from the sources in the checkout (K1, the
fused sequential forward; K2, its hand-written adjoint; K3, irradiance-grid
binning; K4, a phase map's corner reads; K5, the fused non-sequential
bounce loop; K6, its hand-written adjoint; one nvcc each, started together)
and checks each kernel against its plain PyTorch version (K3 with the whole
grid, a band of it and a band of each of 8 slots in shared memory, and
with one hot cell), K1 and K2 also with a 256 x 256 grid, K6 on the
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

Section 8 drives benchmarks/suite.py's mixed-surface scene (a cylindrical
singlet, an inverted square stop, a singlet, a sensor) and asphere scene,
sequential and as 12-bounce Scenes, through K1, K2, K5 and K6 in their
instantiation with the extended kinds: each kernel against its plain
version at 2,999 and 1M rays, then the counted forward (K1 or K5 once)
and gradient paths (K1 + K2, K5 + K6) against spot-RMS anchors computed
with the JAX package and against the eager gradients, the asphere design
of tests/test_asphere.py (400 Adam steps on k1, K1 + K2 per step, under
0.35x the first loss) and benchmarks/suite.py's render_1024x1024 on the
naive and the mixed scene (timed; the image against the same renderer on
the CPU); then it times the four kernels on both scenes against their
plain versions and the three new entry points, with bounds and blocks per
SM.  Every path of sections 4-7 also checks that it launched no
instantiation with the extended kinds.

Section 9 drives chromatic dispersion: the achromat of
tests/test_dispersion.py (Abbe glasses, and Sellmeier ones by
``glass_pair``) with a sensor at its design plane and the Sellmeier Cooke
triplet of examples/16_cooke_triplet.py, sequential and as 12-bounce
Scenes, through K1 and K5 in their extended instantiation and K2 and K6 in
their instantiation with dispersion: each kernel against its plain version
at 2,999 and 1M rays (K2 and K6 with the dispersion columns and the
wavelength's cotangent), the counted forward and gradient paths against
JAX anchors (tests/dispersion_anchors.py) and the eager gradients (the
curvatures, the Abbe achromat's glass indices, the wavelength), the two
achromat designs by ``fit_lbfgs`` at 1M rays (the F-to-C gap, K1 and K2
once per evaluation), then the four kernels' times against their plain
versions, K1 and K5 against the achromat at constant indices, the entry
points, bounds and blocks per SM.

Section 10 drives the deterministic streams (the optical path length and
the final medium, path and hit recording) through the instantiations of K1,
K2, K5 and K6 with the streams: each kernel against its plain version at
2,999 and 1M rays (K1 and K2 with the path length on the bench singlet, the
256 x 256 ring-former plate and the Sellmeier achromat, the OPL cotangents
of K2 against autograd of the plain version; K1 with the records on the
bench singlet and the Cooke triplet; K5 and K6 with the path length and K5
with the records on the 8-bounce naive scene and the mirror fold), the
counted paths (``simulate_fused(track_opl=True)``: K1 once; a
``wavefront_rms(refocus=True)`` grad step in c1 and c2: K1 + K2, against
the eager gradients; the same as a Scene: K5; K5 + K6; ``footprints`` on the
Cooke triplet at 1M rays: K1 once; a grad step through ``record_hits``: K1
once and its backward recomputed eagerly, no K2), the JAX anchors of
tests/wavefront_anchors.py (the bench singlet's wavefront error and Zernike
terms on the reference's threefry rays, the axial OPL, the Cooke
footprints), the wavefront design by ``fit_lbfgs`` (20 steps, 1M rays, K1
and K2 once per evaluation), and the stream instantiations' times, bounds
(with the streams' bytes) and blocks per SM; the kernel summary line lists
them beside the seven kernels.

Section 13 drives the diffractive and ideal elements (the kinoform DOE,
the grating, the ideal ABCD elements, the microlens array, the ELLIPSE
bound) through the instantiations of K1, K2, K5 and K6 with them: each
kernel against its plain version (example 25's hybrid achromat at 2,999
and 1M rays, example 05's nine-channel spectrometer and a Scene of every
new kind at 1M rays: moments slot by slot, the DOE's coefficient and the
wavelength's cotangents, K6's replay against K5), the counted forward and
grad steps (fused against eager gradients to 1e-3), examples 25's and
05's designs as published on the reference's rays against the JAX
package's (tests/diffractive_anchors.py: the shift cut over 15x, the DOE
power within 25% of the thin-lens split, the dispersion and spot RMS),
times, bounds and blocks per SM.

Section 18 drives the polarized field through coated interfaces and metal
mirrors in K1's and K2's instantiation with the field: each against its
plain version at 1M rays on the coated bench singlet (FRESNEL_W and
FRESNEL), the stress rows stack8, gold and mangin, the silver-film
beamsplitter and the aluminium mirrors; the counted paths against the JAX
package's means (tests/field_anchors.py) and the analytic anchors (the
film's polarized T_s, the mirrors' R); grad steps in the curvatures, the
coat thicknesses and E0 against the eager trace; a 20-step Adam design of
the coat thickness through K2 against JAX's; ``jones_pupil`` at 1024^2
against the same grid through ``simulate_fused`` and its maps at 16^2
against JAX's; times, bounds and blocks per SM.

Section 20 drives GRIN rods (examples/24_grin_relay.py, tests/test_grin.py)
through K1, K2, K5 and K6 in their instantiation with GRIN rods
(csrc/grin.cuh): each against its plain version at 1M rays with the path
length (the quarter-pitch rod, example 24's relay, a rod beside the bench
singlet, tests/test_grin.py:203's rod as a 4-bounce Scene with barrel
kills, and a rod whose axial term takes rays to their turning points; K6's
replay against K5 bit for bit); example 24's anchors through
``simulate_fused`` (the quarter-pitch fan's spot RMS under 5e-4, the
relay's centroid within 5e-3 of 1.2); the rod as a Scene against the rod
as a SequentialScene; fused against eager gradients in every GrinRod
parameter (GRIN_GRAD_RTOL); example 24's 400-step Adam design of grin_A
through K1 + K2 (its spot RMS and the paraxial working distance of the
fitted A); times, bounds and blocks per SM.

Section 22 drives the polarized field through GRIN rods (tests/test_grin.py
:242, :283, :435) through K1, K2, K5 and K6 in their field instantiation
with GRIN rods (csrc/grin.cuh::grin_rod_field and its adjoint): each
against its plain version at 1M rays (the quarter-pitch rod with E0, the
rod before a plate at Brewster's angle to its exit, the rod as a 4-bounce
Scene lit by an off-axis point source with a circular E0; the rays, the
final field and |E|^2, the ray, table and launch-field cotangents; K6's
replay against K5 bit for bit, its field too); the counted paths against
the JAX package's numbers (tests/grin_field_anchors.py: weight, centroid,
mean |E|^2); fused against eager gradients in n0, grin_A and E0
(GRIN_GRAD_RTOL); times, bounds and blocks per SM.

The build phase prints each kernel's ptxas registers and spills, and the
next K1's, K2's, K5's and K6's resident blocks per SM on their main paths'
launches.  K4's scatter is checked on both of its paths: maps held in
shared memory (32 x 32 and the largest the launcher takes) and larger ones
(one row more, and 256 x 256).  The timing phase also times each of K3's
launches in the eager bounce loop on its own, and the one-call library
yardsticks: ``index_add_`` (and ``index_put_``) for K3 on the bench spot
and on random hits over one 256 x 256 slot, ``torch.take`` for K4's
gather and ``index_add_`` (and four ``index_put_``) for its scatter; at
16M rays it times K1 against its plain version and K2, K5 and K6 alone.
Each phase prints one JSON line (its 'clock_s': the seconds since the
script started); any failed check raises, so the script exits non-zero.  Then come the kernel summary line (each kernel's launches
on its main path, error, time, plain time, the bound of its work on this
card and, for K3 and K4's gather and scatter, a library call's time), the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside it, the script fails.
"""

import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()  # each emitted line's 'clock_s' counts from here
SEED = 1234
N_MAIN = 1_000_000
N_SMALL = 2_999
N_LARGE = 16_000_000
# Anchors of the bench scene: BENCH_r05.json records spot_rms 0.16907 for
# the JAX package at 1M rays; the paraxial focal length is 20.513.
SPOT_RMS_REF, SPOT_RMS_TOL = 0.1691, 0.002
FOCAL_REF, FOCAL_TOL = 20.513, 1e-3
# Anchors of benchmarks/suite.py's mixed-surface and asphere scenes: their
# spot RMS by the JAX package at 1M rays, the mean over keys 0-3 (the same
# as sequential scenes and as 12-bounce Scenes), each within 6 of its
# standard deviations over those keys (0.00098, 0.000155): this run draws
# its own rays.
MIXED_RMS_REF, MIXED_RMS_TOL = 2.0362, 0.006
ASPH_RMS_REF, ASPH_RMS_TOL = 0.66825, 0.001
# The asphere design of tests/test_asphere.py:52-81 (the conic of the
# reference's singlet, Adam on k1): its final loss under this share of the
# first.
ASPH_DESIGN_RAYS, ASPH_DESIGN_STEPS, ASPH_DESIGN_LR = 4000, 400, 0.02
ASPH_DESIGN_SHARE = 0.35
# The renderer (benchmarks/suite.py render_1024x1024): the card's image
# against the same renderer on the CPU, each channel to RENDER_TOL, except
# the pixels whose winning row flips under another rounding (a ray grazing
# two rows' hits within an ulp, or a bound's rim): at most RENDER_FLIP_SHARE
# of them.
RENDER_SIZE = (1024, 1024)
RENDER_TOL = 1e-5
RENDER_FLIP_SHARE = 1e-3
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
# Chromatic dispersion (section 9).  The achromat of tests/test_dispersion.py:
# 59-68 (a cemented doublet of an N-BK7 crown and an SF2-like flint, Abbe
# numbers; and the same with glass_pair('N-BK7', 'SF2', model='sellmeier'))
# with a sensor at its design plane z = 100, lit by two collimated disks of
# radius 3 at z = -10, F and C light, ACHROMAT_RAYS each; and the Sellmeier
# Cooke triplet of examples/16_cooke_triplet.py:40-55 (N-SK16 / F2 / N-SK16,
# stop r = 5 at z = 12.3) with a sensor at its image plane z = 60.9, lit at
# the F, d and C lines and at tan(field) 0 and 0.1: six bundles, 1M rays in
# all.  Anchors from the JAX package (tests/dispersion_anchors.py, on the
# CPU): the triplet's spot RMS per bundle at 1M rays, the mean over keys 0-3,
# each within 6 of its standard deviations over those keys (this run draws
# its own rays); the achromat's axis crossings of a paraxial ray (height
# 0.1) at the F, d and C lines, to CROSS_TOL (float32 rounding of the
# crossing's division at a slope of 1e-3).  The achromat design (the loss of
# tests/test_dispersion.py:76-83, fit_lbfgs): the F-to-C focus gap under
# ACHROMAT_DESIGN's share of its start in its steps, the JAX test's own
# anchor for the Abbe glasses.  The wavelength's cotangent, kernel against
# plain: each ray within WL_RTOL of the stream's scale (the Sellmeier terms
# of a glass cancel about a hundredfold in d n / d lambda, so float32
# rounding in another order reads ~1e-4 of the scale on the CPU).
F_LINE, D_LINE, C_LINE = 0.4861, 0.5876, 0.6563
ACHROMAT_KW = dict(c1=0.02, c2=-0.025, c3=-0.004, d=20.0, t1=4.0, t2=2.0)
ACHROMAT_ABBE = dict(ior_glass1=1.5168, ior_glass2=1.6727, abbe_vd1=64.17,
                     abbe_vd2=32.25)
ACHROMAT_Z = 100.0
ACHROMAT_RAYS = 524_288
ACHROMAT_DESIGN = {'abbe': (20, 0.25), 'sellmeier': (30, 0.3)}
ACHROMAT_CROSS_REF = {'abbe': (109.11491, 108.55776, 108.31959),
                      'sellmeier': (103.19884, 102.89629, 102.8531)}
CROSS_TOL = 2e-3
COOKE_LINES = (0.48613, 0.5876, 0.65627)
COOKE_FIELDS = (0.0, 0.1)
COOKE_IMG_Z = 60.9
COOKE_RMS_REF = (0.355714, 0.350965, 0.346175, 0.359114, 0.354366, 0.34994)
COOKE_RMS_TOL = (0.001291, 0.001215, 0.002606, 0.001061, 0.00252, 0.001301)
DISP_BOUNCES = 12
WL_RTOL = 1e-3
# K2 and K6 against their plain versions on these scenes: each ray's
# cotangents under DISP_BWD_TOL * (|plain| + the group's scale), BWD_TOL's
# rule at 10 times its bound: the rays pass 3 to 6 refracting faces and
# travel 60-110 mm to the sensor, and the position cotangents' float32
# rounding in another order (the kernel contracts multiply-adds) reaches
# 1.6e-5 of the group's scale on a CPU build of the same device functions,
# 3 times the bench scene's worst.
DISP_BWD_TOL = 1e-4
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
    print(json.dumps({'phase': phase, 'clock_s': time.perf_counter() - T0,
                      **kw}),
          flush=True)


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


def compare(torch, out_k, s_k, out_p, s_p, intensity_rtol=0.0, world=False,
            pos_tol=POS_TOL, moment_atol=1e-6):
    """Kernel vs plain -> dict of worst errors; raises on a breach.  The
    intensities must be equal, or within ``intensity_rtol`` where rows
    weight them (FRESNEL_W, REFLECT_W: FRESNEL_I_RTOL).  With ``world``
    each position component is held within POS_TOL of 1 + the ray's world
    scale (its largest |coordinate|), as ``compare_streams`` holds records:
    a ghost path's two reflections turn the beam back and forth, so the
    rounding of a coordinate grows with the whole path's; ``pos_tol``
    replaces POS_TOL (GHOST_POS_TOL on the 27-row Cooke ghost);
    ``moment_atol`` is the moments' absolute floor (PUPIL_MOMENT_ATOL on a
    spot focused to a point)."""
    n = out_k.px.shape[0]
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz')
    bad, over, i_err = traced_apart(torch, out_k, out_p, intensity_rtol,
                                    world, pos_tol)
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
               max_moment_abs_err=float(mom_err.max()),
               max_intensity_rel_err=float(
                   (i_err[keep] / out_p.intensity[keep].abs().clamp(
                       min=1e-30)).max()) if n else 0.0,
               max_err_over_tol=float(over[keep].max()) if n else 0.0)
    check(n_flip <= allowed, f'{n_flip} rays differ (allowed {allowed})')
    check(bool((mom_err <= bound + moment_atol).all()),
          f'moments differ: {mk.tolist()} vs {mp.tolist()}')
    return res


def traced_apart(torch, out_k, out_p, intensity_rtol=0.0, world=False,
                 pos_tol=POS_TOL):
    """``compare``'s rule -> (the rays kernel and plain version trace apart
    [N] bool, each ray's worst position or direction error over its bound,
    the intensities' errors)."""
    i_err = (out_k.intensity - out_p.intensity).abs()
    bad = ~(i_err <= intensity_rtol * out_p.intensity.abs())
    scale = (torch.stack([out_p.px.abs(), out_p.py.abs(), out_p.pz.abs()])
             .amax(0) if world else 0.0)
    over = torch.zeros_like(out_p.px)   # the worst error over its bound
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz'):
        a, b = getattr(out_k, c), getattr(out_p, c)
        mag = torch.maximum(b.abs(), scale) if c[0] == 'p' and world \
            else b.abs()
        over = torch.maximum(over, (a - b).abs() / (pos_tol + pos_tol * mag))
        bad |= ~torch.isfinite(a)
    return bad | (over > 1.0), over, i_err


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
                           allowed=None, tol=BWD_TOL):
    """Per-ray cotangents, kernel vs plain (7 streams px..intensity) ->
    dict; raises on a breach of ``tol`` (BWD_TOL's rule).  ``allowed`` rays
    may differ (default BWD_FLIPS_PER_MILLION), ``intensity_allowed`` in the
    intensity cotangent alone (a grid cotangent read from a neighbour
    bin).  Per group
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
            bound = tol * (g_p[j].abs() + scale)
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


def compare_table_cotangents(torch, fused_trace, g_k, g_p, plates=False,
                             ext=False, disp=False, coat=False, diff=False,
                             freeform=False, rtol=TAB_RTOL, ref64=None):
    """Table cotangent [K, 160], kernel vs plain -> dict; raises on a
    breach of ``rtol`` (TAB_RTOL; section 20's turning-point rod
    GRIN_TURN_TAB_RTOL).  With ``ref64``, the plain version's float64 table
    cotangent, a column group beyond ``rtol`` passes where the kernel lies
    within FIELD_F64_RATIO times the float32 plain version's distance of
    it (section 17's rule, for sums whose rounding the near-axis or
    near-turning rays dominate: ``table_f64`` reports both distances over
    the scale).  Outside GRAD_COLS (PLATE_GRAD_COLS with phase
    plates, EXT_GRAD_COLS with the extended kinds, DISP_GRAD_COLS with a
    dispersive row, with ``coat`` COAT_GRAD_COLS, with ``diff``
    FF_GRAD_COLS and with ``freeform`` FF_TERM_COLS) both must be exactly
    zero, but the plain
    version's at the coat's layer indices (static: no parameter reaches
    them, and the kernels do not compute them)."""
    offs = list(fused_trace.grad_cols(() if plates else None, ext, disp,
                                      coat, diff, freeform))
    # the asphere's a4..a10 span r^4..r^10, the dispersion coefficients
    # B ~ 1 and C ~ 0.01-100 um^2: each column its own scale
    fields = (offs[0:5], offs[5:14], offs[14:17], offs[17:19]) + (
        (offs[19:23],) if len(offs) > 19 else ()) + tuple(
        [c] for c in offs[23:])
    worst, f64 = 0.0, []
    for cols in fields:
        scale = float(g_p[:, cols].abs().max())
        err = float((g_k[:, cols] - g_p[:, cols]).abs().max())
        ok = err <= rtol * scale
        if ref64 is not None:
            e_k, e_p = (float((g[:, cols].double() - ref64[:, cols]).abs()
                              .max()) for g in (g_k, g_p))
            f64.append(dict(cols=cols[0], kernel=e_k / max(scale, 1e-30),
                            plain=e_p / max(scale, 1e-30)))
            ok = ok or e_k <= FIELD_F64_RATIO * e_p
        check(ok, f'table cotangent columns {cols} differ by {err} '
              f'(scale {scale}; float64 {f64[-1:]})')
        worst = max(worst, err / max(scale, 1e-30))
    outside = [c for c in range(g_p.shape[1]) if c not in offs]
    indices = ({c - 1 for c in fused_trace.COAT_GRAD_COLS} if coat
               else set())
    check(float(g_k[:, outside].abs().max()) == 0.0
          and float(g_p[:, [c for c in outside if c not in indices]]
                    .abs().max()) == 0.0,
          'nonzero table cotangent outside GRAD_COLS')
    res = dict(table_err_over_scale=worst,
               table_max_abs_err=float((g_k - g_p).abs().max()),
               rows_with_grad=int((g_p.abs().sum(1) > 0).sum()))
    if f64:
        res['table_f64'] = f64
    return res


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
    test_nonseq_bwd_scan_large_budget): rays live beyond K6's 13 checkpoints.
    Rays: ``mirror_fold_rays``."""
    return rt.Scene([
        rt.SphericalMirror(c1=-0.02, d=0.0, translation=[0.0, 0.0, 40.0],
                           c1_grad=True, name='m1'),
        rt.SphericalMirror(c1=0.02, d=0.0, translation=[0.0, 0.0, 0.0],
                           rotation=[0.0, math.pi, 0.0], name='m2'),
        rt.SensorElement(radius=3.0, translation=[6.0, 0.0, 20.0],
                         name='sensor'),
    ], n_bounces=25)


def mixed_scene(rt, n_bounces=None):
    """benchmarks/suite.py's mixed-surface scene (11 rows): a cylindrical
    singlet (two QUADRIC_ZY faces, four side planes), an inverted square
    stop at z = 8 (RECT), a spherical singlet at z = 14 and a disk sensor at
    z = 40; with ``n_bounces`` a Scene.  Rays: ``sample_rays``."""
    els = [rt.CylSingletLens(c1=0.04, c2=-0.04, height=12.0, width=14.0,
                             t=3.0, ior_glass=1.5, name='cyl'),
           rt.RectangularAperture(half_x=5.0, half_y=5.0, invert=True,
                                  translation=[0.0, 0.0, 8.0], name='stop'),
           rt.SingletLens(c1=0.03, c2=-0.03, d=14.0, t=2.0, ior_glass=1.62,
                          translation=[0.0, 0.0, 14.0], name='lens2'),
           rt.SensorElement(radius=10.0, translation=[0.0, 0.0, 40.0],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def asphere_scene(rt, n_bounces=None):
    """benchmarks/suite.py's asphere scene: an even-asphere singlet (k1 =
    -0.6, a4 = 2.5e-4, a6 = 1e-6) and a disk sensor at z = 19; with
    ``n_bounces`` a Scene.  Rays: ``sample_rays``."""
    els = [rt.AsphericLens(c1=0.05, k1=-0.6, a1=[2.5e-4, 1e-6, 0.0, 0.0],
                           c2=-0.02, d=10.0, t=3.0, ior_glass=1.5,
                           name='asph'),
           rt.SensorElement(radius=8.0, translation=[0.0, 0.0, 19.0],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def achromat_scene(rt, model='abbe', n_bounces=None, grad=False):
    """The achromat of tests/test_dispersion.py:59-68 with a sensor at its
    design plane z = 100: the Abbe glasses of the test, or glass_pair(
    'N-BK7', 'SF2', model='sellmeier'); ``grad``: the three curvatures
    trainable; with ``n_bounces`` a Scene.  Rays: ``achromat_bundles``."""
    glasses = (ACHROMAT_ABBE if model == 'abbe'
               else rt.glass_pair('N-BK7', 'SF2', model='sellmeier'))
    els = [rt.DoubletLens(**ACHROMAT_KW, **glasses, c1_grad=grad,
                          c2_grad=grad, c3_grad=grad, name='achromat'),
           rt.SensorElement(radius=30.0, translation=[0.0, 0.0, ACHROMAT_Z],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def achromat_bundles(rt, n=ACHROMAT_RAYS):
    """[(bundle, n)]: collimated disks of radius 3 at z = -10, F light
    (ray_id 0) and C light (ray_id 1)."""
    return [(rt.CollimatedDisk.make(radius=3.0, ray_id=j, wavelength=wl,
                                    translation=[0.0, 0.0, -10.0]), n)
            for j, wl in enumerate((F_LINE, C_LINE))]


def cooke_scene(rt, n_bounces=None):
    """The Sellmeier Cooke triplet of examples/16_cooke_triplet.py:40-55
    (pert 1: the textbook 50 mm f/4.5; 11 rows with the stop and a sensor at
    the image plane z = 60.9); with ``n_bounces`` a Scene.  Rays:
    ``cooke_bundles``."""
    sk16 = rt.glass('N-SK16', model='sellmeier')
    f2 = rt.glass('F2', model='sellmeier')
    els = [rt.SingletLens(c1=1.0 / 22.01, c2=1.0 / -435.8, d=17.0, t=3.26,
                          translation=[0.0, 0.0, 1.63], c1_grad=True,
                          c2_grad=True, name='crown_front', **sk16),
           rt.SingletLens(c1=1.0 / -22.21, c2=1.0 / 22.26, d=11.0, t=1.0,
                          translation=[0.0, 0.0, 9.77], c1_grad=True,
                          c2_grad=True, name='flint', **f2),
           rt.CircularAperture(radius=5.0, translation=[0.0, 0.0, 12.3],
                               name='stop'),
           rt.SingletLens(c1=1.0 / 79.68, c2=1.0 / -18.40, d=13.0, t=2.95,
                          translation=[0.0, 0.0, 16.5], c1_grad=True,
                          c2_grad=True, name='crown_rear', **sk16),
           rt.SensorElement(radius=20.0, translation=[0.0, 0.0, COOKE_IMG_Z],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def cooke_bundles(rt, n=N_MAIN):
    """[(bundle, n_j)], n rays in all: a collimated disk of radius 5 at
    z = -10 for each field tan(f) of COOKE_FIELDS and line of COOKE_LINES
    (ray_id = 3 * field index + line index), tilted about x so its rays
    head up at tan(f), centred so that they cross the axis at the stop."""
    out, n_b = [], len(COOKE_FIELDS) * len(COOKE_LINES)
    for i, f in enumerate(COOKE_FIELDS):
        for j, wl in enumerate(COOKE_LINES):
            b = len(out)
            out.append((rt.CollimatedDisk.make(
                radius=5.0, ray_id=b, wavelength=wl,
                rotation=[-math.atan(f), 0.0, 0.0],
                translation=[0.0, -f * (12.3 + 10.0), -10.0]),
                n // n_b + (n % n_b if b == n_b - 1 else 0)))
    return out


# The leaves each extended scene's gradient phases train (the issue's
# choice: a cylindrical face and a spherical face; the conic and the
# polynomial)
EXT_TRAINED = {'mixed': (('cyl', 'c1'), ('lens2', 'c2')),
               'asphere': (('asph', 'k1'), ('asph', 'a1'))}
EXT_BOUNCES = 12


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
    ext = fused_trace.ext_kinds(meta)
    disp = fused_trace.dispersive(meta)
    maps = fused_trace.plate_maps(meta, None)
    out_k, _ = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, nb,
                                                  maps, ext)
    out_p, _ = fused_nonseq.trace_nonseq_fused_plain(flat, rays, cfg, meta,
                                                     nb, maps)
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
    res_k = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, sub, cfg, nb, g_rays, g_mom, g_grid=g_grid, maps=maps,
        ext=ext, disp=disp, need_wavelength=disp)
    res_p = fused_nonseq.trace_nonseq_bwd_plain(
        flat, sub, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid, maps=maps,
        need_wavelength=disp)
    (gt_k, gr_k), (gt_p, gr_p) = res_k[:2], res_p[:2]
    torch.cuda.synchronize()
    res = dict(forward_differ=n - n_sub)
    res.update(compare_ray_cotangents(
        torch, gr_k, gr_p, allowed=allowed,
        intensity_allowed=(math.ceil(GRID_SHARE * n_sub)
                           if cfg.grid_shape else 0),
        tol=DISP_BWD_TOL if disp else BWD_TOL))
    res.update(compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        maps is not None, ext, disp))
    if disp:
        res['wavelength'] = compare_wavelength_cotangents(
            torch, res_k[3], res_p[3], allowed)
    # the first row's curvature, q[0:3]: a mirror's c1 in the mirror scenes
    res['row0_curvature_cotangent'] = float(gt_k[0, :3].abs().sum())
    return res


def compare_wavelength_cotangents(torch, g_k, g_p, allowed=None):
    """The wavelength's cotangent [N], kernel vs plain -> dict; raises if
    more than ``allowed`` rays (default BWD_FLIPS_PER_MILLION) differ by
    more than WL_RTOL of the stream's scale (module notes)."""
    n = g_p.shape[0]
    scale = float(g_p.abs().max()) if n else 0.0
    err = (g_k - g_p).abs()
    bad = (err > WL_RTOL * scale) | ~torch.isfinite(g_k)
    if allowed is None:
        allowed = math.ceil(BWD_FLIPS_PER_MILLION * n / 1e6)
    res = dict(scale=scale, rays_differ=int(bad.sum()), allowed=allowed,
               max_err_over_scale=float(err.max()) / max(scale, 1e-30),
               max_err_in_bound_over_scale=(
                   float(err[~bad].max()) / max(scale, 1e-30)
                   if int(bad.sum()) < n else 0.0))
    check(scale > 0.0, 'the wavelength has no cotangent')
    check(res['rays_differ'] <= allowed,
          f'{res["rays_differ"]} rays have another wavelength cotangent')
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


def compare_nonseq(torch, out_k, s_k, out_p, s_p, world=False, allowed=None):
    """K5 (or the eager bounce loop) vs the plain bounce loop -> dict;
    raises on a breach (module notes: NS_*).  ``world``: each ray's
    positions and directions are held by ``traced_apart``'s world rule
    (within POS_TOL of 1 + its world scale) in place of NS_POS_TOL, for rays
    that run far from the origin (section 16's uncapped lightpipe).
    ``allowed`` replaces the NS rule's count of rays that may differ
    (section 20's turning-point rod: GRIN_TURN_SHARE)."""
    n = out_p.px.shape[0]
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz')
    if world:
        bad = traced_apart(torch, out_k, out_p, NS_INT_TOL, world=True)[0]
    else:
        dpos = torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                            for c in comps[:3]]).amax(0)
        bad = ((dpos > NS_POS_TOL)
               | ((out_k.intensity - out_p.intensity).abs() > NS_INT_TOL))
    for c in comps + ('intensity',):
        bad |= ~torch.isfinite(getattr(out_k, c))
    n_bad = int(bad.sum())
    if allowed is None:
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
    if s_p.grid.numel():
        res.update(compare_grid(torch, s_k.grid, s_p.grid,
                                NS_GRID_TOTAL_RTOL))
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


def k4_shared_cap():
    """The most cells of a map that K4's scatter holds in shared memory
    (kMaxSharedCells, read from its source): larger maps take its vector
    path."""
    import re
    src = os.path.join(ROOT, 'raytracetorch_tpu_torch', 'csrc',
                       'grid_corners.cu')
    with open(src) as f:
        m = re.search(r'constexpr int kMaxSharedCells = (\d+);', f.read())
    check(m is not None, 'kMaxSharedCells not found in grid_corners.cu')
    return int(m.group(1))


def compare_plate_bwd(rt, torch, scene, params, rays, seed, nonseq=False):
    """K2 (or K6 with ``nonseq``) on a scene with a plate against its plain
    version, with seeded cotangents of the rays, the moments and the grid:
    ray cotangents under BWD_TOL, the table under TAB_RTOL over
    PLATE_GRAD_COLS (EXT_GRAD_COLS with the extended kinds), the maps per
    ``compare_maps`` -> dict."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    cfg, meta = scene.sensor_config(), scene.static_meta()
    dev = rays.px.device
    flat = rt.flatten_table_rows(scene.build_table(params))
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    maps = fused_trace.plate_maps(meta, scene.side_grids(params))
    maps = tuple(m.detach() for m in maps)
    ext = fused_trace.ext_kinds(meta)
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, dev, seed)
    if nonseq:
        nb = scene.n_bounces
        gt_k, gr_k, gm_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, ext=ext)
        gt_p, gr_p, gm_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps)
    else:
        gt_k, gr_k, gm_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps,
            ext=ext)
        gt_p, gr_p, gm_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps)
    torch.cuda.synchronize()
    res = compare_ray_cotangents(
        torch, gr_k, gr_p, allowed=(max(3, math.ceil(
            NS_MISMATCH_SHARE * rays.n)) if nonseq else None),
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if cfg.grid_shape else 0))
    res.update(compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        plates=True, ext=ext))
    res.update(compare_maps(torch, gm_k, gm_p))
    return res


# Float32 operations per ray of one table row, counted in the kernels'
# sources (csrc/trace_seq_common.cuh): the intersection with its bounds,
# and the normal, physics, update and sensor terms of a row that is
# applied.  Each kernel's bound is the larger of its bytes over the HBM
# rate and these operations over the float32 rate.
# The extended kinds: an asphere row refines both roots (4 Halley steps of
# ~83 operations and a last residual of ~75 each) and its normal takes ~30;
# VB_RECT adds ~6 comparisons to a volume bound's, VB_CYL_EDGE two sags
# and ~8 comparisons (~26).
ASPH_REFINE_OPS = 2 * (4 * 83 + 75)
# The diffractive and ideal kinds (csrc/diffractive.cuh): each rotates the
# direction into the surface frame and back (30); LINEAR three divisions,
# a square root and ~8 more; GRATING a division, a square root and ~10;
# MLA two floors, a square root, four divisions and ~12; DOE the side, its
# media, 4 a radial term, a square root, a division and ~14, its efficiency
# a sine and ~8 more.  The ELLIPSE bound ~12 a root more than a disk's and
# a cosine and a sine per row and block (ELLIPSE_ROW_OPS).
DIFF_PHYS_OPS = {5: 42, 7: 42, 14: 48}
DOE_OPS, DOE_TERM_OPS, DOE_EFF_OPS = 50, 4, 10
ELLIPSE_OPS, ELLIPSE_ROW_OPS = 24, 2
EXT_VB_OPS = {3: 6, 4: 26}
# A dispersive row's indices: lambda^2 (~3 operations), then per side a
# Cauchy index (~4) or a Sellmeier one (3 terms of ~7 and a square root,
# ~24); a constant side costs nothing.
DISP_L2_OPS = 3
DISP_SIDE_OPS = {0: 0, 1: 4, 2: 24}


def intersect_ops(meta):
    """A row's intersection operations (a freeform row's Newton steps over
    its terms and its normal's evaluation: freeform_ops)."""
    return ((83 if meta.plane else 122) + (22 if meta.sb else 0)
            + (ELLIPSE_OPS if meta.sb == 3 else 0)
            + (22 if meta.vb else 0) + EXT_VB_OPS.get(meta.vb, 0)
            + (ASPH_REFINE_OPS if meta.asph and not meta.ff else 0)
            + freeform_ops(meta)[0])


def apply_ops(meta):
    from raytracetorch_tpu_torch.constants import PhysKind
    physics = {PhysKind.SNELL: 26, PhysKind.REFLECT: 13,
               PhysKind.APERTURE: 8, PhysKind.PHASE_GRID: 130,
               PhysKind.FRESNEL: 26 + FRESNEL_OPS,
               PhysKind.FRESNEL_W: 26 + FRESNEL_OPS,
               PhysKind.REFLECT_W: 26 + FRESNEL_OPS}.get(meta.ph, 0)
    if meta.ph in DIFF_PHYS_OPS:
        physics = DIFF_PHYS_OPS[meta.ph]
    elif meta.ph == PhysKind.DOE:
        physics = (DOE_OPS + DOE_TERM_OPS * meta.doe[0]
                   + (DOE_EFF_OPS if meta.doe[1] else 0))
    normal = 0 if meta.plane else 30 if meta.asph else 34
    disp = (DISP_L2_OPS + sum(DISP_SIDE_OPS[m] for m in meta.dispm)
            if meta.disp else 0)
    return 7 + normal + physics + disp + (13 if meta.sensor else 0)


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


def nonseq_work(rt, torch, scene, params, rays, key=None):
    """K5's data-dependent work on these rays, counted with the plain bounce
    loop: the row scans it runs (one per ray and bounce begun with
    intensity > 0 and a hit in the last bounce), the winners per row, and
    each ray's number of bounces won ([N] int32).  ``key``: the Philox key
    of a scene's FRESNEL draws."""
    from raytracetorch_tpu_torch.core.trace import bounce_step, nearest_hit
    from raytracetorch_tpu_torch.rays.draws import NonseqDraws
    draws = (NonseqDraws(rays.n, rays.px.device, key=key)
             if key is not None else None)
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
        for b in range(scene.n_bounces):
            if not bool(going.any()):
                break
            scans += int(going.sum())
            win, _ = nearest_hit(table, rays.pos_c, rays.dir_c, meta)
            rays, sens, act = bounce_step(rows, rays, cfg, sens, meta,
                                          plain=True, grids=grids,
                                          draws=draws, bounce=b)
            for k in range(len(meta)):
                wins[k] += int((act & going & (win == k)).sum())
            lives += (act & going).int()
            going = going & act & (rays.intensity > 0)
    return scans, wins, lives


def segment_replays(lives, checkpoints=None):
    """The bounces K6 replays for the earlier segments of rays that live
    ``lives`` bounces, with ``checkpoints`` bounces a segment (by default
    the kernel's, fused_nonseq.K6_CHECKPOINTS): a ray of m earlier segments
    replays K + 2K + ... + mK, K = checkpoints (K6 keeps min(budget,
    K6_CHECKPOINTS), and no ray outlives a budget below it)."""
    if checkpoints is None:
        from raytracetorch_tpu_torch.ops.fused_nonseq import K6_CHECKPOINTS
        checkpoints = K6_CHECKPOINTS
    m = (lives - 1).clamp(min=0) // checkpoints
    return int((checkpoints * m * (m + 1) // 2).sum())


def nonseq_ops(meta, scans, wins, replayed):
    """(K5's, K6's) float32 operations for this work: K5 scans every row at
    each bounce and applies the winner's physics; K6 replays K5, then per
    winning bounce recomputes the winner and runs its adjoint, about twice
    the forward's size (the rows that lose the argmin have a zero adjoint),
    and each segment-replay bounce is a scan and the average winner's
    physics (csrc/trace_nonseq_bwd.cu)."""
    scan_ops = sum(intersect_ops(m) for m in meta)
    apply = sum(w * apply_ops(m) for w, m in zip(wins, meta))
    k5 = scans * scan_ops + apply
    k6 = (k5 + 3 * sum(w * (intersect_ops(m) + apply_ops(m))
                       for w, m in zip(wins, meta))
          + replayed * (scan_ops + apply / max(sum(wins), 1)))
    return k5, k6


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


def timed(torch, fn):
    """(fn(), the ms of that one call between two CUDA events)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def time_pair(torch, kernel_fn, plain_fn, reps=20, warmup=3):
    """Kernel and plain version in turns (plain, kernel, kernel, plain),
    reps/2 kernel calls per turn after ``warmup``, a fifth as many plain
    calls (at least one) after one warm-up: the plain versions take 10 ms
    to 3 s a call and are a reference, not the measured kernel -> (kernel
    ms median, plain ms median, runs)."""
    half = reps // 2
    plain = max(1, half // 5)
    p1 = time_ms(torch, plain_fn, 1, plain)
    k1 = time_ms(torch, kernel_fn, warmup, half)
    k2 = time_ms(torch, kernel_fn, warmup, half)
    p2 = time_ms(torch, plain_fn, 1, plain)
    k, p = k1 + k2, p1 + p2
    return statistics.median(k), statistics.median(p), k, p


def ext_kernels_vs_plain(rt, torch, ns, flat, kinds, maps, meta, cfg, rays,
                         seed, n_bounces):
    """K1, K2, K5 and K6 in their instantiations with the extended kinds
    (and, on a dispersive table, K2's and K6's with dispersion and the
    wavelength's cotangent) against their plain versions on ``rays`` ->
    dict; raises on a breach.  ``ns`` is the scene as a Scene of
    ``n_bounces``; seeds ``seed + 1`` and ``seed + 2`` draw the cotangents
    of K2 and K6."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    disp = fused_trace.dispersive(meta)
    nmeta, ncfg = ns.static_meta(), ns.sensor_config(cfg.n_bundles)
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps,
                                                ext=True)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta, maps)
    torch.cuda.synchronize()
    res = {'k1': compare(torch, out_k, s_k, out_p, s_p)}
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, rays.px.device,
                                         seed + 1)
    res_k = fused_trace.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=True,
        disp=disp, need_wavelength=disp)
    res_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta, g_rays,
                                            g_mom, maps=maps,
                                            need_wavelength=disp)
    torch.cuda.synchronize()
    res['k2'] = compare_ray_cotangents(torch, res_k[1], res_p[1],
                                       tol=DISP_BWD_TOL if disp else BWD_TOL)
    res['k2'].update(compare_table_cotangents(
        torch, fused_trace, res_k[0], res_p[0], plates=True, ext=True,
        disp=disp))
    check(res['k2']['rows_with_grad'] >= 3, 'too few rows with a table '
          'cotangent')
    if disp:
        res['k2']['wavelength'] = compare_wavelength_cotangents(
            torch, res_k[3], res_p[3])
        dcols = list(fused_trace.DISP_GRAD_COLS)
        res['k2']['disp_rows_with_grad'] = int(
            (res_p[0][:, dcols].abs().sum(1) > 0).sum())
        check(res['k2']['disp_rows_with_grad'] >= 2,
              'too few rows with a dispersion cotangent')
    out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
        flat, kinds, rays, ncfg, n_bounces, maps, ext=True)
    out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays, ncfg, nmeta, n_bounces, maps)
    torch.cuda.synchronize()
    res['k5'] = compare_nonseq(torch, out_k, s_k, out_p, s_p)
    *_, ends = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, ncfg, n_bounces, (None,) * 7, None,
        need_table=False, need_rays=False, replay=True, maps=maps, ext=True,
        disp=disp)
    torch.cuda.synchronize()
    res['k6_replay_equals_k5'] = all(
        torch.equal(getattr(ends, c), getattr(out_k, c))
        for c in fused_trace.COMPS)
    check(res['k6_replay_equals_k5'], "K6's replay ends apart from K5")
    res['k6'] = compare_k6(rt, torch, ns, rays, seed + 2)
    return res


def ext_timing(torch, flat, kinds, maps, meta, cfg, nmeta, ncfg, rays,
               n_bounces):
    """Median CUDA-event ms of K1, K2, K5 and K6 in their instantiations
    with the extended kinds (K2's and K6's with dispersion on a dispersive
    table) against their plain versions at the scene's sizes, with the
    cotangents of a moment loss -> {kernel: dict}."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    from raytracetorch_tpu_torch.ops.fused_trace import dispersive
    disp, no_rays = dispersive(meta), (None,) * 7
    g_mom1 = torch.randn(1, cfg.n_bundles, 7, generator=torch.Generator(
        device=rays.px.device).manual_seed(SEED), device=rays.px.device)
    pairs = {
        'k1': (lambda: fused_trace.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext=True),
            lambda: fused_trace.trace_sequential_fused_plain(
                flat, rays, cfg, meta, maps), 20, 3),
        'k2': (lambda: fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, no_rays, g_mom1, maps=maps, ext=True,
            disp=disp),
            lambda: fused_trace.trace_seq_bwd_plain(
                flat, rays, cfg, meta, no_rays, g_mom1, maps=maps), 20, 3),
        'k5': (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, ncfg, n_bounces, maps, ext=True),
            lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, rays, ncfg, nmeta, n_bounces, maps), 4, 1),
        'k6': (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, ncfg, n_bounces, no_rays, g_mom1, maps=maps,
            ext=True, disp=disp),
            lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, rays, ncfg, nmeta, n_bounces, no_rays, g_mom1,
                maps=maps), 4, 1)}
    out = {}
    for key, (kfn, pfn, reps, warm) in pairs.items():
        k_ms, p_ms, k_runs, p_runs = time_pair(torch, kfn, pfn, reps, warm)
        out[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs,
                        plain_runs=p_runs)
    return out


def counted_path(rt, torch, sc, rays, n_bundles, trained, fwd, bwd, counters,
                 reset_counters, only, label):
    """The forward of ``sc.simulate_fused`` (kernel ``fwd`` once, in the
    instantiation with the extended kinds) and a spot-loss gradient step
    (``fwd`` and ``bwd`` once each) against the eager trace's gradients in
    the leaves ``trained`` ([(element, param)]), the rays' px and, on a
    dispersive scene, their wavelength -> dict with the bundles' spot RMS;
    raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_trace
    dev = rays.px.device
    disp = fused_trace.dispersive(sc.static_meta())
    params = sc.init_params(dev)
    torch.cuda.synchronize()
    reset_counters()
    out, sens, _ = sc.simulate_fused(params, rays, n_bundles)
    torch.cuda.synchronize()
    fwd_launches = counters()
    finite = all(bool(torch.isfinite(getattr(out, c)).all())
                 for c in fused_trace.COMPS)

    def grads(simulate):
        p = sc.init_params(dev)
        for el, k in trained:
            p[el][k].requires_grad_(True)
        r = rays.replace(px=rays.px.clone().requires_grad_(True),
                         wavelength=rays.wavelength.clone()
                         .requires_grad_(disp))
        o, s_, _ = simulate(p, r, n_bundles)
        (rt.spot_size_loss(s_) + (o.px * o.dx).mean()).backward()
        return [p[el][k].grad for el, k in trained], r.px.grad, \
            r.wavelength.grad

    torch.cuda.synchronize()
    reset_counters()
    g_f, rg_f, wg_f = grads(sc.simulate_fused)
    torch.cuda.synchronize()
    grad_launches = counters()
    g_e, rg_e, wg_e = grads(sc.simulate)
    rel = [float(((a - b).abs() / b.abs()).max()) for a, b in zip(g_f, g_e)]
    zeros = torch.zeros_like(rays.px)
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n))
    res = dict(
        fwd_launches=fwd_launches, grad_launches=grad_launches,
        spot_rms=[float(v) for v in sens.spot_rms(0)], finite=finite,
        shape=list(out.pos.shape), grad_fused=[g.tolist() for g in g_f],
        grad_eager=[g.tolist() for g in g_e], rel_err=rel,
        ray_grads=compare_ray_cotangents(
            torch, (rg_f,) + (zeros,) * 6, (rg_e,) + (zeros,) * 6,
            allowed=allowed, tol=DISP_BWD_TOL if disp else BWD_TOL))
    if disp:
        res['wavelength_grads'] = compare_wavelength_cotangents(
            torch, wg_f, wg_e, allowed)
    check(only(fwd_launches, **{fwd: 1, 'ext': 1}),
          f'{label}: the forward launched {fwd_launches}')
    check(only(grad_launches, **{fwd: 1, bwd: 1, 'ext': 2}),
          f'{label}: the grad step launched {grad_launches}')
    check(finite and res['shape'] == [rays.n, 3], f'{label}: bad rays')
    check(max(rel) < GRAD_RTOL,
          f'{label}: fused vs eager gradients differ: {rel}')
    return res


def extended_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 8: benchmarks/suite.py's mixed-surface and asphere scenes,
    sequential and as 12-bounce Scenes, through K1, K2, K5 and K6 in their
    instantiation with the extended kinds: each kernel against its plain
    version at 2,999 and 1M rays; the counted forward and gradient paths
    with the spot anchors and eager gradients; the asphere design of
    tests/test_asphere.py:52-81 through ``simulate_fused``; the renderer at
    1024 x 1024 on the naive and the mixed scene, timed and held to the
    same renderer on the CPU; then the four kernels' times against their
    plain versions, their bounds and their blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_trace
    from raytracetorch_tpu_torch.render.camera import Camera, Renderer
    scenes = {'mixed': (mixed_scene, MIXED_RMS_REF, MIXED_RMS_TOL),
              'asphere': (asphere_scene, ASPH_RMS_REF, ASPH_RMS_TOL)}

    def inputs(make):
        seq, ns = make(rt), make(rt, EXT_BOUNCES)
        meta, cfg = seq.static_meta(), seq.sensor_config()
        check(fused_trace.ext_kinds(meta), 'a scene without an extended kind')
        flat = rt.flatten_table_rows(seq.build_table(seq.init_params(dev)))
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        return (seq, ns, flat, kinds, fused_trace.plate_maps(meta, None),
                meta, cfg, ns.static_meta(), ns.sensor_config())

    # 8a. each kernel against its plain version
    kern = {}
    for case, (make, _, _) in scenes.items():
        seq, ns, flat, kinds, maps, meta, cfg, nmeta, ncfg = inputs(make)
        for n in (N_SMALL, N_MAIN):
            rays = sample_rays(rt, torch, n, dev, SEED + 101 + n)
            kern[f'{case}_{n}'] = ext_kernels_vs_plain(
                rt, torch, ns, flat, kinds, maps, meta, cfg, rays,
                SEED + 101 + n, EXT_BOUNCES)
    emit('ext_kernels_vs_plain', **kern)

    # 8b. the counted paths: forward (K1 or K5 once, with the extended
    # kinds) against the spot anchor, and a gradient step (K1 + K2 or K5 +
    # K6 once each) against the eager trace's gradients, in the leaves of
    # EXT_TRAINED and the rays' px
    paths = {}
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED)
    for case, (make, ref, tol) in scenes.items():
        seq, ns = make(rt), make(rt, EXT_BOUNCES)
        for kind, sc, fwd, bwd in (
                ('sequential', seq, 'trace_seq_fwd', 'trace_seq_bwd'),
                ('scene', ns, 'trace_nonseq_fwd', 'trace_nonseq_bwd')):
            res = counted_path(rt, torch, sc, rays, None, EXT_TRAINED[case],
                               fwd, bwd, counters, reset_counters, only,
                               f'{case} {kind}')
            res['spot_rms_ref'] = ref
            paths[f'{case}_{kind}'] = res
            rms = res['spot_rms'][0]
            check(abs(rms - ref) < tol, f'{case} {kind}: spot rms {rms}')
        check(abs(paths[f'{case}_scene']['spot_rms'][0]
                  - paths[f'{case}_sequential']['spot_rms'][0])
              <= NS_SPOT_RTOL * paths[f'{case}_sequential']['spot_rms'][0],
              f'{case}: the Scene and the sequential trace differ')
    emit('ext_main', n=N_MAIN, **paths)

    # 8c. the asphere design of tests/test_asphere.py:52-81 on the card:
    # Adam on the conic of the reference's singlet through simulate_fused
    dscene = rt.SequentialScene([rt.AsphericLens(
        c1=0.0167, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        k1_grad=True, name='lens')])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    drays = rt.CollimatedDisk.make(radius=8.0,
                                   translation=[0.0, 0.0, -10.0]).sample(
        gen, ASPH_DESIGN_RAYS, dev)
    evals = [0]
    base_loss = design_loss(torch, dscene, drays)

    def loss(p):
        evals[0] += 1
        return base_loss(p)

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    d_opt, d_hist = rt.fit(loss, dscene.init_params(dev),
                           trainable=dscene.trainable(),
                           steps=ASPH_DESIGN_STEPS, lr=ASPH_DESIGN_LR)
    torch.cuda.synchronize()
    d_s = time.perf_counter() - t0
    d_launches = counters()
    l0, lf = float(d_hist[0]), float(d_hist[-1])
    k1 = float(d_opt['lens']['k1'])
    emit('asphere_design', n=ASPH_DESIGN_RAYS, steps=ASPH_DESIGN_STEPS,
         evaluations=evals[0], launches=d_launches, seconds=d_s,
         loss_start=l0, loss_end=lf, loss_share=lf / l0, k1=k1)
    check(only(d_launches, trace_seq_fwd=evals[0], trace_seq_bwd=evals[0],
               ext=2 * evals[0]),
          f'{evals[0]} evaluations launched {d_launches}')
    check(lf < ASPH_DESIGN_SHARE * l0,
          f'asphere design: {l0} -> {lf} (not under {ASPH_DESIGN_SHARE})')
    check(math.isfinite(k1) and k1 != 0.0, f'asphere design: k1 {k1}')

    # 8d. the renderer, benchmarks/suite.py render_1024x1024: the naive
    # scene and the mixed scene (its cylinder's edges), plain torch on the
    # card, timed, and held to the same renderer on the CPU
    cam = Camera(position=[25.0, 18.0, -25.0], look_at=[0.0, 0.0, 10.0],
                 fov_deg=45.0, width=RENDER_SIZE[1], height=RENDER_SIZE[0])
    renders = {}
    for case, sc in (('naive', naive_scene(rt)),
                     ('mixed', mixed_scene(rt, EXT_BOUNCES))):
        r = Renderer(sc)
        p_dev = sc.init_params(dev)
        torch.cuda.synchronize()
        reset_counters()
        img = r.render_3d(p_dev, cam)
        torch.cuda.synchronize()
        launched = counters()
        runs = time_ms(torch, lambda: r.render_3d(p_dev, cam), 2, 10)
        img_cpu = r.render_3d(sc.init_params('cpu'), cam)
        diff = (img.cpu() - img_cpu).abs().amax(-1)
        hit = ~(img_cpu == 1.0).all(-1)
        res = dict(shape=list(img.shape), ms=statistics.median(runs),
                   runs=runs, launches=launched,
                   finite=bool(torch.isfinite(img).all()),
                   hit_share=float(hit.float().mean()),
                   pixels_differ_share=float((diff > RENDER_TOL).float()
                                             .mean()),
                   max_abs_err=float(diff.max()),
                   max_abs_err_agreeing=float(
                       diff[diff <= RENDER_TOL].max()))
        renders[case] = res
        check(res['shape'] == [*RENDER_SIZE, 3] and res['finite']
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
              f'{case}: bad image')
        check(only(launched), f'the renderer launched {launched}')
        check(0.02 < res['hit_share'] < 0.98,
              f'{case}: {res["hit_share"]} of the pixels hit geometry')
        check(res['pixels_differ_share'] <= RENDER_FLIP_SHARE,
              f'{case}: {res["pixels_differ_share"]} of the pixels differ '
              f'from the CPU image')
    emit('render', size=list(RENDER_SIZE), **renders)

    # 8e. times at 1M rays against the plain versions, bounds (this run's
    # work, section 6's method), blocks per SM
    timing, bounds, occ = {}, {}, {}
    n = N_MAIN
    for case, (make, _, _) in scenes.items():
        seq, ns, flat, kinds, maps, meta, cfg, nmeta, ncfg = inputs(make)
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        for key, res in ext_timing(torch, flat, kinds, maps, meta, cfg,
                                   nmeta, ncfg, rays, EXT_BOUNCES).items():
            timing[f'{case}_{key}'] = res
        p = seq.init_params(dev)
        p_grad = seq.init_params(dev)
        for el, k in EXT_TRAINED[case]:
            p_grad[el][k].requires_grad_(True)

        def step(sc):
            def run():
                _, s_, _ = sc.simulate_fused(p_grad, rays)
                rt.spot_size_loss(s_).backward()
            return run
        for key, fn in (('simulate_fused', lambda: seq.simulate_fused(p,
                                                                       rays)),
                        ('grad_step_fused', step(seq)),
                        ('scene_simulate_fused', lambda: ns.simulate_fused(
                            p, rays)),
                        ('scene_grad_step_fused', step(ns))):
            runs = time_ms(torch, fn)
            timing[f'{case}_{key}_ms'] = statistics.median(runs)
            timing[f'{case}_{key}_runs'] = runs
        k1_ops = n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
        scans, wins, lives = nonseq_work(rt, torch, ns, p, rays)
        k5_ops, k6_ops = nonseq_ops(nmeta, scans, wins,
                                    segment_replays(lives))
        io = n * (32 + 28) + table_bytes(meta)
        cols = len(fused_trace.EXT_GRAD_COLS) * 4 * len(meta)
        bounds[case] = {k: dict(zip(('bound_ms', 'bound_by'), v)) for k, v in {
            'k1': bound(io, k1_ops), 'k2': bound(io + cols, 3 * k1_ops),
            'k5': bound(io, k5_ops), 'k6': bound(io + cols, k6_ops)}.items()}
        bounds[case].update(k1_ops=k1_ops, k5_row_scans=scans,
                            k5_winners_per_row=wins, k5_ops=k5_ops,
                            k6_ops=k6_ops)
        for lib, sc in (('trace_seq_fwd', seq), ('trace_seq_bwd', seq),
                        ('trace_nonseq_fwd', ns), ('trace_nonseq_bwd', ns)):
            occ[f'{lib}_{case}'] = fused_trace.blocks_per_sm(
                lib, len(sc.static_meta()), sc.sensor_config(), True,
                sc.n_bounces, ext=True)
    emit('ext_timing', **timing)
    emit('ext_bounds', n=n, **bounds)
    emit('ext_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds)


DISP_CASES = ('achromat_abbe', 'achromat_sellmeier', 'cooke')
# The leaves each dispersive scene's gradient phases train: the
# achromat's curvatures and (Abbe: their Cauchy B depends on it) its glass
# indices, a curvature of each of the triplet's lenses
DISP_TRAINED = {
    'achromat_abbe': (('achromat', 'c1'), ('achromat', 'c2'),
                      ('achromat', 'c3'), ('achromat', 'ior_glass1'),
                      ('achromat', 'ior_glass2')),
    'achromat_sellmeier': (('achromat', 'c1'), ('achromat', 'c2'),
                           ('achromat', 'c3')),
    'cooke': (('crown_front', 'c1'), ('flint', 'c2'), ('crown_rear', 'c2'))}


def disp_case(rt, case, n_bounces=None):
    """(scene, bundle maker, bundles) of a DISP_CASES name; with
    ``n_bounces`` the scene is a Scene."""
    if case == 'cooke':
        return cooke_scene(rt, n_bounces), cooke_bundles, 6
    return (achromat_scene(rt, case.split('_')[1], n_bounces),
            lambda rt_, n: achromat_bundles(rt_, n // 2), 2)


def disp_rays(rt, torch, case, n, device, seed):
    """About n seeded rays of a DISP_CASES scene's bundles."""
    _, bundles, _ = disp_case(rt, case)
    gen = torch.Generator(device=device).manual_seed(seed)
    return rt.sample_bundles(gen, bundles(rt, n), device)


def axis_crossings(rt, torch, scene, params, device, height=0.1):
    """The z at which a ray at ``height`` parallel to the axis crosses it
    behind the scene, at the F, d and C lines: one fused trace of 3 rays."""
    rays = rt.Rays.create([[0.0, height, -10.0]] * 3, [[0.0, 0.0, 1.0]] * 3,
                          wavelength=[F_LINE, D_LINE, C_LINE], device=device)
    out, _, _ = scene.simulate_fused(params, rays)
    t = -out.py / out.dy
    return [float(v) for v in out.pz + t * out.dz]


def dispersion_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 9: chromatic dispersion.  The achromat (Abbe and Sellmeier
    glasses) and the Sellmeier Cooke triplet, sequential and as 12-bounce
    Scenes, through K1, K2, K5 and K6 in their instantiation with the
    extended kinds: each kernel against its plain version at 2,999 and 1M
    rays (K2 and K6 with the wavelength's cotangent and the disp columns);
    the counted forward and gradient paths with the JAX anchors (the
    triplet's spot RMS per bundle, the achromat's axis crossings) and the
    eager gradients, the wavelength's included; the achromat designs by
    fit_lbfgs at 1M rays (K1 and K2 once per evaluation); then the four
    kernels' times against their plain versions, K1 and K5 against the same
    achromat with constant indices (the main path's instantiations), the
    entry points, bounds and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

    def inputs(case):
        seq, _, nb = disp_case(rt, case)
        ns = disp_case(rt, case, DISP_BOUNCES)[0]
        meta = seq.static_meta()
        check(fused_trace.ext_kinds(meta) and fused_trace.dispersive(meta),
              f'{case}: not a dispersive scene')
        cfg = seq.sensor_config(nb)
        flat = rt.flatten_table_rows(seq.build_table(seq.init_params(dev)))
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        return (seq, ns, nb, flat, kinds, fused_trace.plate_maps(meta, None),
                meta, cfg, ns.static_meta(), ns.sensor_config(nb))

    # 9a. each kernel against its plain version
    kern = {}
    for case in DISP_CASES:
        seq, ns, nb, flat, kinds, maps, meta, cfg, nmeta, ncfg = inputs(case)
        for n in (N_SMALL, N_MAIN):
            rays = disp_rays(rt, torch, case, n, dev, SEED + 201 + n)
            kern[f'{case}_{n}'] = ext_kernels_vs_plain(
                rt, torch, ns, flat, kinds, maps, meta, cfg, rays,
                SEED + 201 + n, DISP_BOUNCES)
    emit('disp_kernels_vs_plain', **kern)

    # 9b. the counted paths: forward (K1 or K5 once) against the JAX
    # anchors, a gradient step (K1 + K2 or K5 + K6 once each) against the
    # eager trace's gradients in DISP_TRAINED, the rays' px and wavelength
    paths = {}
    for case in DISP_CASES:
        seq, _, nb = disp_case(rt, case)
        ns = disp_case(rt, case, DISP_BOUNCES)[0]
        rays = disp_rays(rt, torch, case, N_MAIN, dev, SEED)
        for kind, sc, fwd, bwd in (
                ('sequential', seq, 'trace_seq_fwd', 'trace_seq_bwd'),
                ('scene', ns, 'trace_nonseq_fwd', 'trace_nonseq_bwd')):
            res = counted_path(rt, torch, sc, rays, nb, DISP_TRAINED[case],
                               fwd, bwd, counters, reset_counters, only,
                               f'{case} {kind}')
            paths[f'{case}_{kind}'] = res
            if case == 'cooke':
                rms = res['spot_rms']
                res.update(spot_rms_ref=list(COOKE_RMS_REF),
                           spot_rms_tol=list(COOKE_RMS_TOL))
                check(all(abs(a - b) < t for a, b, t in zip(
                    rms, COOKE_RMS_REF, COOKE_RMS_TOL)),
                      f'cooke {kind}: spot rms {rms}')
        if case != 'cooke':
            model = case.split('_')[1]
            reset_counters()
            cross = axis_crossings(rt, torch, seq, seq.init_params(dev), dev)
            torch.cuda.synchronize()
            paths[f'{case}_crossings'] = dict(
                z=cross, ref=list(ACHROMAT_CROSS_REF[model]), tol=CROSS_TOL,
                launches=counters())
            check(all(abs(a - b) < CROSS_TOL for a, b in zip(
                cross, ACHROMAT_CROSS_REF[model])),
                  f'{case}: axis crossings {cross}')
        check(all(abs(a - b) <= NS_SPOT_RTOL * b for a, b in zip(
            paths[f'{case}_scene']['spot_rms'],
            paths[f'{case}_sequential']['spot_rms'])),
              f'{case}: the Scene and the sequential trace differ')
    emit('disp_main', n=N_MAIN, **paths)

    # 9c. the achromat designs at full width: fit_lbfgs on the two-colour
    # doublet through simulate_fused with the loss of
    # tests/test_dispersion.py:76-83; the F-to-C gap of a ray at height 2
    designs = {}
    for model, (steps, share) in ACHROMAT_DESIGN.items():
        dscene = achromat_scene(rt, model, grad=True)
        gen = torch.Generator(device=dev).manual_seed(SEED + 211)
        drays = rt.sample_bundles(gen, achromat_bundles(rt), dev)
        evals = [0]
        base_loss = design_loss(torch, dscene, drays, ACHROMAT_Z)

        def loss(p, base_loss=base_loss, evals=evals):
            evals[0] += 1
            return base_loss(p)

        def gap(p, dscene=dscene):
            with torch.no_grad():
                z = axis_crossings(rt, torch, dscene, p, dev, height=2.0)
            return abs(z[0] - z[2])

        p0 = dscene.init_params(dev)
        gap0 = gap(p0)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        p1, hist = rt.fit_lbfgs(loss, p0, trainable=dscene.trainable(),
                                steps=steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = counters()
        gap1 = gap(p1)
        designs[model] = dict(
            n=drays.n, steps=steps, evaluations=evals[0], launches=launched,
            seconds=seconds, gap_start=gap0, gap_end=gap1,
            gap_share=gap1 / gap0, gap_share_max=share,
            loss_start=float(hist[0]), loss_end=float(hist[-1]),
            curvatures=[float(p1['achromat'][c]) for c in ('c1', 'c2', 'c3')])
        check(only(launched, trace_seq_fwd=evals[0], trace_seq_bwd=evals[0],
                   ext=2 * evals[0]),
              f'{model} design: {evals[0]} evaluations launched {launched}')
        check(gap1 < share * gap0,
              f'{model} achromat: gap {gap0} -> {gap1} (not under {share})')
        check(float(hist[-1]) < float(hist[0]), f'{model} design: no gain')
    emit('achromat_design', **designs)

    # 9d. times at 1M rays against the plain versions; K1 and K5 against
    # the same achromat with constant indices (their main-path
    # instantiations; K5 keeps its packed scan records there); bounds
    # (this run's work, section 6's method), blocks per SM
    timing, bounds, occ = {}, {}, {}
    for case in DISP_CASES:
        seq, ns, nb, flat, kinds, maps, meta, cfg, nmeta, ncfg = inputs(case)
        rays = disp_rays(rt, torch, case, N_MAIN, dev, SEED + 1)
        for key, res in ext_timing(torch, flat, kinds, maps, meta, cfg,
                                   nmeta, ncfg, rays, DISP_BOUNCES).items():
            timing[f'{case}_{key}'] = res
        p = seq.init_params(dev)
        p_grad = seq.init_params(dev)
        for el, k in DISP_TRAINED[case]:
            p_grad[el][k].requires_grad_(True)

        def step(sc):
            def run():
                _, s_, _ = sc.simulate_fused(p_grad, rays, nb)
                rt.spot_size_loss(s_).backward()
            return run
        for key, fn in (('simulate_fused',
                         lambda: seq.simulate_fused(p, rays, nb)),
                        ('grad_step_fused', step(seq)),
                        ('scene_simulate_fused',
                         lambda: ns.simulate_fused(p, rays, nb)),
                        ('scene_grad_step_fused', step(ns))):
            runs = time_ms(torch, fn)
            timing[f'{case}_{key}_ms'] = statistics.median(runs)
            timing[f'{case}_{key}_runs'] = runs
        k1_ops = rays.n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
        scans, wins, lives = nonseq_work(rt, torch, ns, p, rays)
        k5_ops, k6_ops = nonseq_ops(nmeta, scans, wins,
                                    segment_replays(lives))
        # 8 input streams and the wavelength (36 B), 7 outputs (28 B)
        io = rays.n * (36 + 28) + table_bytes(meta)
        cols = (len(fused_trace.EXT_GRAD_COLS)
                + len(fused_trace.DISP_GRAD_COLS)) * 4 * len(meta)
        bounds[case] = {k: dict(zip(('bound_ms', 'bound_by'), v)) for k, v in {
            'k1': bound(io, k1_ops), 'k2': bound(io + cols, 3 * k1_ops),
            'k5': bound(io, k5_ops), 'k6': bound(io + cols, k6_ops)}.items()}
        bounds[case].update(k1_ops=k1_ops, k5_row_scans=scans,
                            k5_winners_per_row=wins, k5_ops=k5_ops,
                            k6_ops=k6_ops, n=rays.n)
        for lib, sc in (('trace_seq_fwd', seq), ('trace_seq_bwd', seq),
                        ('trace_nonseq_fwd', ns), ('trace_nonseq_bwd', ns)):
            occ[f'{lib}_{case}'] = fused_trace.blocks_per_sm(
                lib, len(sc.static_meta()), sc.sensor_config(nb), True,
                sc.n_bounces, ext=True, disp=True)
    # the cost of dispersion: K1 and K5 on the Abbe achromat against the
    # same doublet with constant d-line indices (no extended kind)
    const = {}
    for name, model in (('dispersive', 'abbe'), ('constant', 'const')):
        if model == 'const':
            els = achromat_scene(rt).elements
            glass = {k: v for k, v in ACHROMAT_ABBE.items()
                     if k.startswith('ior')}
            seq = rt.SequentialScene([rt.DoubletLens(
                **ACHROMAT_KW, **glass, name='achromat'), els[1]])
        else:
            seq = achromat_scene(rt)
        ns = rt.Scene(seq.elements, n_bounces=DISP_BOUNCES)
        meta, cfg = seq.static_meta(), seq.sensor_config(2)
        ext = fused_trace.ext_kinds(meta)
        maps = fused_trace.plate_maps(meta, None)
        flat = rt.flatten_table_rows(seq.build_table(seq.init_params(dev)))
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        rays = disp_rays(rt, torch, 'achromat_abbe', N_MAIN, dev, SEED + 1)
        const[name] = dict(
            ext=ext,
            k1_ms=statistics.median(time_ms(
                torch, lambda: fused_trace.trace_seq_fwd_cuda(
                    flat, kinds, rays, cfg, maps, ext))),
            k5_ms=statistics.median(time_ms(
                torch, lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                    flat, kinds, rays, ns.sensor_config(2), DISP_BOUNCES,
                    maps, ext))))
    timing['achromat_dispersive_vs_constant'] = const
    emit('disp_timing', **timing)
    emit('disp_bounds', **bounds)
    emit('disp_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, designs=designs, timing=timing,
                bounds=bounds)


# Section 10: the deterministic streams.  Anchors from the JAX package
# (tests/wavefront_anchors.py, on the CPU): the bench singlet's refocused
# RMS wavefront error, its defocus and spherical Zernike terms over the
# launch pupil (r = 4) and its final media, on 1M rays of the reference's
# threefry draws (rays/reference_prng.py), both packages tracing the same
# rays (WF_RMS_RTOL, WF_ZERNIKE_TOL: float32 OPLs of ~30 summed in another
# order; the plain versions' own agreement with the JAX package,
# tests/test_torch_wavefront.py); tests/test_wavefront.py's axial OPL; the
# footprint r_max of the Cooke triplet's faces, stop and sensor at 1M rays
# (the mean over four PRNG keys, 6 standard deviations); the wavefront
# design's loss before and after (fit_lbfgs, 20 steps, c1 and c2): the
# start on the same rays to WF_RMS_RTOL, the end within WF_DESIGN_TOL of
# the JAX run's, both at the float32 floor of the RMS where the two
# optimizers' line searches stop (the JAX run ends at 2.5e-5, and its
# 20,000-ray run's loss jitters between 1.4e-5 and 4.9e-5 over its last
# steps; the two L-BFGS line searches end at other points of a flat
# valley: WF_DESIGN_REF's curvatures are reported, not bounded).
WF_PUPIL = 4.0
WF_BENCH_REF = {'rms': 0.000989, 'zernike': (0.00217499, -0.0021453),
                'n_final': (1.0,)}
WF_RMS_RTOL, WF_RMS_ATOL = 2e-3, 5e-6
WF_ZERNIKE_TOL = 2e-3
AXIAL_OPL_REF = 8.0 + 1.5168 * 4.0
COOKE_FACE_ROWS = (0, 1, 3, 4, 6, 7, 8, 10)
COOKE_RMAX_REF = (6.166214, 5.763087, 4.0932, 3.919939, 4.152991, 4.73311,
                  4.947919, 5.58179)
COOKE_RMAX_TOL = (0.00184, 0.002017, 0.00191, 0.001893, 0.001536, 0.003274,
                  0.003429, 0.000662)
WF_DESIGN_STEPS = 20
WF_DESIGN_REF = (0.000989, 2.537e-05, 0.02494481, -0.00352133)
WF_DESIGN_TOL = 3e-5
# Kernel against plain version: the optical path length within OPL_RTOL of
# (1 + |plain|) (float32 n t over up to 11 rows, the kernel contracting
# multiply-adds: ~8 ulps of an OPL of ~110 measured on the card); the
# records within POS_TOL of 1 + the ray's world scale (the largest |value|
# of its records), as ``compare`` holds positions: a surface-frame hit
# inherits the rounding of the world-frame position and t it comes from
# (on the Cooke triplet 1.3e-4 absolute at a world scale of ~60, measured);
# the raw hit of a row that took no weight (a miss: the root of a quadric
# whose leading coefficient can all but vanish, a ray nearly parallel to an
# edge cylinder's axis, lying hundreds of mm out) within RAW_HIT_RTOL of
# that scale (1.3e-2 worst on 3M such entries of the Cooke triplet at 1M
# rays, one entry over 1e-2); the medium, the hit weights and slots equal.
# A ray off in any of them counts as flipped (FLIPS_PER_MILLION, as
# ``compare``).
OPL_RTOL = 2e-6
RAW_HIT_RTOL = 1e-2


# ---- Section 11: Fresnel physics and the random draws ----
#
# The bench scene with its singlet's faces FRESNEL (``fresnel=True``) or
# FRESNEL_W (``'weighted'``), the naive scene with a FRESNEL singlet, and
# the ghosts of the plane window and of the Cooke triplet.  The JAX anchors
# come from tests/fresnel_anchors.py (the JAX package on the CPU at N_MAIN
# rays of the reference's threefry draws; the sequential ones with the
# reference's very Fresnel uniforms, rays/reference_prng.fresnel_uniforms,
# the non-sequential one with its XLA loop's fold_in draws, which the port's
# counter-based draws do not reproduce).
#
# Tolerances: a ray whose uniform lies within an ulp or two of R takes the
# other branch on the card (FMA contraction of R) or in another package, so
# FRESNEL_FLIPS rays of 1M may differ from the JAX anchor's (the port against
# its plain version: FLIPS_PER_MILLION, as elsewhere); the flipped share
# moves the forward fraction by at most FRESNEL_FLIPS / N and the spot RMS by
# at most ~FRESNEL_FLIPS / N of its value (held at FRESNEL_RMS_RTOL);
# FRESNEL_W's mean intensity is a mean of float32 products at rtol 1e-5;
# the non-sequential sensor share within FRESNEL_NS_SIGMAS binomial sigmas
# of the difference of two independent estimates (other draws by design).
FRESNEL_FLIPS = 20
# FRESNEL_W's and REFLECT_W's weights are products of R or 1 - R, which the
# card rounds otherwise (FMA contraction of R's two quotients): each factor
# carries a few ulps, the 27-row Cooke ghost's product ~20 factors, well
# inside 1e-5 relative (kernel against plain)
FRESNEL_I_RTOL = 1e-5
# The Cooke ghost's path runs 27 rows (the other scenes at most 11), its
# two reflections turning the beam back and forth: at 1M rays 14 rays
# ended between 1.0 and 1.25 POS_TOL of their world scale from the plain
# version's (H100, 1M rays), beside 5 rays that part at a bound's rim
# (``flip_margins``: margins 1e-7 to 6e-6); its positions, and only its,
# are held at twice POS_TOL of that scale
GHOST_POS_TOL = 2 * POS_TOL
FRESNEL_RMS_RTOL = 1e-4
FRESNEL_W_RTOL = 1e-5
FRESNEL_NS_SIGMAS = 5.0
# tests/fresnel_anchors.py (the JAX package on the CPU, N_MAIN rays)
FRESNEL_SEQ_REF = {'forward': 0.92144, 'mean_intensity': 1.0,
                   'sensor_share': 0.92144, 'spot_rms': 0.16907466}
FRESNEL_W_REF = {'forward': 1.0, 'mean_intensity': 0.92145248,
                 'sensor_share': 1.0, 'spot_rms': 0.16907028}
FRESNEL_NS_REF = 0.922074
# the Cooke triplet's ghost of its first face and its last lens's back face:
# 27 rows, beyond K2's 8 rows of saved states in shared memory
COOKE_GHOST = (0, 8)
# the seeds of the section's draws (the sequential streams' generator, the
# non-sequential Philox key)
FRESNEL_SEED = SEED + 1201
FRESNEL_KEY = (0x2545F491, 0x9E3779B9)
# a FRESNEL, FRESNEL_W or REFLECT_W row's physics beyond SNELL's: the
# reflectance (2 divisions, ~20 more operations) and the weight's clip
FRESNEL_OPS = 22
# the counter-based draw of a FRESNEL winner (K5, K6): 10 Philox rounds of
# 2 high and 2 low 32-bit products, 4 XORs, 2 key additions, counted at
# the float32 rate
PHILOX_OPS = 100
# the window ghost's closed form: normal incidence on n = 1.5, R = 0.04
WINDOW_R = ((1.0 - 1.5) / 2.5) ** 2
WINDOW_GHOST = (1.0 - WINDOW_R) ** 2 * WINDOW_R ** 2


# ---- Section 12: thin-film coatings and metal mirrors ----
#
# The bench singlet with a quarter-wave MgF2 coat on both faces (its
# thickness trainable), in FRESNEL_W and FRESNEL; the naive scene with it;
# example 11's telescope (a parabolic aluminium primary under an enhancing
# pair, a Sellmeier corrector, 8 bounces); the stress rows (an 8-layer
# stack with a silver film on a FRESNEL_W singlet, a dispersive gold mirror
# lit at 0.45 and 0.70 um, a Mangin mirror with an aluminium back); and
# example 29's classical Cassegrain (ideal conic mirrors: the main path's
# instantiation).  The JAX anchors come from tests/coating_anchors.py (the
# JAX package on the CPU, on the reference's threefry rays and, with
# fresnel=True, its very uniforms).
COAT_NC = 1.38
COAT_QW = 0.5876 / (4 * COAT_NC)
# the quarter-wave coat's normal-incidence reflectance on the bench glass
COAT_R_QW = ((1.5 - COAT_NC ** 2) / (1.5 + COAT_NC ** 2)) ** 2
COAT_SEED = SEED + 1301
# example 11: the enhancing pair (ZnS-like high, MgF2 low, quarter waves),
# the detuned start of its design, its rays and steps
TELESCOPE_WL = 0.5876
TELESCOPE_PAIR = ((2.35, TELESCOPE_WL / (4 * 2.35)),
                  (1.38, TELESCOPE_WL / (4 * 1.38)))
TELESCOPE_START = (0.05, 0.08)
TELESCOPE_RAYS = 100_000
TELESCOPE_STEPS = 300
# the stress rows' 8-layer stack: three high-low quarter-wave pairs, a high
# layer and a 10 nm silver film next to the glass
STRESS_STACK = ((2.35, TELESCOPE_WL / (4 * 2.35)),
                (1.38, TELESCOPE_WL / (4 * 1.38))) * 3 + (
                    (2.35, TELESCOPE_WL / (4 * 2.35)), ('Ag', 0.01))
STRESS_CASES = ('stack8', 'gold', 'mangin')
# example 29's classical Cassegrain: primary f 50 at z 100, secondary 40
# inside it with magnification 5 (R2 = -25, k2 = -2.25), back focus z 110
CASS_F1, CASS_SEP, CASS_MAG = 50.0, 40.0, 5.0


def coated_scene(rt, mode, n_bounces=None):
    """The bench scene with its singlet under a quarter-wave MgF2 coat on
    both faces (``coat_d`` trainable) in Fresnel ``mode``; with
    ``n_bounces`` the naive scene (a Scene with its 256 x 256 grid)."""
    els = [rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                          ior_media=1.0, fresnel=mode,
                          coating=[(COAT_NC, COAT_QW)], coating_grad=True,
                          name='lens'),
           rt.CircularAperture(radius=5.0, name='stop'),
           rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                            name='sensor')]
    if n_bounces is None:
        return rt.SequentialScene(els)
    scene = rt.Scene(els, n_bounces=n_bounces)
    scene.grid_shape, scene.grid_half_extent = GRID, GRID_E
    return scene


def telescope_scene(rt, mirrors, glass, coating=None,
                    n_bounces=NS_BOUNCES):
    """examples/11_telescope_metal_optics.py's scene: the f = 500 parabolic
    aluminium primary (``coating`` on it, trainable), the N-BK7 Sellmeier
    corrector (``glass``: the package's utils/glass.py::glass) and the
    sensor near prime focus (``mirrors``: the package's mirror module)."""
    return rt.Scene([
        mirrors.ParabolicMirror(c1=-0.001, d=200.0,
                                translation=[0, 0, 500.0], metal='Al',
                                coating=coating, coating_grad=True,
                                name='primary'),
        rt.SingletLens(c1=0.0004, c2=-0.0004, d=120.0, t=5.0,
                       translation=[0, 0, 100.0], name='corrector',
                       **glass('N-BK7', model='sellmeier')),
        rt.SensorElement(radius=40.0, translation=[0, 0, 1.0], name='ccd'),
    ], n_bounces=n_bounces)


def stress_scene(rt, mirrors, name, n_bounces=None):
    """A stress row's scene (``mirrors``: the package's mirror module):
    'stack8' the bench singlet, FRESNEL_W, under STRESS_STACK on both
    faces; 'gold' a dispersive gold spherical mirror; 'mangin' a Mangin
    mirror with an aluminium back (tests/test_conic_mirror.py's); each
    with a sensor, and with ``n_bounces`` as a Scene."""
    if name == 'stack8':
        els = [rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0,
                              ior_glass=1.5, fresnel='weighted',
                              coating=list(STRESS_STACK), coating_grad=True,
                              name='lens'),
               rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                                name='sensor')]
    elif name == 'gold':
        els = [mirrors.SphericalMirror(c1=-0.01, d=40.0, metal='Au',
                                       metal_dispersion=True,
                                       translation=[0, 0, 50.0],
                                       name='mirror'),
               rt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                                name='sensor')]
    else:
        els = [mirrors.ManginMirror(c1=-0.02, c2=-0.025, d=30.0, t=4.0,
                                    ior_glass=1.5168, metal='Al',
                                    translation=[0, 0, 60.0],
                                    name='mirror'),
               rt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                                name='sensor')]
    if n_bounces is None:
        return rt.SequentialScene(els)
    return rt.Scene(els, n_bounces=n_bounces)


def stress_bundles(rt, name, n):
    """[(bundle, n)] of a stress row: the bench disk; the gold mirror's two
    bundles at 0.45 and 0.70 um (tests/test_coatings.py:507-521); a disk of
    radius 10 on the Mangin mirror."""
    if name == 'stack8':
        return [(rt.CollimatedDisk.make(radius=4.0,
                                        translation=[0.0, 0.0, -10.0]), n)]
    if name == 'gold':
        return [(rt.CollimatedDisk.make(radius=15.0, ray_id=j,
                                        wavelength=wl,
                                        translation=[0.0, 0.0, -3.0]),
                 n // 2) for j, wl in enumerate((0.45, 0.70))]
    return [(rt.CollimatedDisk.make(radius=10.0,
                                    translation=[0.0, 0.0, -3.0]), n)]


def cassegrain_scene(rt, mirrors, k1=-1.0):
    """examples/29_cassegrain_telescope.py's classical Cassegrain: a
    parabolic primary (conic constant ``k1``) and the stigmatic hyperbolic
    secondary (ideal reflectors, conic constants trainable), the sensor at
    the back focus."""
    a = CASS_F1 - CASS_SEP
    b = CASS_MAG * a
    c2 = 1.0 / (2.0 / (1.0 / b - 1.0 / a))
    k2 = -((CASS_MAG + 1.0) / (CASS_MAG - 1.0)) ** 2
    z_p, z_s = 100.0, 100.0 - CASS_SEP
    return rt.SequentialScene([
        mirrors.ConicMirror(c1=-1.0 / (2 * CASS_F1), k=k1, d=60.0,
                            k_grad=True, translation=[0, 0, z_p],
                            name='primary'),
        mirrors.ConicMirror(c1=c2, k=k2, d=16.0, k_grad=True,
                            translation=[0, 0, z_s], name='secondary'),
        rt.SensorElement(radius=5.0, translation=[0, 0, z_s + b],
                         name='img')])




def with_fresnel(scene, mode):
    """``scene`` (either package's) with every lens's optical faces in the
    Fresnel ``mode`` (True: FRESNEL, 'weighted': FRESNEL_W)."""
    for el in scene.elements:
        if hasattr(el, '_refract_kind'):
            el.fresnel = mode
    scene._static_meta = None
    return scene


def fresnel_scene(rt, mode, n_bounces=None):
    """The bench scene with its singlet in Fresnel ``mode``; with
    ``n_bounces`` the naive scene (a Scene with its 256 x 256 grid)."""
    sc = (bench_scene(rt) if n_bounces is None
          else naive_scene(rt, n_bounces=n_bounces))
    return with_fresnel(sc, mode)


def window_scene(rt):
    """tests/test_ghosts.py's plane-parallel n = 1.5 window and a sensor
    behind it."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.0, c2=0.0, d=10.0, t=3.0, ior_glass=1.5,
                       name='win'),
        rt.SensorElement(radius=8.0, translation=[0.0, 0.0, 10.0],
                         name='sensor')])


def fresnel_stats(dz, intensity, moments):
    """The anchors' statistics of a Fresnel trace, from numpy arrays: the
    share of rays going forward (dz > 0), the mean intensity, the sensor's
    share of rays (moment w > 0 over N) and the spot RMS of slot 0, bundle
    0 (float64)."""
    import numpy as np
    m = np.asarray(moments, np.float64)[0, 0]
    w = max(m[0], 1e-12)
    var = (m[3] / w - (m[1] / w) ** 2) + (m[4] / w - (m[2] / w) ** 2)
    n = len(dz)
    return dict(forward=float((np.asarray(dz) > 0).sum()) / n,
                mean_intensity=float(np.asarray(intensity, np.float64)
                                     .mean()),
                sensor_share=float(m[6]) / n,
                spot_rms=float(np.sqrt(max(var, 1e-24))))


def compare_streams(torch, aux_k, aux_p):
    """The streams of K1 or K5 against their plain versions' -> dict;
    raises on a breach (module notes: OPL_RTOL, POS_TOL, RAW_HIT_RTOL)."""
    n = aux_p['opl'].shape[0] if 'opl' in aux_p else aux_p['paths'].shape[1]
    bad = torch.zeros(n, dtype=torch.bool, device=next(iter(
        aux_p.values())).device)
    worst, raw = {}, None
    if 'paths' in aux_p:
        world = 1.0 + torch.nan_to_num(aux_p['paths'].abs(),
                                       nan=0.0).amax(-1).amax(0)
    for key, p in aux_p.items():
        k = aux_k[key]
        check(tuple(k.shape) == tuple(p.shape) and k.dtype == p.dtype,
              f'stream {key}: {tuple(k.shape)} {k.dtype} against '
              f'{tuple(p.shape)} {p.dtype}')
        err = (k.float() - p.float()).abs()
        worst[key] = float(torch.nan_to_num(err, nan=0.0).max())
        nan_ok = torch.isnan(k) == torch.isnan(p)
        if key in ('paths', 'hits'):
            # each record within POS_TOL of 1 + the trace's world scale (the
            # largest |component| of the record, and of the ray's recorded
            # positions: a surface-frame hit inherits the rounding of the
            # world-frame position and t it is computed from)
            scale = 1.0 + torch.nan_to_num(p.abs(), nan=0.0).amax(-1)
            if 'paths' in aux_p:
                scale = torch.maximum(scale, world)
            rel = torch.nan_to_num(err, nan=0.0).amax(-1) / scale
            ok = (rel <= POS_TOL) & nan_ok.all(-1)
            if key == 'hits':
                # a row's raw hit where the row took no weight: a miss's
                # root, possibly ill-conditioned (module notes)
                missed = aux_p['hit_weights'] == 0
                raw = dict(entries=int(missed.sum()),
                           over_pos_tol=int((missed & (rel > POS_TOL))
                                            .sum()),
                           over_raw_rtol=int((missed & (rel > RAW_HIT_RTOL))
                                             .sum()),
                           max_rel=float(rel[missed].max())
                           if bool(missed.any()) else 0.0,
                           hit_max_rel=float(rel[~missed].max())
                           if bool((~missed).any()) else 0.0)
                ok = ok | (missed & (rel <= RAW_HIT_RTOL) & nan_ok.all(-1))
            ok = ok.all(0)
        elif key == 'opl':
            ok = torch.isclose(k, p, rtol=OPL_RTOL, atol=OPL_RTOL)
        else:
            ok = (k == p).all(0) if k.dim() > 1 else k == p
        bad |= ~ok
    n_flip = int(bad.sum())
    allowed = math.ceil(FLIPS_PER_MILLION * n / 1e6)
    res = dict(stream_flipped=n_flip, stream_flips_allowed=allowed,
               stream_max_abs_err=worst)
    if raw is not None:
        res['raw_hits'] = raw
    check(n_flip <= allowed,
          f'{n_flip} rays have other streams (allowed {allowed}): {res}')
    return res


def stream_case(rt, torch, name, n, device, seed, n_bounces=None):
    """(scene, params, rays, bundles) of a section 10 case: the bench
    singlet, the 256 x 256 ring-former plate, the Sellmeier achromat, the
    Cooke triplet; with ``n_bounces`` their Scene (the bench singlet: the
    naive scene), or the mirror fold (``name`` 'fold')."""
    if name == 'fold':
        sc = mirror_fold_scene(rt)
        return (sc, sc.init_params(device),
                mirror_fold_rays(rt, torch, n, device, seed), 1)
    if name == 'ring':
        sc = ring_scene(rt, bounces=n_bounces)
        return (sc, ring_params(sc, device),
                ring_rays(rt, torch, n, device, seed), 1)
    if name == 'bench':
        sc = bench_scene(rt) if n_bounces is None else naive_scene(rt)
        return sc, sc.init_params(device), sample_rays(
            rt, torch, n, device, seed), 1
    sc, _, nb = disp_case(rt, name, n_bounces)
    return sc, sc.init_params(device), disp_rays(rt, torch, name, n, device,
                                                 seed), nb


def stream_inputs(rt, torch, sc, params, nb):
    """(meta, cfg, flat, kinds, maps, ext, disp) of a scene's fused
    launch."""
    from raytracetorch_tpu_torch.ops import fused_trace
    meta, cfg = sc.static_meta(), sc.sensor_config(nb)
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=flat.device)
    grids = {k: v.detach() for k, v in sc.side_grids(params).items()}
    return (meta, cfg, flat, kinds, fused_trace.plate_maps(meta, grids),
            fused_trace.ext_kinds(meta), fused_trace.dispersive(meta))


def stream_kernels_vs_plain(rt, torch, name, n, device, seed, records,
                            nonseq=False):
    """K1 and K2 (``nonseq``: K5 and K6) in their instantiations with the
    streams against their plain versions: the rays, moments and streams
    (``records``: the path and hit records too), and the ray, table and
    map cotangents under seeded cotangents of the rays, moments, opl and
    n_final -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, nb = stream_case(rt, torch, name, n, device, seed,
                                       NS_BOUNCES if nonseq else None)
    meta, cfg, flat, kinds, maps, ext, disp = stream_inputs(
        rt, torch, sc, params, nb)
    flags = dict(track_opl=True, record_paths=records, record_hits=records)
    if nonseq:
        nbn = sc.n_bounces
        out_k, s_k, aux_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nbn, maps, ext, **flags)
        out_p, s_p, aux_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nbn, maps, **flags)
        torch.cuda.synchronize()
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
    else:
        out_k, s_k, aux_k = fused_trace.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, **flags)
        out_p, s_p, aux_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, **flags)
        torch.cuda.synchronize()
        res = compare(torch, out_k, s_k, out_p, s_p)
    res.update(compare_streams(torch, aux_k, aux_p))
    if records:
        return res
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    g_opl, g_nf = (torch.randn(rays.n, generator=gen, device=device)
                   for _ in range(2))
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nbn, g_rays, g_mom, g_grid=g_grid,
            maps=maps, ext=ext, disp=disp, g_opl=g_opl, g_nfinal=g_nf,
            opl=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nbn, g_rays, g_mom, g_grid=g_grid,
            maps=maps, g_opl=g_opl, g_nfinal=g_nf)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps,
            ext=ext, disp=disp, g_opl=g_opl, g_nfinal=g_nf, opl=True)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps,
            g_opl=g_opl, g_nfinal=g_nf)
    torch.cuda.synchronize()
    # K6: compare_k6's allowances (rim flips; a grid cotangent read from a
    # neighbour bin)
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq \
        else None
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1], allowed=allowed,
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if nonseq and cfg.grid_shape else 0),
        tol=DISP_BWD_TOL if disp else BWD_TOL)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True,
        disp=disp))
    if maps:
        res['bwd'].update(compare_maps(torch, g_k[2], g_p[2]))
    return res


def wf_loss(rt, out, aux):
    """The design loss: the refocused RMS wavefront error."""
    return rt.wavefront_rms(out, aux['opl'], refocus=True)


def streams_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 10: the deterministic streams (track_opl, record_paths,
    record_hits) through K1, K2, K5 and K6 in their instantiations with the
    streams: each kernel against its plain version at 2,999 and 1M rays
    (K1 and K2 with the path length on the bench singlet, the ring-former
    plate and the Sellmeier achromat, K1 with the records on the bench
    singlet and the Cooke triplet, K5 and K6 with the path length and K5
    with the records on the 8-bounce naive scene and the mirror fold); the
    counted paths (simulate_fused with track_opl, a wavefront grad step in
    c1 and c2 against the eager gradients, the same as a Scene, footprints
    on the Cooke triplet, a grad step through record_hits, which recomputes
    its backward eagerly); the JAX anchors; the wavefront design by
    fit_lbfgs at 1M rays; then times, bounds and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    from raytracetorch_tpu_torch.rays import reference_prng

    # 10a. each kernel against its plain version
    kern = {}
    for n in (N_SMALL, N_MAIN):
        for name in ('bench', 'ring', 'achromat_sellmeier'):
            kern[f'k1k2_opl_{name}_{n}'] = stream_kernels_vs_plain(
                rt, torch, name, n, dev, SEED + 301 + n, records=False)
        for name in ('bench', 'cooke'):
            kern[f'k1_records_{name}_{n}'] = stream_kernels_vs_plain(
                rt, torch, name, n, dev, SEED + 302 + n, records=True)
        for name in ('bench', 'fold'):
            kern[f'k5k6_opl_{name}_{n}'] = stream_kernels_vs_plain(
                rt, torch, name, n, dev, SEED + 303 + n, records=False,
                nonseq=True)
            kern[f'k5_records_{name}_{n}'] = stream_kernels_vs_plain(
                rt, torch, name, n, dev, SEED + 304 + n, records=True,
                nonseq=True)
    emit('streams_kernels_vs_plain', **kern)

    # 10b. the counted paths on 1M rays
    seq, ns = bench_scene(rt), naive_scene(rt)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED)
    paths = {}

    def wf_grads(sc, simulate, **kw):
        p = sc.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        out, _, aux = simulate(p, rays, **kw)
        loss = (wf_loss(rt, out, aux) if 'opl' in aux
                else (aux['hits'][-1, :, :2] ** 2).mean())
        loss.backward()
        return [p['lens'][k].grad for k in ('c1', 'c2')], float(loss.detach())

    for label, sc, fwd, bwd in (
            ('sequential', seq, 'trace_seq_fwd', 'trace_seq_bwd'),
            ('scene', ns, 'trace_nonseq_fwd', 'trace_nonseq_bwd')):
        p = sc.init_params(dev)
        torch.cuda.synchronize()
        reset_counters()
        out, _, aux = sc.simulate_fused(p, rays, track_opl=True)
        torch.cuda.synchronize()
        fwd_launches = counters()
        check(only(fwd_launches, **{fwd: 1, 'streams': 1}),
              f'{label} simulate_fused(track_opl) launched {fwd_launches}')
        check(bool(torch.isfinite(aux['opl']).all()), f'{label}: opl')
        reset_counters()
        g_f, loss_f = wf_grads(sc, sc.simulate_fused, track_opl=True)
        torch.cuda.synchronize()
        grad_launches = counters()
        check(only(grad_launches, **{fwd: 1, bwd: 1, 'streams': 2}),
              f'{label} wavefront grad step launched {grad_launches}')
        g_e, loss_e = wf_grads(sc, sc.simulate, track_opl=True)
        rel = [float(((a - b).abs() / b.abs()).max())
               for a, b in zip(g_f, g_e)]
        paths[label] = dict(fwd_launches=fwd_launches,
                            grad_launches=grad_launches,
                            loss_fused=loss_f, loss_eager=loss_e,
                            grad_fused=[float(g) for g in g_f],
                            grad_eager=[float(g) for g in g_e], rel_err=rel)
        check(max(rel) < GRAD_RTOL,
              f'{label}: fused vs eager wavefront gradients differ: {rel}')
    # a grad step through record_hits: K1 once, its backward recomputed
    # through the eager chain (no K2)
    reset_counters()
    g_f, loss_f = wf_grads(seq, seq.simulate_fused, record_hits=True)
    torch.cuda.synchronize()
    rec_launches = counters()
    check(only(rec_launches, trace_seq_fwd=1, streams=1,
               record_recomputes=1),
          f'the record_hits grad step launched {rec_launches}')
    g_e, loss_e = wf_grads(seq, seq.simulate, record_hits=True)
    rel = [float(((a - b).abs() / b.abs()).max()) for a, b in zip(g_f, g_e)]
    paths['record_hits_grad'] = dict(launches=rec_launches, rel_err=rel,
                                     grad_fused=[float(g) for g in g_f])
    check(max(rel) < GRAD_RTOL,
          f'record_hits: fused vs eager gradients differ: {rel}')
    # footprints on the Cooke triplet: K1 once (its records)
    cooke = cooke_scene(rt)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c_rays = rt.sample_bundles(gen, cooke_bundles(rt), dev)
    cp = cooke.init_params(dev)
    torch.cuda.synchronize()
    reset_counters()
    reps = rt.footprints(cooke, cp, c_rays)
    torch.cuda.synchronize()
    fp_launches = counters()
    r_max = [reps[k]['r_max'] for k in COOKE_FACE_ROWS]
    paths['footprints'] = dict(launches=fp_launches, r_max=r_max,
                               r_max_ref=list(COOKE_RMAX_REF),
                               r_max_tol=list(COOKE_RMAX_TOL),
                               report=rt.footprint_report(reps))
    check(only(fp_launches, trace_seq_fwd=1, streams=1),
          f'footprints launched {fp_launches}')
    check(all(abs(a - b) <= t for a, b, t in zip(
        r_max, COOKE_RMAX_REF, COOKE_RMAX_TOL)),
          f'cooke footprints r_max {r_max}')
    emit('streams_main', n=N_MAIN, **paths)

    # 10c. anchors: the bench singlet on the reference's threefry rays
    wf_rays = reference_prng.collimated_disk(
        reference_prng.prng_key(0), N_MAIN, WF_PUPIL, (0.0, 0.0, -10.0),
        device=dev)
    with torch.no_grad():
        out, _, aux = seq.simulate_fused(seq.init_params(dev), wf_rays,
                                         track_opl=True)
        rms = float(wf_loss(rt, out, aux))
        alive = (out.intensity > 0).float()
        tot = rt.opl_to_point(out, aux['opl'], rt.best_focus(out))
        opd = tot - (tot * alive).sum() / alive.sum()
        coef = rt.zernike_fit(torch.stack([wf_rays.px, wf_rays.py], 1), opd,
                              WF_PUPIL, weights=alive)
        zern = [float(coef[3]), float(coef[10])]
        n_final = sorted({float(v) for v in aux['n_final'].unique()})
        axial = rt.Rays.create([[0.0, 0.0, -10.0]], [[0.0, 0.0, 1.0]],
                               device=dev)
        lens = rt.SequentialScene([rt.SingletLens(
            c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
            name='lens')])
        _, _, a_aux = lens.simulate_fused(lens.init_params(dev), axial,
                                          track_opl=True)
        axial_opl = float(a_aux['opl'][0])
    ztol = WF_ZERNIKE_TOL * max(abs(v) for v in WF_BENCH_REF['zernike'])
    anchors = dict(rms=rms, rms_ref=WF_BENCH_REF['rms'], zernike=zern,
                   zernike_ref=list(WF_BENCH_REF['zernike']),
                   zernike_tol=ztol + WF_RMS_ATOL, n_final=n_final,
                   axial_opl=axial_opl, axial_opl_ref=AXIAL_OPL_REF)
    emit('streams_anchors', **anchors)
    check(abs(rms - WF_BENCH_REF['rms'])
          <= WF_RMS_RTOL * WF_BENCH_REF['rms'] + WF_RMS_ATOL,
          f'bench wavefront rms {rms}')
    check(all(abs(a - b) <= ztol + WF_RMS_ATOL
              for a, b in zip(zern, WF_BENCH_REF['zernike'])),
          f'bench zernike terms {zern}')
    check(tuple(n_final) == WF_BENCH_REF['n_final'], f'n_final {n_final}')
    check(abs(axial_opl - AXIAL_OPL_REF) <= 1e-6 * AXIAL_OPL_REF,
          f'axial opl {axial_opl}')

    # 10d. the wavefront design on those rays: K1 and K2 once an evaluation
    evals = [0]

    def loss(p):
        evals[0] += 1
        o, _, a = seq.simulate_fused(p, wf_rays, track_opl=True)
        return wf_loss(rt, o, a)
    p0 = seq.init_params(dev)
    trainable = seq.trainable()
    trainable['lens'].update(c1=True, c2=True)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    p1, hist = rt.fit_lbfgs(loss, p0, trainable=trainable,
                            steps=WF_DESIGN_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = counters()
    with torch.no_grad():
        end = float(loss(p1))
    design = dict(n=wf_rays.n, steps=WF_DESIGN_STEPS, evaluations=evals[0] - 1,
                  launches=launched, seconds=seconds,
                  loss_start=float(hist[0]), loss_end=end,
                  c1=float(p1['lens']['c1']), c2=float(p1['lens']['c2']),
                  ref=WF_DESIGN_REF, tol=WF_DESIGN_TOL)
    emit('wavefront_design', **design)
    n_ev = evals[0] - 1
    check(only(launched, trace_seq_fwd=n_ev, trace_seq_bwd=n_ev,
               streams=2 * n_ev),
          f'wavefront design: {n_ev} evaluations launched {launched}')
    check(abs(design['loss_start'] - WF_DESIGN_REF[0])
          <= WF_RMS_RTOL * WF_DESIGN_REF[0] + WF_RMS_ATOL,
          f'wavefront design start {design["loss_start"]}')
    check(abs(end - WF_DESIGN_REF[1]) <= WF_DESIGN_TOL,
          f'wavefront design end {end} (JAX {WF_DESIGN_REF[1]})')

    # 10e. times at 1M rays against the plain versions, the entry points,
    # bounds (the streams' bytes counted) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    opl = dict(track_opl=True)
    rec = dict(track_opl=True, record_paths=True, record_hits=True)
    for name, nonseq, flags in (('bench', False, opl), ('bench', False, rec),
                                ('cooke', False, rec), ('bench', True, opl),
                                ('bench', True, rec)):
        sc, params, r, nb = stream_case(rt, torch, name, N_MAIN, dev,
                                        SEED + 1,
                                        NS_BOUNCES if nonseq else None)
        meta, cfg, flat, kinds, maps, ext, disp = stream_inputs(
            rt, torch, sc, params, nb)
        key = (f'{"k5" if nonseq else "k1"}_{name}_'
               f'{"records" if flags is rec else "opl"}')
        if nonseq:
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, sc.n_bounces, maps, ext, **flags))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, sc.n_bounces, maps, **flags))
        else:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, **flags))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, **flags))
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, reps=10,
                                          warmup=2)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
        rows = sc.n_bounces if nonseq else len(meta)
        # 8 input streams, the wavelength (36 B) and 7 outputs (28 B), opl
        # and n_final (8 B); records: positions 12 B a row (and the launch's
        # on a sequential trace), hits 12 B and their weight 4 B a row (K5:
        # and the slot, 4 B)
        io = r.n * (36 + 28 + 8) + table_bytes(meta) + grid_bytes(cfg)
        if flags is rec:
            io += r.n * (12 * (rows + (0 if nonseq else 1))
                         + (20 if nonseq else 16) * rows)
        if nonseq:
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            bounds[key] = bound(io, k5_ops)
            if flags is opl:
                g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg,
                                                          dev, SEED + 3)
                g_opl = torch.ones(r.n, device=dev)
                k_ms, p_ms, k_runs, _ = time_pair(
                    torch, lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                        flat, kinds, r, cfg, sc.n_bounces, (None,) * 7,
                        g_mom, g_grid=g_grid, maps=maps, ext=ext,
                        g_opl=g_opl, opl=True),
                    lambda: fused_nonseq.trace_nonseq_bwd_plain(
                        flat, r, cfg, meta, sc.n_bounces, (None,) * 7,
                        g_mom, g_grid=g_grid, maps=maps, g_opl=g_opl),
                    reps=6, warmup=1)
                timing['k6_bench_opl'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                              kernel_runs=k_runs)
                bounds['k6_bench_opl'] = bound(
                    io + len(meta) * len(fused_trace.EXT_GRAD_COLS) * 4,
                    k6_ops)
                occ['trace_nonseq_bwd'] = fused_trace.blocks_per_sm(
                    'trace_nonseq_bwd', len(meta), cfg, True, sc.n_bounces,
                    ext=True, streams=True)
            occ['trace_nonseq_fwd'] = fused_trace.blocks_per_sm(
                'trace_nonseq_fwd', len(meta), cfg, True, sc.n_bounces,
                ext=True, streams=True)
        else:
            # the path length adds n t and the medium's select: ~4 a row
            bounds[key] = bound(io, k1_ops + r.n * 4 * len(meta))
            if flags is opl:
                g_mom = random_cotangents(torch, r.n, cfg, dev,
                                          SEED + 4)[1]
                g_opl = torch.ones(r.n, device=dev)
                k_ms, p_ms, k_runs, _ = time_pair(
                    torch, lambda: fused_trace.trace_seq_bwd_cuda(
                        flat, kinds, r, cfg, (None,) * 7, g_mom, maps=maps,
                        ext=ext, g_opl=g_opl, opl=True),
                    lambda: fused_trace.trace_seq_bwd_plain(
                        flat, r, cfg, meta, (None,) * 7, g_mom, maps=maps,
                        g_opl=g_opl), reps=10, warmup=2)
                timing['k2_bench_opl'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                              kernel_runs=k_runs)
                bounds['k2_bench_opl'] = bound(
                    io + len(meta) * len(fused_trace.EXT_GRAD_COLS) * 4,
                    3 * k1_ops)
                for lib in ('trace_seq_fwd', 'trace_seq_bwd'):
                    occ[lib] = fused_trace.blocks_per_sm(
                        lib, len(meta), cfg, True, ext=True, streams=True)
    # the entry points
    p_wf = seq.init_params(dev)
    for key, fn in (
            ('simulate_fused_opl',
             lambda: seq.simulate_fused(p_wf, rays, track_opl=True)),
            ('wavefront_grad_step_fused',
             lambda: wf_grads(seq, seq.simulate_fused, track_opl=True)),
            ('wavefront_grad_step_eager',
             lambda: wf_grads(seq, seq.simulate, track_opl=True)),
            ('scene_simulate_fused_opl',
             lambda: ns.simulate_fused(p_wf, rays, track_opl=True)),
            ('footprints_cooke',
             lambda: rt.footprints(cooke, cp, c_rays))):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{key}_ms'] = statistics.median(runs)
        timing[f'{key}_runs'] = runs
    timing['wavefront_design_s'] = seconds
    emit('streams_timing', **timing)
    emit('streams_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('streams_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                design=design)


FRESNEL_SEQ_CASES = ('mc', 'weighted', 'window_ghost', 'cooke_ghost')
FRESNEL_NS_CASES = ('mc', 'weighted')


def fresnel_case(rt, torch, name, n, device, seed, nonseq=False):
    """(scene, build, params, rays, cfg, draws) of a section 11 case:
    ``build(params) -> (table, static_meta)``; ``draws`` the sequential
    FRESNEL streams ([F, n], from a generator seeded ``seed + 1``), the
    non-sequential Philox key (FRESNEL_KEY) or None.  Cases: 'mc' and
    'weighted' (the bench singlet in that mode; ``nonseq``: the naive
    scene), 'window_ghost' (the window's ghost (0, 1), n axial rays over a
    disk of radius 4) and 'cooke_ghost' (the Cooke triplet's ghost
    COOKE_GHOST on its six bundles)."""
    from raytracetorch_tpu_torch.rays.draws import row_uniforms
    from raytracetorch_tpu_torch.utils import ghosts
    if name.endswith('_ghost'):
        window = name == 'window_ghost'
        sc = window_scene(rt) if window else cooke_scene(rt)
        pair = (0, 1) if window else COOKE_GHOST
        if window:
            rays, cfg = sample_rays(rt, torch, n, device, seed), \
                sc.sensor_config()
        else:
            gen = torch.Generator(device=device).manual_seed(seed)
            rays = rt.sample_bundles(gen, cooke_bundles(rt, n), device)
            cfg = sc.sensor_config(len(COOKE_LINES) * len(COOKE_FIELDS))
        return (sc, lambda p: ghosts.ghost_table(sc, p, pair),
                sc.init_params(device), rays, cfg, None)
    mode = True if name == 'mc' else 'weighted'
    sc = fresnel_scene(rt, mode, NS_BOUNCES if nonseq else None)
    rays = sample_rays(rt, torch, n, device, seed)
    draws = None
    if mode is True:
        draws = FRESNEL_KEY if nonseq else row_uniforms(
            sc.static_meta(), n,
            torch.Generator(device=device).manual_seed(seed + 1))
    return (sc, lambda p: (sc.build_table(p), sc.static_meta()),
            sc.init_params(device), rays, sc.sensor_config(), draws)


def flip_margins(torch, flat, meta, rays, cfg, uniforms, apart,
                 limit=FRESNEL_FLIPS):
    """Where K1 and its plain version part on each ray they trace apart
    (``apart``; the first ``limit`` of them) -> list of dicts: the first row
    at which their records differ (the hit weight's sign or value, or the
    position after the row) with its physics kind, and, from the plain
    version's ray entering that row, how near the row's discontinuities it
    passes: ``rim``, the relative margin of each bound (1 - r^2 / R^2 of a
    DISK or APER_R2 bound, 1 - |z c| of a HEMI bound, the distance inside a
    Z_BETWEEN bound over its length; 0 at the rim, negative outside),
    ``graze``, the quadric's discriminant over B^2 + |4 A C| (0: tangent),
    and ``critical``, 1 - sin^2 of the refraction angle (0 at the critical
    angle).  A sign that float32 rounding can flip makes the two part."""
    import dataclasses
    from raytracetorch_tpu_torch.constants import SBKind, VBKind
    from raytracetorch_tpu_torch.core.intersect import intersect, normal_world
    from raytracetorch_tpu_torch.core.physics import refract_components
    from raytracetorch_tpu_torch.core.static_dispatch import dispersive_iors
    from raytracetorch_tpu_torch.core.table import FlatRow
    from raytracetorch_tpu_torch.geom import vec3 as v3
    from raytracetorch_tpu_torch.geom.surfaces import ray_coeffs
    from raytracetorch_tpu_torch.ops import fused_trace
    idx = torch.nonzero(apart).flatten()[:limit]
    if idx.numel() == 0:
        return []
    sub = rays.replace(**{f.name: getattr(rays, f.name)[idx]
                          for f in dataclasses.fields(rays)})
    u = None if uniforms is None else uniforms[:, idx].contiguous()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=flat.device)
    maps = fused_trace.plate_maps(meta, {})
    rec = dict(record_paths=True, record_hits=True, uniforms=u)
    out_k, _, aux_k = fused_trace.trace_seq_fwd_cuda(
        flat, kinds, sub, cfg, maps, fused_trace.ext_kinds(meta),
        fresnel=True, **rec)
    out_p, _, aux_p = fused_trace.trace_sequential_fused_plain(
        flat, sub, cfg, meta, maps, **rec)
    hw_k, hw_p = aux_k['hit_weights'], aux_p['hit_weights']
    pk, pp = aux_k['paths'][1:], aux_p['paths'][1:]
    scale = 1.0 + pp.abs().amax(-1)
    differ = (((hw_k > 0) != (hw_p > 0))
              | ((hw_k - hw_p).abs() > 1e-3 * hw_p.abs())
              | ((pk - pp).abs().amax(-1) > 1e-3 * scale))
    n_streams = [sum(m.ph == 4 for m in meta[:k]) for k in range(len(meta))]
    report = []
    for j in range(idx.numel()):
        rows = torch.nonzero(differ[:, j]).flatten()
        entry = dict(ray=int(idx[j]), kernel_intensity=float(
            out_k.intensity[j]), plain_intensity=float(out_p.intensity[j]))
        if rows.numel() == 0:
            report.append(entry)
            continue
        k = int(rows[0])
        one = sub.replace(**{f.name: getattr(sub, f.name)[j:j + 1]
                             for f in dataclasses.fields(sub)})
        if k > 0:
            one = fused_trace.trace_sequential_fused_plain(
                flat[:k], one, cfg, meta[:k], maps,
                uniforms=None if u is None
                else u[:n_streams[k], j:j + 1].contiguous())[0]
        m, row = meta[k], FlatRow(flat[k])
        res = intersect(row, one.pos_c, one.dir_c, m)
        rim = {}
        if m.vb == VBKind.APER_R2:
            rim['aper_r2'] = 1.0 - float(res['hit_e'][0] ** 2
                                         + res['hit_e'][1] ** 2) / float(
                                             row.vb[0])
        if m.vb == VBKind.Z_BETWEEN:
            lo, hi = float(row.vb[0]), float(row.vb[1])
            z = float(res['hit_e'][2])
            rim['z_between'] = min(z - lo, hi - z) / (hi - lo)
        o_s, d_s = res['o_s'], res['d_s']
        if m.plane:
            hits = [v3.fma(o_s, -o_s[2] / d_s[2], d_s)]
        else:
            a, b, c = ray_coeffs(row.q, o_s, d_s)
            disc = b * b - 4.0 * a * c
            entry['graze'] = float(disc / (b * b + (4.0 * a * c).abs()))
            sq = torch.sqrt(disc.clamp(min=0.0))
            hits = [v3.fma(o_s, t, d_s) for t in
                    ((-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a))]
        for name_, fn in (
                ('disk', lambda h: 1.0 - float((h[0] - row.sb[1]) ** 2 + (
                    h[1] - row.sb[2]) ** 2) / float(row.sb[0])),
                ('hemi', lambda h: 1.0 - abs(float(h[2] * row.sb[0])))):
            if m.sb == (SBKind.DISK if name_ == 'disk' else SBKind.HEMI):
                rim[name_] = max(fn(h) for h in hits)
        n_w = normal_world(row, res['hit_s'], m)
        n_in, n_out = (dispersive_iors(row, one.wavelength, m) if m.disp
                       else (row.ph[0:1], row.ph[1:2]))
        _, cos_i, _, _, mu, _, _, _ = refract_components(one.dir_c, n_w,
                                                         n_in, n_out)
        entry.update(row=k, kind=int(m.ph), hit=bool(res['valid'][0]),
                     kernel_hit=bool(hw_k[k, j] > 0),
                     plain_hit=bool(hw_p[k, j] > 0), rim=rim,
                     critical=float(1.0 - mu * mu * (1.0 - cos_i * cos_i)))
        report.append(entry)
    return report


def fresnel_kernels_vs_plain(rt, torch, name, n, device, seed, nonseq=False):
    """K1 and K2 (``nonseq``: K5 and K6) in their instantiation with the
    Fresnel kinds against their plain versions on a section 11 case, with
    the same draws: the rays and moments (the grid on the naive scene), and
    the ray and table cotangents under seeded cotangents; K6's replay
    against K5 bit for bit -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, build, params, rays, cfg, draws = fresnel_case(
        rt, torch, name, n, device, seed, nonseq)
    table, meta = build(params)
    flat = rt.flatten_table_rows(table).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    maps = fused_trace.plate_maps(meta, {})
    ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
    if nonseq:
        nb = sc.n_bounces
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=True, key=draws)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps, key=draws)
        torch.cuda.synchronize()
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
        apart = ~((torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                                for c in ('px', 'py', 'pz')]).amax(0)
                   <= NS_POS_TOL)
                  & ((out_k.intensity - out_p.intensity).abs()
                     <= NS_INT_TOL))
    else:
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, fresnel=True, uniforms=draws)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, uniforms=draws)
        torch.cuda.synchronize()
        # compare's rule: intensities equal, or within FRESNEL_I_RTOL where
        # rows weight them (FRESNEL_W, REFLECT_W); positions within POS_TOL
        # of 1 + |x|, the 27-row Cooke ghost's within GHOST_POS_TOL of its
        # world scale
        weighted = any(m.ph in (8, 9) for m in meta)
        tol = dict(intensity_rtol=FRESNEL_I_RTOL if weighted else 0.0)
        if name == 'cooke_ghost':
            tol.update(world=True, pos_tol=GHOST_POS_TOL)
        apart = traced_apart(torch, out_k, out_p, **tol)[0]
        flips = flip_margins(torch, flat, meta, rays, cfg, draws, apart)
        emit('fresnel_flips', case=name, n=n, apart=int(apart.sum()),
             rays=flips)
        res = compare(torch, out_k, s_k, out_p, s_p, **tol)
        res['flips'] = flips
    res.update(rows=len(meta), forward=float((out_k.dz > 0).float().mean()),
               mean_intensity=float(out_k.intensity.double().mean()))
    # the backward on the rays both trace alike: the others (flipped at a
    # rim or a draw, counted above) launch dead, as compare_k6 leaves them
    # out; the ray indices, and so the non-sequential draws, stay
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, ext=ext, disp=disp, fresnel=True, key=draws,
            replay=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, key=draws)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=ext,
            disp=disp, fresnel=True, uniforms=draws)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, maps=maps, uniforms=draws)
    torch.cuda.synchronize()
    if nonseq:
        out_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=True, key=draws)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_k, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    # K6: compare_k6's allowances (rim flips; a grid cotangent read from a
    # neighbour bin)
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1],
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq
        else None,
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if nonseq and cfg.grid_shape else 0),
        tol=DISP_BWD_TOL if disp else BWD_TOL)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True,
        disp=disp))
    return res


def fresnel_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 11: Fresnel physics and the random draws through K1, K2, K5
    and K6 in their instantiations with the Fresnel kinds: each kernel
    against its plain version at 2,999 and 1M rays on the same draws (the
    bench singlet with ``fresnel=True`` and ``'weighted'``, the window's
    ghost, a 27-row ghost of the Cooke triplet; K5 and K6 on the naive
    scene in both modes, K6's replay against K5); the counted paths
    (``simulate_fused`` with a generator and its spot-loss grad step in c1
    and c2 against the eager gradients, both modes and both scene types;
    the window ghost through the fused trace; the Cooke ghost's flux
    gradient in c1 against the eager trace's); the JAX anchors
    (tests/fresnel_anchors.py: on the reference's threefry rays and, with
    ``fresnel=True``, its very uniforms; the non-sequential sensor share
    within binomial sigmas); then times, bounds (with the uniforms' 4 B a
    ray and FRESNEL row) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    from raytracetorch_tpu_torch.rays import reference_prng
    from raytracetorch_tpu_torch.utils import ghosts

    # 11a. each kernel against its plain version
    kern = {}
    for n in (N_SMALL, N_MAIN):
        for name in FRESNEL_SEQ_CASES:
            kern[f'k1k2_{name}_{n}'] = fresnel_kernels_vs_plain(
                rt, torch, name, n, dev, FRESNEL_SEED + n)
        for name in FRESNEL_NS_CASES:
            kern[f'k5k6_{name}_{n}'] = fresnel_kernels_vs_plain(
                rt, torch, name, n, dev, FRESNEL_SEED + 7 + n, nonseq=True)
    emit('fresnel_kernels_vs_plain', **kern)
    ghost = kern[f'k1k2_window_ghost_{N_MAIN}']
    check(abs(ghost['mean_intensity'] - WINDOW_GHOST) <= 1e-5 * WINDOW_GHOST,
          f'window ghost flux {ghost["mean_intensity"]} (T R R T = '
          f'{WINDOW_GHOST})')

    # 11b. the counted paths on 1M rays
    rays = sample_rays(rt, torch, N_MAIN, dev, FRESNEL_SEED)
    paths = {}

    def grads(sc, simulate, **kw):
        p = sc.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        _, sens, _ = simulate(p, rays, **kw)
        loss = rt.spot_size_loss(sens)
        loss.backward()
        return [p['lens'][k].grad for k in ('c1', 'c2')], float(loss.detach())

    for label, mode, nb, fwd, bwd in (
            ('sequential_mc', True, None, 'trace_seq_fwd', 'trace_seq_bwd'),
            ('sequential_weighted', 'weighted', None, 'trace_seq_fwd',
             'trace_seq_bwd'),
            ('scene_mc', True, NS_BOUNCES, 'trace_nonseq_fwd',
             'trace_nonseq_bwd'),
            ('scene_weighted', 'weighted', NS_BOUNCES,
             'trace_nonseq_fwd', 'trace_nonseq_bwd')):
        sc = fresnel_scene(rt, mode, nb)

        def kw():
            # the same draws for the fused and the eager call
            return (dict(generator=torch.Generator(device=dev).manual_seed(
                FRESNEL_SEED + 3)) if mode is True else {})
        p = sc.init_params(dev)
        torch.cuda.synchronize()
        reset_counters()
        out, sens, _ = sc.simulate_fused(p, rays, **kw())
        torch.cuda.synchronize()
        fwd_launches = counters()
        check(only(fwd_launches, **{fwd: 1, 'fresnel': 1}),
              f'{label} simulate_fused launched {fwd_launches}')
        check(bool(torch.isfinite(sens.moments).all()), f'{label}: moments')
        reset_counters()
        g_f, loss_f = grads(sc, sc.simulate_fused, **kw())
        torch.cuda.synchronize()
        grad_launches = counters()
        check(only(grad_launches, **{fwd: 1, bwd: 1, 'fresnel': 2}),
              f'{label} grad step launched {grad_launches}')
        g_e, loss_e = grads(sc, sc.simulate, **kw())
        rel = [float(((a - b).abs() / b.abs()).max())
               for a, b in zip(g_f, g_e)]
        paths[label] = dict(fwd_launches=fwd_launches,
                            grad_launches=grad_launches,
                            forward=float((out.dz > 0).float().mean()),
                            mean_intensity=float(out.intensity.mean()),
                            loss_fused=loss_f, loss_eager=loss_e,
                            grad_fused=[float(g) for g in g_f],
                            grad_eager=[float(g) for g in g_e], rel_err=rel)
        check(max(rel) < GRAD_RTOL,
              f'{label}: fused vs eager gradients differ: {rel}')
    # the main path takes no Fresnel instantiation
    bench = bench_scene(rt)
    reset_counters()
    bench.simulate_fused(bench.init_params(dev), rays)
    torch.cuda.synchronize()
    main_launches = counters()
    check(only(main_launches, trace_seq_fwd=1),
          f'the main path launched {main_launches}')
    # the window ghost through the fused trace: K1 once, T R R T
    win = window_scene(rt)
    table, meta = ghosts.ghost_table(win, win.init_params(dev), (0, 1))
    reset_counters()
    g_out, g_sens = rt.trace_sequential_fused(table, rays,
                                              win.sensor_config(), meta)
    torch.cuda.synchronize()
    win_launches = counters()
    inside = (rays.px ** 2 + rays.py ** 2) <= 25.0
    flux = float(g_out.intensity[inside].double().mean())
    paths['window_ghost'] = dict(launches=win_launches, flux=flux,
                                 closed_form=WINDOW_GHOST,
                                 sensor_total=float(g_sens.moments[0, 0, 0]))
    check(only(win_launches, trace_seq_fwd=1, fresnel=1),
          f'the window ghost launched {win_launches}')
    check(abs(flux - WINDOW_GHOST) <= 1e-5 * WINDOW_GHOST,
          f'window ghost flux {flux}')
    # the Cooke ghost's flux gradient in c1: K1 + K2 against the eager trace
    cooke = cooke_scene(rt)
    c_rays = rt.sample_bundles(torch.Generator(device=dev).manual_seed(
        FRESNEL_SEED + 4), cooke_bundles(rt, N_MAIN), dev)

    def ghost_grad(fused):
        p = cooke.init_params(dev)
        p['crown_front']['c1'].requires_grad_(True)
        if fused:
            t, m = ghosts.ghost_table(cooke, p, COOKE_GHOST)
            out, _ = rt.trace_sequential_fused(t, c_rays, cooke.sensor_config(
                6), m)
        else:
            out, _, _ = ghosts.ghost_trace(cooke, p, c_rays, COOKE_GHOST)
        out.intensity.mean().backward()
        return float(p['crown_front']['c1'].grad), float(
            out.intensity.detach().mean())
    reset_counters()
    gk, flux_k = ghost_grad(True)
    torch.cuda.synchronize()
    cg_launches = counters()
    ge, flux_e = ghost_grad(False)
    paths['cooke_ghost_grad'] = dict(launches=cg_launches, grad_fused=gk,
                                     grad_eager=ge, flux_fused=flux_k,
                                     flux_eager=flux_e,
                                     rel_err=abs(gk - ge) / abs(ge))
    check(only(cg_launches, trace_seq_fwd=1, trace_seq_bwd=1, fresnel=2),
          f'the Cooke ghost grad launched {cg_launches}')
    check(ge != 0.0 and abs(gk - ge) <= GRAD_RTOL * abs(ge),
          f'Cooke ghost flux gradient {gk} (eager {ge})')
    emit('fresnel_main', n=N_MAIN, **paths)

    # 11c. anchors on the reference's threefry rays
    ref_rays = reference_prng.collimated_disk(
        reference_prng.prng_key(0), N_MAIN, 4.0, (0.0, 0.0, -10.0),
        device=dev)
    anchors = {}
    with torch.no_grad():
        for mode, ref in ((True, FRESNEL_SEQ_REF),
                          ('weighted', FRESNEL_W_REF)):
            sc = fresnel_scene(rt, mode)
            u = reference_prng.fresnel_uniforms(reference_prng.prng_key(0),
                                                sc.static_meta(), N_MAIN,
                                                device=dev)
            out, sens, _ = sc.simulate_fused(sc.init_params(dev), ref_rays,
                                             uniforms=u)
            st = fresnel_stats(out.dz.cpu().numpy(),
                               out.intensity.cpu().numpy(),
                               sens.moments.cpu().numpy())
            label = 'mc' if mode is True else 'weighted'
            anchors[label] = dict(got=st, ref=ref)
            check(abs(st['forward'] - ref['forward'])
                  <= FRESNEL_FLIPS / N_MAIN, f'{label}: forward share {st}')
            check(abs(st['sensor_share'] - ref['sensor_share'])
                  <= FRESNEL_FLIPS / N_MAIN, f'{label}: sensor share {st}')
            check(abs(st['mean_intensity'] - ref['mean_intensity'])
                  <= FRESNEL_W_RTOL * ref['mean_intensity'],
                  f'{label}: mean intensity {st}')
            check(abs(st['spot_rms'] - ref['spot_rms'])
                  <= FRESNEL_RMS_RTOL * ref['spot_rms'],
                  f'{label}: spot rms {st}')
        ns = fresnel_scene(rt, True, NS_BOUNCES)
        _, sens, _ = ns.simulate_fused(
            ns.init_params(dev), ref_rays,
            generator=torch.Generator(device=dev).manual_seed(FRESNEL_SEED))
        share = float(sens.moments[0, 0, 6]) / N_MAIN
        sigma = math.sqrt(2 * FRESNEL_NS_REF * (1 - FRESNEL_NS_REF) / N_MAIN)
        anchors['scene_sensor_share'] = dict(
            got=share, ref=FRESNEL_NS_REF, sigma=sigma,
            sigmas=abs(share - FRESNEL_NS_REF) / sigma)
        check(abs(share - FRESNEL_NS_REF) <= FRESNEL_NS_SIGMAS * sigma,
              f'scene sensor share {share} (JAX {FRESNEL_NS_REF})')
    emit('fresnel_anchors', **anchors)

    # 11d. times at 1M rays against the plain versions, bounds (the
    # uniforms' 4 B a ray and FRESNEL row counted) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    for name, nonseq in (('mc', False), ('weighted', False),
                         ('cooke_ghost', False), ('mc', True),
                         ('weighted', True)):
        sc, build, params, r, cfg, draws = fresnel_case(
            rt, torch, name, N_MAIN, dev, FRESNEL_SEED + 5, nonseq)
        table, meta = build(params)
        flat = rt.flatten_table_rows(table).detach()
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        maps = fused_trace.plate_maps(meta, {})
        ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
        n_draws = sum(m.ph == 4 for m in meta)
        key = f'{"k5" if nonseq else "k1"}_{name}'
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 5)
        io = (r.n * (36 + 28 + 4 * (0 if nonseq else n_draws))
              + table_bytes(meta) + grid_bytes(cfg))
        if nonseq:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, fresnel=True, key=draws))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps, key=draws))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps, ext=ext, fresnel=True, key=draws))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps, key=draws))
            reps = dict(reps=4, warmup=1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r,
                                             key=draws)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            draws_ops = PHILOX_OPS * sum(
                w for w, m in zip(wins, meta) if m.ph == 4)
            bounds[key] = bound(io, k5_ops + draws_ops)
            bounds[key.replace('k5', 'k6')] = bound(
                io + r.n * 28 + len(meta) * len(fused_trace.EXT_GRAD_COLS)
                * 4, k6_ops + 2 * draws_ops)
        else:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, fresnel=True,
                uniforms=draws))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, uniforms=draws))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                disp=disp, fresnel=True, uniforms=draws))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps,
                uniforms=draws))
            reps = dict(reps=10, warmup=2)
            k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
            bounds[key] = bound(io, k1_ops)
            bounds[key.replace('k1', 'k2')] = bound(
                io + r.n * 28 + len(meta) * len(fused_trace.grad_cols(
                    (), True, disp)) * 4, 3 * k1_ops)
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, **reps)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        k_ms, p_ms, k_runs, _ = time_pair(torch, bk, bp, **reps)
        timing[key.replace('k1', 'k2').replace('k5', 'k6')] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        if name == 'mc':
            for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                        else ('trace_seq_fwd', 'trace_seq_bwd')):
                occ[lib] = fused_trace.blocks_per_sm(
                    lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                    fresnel=True)
    ns, seq = (fresnel_scene(rt, True, NS_BOUNCES),
               fresnel_scene(rt, True))
    p_ns, p_seq = ns.init_params(dev), seq.init_params(dev)
    for label, fn in (
            ('simulate_fused_mc', lambda: seq.simulate_fused(
                p_seq, rays, generator=torch.Generator(device=dev))),
            ('grad_step_fused_mc', lambda: grads(
                seq, seq.simulate_fused,
                generator=torch.Generator(device=dev))),
            ('scene_simulate_fused_mc', lambda: ns.simulate_fused(
                p_ns, rays, generator=torch.Generator(device=dev)))):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('fresnel_timing', **timing)
    emit('fresnel_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('fresnel_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                anchors=anchors)


# tests/coating_anchors.py (the JAX package on the CPU)
COAT_W_REF = {'forward': 1.0, 'mean_intensity': 0.97185408,
              'sensor_share': 1.0, 'spot_rms': 0.16907049}
COAT_MC_REF = {'forward': 0.971861, 'mean_intensity': 1.0,
               'sensor_share': 0.971861, 'spot_rms': 0.16907107}
COAT_NS_REF = 0.972086
TELESCOPE_REF = {'bare': 0.3029479296875, 'enhanced': 0.3264509375,
                 'optimized': 0.326947734375,
                 'coat_d': [0.06251496821641922, 0.09285855293273926]}
TELESCOPE12_REF = {'bare': 0.9154471875, 'enhanced': 0.969435078125,
                   'optimized': 0.970558125,
                   'coat_d': [0.06251128017902374, 0.09284263849258423]}
TELESCOPE_PARTED = 0.1005
# the design of tests/test_coatings.py:121-164: the quarter wave within 0.003
COAT_DESIGN_TOL = 0.003
# Example 11's 50 mm disk: most rays reflected off the primary meet a
# float32 root of the paraboloid ~0.01 mm off the mirror (the quadric
# solver's cancellation where its |A| is barely above SOLVER_EPS; ROADMAP
# Queue 3) and stay on it, in the JAX package (throughput 0.303 where the
# aluminium reflects 0.91) as in the port, and each implementation's
# rounding meets that root on other rays.  So its throughputs are held to
# JAX's within TELESCOPE_PARTED (the share of rays the two packages' traces
# end apart, tests/coating_anchors.py) and its design's thicknesses within
# TELESCOPE_D_TOL um; a 12 mm disk, where no ray meets that root, is held
# to JAX's within FRESNEL_W_RTOL and 1e-4 um.  K5 and its plain version may
# part on up to TELESCOPE_APART_MAX of the 50 mm disk's rays (the rays
# alike must give the same cotangents).
TELESCOPE_D_TOL = 5e-3
TELESCOPE12_D_TOL = 1e-4
TELESCOPE_APART_MAX = 0.15
COAT_SEQ_CASES = ('coated_w', 'coated_mc') + STRESS_CASES
COAT_NS_CASES = ('coated_mc', 'telescope') + STRESS_CASES
# the stack's float32 operations a layer and polarization: one sin and cos
# and the real 2 x 2 update (~30); an absorbing layer's complex cosine,
# admittance and phase (~120); a metal substrate's complex cosine (~40);
# and the reflectance from (B, C) (~20)
COAT_LAYER_OPS, COAT_ABS_LAYER_OPS, COAT_METAL_OPS, COAT_RT_OPS = (
    32, 120, 40, 20)


def coat_ops(meta):
    """The stack's float32 operations of one ray at a coated or metal row
    (both polarizations), 0 where no coating acts."""
    from raytracetorch_tpu_torch.core.static_dispatch import coat_acts
    if not coat_acts(meta):
        return 0
    layer = COAT_ABS_LAYER_OPS if meta.coat_k is not None else COAT_LAYER_OPS
    return 2 * (meta.n_coat * layer + COAT_RT_OPS
                + (COAT_METAL_OPS if meta.metal else 0))


def coating_case(rt, torch, name, n, device, seed, nonseq=False):
    """(scene, params, rays, cfg, draws) of a section 12 case: 'coated_w'
    and 'coated_mc' (the coated bench singlet, FRESNEL_W and FRESNEL;
    ``nonseq``: the naive scene), 'telescope' (example 11, the enhancing
    pair, 50 mm disk at 0.5876 um, 8 bounces) and the STRESS_CASES; draws:
    the sequential FRESNEL streams ([F, n]), the Philox key, or None."""
    from raytracetorch_tpu_torch.rays.draws import row_uniforms
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = NS_BOUNCES if nonseq else None
    if name.startswith('coated'):
        sc = coated_scene(rt, 'weighted' if name == 'coated_w' else True, nb)
        rays = sample_rays(rt, torch, n, device, seed)
    elif name == 'telescope':
        sc = telescope_scene(rt, rt, rt.glass, list(TELESCOPE_PAIR))
        rays = rt.CollimatedDisk.make(
            radius=50.0, translation=[0.0, 0.0, 2.0],
            wavelength=TELESCOPE_WL).sample(gen, n, device)
    else:
        sc = stress_scene(rt, rt, name, nb)
        rays = rt.sample_bundles(gen, stress_bundles(rt, name, n), device)
    draws = None
    if any(m.ph == 4 for m in sc.static_meta()):
        draws = FRESNEL_KEY if nonseq else row_uniforms(
            sc.static_meta(), n, torch.Generator(device=device).manual_seed(
                seed + 1))
    cfg = sc.sensor_config(2 if name == 'gold' else None)
    return sc, sc.init_params(device), rays, cfg, draws


def coating_kernels_vs_plain(rt, torch, name, n, device, seed, nonseq=False):
    """K1 and K2 (``nonseq``: K5 and K6) in their instantiation with the
    coatings against their plain versions on a section 12 case, with the
    same draws: the rays and moments, then the ray and table (the coat
    thicknesses' included) and wavelength cotangents under seeded
    cotangents on the rays both trace alike; K6's replay against K5 bit for
    bit.  Example 11's telescope is rounding-chaotic (``sensitive_share``):
    up to TELESCOPE_APART_MAX of its rays may trace apart, and its replay
    is not held bit for bit -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, cfg, draws = coating_case(rt, torch, name, n, device,
                                                seed, nonseq)
    meta = sc.static_meta()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    maps = fused_trace.plate_maps(meta, {})
    ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
    coat = fused_trace.coat_side(meta, device)
    fres = fused_trace.fresnel_kinds(meta)
    chaotic = name == 'telescope'
    if nonseq:
        nb = sc.n_bounces
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=fres, key=draws,
            coat=coat)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps, key=draws)
        torch.cuda.synchronize()
        apart = ~((torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                                for c in ('px', 'py', 'pz')]).amax(0)
                   <= NS_POS_TOL)
                  & ((out_k.intensity - out_p.intensity).abs()
                     <= NS_INT_TOL))
        if chaotic:
            res = dict(n=n, apart=int(apart.sum()),
                       apart_share=float(apart.float().mean()))
            check(res['apart_share'] <= TELESCOPE_APART_MAX,
                  f'telescope: {res["apart"]} rays trace apart')
        else:
            res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
    else:
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, fresnel=fres, uniforms=draws,
            coat=coat)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, uniforms=draws)
        torch.cuda.synchronize()
        weighted = any(m.ph in (8, 9) or m.metal for m in meta)
        tol = dict(intensity_rtol=FRESNEL_I_RTOL if weighted else 0.0)
        apart = traced_apart(torch, out_k, out_p, **tol)[0]
        res = compare(torch, out_k, s_k, out_p, s_p, **tol)
    res.update(rows=len(meta),
               mean_intensity=float(out_k.intensity.double().mean()))
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, ext=ext, disp=disp, fresnel=fres, key=draws,
            coat=coat, replay=True, need_wavelength=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, key=draws, need_wavelength=True)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=ext,
            disp=disp, fresnel=fres, uniforms=draws, coat=coat,
            need_wavelength=True)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, maps=maps, uniforms=draws,
            need_wavelength=True)
    torch.cuda.synchronize()
    if nonseq and not chaotic:
        out_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=fres, key=draws,
            coat=coat)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_k, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq \
        else None
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1], allowed=allowed,
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if nonseq and cfg.grid_shape else 0),
        tol=DISP_BWD_TOL if disp else BWD_TOL)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True, disp=disp,
        coat=True))
    if rays.wavelength is not None and bool((rays.wavelength > 0).any()):
        res['bwd']['wavelength'] = compare_wavelength_cotangents(
            torch, g_k[3], g_p[3], allowed)
    return res


def telescope_design(rt, torch, rays, steps=TELESCOPE_STEPS):
    """Example 11 as its script runs it, through K5 (and K6 in each design
    step): the bare, enhanced and optimized throughputs on ``rays`` and the
    thicknesses after ``steps`` Adam steps from TELESCOPE_START."""
    def tput(sc, p):
        with torch.no_grad():
            _, sens, _ = sc.simulate_fused(p, rays)
        return float(sens.moments[0, 0, 0].double()) / rays.n
    dev = rays.px.device
    bare = telescope_scene(rt, rt, rt.glass, None)
    enh = telescope_scene(rt, rt, rt.glass, list(TELESCOPE_PAIR))
    got = dict(bare=tput(bare, bare.init_params(dev)),
               enhanced=tput(enh, enh.init_params(dev)))
    p = enh.init_params(dev)
    cd = torch.tensor(TELESCOPE_START, dtype=torch.float32, device=dev,
                      requires_grad=True)
    p['primary']['coat_d'] = cd
    opt = torch.optim.Adam([cd], lr=2e-3)
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad()
        _, s_, _ = enh.simulate_fused(p, rays)
        (-s_.moments[0, 0, 0] / rays.n).backward()
        opt.step()
        with torch.no_grad():
            cd.clamp_(1e-3, 0.4)
    got['design_seconds'] = time.perf_counter() - t0
    got['optimized'] = tput(enh, {**p, 'primary': {**p['primary'],
                                                   'coat_d': cd.detach()}})
    got['coat_d'] = [float(x) for x in cd.detach()]
    return got


def coating_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 12: thin-film coatings and metal mirrors through K1, K2, K5
    and K6 in their instantiation with the coatings: each kernel against
    its plain version at 1M rays (the coated bench singlet in FRESNEL_W
    and FRESNEL, example 11's telescope, the stress rows; K5 and K6 as
    Scenes); the counted paths (the coated singlet's forward and grad step
    in c1, c2 and the coat against the eager gradients, its quarter-wave
    design; the FRESNEL singlet and the naive Scene with a generator;
    example 11 at 1M rays and as published; example 29's Cassegrain through
    the main path's K1 and K2); the JAX anchors (tests/coating_anchors.py);
    then times, bounds (with the stack's operations and the side buffer's
    bytes) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    from raytracetorch_tpu_torch.rays import reference_prng

    # 12a. each kernel against its plain version
    kern = {}
    for name in COAT_SEQ_CASES:
        kern[f'k1k2_{name}'] = coating_kernels_vs_plain(
            rt, torch, name, N_MAIN, dev, COAT_SEED + 11)
    for name in COAT_NS_CASES:
        kern[f'k5k6_{name}'] = coating_kernels_vs_plain(
            rt, torch, name, N_MAIN, dev, COAT_SEED + 13, nonseq=True)
    emit('coating_kernels_vs_plain', n=N_MAIN, **kern)

    # 12b. the counted paths
    rays = sample_rays(rt, torch, N_MAIN, dev, COAT_SEED)
    paths = {}

    def grads(sc, simulate, keys, rays_, loss_fn, **kw):
        p = sc.init_params(dev)
        for el, k in keys:
            p[el][k].requires_grad_(True)
        _, sens, _ = simulate(p, rays_, **kw)
        loss = loss_fn(sens)
        loss.backward()
        return [p[el][k].grad.clone() for el, k in keys], float(
            loss.detach())

    def rel_err(g_f, g_e):
        return max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                   for a, b in zip(g_f, g_e))

    # 1. the coated singlet, FRESNEL_W: K1, K1 + K2
    sc = coated_scene(rt, 'weighted')
    keys = (('lens', 'c1'), ('lens', 'c2'), ('lens', 'coat_d'))
    reset_counters()
    out, sens, _ = sc.simulate_fused(sc.init_params(dev), rays)
    torch.cuda.synchronize()
    fwd = counters()
    # the family instantiation counts in each family it ran with: the
    # coated faces are FRESNEL_W rows
    check(only(fwd, trace_seq_fwd=1, fresnel=1, coat=1),
          f'coated singlet simulate_fused launched {fwd}')
    reset_counters()
    g_f, loss_f = grads(sc, sc.simulate_fused, keys, rays, rt.spot_size_loss)
    torch.cuda.synchronize()
    gl = counters()
    check(only(gl, trace_seq_fwd=1, trace_seq_bwd=1, fresnel=2, coat=2),
          f'coated singlet grad step launched {gl}')
    g_e, loss_e = grads(sc, sc.simulate, keys, rays, rt.spot_size_loss)
    flux = float(out.intensity.double().mean())
    paths['coated_weighted'] = dict(
        fwd_launches=fwd, grad_launches=gl, mean_intensity=flux,
        closed_form=(1 - COAT_R_QW) ** 2, loss_fused=loss_f,
        loss_eager=loss_e, rel_err=rel_err(g_f, g_e),
        grad_coat_d=[float(x) for x in g_f[2]])
    check(paths['coated_weighted']['rel_err'] < GRAD_RTOL,
          f'coated singlet: fused vs eager gradients {paths}')
    check(abs(flux - (1 - COAT_R_QW) ** 2) <= 1e-3,
          f'coated singlet flux {flux} (1 - R_qw)^2 {(1 - COAT_R_QW) ** 2}')
    # its design (tests/test_coatings.py:121-164): Adam on the coat from
    # 0.06 um to the quarter wave, through K5 and K6
    dsc = rt.Scene([
        rt.SingletLens(c1=0.02, c2=-0.02, d=10.0, t=3.0, ior_glass=1.5168,
                       fresnel='weighted', coating=[(COAT_NC, 0.06)],
                       coating_grad=True, name='lens'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.3], name='s'),
    ], n_bounces=6)
    d_rays = rt.CollimatedDisk.make(radius=1.0, translation=[0, 0, -10.0]) \
        .sample(torch.Generator(device=dev).manual_seed(COAT_SEED + 2),
                5000, dev)
    dp = dsc.init_params(dev)
    coat_d = dp['lens']['coat_d'].requires_grad_(True)
    opt = torch.optim.Adam([coat_d], lr=2e-3)
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(150):
        opt.zero_grad()
        _, s_, _ = dsc.simulate_fused(dp, d_rays)
        (-s_.moments[0, 0, 0] / d_rays.n).backward()
        opt.step()
        with torch.no_grad():
            coat_d.clamp_(1e-3, 0.3)
    torch.cuda.synchronize()
    d_launches = counters()
    paths['coat_design'] = dict(
        d_opt=float(coat_d.detach()[0]), d_qw=COAT_QW, launches=d_launches,
        seconds=time.perf_counter() - t0)
    check(only(d_launches, trace_nonseq_fwd=150, trace_nonseq_bwd=150,
               fresnel=300, coat=300),
          f'the coat design launched {d_launches}')
    check(abs(paths['coat_design']['d_opt'] - COAT_QW) <= COAT_DESIGN_TOL,
          f'coat design ended at {paths["coat_design"]["d_opt"]} (QW '
          f'{COAT_QW})')
    # 2. FRESNEL with a generator: K1; the naive Scene: K5
    for label, nb, lib in (('sequential_mc', None, 'trace_seq_fwd'),
                           ('scene_mc', NS_BOUNCES, 'trace_nonseq_fwd')):
        sc = coated_scene(rt, True, nb)
        reset_counters()
        out, sens, _ = sc.simulate_fused(
            sc.init_params(dev), rays,
            generator=torch.Generator(device=dev).manual_seed(COAT_SEED))
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, **{lib: 1, 'fresnel': 1, 'coat': 1}),
              f'{label} launched {fl}')
        paths[label] = dict(launches=fl,
                            forward=float((out.dz > 0).float().mean()),
                            sensor_share=float(sens.moments[0, 0, 6]) /
                            N_MAIN)
    # 3. example 11 at 1M rays: K5; a grad step in the coat: K5 + K6; the
    # fused gradient against the eager one on a 12 mm disk (not chaotic)
    tel = telescope_scene(rt, rt, rt.glass, list(TELESCOPE_PAIR))
    t_rays = rt.CollimatedDisk.make(
        radius=50.0, translation=[0.0, 0.0, 2.0],
        wavelength=TELESCOPE_WL).sample(
            torch.Generator(device=dev).manual_seed(COAT_SEED + 3), N_MAIN,
            dev)
    reset_counters()
    out, sens, _ = tel.simulate_fused(tel.init_params(dev), t_rays)
    torch.cuda.synchronize()
    tf = counters()
    check(only(tf, trace_nonseq_fwd=1, coat=1), f'telescope launched {tf}')

    def flux_loss(s_):
        return -s_.moments[0, 0, 0] / N_MAIN
    reset_counters()
    g_t, _ = grads(tel, tel.simulate_fused, (('primary', 'coat_d'),),
                   t_rays, flux_loss)
    torch.cuda.synchronize()
    tg = counters()
    check(only(tg, trace_nonseq_fwd=1, trace_nonseq_bwd=1, coat=2),
          f'telescope grad step launched {tg}')
    check(bool(torch.isfinite(g_t[0]).all()), 'telescope: coat gradient')
    r12 = rt.CollimatedDisk.make(
        radius=12.0, translation=[0.0, 0.0, 2.0],
        wavelength=TELESCOPE_WL).sample(
            torch.Generator(device=dev).manual_seed(COAT_SEED + 4), N_MAIN,
            dev)
    g12_f, _ = grads(tel, tel.simulate_fused, (('primary', 'coat_d'),), r12,
                     flux_loss)
    g12_e, _ = grads(tel, tel.simulate, (('primary', 'coat_d'),), r12,
                     flux_loss)
    paths['telescope'] = dict(
        fwd_launches=tf, grad_launches=tg,
        throughput=float(sens.moments[0, 0, 0]) / N_MAIN,
        grad_coat_d=[float(x) for x in g_t[0]],
        disk12_rel_err=rel_err(g12_f, g12_e))
    check(paths['telescope']['disk12_rel_err'] < GRAD_RTOL,
          f'telescope: fused vs eager gradients {paths["telescope"]}')
    # example 29's Cassegrain: ideal conic mirrors, the main path's K1, K2
    cass = cassegrain_scene(rt, rt)
    c_rays = rt.CollimatedDisk.make(radius=25.0, translation=[0, 0, 0.0]) \
        .sample(torch.Generator(device=dev).manual_seed(COAT_SEED + 5),
                N_MAIN, dev)
    reset_counters()
    out, sens, _ = cass.simulate_fused(cass.init_params(dev), c_rays)
    torch.cuda.synchronize()
    cf = counters()
    check(only(cf, trace_seq_fwd=1), f'Cassegrain launched {cf}')
    focus = 100.0 - CASS_SEP + CASS_MAG * (CASS_F1 - CASS_SEP)
    t_ = (focus - out.pz) / out.dz
    miss = torch.sqrt((out.px + t_ * out.dx) ** 2
                      + (out.py + t_ * out.dy) ** 2)
    # the grad step away from the stigmatic solution (k1 = -0.9), where the
    # spot (~1e-5 mm there) and its gradient are not float32 rounding
    ck = (('primary', 'k'), ('secondary', 'k'))
    cass9 = cassegrain_scene(rt, rt, k1=-0.9)
    reset_counters()
    gc_f, _ = grads(cass9, cass9.simulate_fused, ck, c_rays,
                    rt.spot_size_loss)
    torch.cuda.synchronize()
    cg = counters()
    gc_e, _ = grads(cass9, cass9.simulate, ck, c_rays, rt.spot_size_loss)
    paths['cassegrain'] = dict(
        fwd_launches=cf, grad_launches=cg,
        spot_rms=float(sens.spot_rms(0)[0]),
        max_miss=float(miss.max()), back_focus=focus,
        rel_err=rel_err(gc_f, gc_e))
    check(only(cg, trace_seq_fwd=1, trace_seq_bwd=1),
          f'Cassegrain grad step launched {cg}')
    check(paths['cassegrain']['max_miss'] < 1e-3
          and paths['cassegrain']['spot_rms'] < 1e-3,
          f'Cassegrain focus {paths["cassegrain"]}')
    check(paths['cassegrain']['rel_err'] < GRAD_RTOL,
          f'Cassegrain: fused vs eager gradients {paths["cassegrain"]}')
    emit('coating_main', n=N_MAIN, **paths)

    # 12c. anchors on the reference's threefry rays
    anchors = {}
    ref_rays = reference_prng.collimated_disk(
        reference_prng.prng_key(0), N_MAIN, 4.0, (0.0, 0.0, -10.0),
        device=dev)
    with torch.no_grad():
        for mode, ref in (('weighted', COAT_W_REF), (True, COAT_MC_REF)):
            sc = coated_scene(rt, mode)
            u = reference_prng.fresnel_uniforms(
                reference_prng.prng_key(0), sc.static_meta(), N_MAIN,
                device=dev)
            out, sens, _ = sc.simulate_fused(sc.init_params(dev), ref_rays,
                                             uniforms=u)
            st = fresnel_stats(out.dz.cpu().numpy(),
                               out.intensity.cpu().numpy(),
                               sens.moments.cpu().numpy())
            label = 'mc' if mode is True else 'weighted'
            anchors[label] = dict(got=st, ref=ref)
            check(abs(st['forward'] - ref['forward'])
                  <= FRESNEL_FLIPS / N_MAIN, f'{label}: forward share {st}')
            check(abs(st['mean_intensity'] - ref['mean_intensity'])
                  <= FRESNEL_W_RTOL * ref['mean_intensity'],
                  f'{label}: mean intensity {st}')
            check(abs(st['spot_rms'] - ref['spot_rms'])
                  <= FRESNEL_RMS_RTOL * ref['spot_rms'],
                  f'{label}: spot rms {st}')
        ns = coated_scene(rt, True, NS_BOUNCES)
        _, sens, _ = ns.simulate_fused(
            ns.init_params(dev), ref_rays,
            generator=torch.Generator(device=dev).manual_seed(COAT_SEED))
        share = float(sens.moments[0, 0, 6]) / N_MAIN
        sigma = math.sqrt(2 * COAT_NS_REF * (1 - COAT_NS_REF) / N_MAIN)
        anchors['scene_sensor_share'] = dict(got=share, ref=COAT_NS_REF,
                                             sigmas=abs(share - COAT_NS_REF)
                                             / sigma)
        check(abs(share - COAT_NS_REF) <= FRESNEL_NS_SIGMAS * sigma,
              f'coated scene sensor share {share} (JAX {COAT_NS_REF})')
    # example 11 as published (the reference's rays over its 50 mm disk,
    # 300 Adam steps), and on a 12 mm disk
    for label, radius, ref, tol, d_tol in (
            ('telescope', 50.0, TELESCOPE_REF, TELESCOPE_PARTED,
             TELESCOPE_D_TOL),
            ('telescope12', 12.0, TELESCOPE12_REF, None, TELESCOPE12_D_TOL)):
        p_rays = reference_prng.collimated_disk(
            reference_prng.prng_key(0), TELESCOPE_RAYS, radius,
            (0.0, 0.0, 2.0), wavelength=TELESCOPE_WL, device=dev)
        reset_counters()
        got = telescope_design(rt, torch, p_rays)
        torch.cuda.synchronize()
        got['launches'] = counters()
        anchors[label] = dict(got=got, ref=ref)
        check(only(got['launches'], trace_nonseq_fwd=TELESCOPE_STEPS + 3,
                   trace_nonseq_bwd=TELESCOPE_STEPS,
                   coat=2 * TELESCOPE_STEPS + 3),
              f'{label} launched {got["launches"]}')
        for k in ('bare', 'enhanced', 'optimized'):
            t_ = (tol + 1e-5 if tol is not None
                  else FRESNEL_W_RTOL * ref[k])
            check(abs(got[k] - ref[k]) <= t_,
                  f'{label} {k} throughput {got[k]} (JAX {ref[k]})')
        check(got['enhanced'] > got['bare']
              and got['optimized'] >= got['enhanced'] - 1e-3,
              f'{label} throughputs {got}')
        check(max(abs(a - b) for a, b in zip(got['coat_d'], ref['coat_d']))
              <= d_tol, f'{label} design {got["coat_d"]} (JAX '
              f'{ref["coat_d"]})')
    emit('coating_anchors', **anchors)

    # 12d. times at 1M rays against the plain versions, bounds (the stack's
    # operations, the side buffer's bytes) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    for name, nonseq in (('coated_w', False), ('telescope', True)):
        sc, params, r, cfg, draws = coating_case(rt, torch, name, N_MAIN,
                                                 dev, COAT_SEED + 7, nonseq)
        meta = sc.static_meta()
        flat = rt.flatten_table_rows(sc.build_table(params)).detach()
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        maps = fused_trace.plate_maps(meta, {})
        ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
        coat = fused_trace.coat_side(meta, dev)
        fres = fused_trace.fresnel_kinds(meta)
        key = 'k5' if nonseq else 'k1'
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 6)
        io = (r.n * (36 + 28) + table_bytes(meta) + grid_bytes(cfg)
              + len(meta) * fused_trace.COAT_SIDE * 4)
        cols = len(fused_trace.grad_cols((), True, disp, True))
        if nonseq:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, fresnel=fres, key=draws,
                coat=coat))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps, key=draws))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps, ext=ext, disp=disp, fresnel=fres, key=draws,
                coat=coat))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps, key=draws))
            reps = dict(reps=4, warmup=1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r,
                                             key=draws)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            stack = sum(w * coat_ops(m) for w, m in zip(wins, meta))
            bounds['k5'] = bound(io, k5_ops + stack)
            bounds['k6'] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 k6_ops + 4 * stack)
        else:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, fresnel=fres,
                uniforms=draws, coat=coat))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, uniforms=draws))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                disp=disp, fresnel=fres, uniforms=draws, coat=coat))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps,
                uniforms=draws))
            reps = dict(reps=10, warmup=2)
            k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m) + coat_ops(m)
                               for m in meta)
            bounds['k1'] = bound(io, k1_ops)
            bounds['k2'] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 3 * k1_ops)
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, **reps)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        k_ms, p_ms, k_runs, _ = time_pair(torch, bk, bp, **reps)
        timing[key.replace('k1', 'k2').replace('k5', 'k6')] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[lib] = fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                disp=disp, coat=True)
    sc = coated_scene(rt, 'weighted')
    p_ = sc.init_params(dev)
    for label, fn in (
            ('simulate_fused_weighted', lambda: sc.simulate_fused(p_, rays)),
            ('grad_step_fused_weighted', lambda: grads(
                sc, sc.simulate_fused, keys, rays, rt.spot_size_loss)),
            ('scene_simulate_fused_telescope', lambda: tel.simulate_fused(
                tel.init_params(dev), t_rays))):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('coating_timing', **timing)
    emit('coating_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('coating_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                anchors=anchors)


# ---- section 13: the diffractive and ideal elements ----

# examples/25_hybrid_achromat.py: a BK7 singlet (Abbe) and a weak DOE, the
# F, d and C lines, the sensor at the target focal length
HYB_LAMS = (0.4861, 0.5876, 0.6563)
HYB_N_D, HYB_V_R, HYB_F = 1.5168, 64.17, 80.0
HYB_V_D = 0.5876 / (0.4861 - 0.6563)
HYB_C0 = 1.0 / (2 * (HYB_N_D - 1) * HYB_F)
HYB_RAYS, HYB_STEPS = 2000, 600
# the thin-lens power split's DOE power P V_d / (V_d - V_r), 1/mm
HYB_POWER_SPLIT = HYB_V_D / (HYB_V_D - HYB_V_R) / HYB_F
# examples/05_spectrometer.py: a 3 um transmissive grating ahead of a BK7
# singlet, nine channels of 2,000 rays over 0.45-0.65 um
SPEC_PERIOD, SPEC_F = 3.0, 80.0
SPEC_RAYS, SPEC_STEPS = 2000, 400
DIFF_SEED = SEED + 1401
DIFF_BOUNCES = 8
# The JAX package's examples 25 and 05 on the CPU (tests/diffractive_
# anchors.py).  The port's designs on the CPU agree with them to ~2e-5 mm
# in the chromatic shift, ~1e-9 /mm in the DOE power, ~1e-7 in the
# curvatures and the sensor's z, 1.3e-6 in the dispersion and 2.6% in the
# spectrometer's mean spot RMS (the same script): its spots sit ~16 mm off
# axis, so their RMS from float32 moments cancels to a few percent, as the
# JAX package's does, and each summation order gives another.  Section 13
# holds the card's designs to JAX's within HYB_TOL (absolute) and SPEC_TOL
# (relative), ~30-100x those.
HYBRID_REF = {'shift0': -1.238189697265625, 'shift1': -0.055999755859375,
              'rms0': 0.04583962710654024, 'rms1': 0.0033321641277916083,
              'p_doe': 0.000634458964395523,
              'p_doe_split': 0.0006381776738775675,
              'c1': 0.011593355797231197, 'c2': -0.011432711966335773}
SPECTROMETER_REF = {'dispersion0': 27.707755406697554,
                    'rms_mean0': 0.07580044865608215,
                    'rms_max0': 0.10020510107278824,
                    'dispersion': 27.71729914347328,
                    'rms_mean': 0.04446534812450409,
                    'rms_max': 0.05961174517869949,
                    'loss0': 0.05321425199508667,
                    'loss': 0.017048228532075882,
                    'sensor_z': 85.9959945678711,
                    'c1': 0.010988770052790642, 'c2': -0.012514142319560051}
HYB_TOL = {'shift0': 1e-3, 'shift1': 2e-3, 'rms1': 1e-4, 'p_doe': 1e-6}
SPEC_TOL = {'dispersion': 1e-4, 'rms_mean': 0.08, 'c1': 1e-3, 'c2': 1e-3,
            'sensor_z': 1e-5}


def spec_channels():
    """The spectrometer's nine wavelengths, as numpy.linspace(0.45, 0.65,
    9) gives them."""
    import numpy as np
    return [float(w) for w in np.linspace(0.45, 0.65, 9)]


def hybrid_scene(rt, bare=False, n_bounces=None):
    """Example 25's scene: the singlet (curvatures trainable), with
    ``bare=False`` the DOE of f = 5000 mm at z = 2 (its phase trainable),
    and the sensor at z = 80; a Scene of ``n_bounces`` when given."""
    els = [rt.SingletLens(c1=HYB_C0, c2=-HYB_C0, d=16.0, t=1.0,
                          ior_glass=HYB_N_D, abbe_vd=HYB_V_R, c1_grad=True,
                          c2_grad=True, name='lens')]
    if not bare:
        els.append(rt.DiffractiveLens(radius=8.0, f=5000.0, phase_grad=True,
                                      translation=[0, 0, 2.0], name='doe'))
    els.append(rt.SensorElement(radius=10.0, translation=[0, 0, HYB_F],
                                name='s'))
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def hybrid_bundles(rt, n):
    """The F, d and C bundles of ``n`` rays each over the 4 mm disk."""
    return [(rt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0],
                                    wavelength=lam, ray_id=j), n)
            for j, lam in enumerate(HYB_LAMS)]


def spectrometer_scene(rt, n_bounces=None):
    """Example 05's scene: the grating, the singlet (curvatures trainable)
    and the sensor, whose z alone is trainable."""
    els = [rt.DiffractionGrating(period_um=SPEC_PERIOD, order=1,
                                 diameter=30.0, name='grating'),
           rt.SingletLens(c1=0.012, c2=-0.012, d=24.0, t=4.0,
                          ior_glass=1.5168, abbe_vd=64.17, c1_grad=True,
                          c2_grad=True, translation=[0, 0, 6.0],
                          name='lens'),
           rt.SensorElement(radius=30.0, translation=[0, 0, 6.0 + SPEC_F],
                            trans_grad=True, trans_mask=[0, 0, 1],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def spectrometer_bundles(rt, n):
    """The nine channels, ``n`` rays each over the 4 mm disk."""
    return [(rt.CollimatedDisk.make(radius=4.0, ray_id=j, wavelength=wl,
                                    translation=[0, 0, -5.0]), n)
            for j, wl in enumerate(spec_channels())]


def diffractive_ns_scene(rt, n_bounces=DIFF_BOUNCES):
    """A non-sequential Scene of every new kind: an ideal thin lens, a
    rotated elliptic stop (inverted: the plate outside the ellipse blocks),
    a DOE with its efficiency, a transmissive grating, a microlens array and
    a sensor; each ray meets at most six rows."""
    return rt.Scene([
        rt.IdealThinLens(focal=100.0, focal_grad=True, name='ideal'),
        rt.EllipticAperture(r_major=2.4, r_minor=1.6, rot=0.6, invert=True,
                            translation=[0, 0, 5.0], name='ellipse'),
        rt.DiffractiveLens(radius=6.0, coeffs=[-2.0, 0.01],
                           efficiency=True, phase_grad=True,
                           translation=[0, 0, 10.0], name='doe'),
        rt.DiffractionGrating(period_um=20.0, period_grad=True,
                              translation=[0, 0, 15.0], name='grating'),
        rt.MicrolensArray(half_x=5.0, half_y=5.0, pitch=1.0, f=20.0,
                          pitch_grad=True, f_grad=True,
                          translation=[0, 0, 20.0], name='mla'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 40.0], name='s'),
    ], n_bounces=n_bounces)


def diffractive_ns_bundles(rt, n):
    """Two bundles over a 2.5 mm disk at 0.50 and 0.65 um."""
    return [(rt.CollimatedDisk.make(radius=2.5, translation=[0, 0, -5.0],
                                    wavelength=wl, ray_id=j), n // 2)
            for j, wl in enumerate((0.50, 0.65))]


DIFF_CASES = ('hybrid', 'spectrometer', 'scene')


def diffractive_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, cfg, nonseq) of a section 13 case: 'hybrid'
    (example 25's F, d, C bundles), 'spectrometer' (example 05's nine
    channels) and 'scene' (``diffractive_ns_scene``); ``n`` rays in all."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if name == 'hybrid':
        sc, b = hybrid_scene(rt), hybrid_bundles(rt, n // 3)
    elif name == 'spectrometer':
        sc, b = spectrometer_scene(rt), spectrometer_bundles(rt, n // 9)
    else:
        sc, b = diffractive_ns_scene(rt), diffractive_ns_bundles(rt, n)
    rays = rt.sample_bundles(gen, b, device)
    return (sc, sc.init_params(device), rays, sc.sensor_config(len(b)),
            name == 'scene')


def diffractive_kernels_vs_plain(rt, torch, name, n, device, seed):
    """K1 and K2 (the Scene: K5 and K6) in their instantiation with the
    diffractive kinds against their plain versions on a section 13 case:
    the rays and moments (slot by slot: nine bundles on the spectrometer),
    then the ray, table (a DOE row's coefficients included) and wavelength
    cotangents under seeded cotangents on the rays both trace alike; K6's
    replay against K5 bit for bit -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, cfg, nonseq = diffractive_case(rt, torch, name, n,
                                                     device, seed)
    meta = sc.static_meta()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    maps = fused_trace.plate_maps(meta, {})
    ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
    coat = fused_trace.coat_side(meta, device)
    check(fused_trace.diffractive_kinds(meta), f'{name}: no diffractive row')
    if nonseq:
        nb = sc.n_bounces
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, coat=coat, diff=True)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps)
    else:
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, coat=coat, diff=True)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps)
    torch.cuda.synchronize()
    apart = traced_apart(torch, out_k, out_p, world=nonseq)[0]
    res = compare(torch, out_k, s_k, out_p, s_p, world=nonseq)
    res.update(rows=len(meta), bundles=cfg.n_bundles,
               mean_intensity=float(out_k.intensity.double().mean()))
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
            disp=disp, coat=coat, diff=True, replay=True,
            need_wavelength=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, maps=maps,
            need_wavelength=True)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=ext,
            disp=disp, coat=coat, diff=True, need_wavelength=True)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, maps=maps,
            need_wavelength=True)
    torch.cuda.synchronize()
    if nonseq:
        out_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, coat=coat, diff=True)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_k, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq \
        else None
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1], allowed=allowed,
        tol=DISP_BWD_TOL if disp else BWD_TOL)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True, disp=disp,
        coat=True, diff=True))
    res['bwd']['wavelength'] = compare_wavelength_cotangents(
        torch, g_k[3], g_p[3], allowed)
    return res


def hybrid_chromatic_shift(rt, torch, scene, params):
    """Example 25's marginal-ray axis crossings on the reference's 64 rays
    of PRNGKey(1) over 1 mm: the median z at F minus that at C (the median
    of an even count as numpy takes it), through ``simulate_fused``."""
    import numpy as np
    from raytracetorch_tpu_torch.rays import reference_prng
    dev = params['lens']['c1'].device
    zs = []
    for lam in (HYB_LAMS[0], HYB_LAMS[2]):
        r = reference_prng.collimated_disk(reference_prng.prng_key(1), 64,
                                           1.0, (0.0, 0.0, -10.0), lam, dev)
        with torch.no_grad():
            out, _, _ = scene.simulate_fused(params, r)
        t = -out.px / out.dx * out.dz
        zs.append(float(np.median((out.pz + t).cpu().numpy())))
    return zs[0] - zs[1]


def hybrid_design(rt, torch, device, steps=HYB_STEPS):
    """Example 25 through ``simulate_fused`` (K1, K2 in each step): the bare
    singlet's chromatic shift, then Adam on the hybrid's curvatures and DOE
    phase (its scales) over the reference's 3 x 2,000 rays, traced as one
    3-bundle batch -> dict of its numbers (HYBRID_REF's keys)."""
    from raytracetorch_tpu_torch.rays import reference_prng
    bare = hybrid_scene(rt, bare=True)
    shift0 = hybrid_chromatic_shift(rt, torch, bare, bare.init_params(device))
    hyb = hybrid_scene(rt)
    key = reference_prng.prng_key(0)
    rays = reference_prng.collimated_bundles(
        [key] * 3, HYB_RAYS, 4.0, (0.0, 0.0, -10.0), HYB_LAMS, device)

    def loss(p):
        _, sens, _ = hyb.simulate_fused(p, rays, 3)
        return (sens.spot_rms(0) ** 2).mean()
    t0 = time.perf_counter()
    p, hist = rt.fit(loss, hyb.init_params(device), trainable=hyb.trainable(),
                     steps=steps, lr=3e-2,
                     scales={'lens': {'c1': HYB_C0, 'c2': HYB_C0},
                             'doe': {'phase': 0.2}})
    seconds = time.perf_counter() - t0
    return dict(
        shift0=shift0, shift1=hybrid_chromatic_shift(rt, torch, hyb, p),
        rms0=math.sqrt(float(hist[0])), rms1=math.sqrt(float(hist[-1])),
        p_doe=-2.0 * 0.5876e-3 * float(p['doe']['phase'][0]),
        p_doe_split=HYB_POWER_SPLIT, c1=float(p['lens']['c1']),
        c2=float(p['lens']['c2']), design_seconds=seconds)


def spectrometer_stats(torch, scene, params, rays):
    """(dispersion um/nm, mean spot RMS, worst spot RMS) of the nine
    channels through ``simulate_fused``."""
    import numpy as np
    with torch.no_grad():
        _, sens, _ = scene.simulate_fused(params, rays, 9)
    cx = sens.centroid(0)[:, 0].cpu().numpy()
    rms = sens.spot_rms(0).cpu().numpy()
    lams = np.asarray(spec_channels()) * 1000.0
    return (float(np.polyfit(lams, cx, 1)[0]) * 1e3, float(rms.mean()),
            float(rms.max()))


def spectrometer_design(rt, torch, device, steps=SPEC_STEPS):
    """Example 05 through ``simulate_fused`` (K1, K2 in each step) on the
    reference's nine channels of 2,000 rays: Adam on the singlet's
    curvatures and the sensor's z -> dict of its numbers (SPECTROMETER_REF's
    keys)."""
    from raytracetorch_tpu_torch.rays import reference_prng
    scene = spectrometer_scene(rt)
    keys = reference_prng.split(reference_prng.prng_key(0), 9)
    rays = reference_prng.collimated_bundles(
        keys, SPEC_RAYS, 4.0, (0.0, 0.0, -5.0), spec_channels(), device)
    p0 = scene.init_params(device)

    def loss(p):
        _, sens, _ = scene.simulate_fused(p, rays, 9)
        return (sens.spot_rms(0) ** 2).sum()
    t0 = time.perf_counter()
    p, losses = rt.fit(loss, p0, trainable=scene.trainable(), steps=steps,
                       lr=2e-3)
    seconds = time.perf_counter() - t0
    d0, m0, w0 = spectrometer_stats(torch, scene, p0, rays)
    d1, m1, w1 = spectrometer_stats(torch, scene, p, rays)
    return dict(dispersion0=d0, rms_mean0=m0, rms_max0=w0, dispersion=d1,
                rms_mean=m1, rms_max=w1, loss0=float(losses[0]),
                loss=float(losses[-1]),
                sensor_z=float(p['sensor']['trans'][2]),
                c1=float(p['lens']['c1']), c2=float(p['lens']['c2']),
                design_seconds=seconds)


def diffractive_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 13: the diffractive and ideal elements through K1, K2, K5 and
    K6 in their instantiation with the diffractive kinds: each kernel
    against its plain version (the hybrid achromat at 2,999 and 1M rays, the
    nine-channel spectrometer and the Scene of every new kind at 1M); the
    counted paths (the hybrid's and the spectrometer's ``simulate_fused``
    and grad steps at 1M rays, the Scene's, against the eager gradients);
    examples 25's and 05's designs as published on the reference's rays,
    against the JAX package's (tests/diffractive_anchors.py); then times,
    bounds (with the new kinds' operations) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

    # 13a. each kernel against its plain version
    kern = {}
    for name, n in (('hybrid', N_SMALL), ('hybrid', N_MAIN),
                    ('spectrometer', N_MAIN), ('scene', N_MAIN)):
        kern[f'{name}_{n}'] = diffractive_kernels_vs_plain(
            rt, torch, name, n, dev, DIFF_SEED + 11)
    emit('diffractive_kernels_vs_plain', **kern)

    # 13b. the counted paths at 1M rays: forward (K1 or K5 once), a grad
    # step (K1 + K2, K5 + K6) against the eager gradients
    paths = {}
    for name, lib, trained in (
            ('hybrid', 'seq', (('lens', 'c1'), ('lens', 'c2'),
                               ('doe', 'phase'))),
            ('spectrometer', 'seq', (('lens', 'c1'), ('lens', 'c2'),
                                     ('grating', 'period_um'))),
            ('scene', 'nonseq', (('ideal', 'P'), ('doe', 'phase'),
                                 ('grating', 'period_um'), ('mla', 'pitch'),
                                 ('mla', 'f')))):
        sc, params, rays, cfg, _ = diffractive_case(rt, torch, name, N_MAIN,
                                                    dev, DIFF_SEED + 13)
        nb = cfg.n_bundles
        fwd_lib = 'trace_nonseq_fwd' if lib == 'nonseq' else 'trace_seq_fwd'
        bwd_lib = fwd_lib.replace('fwd', 'bwd')
        reset_counters()
        with torch.no_grad():
            _, sens, _ = sc.simulate_fused(params, rays, nb)
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, **{fwd_lib: 1, 'diff': 1}), f'{name} launched {fl}')

        def grads(simulate):
            p = sc.init_params(dev)
            for el, k in trained:
                p[el][k].requires_grad_(True)
            _, s_, _ = simulate(p, rays, nb)
            loss = (s_.spot_rms(0) ** 2).sum() + s_.moments[0, :, 0].sum() \
                / rays.n
            loss.backward()
            return [p[el][k].grad.clone() for el, k in trained]
        reset_counters()
        g_f = grads(sc.simulate_fused)
        torch.cuda.synchronize()
        gl = counters()
        check(only(gl, **{fwd_lib: 1, bwd_lib: 1, 'diff': 2}),
              f'{name} grad step launched {gl}')
        g_e = grads(sc.simulate)
        rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                  for a, b in zip(g_f, g_e))
        paths[name] = dict(
            fwd_launches=fl, grad_launches=gl, rel_err=rel,
            sensor_share=float(sens.moments[0, :, 0].sum()) / rays.n,
            grads={f'{el}.{k}': [float(x) for x in g.reshape(-1)]
                   for (el, k), g in zip(trained, g_f)})
        check(rel < GRAD_RTOL, f'{name}: fused vs eager gradients {rel}')
    emit('diffractive_main', n=N_MAIN, **paths)

    # 13c. examples 25 and 05 as published, against the JAX package's
    anchors = {}
    reset_counters()
    got = hybrid_design(rt, torch, dev)
    torch.cuda.synchronize()
    got['launches'] = counters()
    anchors['hybrid'] = dict(got=got, ref=HYBRID_REF)
    # the design's steps, the two chromatic shifts' 2 x 2 traces (the bare
    # singlet's in the extended instantiation: it has no diffractive row)
    check(only(got['launches'], trace_seq_fwd=HYB_STEPS + 4,
               trace_seq_bwd=HYB_STEPS, diff=2 * HYB_STEPS + 2, ext=2),
          f'hybrid design launched {got["launches"]}')
    check(abs(got['shift1']) * 15.0 < abs(got['shift0']),
          f'hybrid: the shift is not cut 15x: {got}')
    check(abs(got['p_doe'] - HYB_POWER_SPLIT) < 0.25 * HYB_POWER_SPLIT,
          f'hybrid: DOE power {got["p_doe"]} (split {HYB_POWER_SPLIT})')
    for k, tol in HYB_TOL.items():
        check(abs(got[k] - HYBRID_REF[k]) <= tol,
              f'hybrid {k}: {got[k]} (JAX {HYBRID_REF[k]})')
    reset_counters()
    got = spectrometer_design(rt, torch, dev)
    torch.cuda.synchronize()
    got['launches'] = counters()
    anchors['spectrometer'] = dict(got=got, ref=SPECTROMETER_REF)
    check(only(got['launches'], trace_seq_fwd=SPEC_STEPS + 2,
               trace_seq_bwd=SPEC_STEPS, diff=2 * SPEC_STEPS + 2),
          f'spectrometer design launched {got["launches"]}')
    for k, tol in SPEC_TOL.items():
        check(abs(got[k] - SPECTROMETER_REF[k])
              <= tol * abs(SPECTROMETER_REF[k]),
              f'spectrometer {k}: {got[k]} (JAX {SPECTROMETER_REF[k]})')
    emit('diffractive_anchors', **anchors)

    # 13d. times at 1M rays against the plain versions, bounds (the new
    # kinds' operations) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    for name, key in (('hybrid', 'k1'), ('spectrometer', 'k1_spec'),
                      ('scene', 'k5')):
        sc, params, r, cfg, nonseq = diffractive_case(rt, torch, name,
                                                      N_MAIN, dev,
                                                      DIFF_SEED + 7)
        meta = sc.static_meta()
        flat = rt.flatten_table_rows(sc.build_table(params)).detach()
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        maps = fused_trace.plate_maps(meta, {})
        ext, disp = fused_trace.ext_kinds(meta), fused_trace.dispersive(meta)
        coat = fused_trace.coat_side(meta, dev)
        g_rays, g_mom, _ = random_cotangents(torch, r.n, cfg, dev, SEED + 6)
        io = (r.n * (36 + 28) + table_bytes(meta)
              + len(meta) * fused_trace.COAT_SIDE * 4)
        cols = len(fused_trace.grad_cols((), True, disp, True, True))
        blocks = -(-r.n // fused_trace.THREADS)
        setup = blocks * ELLIPSE_ROW_OPS * sum(m.sb == 3 for m in meta)
        if nonseq:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, coat=coat, diff=True))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
                disp=disp, coat=coat, diff=True))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, maps=maps))
            # the lightpipe's plain loop runs all 50 bounces of 1M rays
            # eagerly (~5 s forward, ~6 s with autograd): timed once
            plain_reps = (1, 0) if name == 'lightpipe' else (4, 1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            bounds['k5'] = bound(io, k5_ops + setup)
            bounds['k6'] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 k6_ops + setup)
        else:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, coat=coat, diff=True))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                disp=disp, coat=coat, diff=True))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps))
            reps = dict(reps=10, warmup=2)
            k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
            bounds[key] = bound(io, k1_ops + setup)
            bounds[key.replace('k1', 'k2')] = bound(
                io + r.n * 28 + len(meta) * cols * 4, 3 * k1_ops + setup)
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, **reps)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        k_ms, p_ms, k_runs, _ = time_pair(torch, bk, bp, **reps)
        timing[key.replace('k1', 'k2').replace('k5', 'k6')] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[f'{lib}_{name}'] = fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                disp=disp, diff=True)
    hyb = hybrid_scene(rt)
    h_rays = diffractive_case(rt, torch, 'hybrid', N_MAIN, dev,
                              DIFF_SEED + 13)[2]
    h_p = hyb.init_params(dev)

    def h_step():
        p = hyb.init_params(dev)
        p['doe']['phase'].requires_grad_(True)
        _, s_, _ = hyb.simulate_fused(p, h_rays, 3)
        rt.spot_size_loss(s_).backward()
    for label, fn in (
            ('simulate_fused_hybrid',
             lambda: hyb.simulate_fused(h_p, h_rays, 3)),
            ('grad_step_fused_hybrid', h_step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('diffractive_timing', **timing)
    emit('diffractive_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('diffractive_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                anchors=anchors)



# Section 14: fuzzy apodization and the obscured pupil.  The telescope
# pupil of tests/test_obscuration.py:91-111 (an outer disk of 4 mm, a 30%
# central obscuration and four vanes 0.12 mm wide, then an ideal thin lens
# f = 50 at z = 2 and the sensor at its focus, z = 52), lit by a collimated
# disk of the pupil's radius from z = -3; the Gaussian apodizer exp(-(x^2 +
# y^2) / 8) at z = 6 in the bench singlet of tests/test_pallas.py:739-748
# (sensor at z = 19, a disk of 4 mm from z = -10); the Lorentzian 1 / (1 +
# (x^2 + y^2) / 4) in the same singlet as a Scene of 6 bounces
# (tests/test_pallas.py:897-903, a disk of 3 mm); the pupil as a Scene of 4.
# The transmitted share of the uniformly lit pupil is its open area's,
# (1 - 0.3^2) - 4 * 0.12 * (4 - 1.2) / (16 pi) = 0.8833, within
# PUPIL_SHARE_TOL (tests/test_obscuration.py::test_energy_fraction's); a
# hit within an ulp of a vane edge may take the other side in the kernel,
# whose hit contracts multiply-adds (FLIPS_PER_MILLION, as elsewhere; with
# collimated light the pupil's hit is the launch's x, y exactly, so none
# does).  The apodizer's spot RMS against the JAX package's at 1M rays
# (tests/fuzzy_anchors.py: the mean over keys 0-3, within 6 of their
# standard deviations).  The design: FUZZY_DESIGN_STEPS Adam steps on the
# apodized singlet's c1 and c2 (lr FUZZY_DESIGN_LR) through K1 and K2, and
# the same through the eager trace: the curvatures end within
# FUZZY_DESIGN_RTOL of each other (per-step gradients agree to ~1e-6).
FUZZY_SEED = SEED + 1501
PUPIL_R, PUPIL_OBS, PUPIL_VANES, PUPIL_VANE_W = 4.0, 0.3, 4, 0.12
PUPIL_SHARE = ((1 - PUPIL_OBS ** 2) - PUPIL_VANES * PUPIL_VANE_W
               * (PUPIL_R - PUPIL_OBS * PUPIL_R) / (math.pi * PUPIL_R ** 2))
PUPIL_SHARE_TOL = 0.004
# The pupil's ideal lens focuses every ray onto the axis: its spot RMS is
# ~1e-7 mm of rounding, so the first and second moments are sums of ~1M
# rounding errors, which the kernel (contracted multiply-adds) and the plain
# version make otherwise.  They are held to tests/test_obscuration.py::
# test_fused_and_roundtrip's atol 1e-3 (its rtol 1e-4 is MOMENT_RTOL's).
PUPIL_MOMENT_ATOL = 1e-3
# A smooth apodizer's factor is a function of the hit, which the kernel
# computes with contracted multiply-adds (positions within POS_TOL), and its
# exp is expf against torch's (each within 2 ulps): the intensities after
# it are held to FUZZY_I_RTOL (POS_TOL's 1e-5; the factors' slopes are
# under 1 /mm), the mask's stay equal (0 or 1).
FUZZY_I_RTOL = POS_TOL
FUZZY_NS_BOUNCES, PUPIL_NS_BOUNCES = 6, 4
APOD_RMS_REF, APOD_RMS_TOL = 0.16384639963507652, 0.00020998354343547778
FUZZY_DESIGN_STEPS, FUZZY_DESIGN_LR, FUZZY_DESIGN_RTOL = 20, 2e-3, 1e-4
# 'clamp': the Gaussian's singlet with an apodizer written with **, clamp,
# == and != (ops/fuzzy_program.py lowers them into the op set), as the JAX
# kernels run such a callable
FUZZY_CASES = ('pupil', 'gauss', 'lorentz_scene', 'pupil_scene', 'clamp')
# The interpreter's cost (csrc/fuzzy.cuh): one float32 operation an
# arithmetic operation of the program, its dispatch unpriced; K2's and K6's
# reverse sweeps run the program again with three partials an operation.
FUZZY_PARTIALS = 3


def gauss_apodizer(torch):
    """exp(-(x^2 + y^2) / 8), tests/test_pallas.py:735-736."""
    def apod(x, y, z):
        return torch.exp(-(x * x + y * y) / 8.0)
    return apod


def clamp_apodizer(torch):
    """clamp(1 - (x^2 + y^2) / 20, 0.05, 1)^2, zero where x == 0 or y !=
    y: the lowered operations of ops/fuzzy_program.py."""
    def apod(x, y, z):
        w = torch.clamp(1.0 - (x ** 2 + y ** 2) / 20.0, 0.05, 1.0) ** 2
        return torch.where((x == 0.0) | (y != y), 0.0, w)
    return apod


def lorentz_apodizer(x, y, z):
    """1 / (1 + (x^2 + y^2) / 4), tests/test_pallas.py:895-896."""
    return 1.0 / (1.0 + (x * x + y * y) / 4.0)


def pupil_scene(rt, n_bounces=None):
    """The obscured pupil before an ideal thin lens focusing on the
    sensor; a Scene of ``n_bounces`` when given."""
    els = [rt.ObscuredAperture(radius=PUPIL_R, obscuration=PUPIL_OBS,
                               n_vanes=PUPIL_VANES, vane_width=PUPIL_VANE_W,
                               name='pupil'),
           rt.IdealThinLens(focal=50.0, diameter=12.0,
                            translation=[0, 0, 2.0], name='lens'),
           rt.SensorElement(radius=6.0, translation=[0, 0, 52.0], name='s')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def apodizer_scene(rt, fn, n_bounces=None):
    """The bench singlet (curvatures trainable) with the component-style
    apodizer ``fn`` at z = 6 and the sensor at z = 19; a Scene of
    ``n_bounces`` when given."""
    els = [rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                          c1_grad=True, c2_grad=True, name='lens'),
           rt.FuzzyAperture(fn, components=True, name='apod',
                            translation=[0, 0, 6.0]),
           rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def fuzzy_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, cfg, nonseq) of a section 14 case: 'pupil',
    'gauss', 'lorentz_scene', 'pupil_scene' and 'clamp'."""
    if name.startswith('pupil'):
        sc = pupil_scene(rt, PUPIL_NS_BOUNCES if name == 'pupil_scene'
                         else None)
        radius, z0 = PUPIL_R, -3.0
    elif name == 'gauss':
        sc, radius, z0 = apodizer_scene(rt, gauss_apodizer(torch)), 4.0, -10.0
    elif name == 'clamp':
        sc, radius, z0 = apodizer_scene(rt, clamp_apodizer(torch)), 4.0, -10.0
    else:
        sc = apodizer_scene(rt, lorentz_apodizer, FUZZY_NS_BOUNCES)
        radius, z0 = 3.0, -10.0
    gen = torch.Generator(device=device).manual_seed(seed)
    rays = rt.CollimatedDisk.make(radius=radius,
                                  translation=[0, 0, z0]).sample(gen, n,
                                                                 device)
    return (sc, sc.init_params(device), rays, sc.sensor_config(),
            not sc.sequential)


def fuzzy_inputs(rt, torch, sc, params, rays, cfg):
    """The fused trace's inputs of a fuzzy scene: (TraceMeta, flat table,
    kinds, maps, coat side buffer, program buffer)."""
    from raytracetorch_tpu_torch.ops import fused_trace
    dev = rays.px.device
    meta = fused_trace.TraceMeta(sc.static_meta(), sc.fuzzy_fns())
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    return (meta, flat, kinds, fused_trace.plate_maps(meta, {}),
            fused_trace.coat_side(meta, dev),
            fused_trace.fuzzy_buffer(meta, dev))


def fuzzy_kernels_vs_plain(rt, torch, name, n, device, seed):
    """K1 and K2 (the Scenes: K5 and K6) in their instantiation with fuzzy
    programs against their plain versions (which call the callables) on a
    section 14 case: the rays and moments, then the ray and table cotangents
    under seeded cotangents on the rays both trace alike; K6's replay
    against K5 bit for bit -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, cfg, nonseq = fuzzy_case(rt, torch, name, n, device,
                                               seed)
    meta, flat, kinds, maps, coat, prog = fuzzy_inputs(rt, torch, sc, params,
                                                       rays, cfg)
    ext = fused_trace.ext_kinds(meta)
    if nonseq:
        nb = sc.n_bounces
        kfwd = (lambda r: fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, r, cfg, nb, maps, ext, coat=coat, fuzzy=prog))
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps)
    else:
        kfwd = (lambda r: fused_trace.trace_seq_fwd_cuda(
            flat, kinds, r, cfg, maps, ext, coat=coat, fuzzy=prog))
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps)
    out_k, s_k = kfwd(rays)
    torch.cuda.synchronize()
    pupil = name.startswith('pupil')
    i_rtol = 0.0 if pupil else FUZZY_I_RTOL
    apart = traced_apart(torch, out_k, out_p, i_rtol)[0]
    res = compare(torch, out_k, s_k, out_p, s_p, intensity_rtol=i_rtol,
                  moment_atol=PUPIL_MOMENT_ATOL if pupil else 1e-6)
    res.update(rows=len(meta), program_words=int(prog.numel()),
               transmitted=float(out_k.intensity.double().mean()))
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, device,
                                         seed + 2)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
            coat=coat, fuzzy=prog, replay=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, maps=maps)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=ext,
            coat=coat, fuzzy=prog)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, maps=maps)
    torch.cuda.synchronize()
    if nonseq:
        out_r = kfwd(rays)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_r, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1],
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq
        else None)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True,
        coat=True, diff=True))
    # the apodizer's (or the pupil's) row carries a table cotangent
    res['bwd']['fuzzy_row_grad'] = float(g_k[0][min(meta.fuzzy)].abs().max())
    return res


def fuzzy_program_ops(meta):
    """The arithmetic operations of each row's program (0 without one)."""
    from raytracetorch_tpu_torch.ops import fuzzy_program
    return [sum(op[0] != fuzzy_program.CODE['const']
                for op in fuzzy_program.trace(meta.fuzzy[k]).ops)
            if k in meta.fuzzy else 0 for k in range(len(meta))]


def fuzzy_design(rt, torch, device, simulate_name, rays):
    """FUZZY_DESIGN_STEPS Adam steps on the Gaussian-apodized singlet's c1
    and c2 through ``simulate_name`` (simulate_fused: K1, K2 each step) ->
    dict of the losses and the curvatures."""
    sc = apodizer_scene(rt, gauss_apodizer(torch))
    simulate = getattr(sc, simulate_name)

    def loss(p):
        _, sens, _ = simulate(p, rays)
        return sens.spot_rms(0)[0]
    t0 = time.perf_counter()
    p, hist = rt.fit(loss, sc.init_params(device), trainable=sc.trainable(),
                     steps=FUZZY_DESIGN_STEPS, lr=FUZZY_DESIGN_LR)
    torch.cuda.synchronize()
    return dict(loss0=float(hist[0]), loss=float(hist[-1]),
                c1=float(p['lens']['c1']), c2=float(p['lens']['c2']),
                seconds=time.perf_counter() - t0)


def fuzzy_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 14: fuzzy apodization and the obscured pupil through K1, K2,
    K5 and K6 in their instantiation with fuzzy programs: each kernel
    against its plain version (at 2,999 and 1M rays); the counted paths (the
    pupil's ``simulate_fused`` against the eager trace and the open area,
    the apodizer's forward and grad step against the eager gradients in the
    curvatures and the ray streams, its spot RMS against the JAX package's,
    the Scenes' forward and grad steps); a 20-step design through K1 and K2
    against the eager one; then times, bounds (with the programs'
    operations) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

    # 14a. each kernel against its plain version
    kern = {}
    for name in FUZZY_CASES:
        for n in (N_SMALL, N_MAIN):
            kern[f'{name}_{n}'] = fuzzy_kernels_vs_plain(
                rt, torch, name, n, dev, FUZZY_SEED + 11)
    emit('fuzzy_kernels_vs_plain', **kern)

    # 14b. the counted paths at 1M rays
    paths = {}
    sc, params, rays, cfg, _ = fuzzy_case(rt, torch, 'pupil', N_MAIN, dev,
                                          FUZZY_SEED + 13)
    reset_counters()
    with torch.no_grad():
        out_f, s_f, _ = sc.simulate_fused(params, rays)
    torch.cuda.synchronize()
    fl = counters()
    # the pupil's IdealThinLens is of the diffractive family
    check(only(fl, trace_seq_fwd=1, diff=1, fuzzy=1),
          f'pupil launched {fl}')
    out_e, s_e, _ = sc.simulate(params, rays)
    share = float(out_f.intensity.double().sum()) / rays.n
    flips = int(((out_f.intensity - out_e.intensity).abs() > 0.5).sum())
    paths['pupil'] = dict(
        fwd_launches=fl, transmitted_share=share, open_area=PUPIL_SHARE,
        eager_flips=flips, flips_allowed=math.ceil(FLIPS_PER_MILLION
                                                   * rays.n / 1e6),
        spot_rms=float(s_f.spot_rms(0)[0]),
        eager_spot_rms=float(s_e.spot_rms(0)[0]))
    check(abs(share - PUPIL_SHARE) <= PUPIL_SHARE_TOL,
          f'pupil share {share} (open area {PUPIL_SHARE})')
    check(flips <= paths['pupil']['flips_allowed'],
          f'pupil: {flips} rays differ from the eager trace')

    sc, params, rays, cfg, _ = fuzzy_case(rt, torch, 'gauss', N_MAIN, dev,
                                          FUZZY_SEED + 13)
    reset_counters()
    with torch.no_grad():
        _, s_f, _ = sc.simulate_fused(params, rays)
    torch.cuda.synchronize()
    fl = counters()
    check(only(fl, trace_seq_fwd=1, fuzzy=1), f'apodizer launched {fl}')

    def grads(simulate):
        p = sc.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        comps = [getattr(rays, c).clone().requires_grad_(True)
                 for c in fused_trace.COMPS]
        r = rays.replace(**dict(zip(fused_trace.COMPS, comps)))
        _, s_, _ = simulate(p, r)
        s_.spot_rms(0)[0].backward()
        return [p['lens']['c1'].grad, p['lens']['c2'].grad], \
            [c.grad for c in comps]
    reset_counters()
    gp_f, gr_f = grads(sc.simulate_fused)
    torch.cuda.synchronize()
    gl = counters()
    check(only(gl, trace_seq_fwd=1, trace_seq_bwd=1, fuzzy=2),
          f'apodizer grad step launched {gl}')
    gp_e, gr_e = grads(sc.simulate)
    rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
              for a, b in zip(gp_f, gp_e))
    # the spot RMS's cotangent of an incoming intensity is a sum of its
    # moments' terms at the hit that nearly cancel (scaling every intensity
    # leaves the RMS alone), so the hits' rounding in another order reads
    # ~1e-4 of it: BWD_TOL's rule at DISP_BWD_TOL (without the apodizer
    # 42,248 of 1M rays exceed BWD_TOL's bound on an H100)
    ray_res = compare_ray_cotangents(torch, gr_f, gr_e, tol=DISP_BWD_TOL)
    rms = float(s_f.spot_rms(0)[0])
    paths['apodizer'] = dict(
        fwd_launches=fl, grad_launches=gl, rel_err=rel,
        grads=[float(g) for g in gp_f], ray_cotangents=ray_res,
        spot_rms=rms, spot_rms_ref=APOD_RMS_REF, spot_rms_tol=APOD_RMS_TOL,
        transmitted=float(s_f.moments[0, 0, 0]) / rays.n)
    check(rel < GRAD_RTOL, f'apodizer: fused vs eager gradients {rel}')
    check(abs(rms - APOD_RMS_REF) <= APOD_RMS_TOL,
          f'apodizer spot RMS {rms} (JAX {APOD_RMS_REF})')

    for name, trained in (('lorentz_scene', ('c1', 'c2')),
                          ('pupil_scene', ())):
        sc, params, rays, cfg, _ = fuzzy_case(rt, torch, name, N_MAIN, dev,
                                              FUZZY_SEED + 13)
        reset_counters()
        with torch.no_grad():
            out_f, s_f, _ = sc.simulate_fused(params, rays)
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, trace_nonseq_fwd=1, fuzzy=1,
                   diff=int(name == 'pupil_scene')),
              f'{name} launched {fl}')
        ent = dict(fwd_launches=fl,
                   transmitted=float(out_f.intensity.double().mean()))
        if trained:
            def ns_grads(simulate):
                p = sc.init_params(dev)
                for k in trained:
                    p['lens'][k].requires_grad_(True)
                _, s_, _ = simulate(p, rays)
                s_.spot_rms(0)[0].backward()
                return [p['lens'][k].grad for k in trained]
            reset_counters()
            g_f = ns_grads(sc.simulate_fused)
            torch.cuda.synchronize()
            gl = counters()
            check(only(gl, trace_nonseq_fwd=1, trace_nonseq_bwd=1, fuzzy=2),
                  f'{name} grad step launched {gl}')
            g_e = ns_grads(sc.simulate)
            rel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                      for a, b in zip(g_f, g_e))
            ent.update(grad_launches=gl, rel_err=rel,
                       grads=[float(g) for g in g_f])
            check(rel < GRAD_RTOL, f'{name}: fused vs eager gradients {rel}')
        else:
            check(abs(ent['transmitted'] - PUPIL_SHARE) <= PUPIL_SHARE_TOL,
                  f'{name}: share {ent["transmitted"]}')
        paths[name] = ent
    emit('fuzzy_main', n=N_MAIN, **paths)

    # 14c. a design through K1 and K2 against the eager one
    d_rays = fuzzy_case(rt, torch, 'gauss', N_MAIN, dev, FUZZY_SEED + 17)[2]
    reset_counters()
    fused = fuzzy_design(rt, torch, dev, 'simulate_fused', d_rays)
    fused['launches'] = counters()
    eager = fuzzy_design(rt, torch, dev, 'simulate', d_rays)
    design = dict(fused=fused, eager=eager, steps=FUZZY_DESIGN_STEPS)
    emit('fuzzy_design', **design)
    check(only(fused['launches'], trace_seq_fwd=FUZZY_DESIGN_STEPS,
               trace_seq_bwd=FUZZY_DESIGN_STEPS,
               fuzzy=2 * FUZZY_DESIGN_STEPS),
          f'fuzzy design launched {fused["launches"]}')
    check(fused['loss'] < fused['loss0'], f'the design did not fall: {fused}')
    for k in ('c1', 'c2'):
        check(abs(fused[k] - eager[k]) <= FUZZY_DESIGN_RTOL * abs(eager[k]),
              f'design {k}: fused {fused[k]} vs eager {eager[k]}')

    # 14d. times at 1M rays against the plain versions, bounds (the
    # programs' operations) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    for name, key in (('gauss', 'k1'), ('pupil', 'k1_pupil'),
                      ('lorentz_scene', 'k5'), ('pupil_scene', 'k5_pupil')):
        sc, params, r, cfg, nonseq = fuzzy_case(rt, torch, name, N_MAIN, dev,
                                                FUZZY_SEED + 7)
        meta, flat, kinds, maps, coat, prog = fuzzy_inputs(
            rt, torch, sc, params, r, cfg)
        ext = fused_trace.ext_kinds(meta)
        g_rays, g_mom, _ = random_cotangents(torch, r.n, cfg, dev, SEED + 6)
        io = (r.n * (36 + 28) + table_bytes(meta) + prog.numel() * 4
              + (0 if coat is None else coat.numel() * 4))
        cols = len(fused_trace.grad_cols((), True, False, coat is not None,
                                         True))
        pops = fuzzy_program_ops(meta)
        if nonseq:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, coat=coat, fuzzy=prog))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
                coat=coat, fuzzy=prog))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, maps=maps))
            reps = dict(reps=6, warmup=1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            prog_ops = sum(w * o for w, o in zip(wins, pops))
            bounds[key] = bound(io, k5_ops + prog_ops)
            bounds[key.replace('k5', 'k6')] = bound(
                io + r.n * 28 + len(meta) * cols * 4,
                k6_ops + (2 + 1 + FUZZY_PARTIALS) * prog_ops)
        else:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, coat=coat, fuzzy=prog))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                coat=coat, fuzzy=prog))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps))
            reps = dict(reps=10, warmup=2)
            k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m) for m in meta)
            prog_ops = r.n * sum(pops)
            bounds[key] = bound(io, k1_ops + prog_ops)
            bounds[key.replace('k1', 'k2')] = bound(
                io + r.n * 28 + len(meta) * cols * 4,
                3 * k1_ops + (2 + FUZZY_PARTIALS) * prog_ops)
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, **reps)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs,
                           program_ops=pops)
        k_ms, p_ms, k_runs, _ = time_pair(torch, bk, bp, **reps)
        timing[key.replace('k1', 'k2').replace('k5', 'k6')] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[f'{lib}_{name}'] = fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                diff=True, fuzzy_words=int(prog.numel()))
    sc, params, rays, _, _ = fuzzy_case(rt, torch, 'gauss', N_MAIN, dev,
                                        FUZZY_SEED + 13)

    def step():
        p = sc.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        _, s_, _ = sc.simulate_fused(p, rays)
        s_.spot_rms(0)[0].backward()
    for label, fn in (
            ('simulate_fused_apodizer',
             lambda: sc.simulate_fused(params, rays)),
            ('grad_step_fused_apodizer', step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('fuzzy_timing', **timing)
    emit('fuzzy_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('fuzzy_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                design=design)


# Section 15: freeform, Zernike and wedge lenses.  Example 19's freeform
# astigmatism corrector (examples/19_freeform_corrector.py: a flat window of
# N-BK7 at z = 20 whose front face carries the XY terms x^2, y^2, x^2 y,
# y^3, xy, before a spherical mirror R = 100 tilted 8 degrees at z = 50, the
# sensor at the medial focus), lit by its beam (a uniform 16 mm square of
# collimated rays from z = -10, those outside the 8 mm disk at intensity 0,
# rays/reference_prng.py's draws of jax.random.uniform); in the kernel
# comparisons its terms carry EX19_COEFFS (near its design's) and it runs as
# a sequence and as a Scene of FF_NS_BOUNCES (the folded beam crosses the
# window again).  Example 20's Zernike corrector
# (examples/20_zernike_corrector.py): the tilted plano-convex singlet is
# measured through K1 with track_opl (the OPD about best focus fitted to 28
# Noll terms), and every term from 4 on above EX20_MIN_WAVES becomes the
# plate's prescription z_j = W_j / (n - 1); then its wavefront RMS and its
# grad step in z1.  Example 26's Shack-Hartmann sensor
# (examples/26_shack_hartmann.py: a Zernike plate with a hidden
# astigmatism and coma before a 0.8 mm microlens array of f = 25 and the
# detector at its focus), lit by uniform rays in the middle of each lenslet
# cell of the sampled pupil, as its sub-grid is: the per-cell centroids'
# slopes reconstruct the hidden coefficients within EX26_ATOL (the
# example's own check).  Example 19's design as published:
# Adam, EX19_DESIGN_STEPS steps at EX19_DESIGN_LR on the spot RMS^2 of
# EX19_DESIGN_RAYS rays, through K1 and K2, and its first EX19_EAGER_STEPS
# steps through the eager trace; the two designs' losses there agree within
# EX19_DESIGN_RTOL, and the fused design lands on the JAX package's anchors
# (tests/freeform_anchors.py): the uncorrected RMS (both designs) within
# EX19_RMS0_RTOL, the corrected within EX19_RMS1_RTOL, and the x^2 and y^2
# coefficients of opposite signs.
FREEFORM_SEED = SEED + 1601
EX19_R, EX19_THETA, EX19_GLASS = 100.0, math.radians(8.0), 1.5168
EX19_TERMS = ((2, 0), (0, 2), (2, 1), (0, 3), (1, 1))
EX19_COEFFS = (2.0e-4, -2.2e-4, 1.0e-6, -1.5e-6, 1.0e-5)
EX19_BEAM = 8.0
EX19_DESIGN_RAYS, EX19_DESIGN_STEPS, EX19_DESIGN_LR = 20_000, 400, 2e-4
# The eager design runs the first EX19_EAGER_STEPS of those steps (its host
# cost, ~0.2 s a step, is the smoke's largest: the whole design took the
# smoke to 1055.7 s on a slower host; 100 steps kept it over 800 s once
# section 22 came), and its loss there is held to the fused design's loss
# at the same step within EX19_DESIGN_RTOL.
EX19_EAGER_STEPS = 50
FF_NS_BOUNCES = 12
EX20_BEAM_R, EX20_TILT, EX20_WAVELEN = 6.0, 0.03, 0.587e-3
EX20_N_TERMS, EX20_MIN_WAVES = 28, 0.05
EX26_PITCH, EX26_F, EX26_R, EX26_GLASS = 0.8, 25.0, 4.0, 1.5
EX26_HIDDEN = {6: 4e-4, 8: 3e-4}
EX26_CONTROLS = (4, 7, 11)
EX26_ATOL = 3e-5
# 'ex20_wide': example 20's plate with every Noll term 4..28 (small
# alternating coefficients): 28 monomials of degree <= 6, the widest
# Zernike set a MAX_FF_TERMS face takes from that range
EX20_WIDE_TERMS = tuple((j, 2e-5 * (-1) ** j) for j in range(4, 29))
FREEFORM_CASES = ('ex19', 'ex19_scene', 'ex20', 'ex20_wide', 'ex26')
# A path length is a running float32 sum of one segment a row: each row
# rounds the sum (half an ulp of the path) and the segment's length, whose
# end points the kernel's contracted multiply-adds round otherwise than the
# plain version or the eager trace (about an ulp of the path), so a ray's
# path lengths are held within OPL_ULPS_PER_ROW ulps of the largest path a
# row (opl_tol; an H100 80GB HBM3 read at most 5 ulps over example 20's 7
# rows at 1M rays).
OPL_ULPS_PER_ROW = 2
# Example 20's corrected wavefront is ~0.07 waves RMS, near the float32
# rounding of its path lengths (ulp(64 mm) = 7.6e-6 mm = 0.013 waves a
# ray), so the fused and eager RMS differ by the spread of those roundings
# (0.0743 against 0.0737 waves on an H100 80GB HBM3, their z1 gradients
# 1.8% apart in norm; chip_fmad.py shows the gap close with -fmad=false).
# The fused run is therefore held to the eager one ray by ray (opl_tol,
# POS_TOL), its RMS to the eager one's within the RMS of the path lengths'
# differences, and its gradient to the eager adjoint taken at the fused
# run's values (GRAD_RTOL in norm); the gradients' gap is reported.
# Example 19's anchors from the JAX package (tests/freeform_anchors.py, on
# the same rays: rays/reference_prng.py's draws), and their tolerances: the
# port's eager design on the CPU starts within 6.4e-10 and ends within
# 1.0e-6 of the JAX package's; the card contracts multiply-adds and rounds
# each of the 400 Adam steps otherwise, so the uncorrected RMS is held to
# EX19_RMS0_RTOL and the corrected to EX19_RMS1_RTOL, and the fused design's
# loss at step EX19_EAGER_STEPS to EX19_DESIGN_RTOL of the eager one's (an
# H100 80GB HBM3 read 8.5e-6).
EX19_RMS0_REF, EX19_RMS1_REF = 0.08329896628856659, 0.004943932872265577
EX19_RMS0_RTOL, EX19_RMS1_RTOL = 1e-4, 0.01
EX19_DESIGN_RTOL = 1e-4
# A freeform root converges when its final |G| < 1e-4 after 8 Newton steps;
# a ray whose |G| lies within rounding of that threshold, or whose hit lies
# within an ulp of a bound's rim, can take the other branch in the kernel
# (contracted multiply-adds) than in the plain version.  Such rays are
# counted against FF_FLIPS_PER_MILLION: an H100 80GB HBM3 read none at
# 2,999 and 1M rays on every section 15 case, so the allowance stays every
# other kind's, FLIPS_PER_MILLION.
FF_FLIPS_PER_MILLION = FLIPS_PER_MILLION
# The operations of a freeform row's intersection (csrc/freeform.cuh): per
# root 9 evaluations of G (8 steps and the final test), each the radial
# sag and slope (FF_RADIAL_OPS), the step (FF_STEP_OPS) and per term its
# powers and products (freeform_term_ops); the normal one more evaluation;
# K2 and K6 reverse each evaluation at FF_BWD_FACTOR times its cost (the
# second partials, the terms' cotangents).  Every section 15 freeform row
# has a plane base (c = 0), whose two roots are one t on the solver's
# linear path: the kernels refine it once (FF_ROOTS).
FF_RADIAL_OPS, FF_STEP_OPS, FF_EVALS = 40, 12, 9
FF_BWD_FACTOR, FF_ROOTS = 3, 1


def opl_tol(torch, opl, rows):
    """OPL_ULPS_PER_ROW float32 ulps of the largest |opl| per row."""
    m = opl.abs().max().float()
    return OPL_ULPS_PER_ROW * rows * float(
        torch.nextafter(m, m.new_tensor(math.inf)) - m)


def freeform_term_ops(i, j):
    """The multiplies and adds of one term's sag and partials."""
    return max(i - 1, 0) + max(j - 1, 0) + max(i - 2, 0) + max(j - 2, 0) + 9


def freeform_ops(meta):
    """(forward, reverse) operations of a freeform row (0, 0 for another):
    FF_ROOTS x FF_EVALS evaluations + the normal's, each the radial part
    and every term."""
    if not meta.ff:
        return 0, 0
    per_eval = FF_RADIAL_OPS + FF_STEP_OPS + sum(freeform_term_ops(i, j)
                                                for i, j in meta.ff)
    fwd = (FF_ROOTS * FF_EVALS + 1) * per_eval
    return fwd, FF_BWD_FACTOR * fwd


def ex19_scene(rt, coeffs=(0.0,) * 5, n_bounces=None):
    """Example 19's scene: the freeform window (its terms trainable), the
    tilted mirror and the sensor at the medial focus; a Scene of
    ``n_bounces`` when given."""
    d_beam = [0.0, math.sin(2 * EX19_THETA), -math.cos(2 * EX19_THETA)]
    sens = [50.0 * d_beam[0], 50.0 * d_beam[1], 50.0 + 50.0 * d_beam[2]]
    els = [rt.FreeformLens(c1=0.0, c2=0.0, d=24.0, t=2.0,
                           ior_glass=EX19_GLASS, translation=[0, 0, 20.0],
                           xy1=[(i, j, c) for (i, j), c in zip(EX19_TERMS,
                                                                coeffs)],
                           xy1_grad=True, name='corrector'),
           rt.SphericalMirror(c1=-1.0 / EX19_R, d=30.0,
                              translation=[0, 0, 50.0],
                              rotation=[EX19_THETA, 0, 0], name='mirror'),
           rt.SensorElement(radius=6.0, translation=sens,
                            rotation=[math.pi - 2 * EX19_THETA, 0, 0],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def square_beam(rt, torch, n, half, device, seed=0):
    """Example 19's and 20's beam: x, y uniform on [-half, half]^2 (the
    reference's jax.random.uniform(PRNGKey(seed), (2, n)) draws), from z =
    -10 along z, at intensity 1 inside the disk of radius ``half`` and 0
    outside it."""
    from raytracetorch_tpu_torch.rays import reference_prng
    import numpy as np
    xy = reference_prng.uniform(reference_prng.prng_key(seed), 2 * n,
                                -half, half).reshape(2, n)
    pos = np.stack([xy[0], xy[1], np.full(n, -10.0, np.float32)], -1)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    ok = (xy[0] ** 2 + xy[1] ** 2 <= np.float32(half * half))
    return rt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d),
                          intensity=torch.from_numpy(ok.astype(np.float32)),
                          device=device, wavelength=torch.zeros(n))


def ex20_scene(rt, z_terms=None):
    """Example 20's scene: the Zernike plate with ``z_terms`` (trainable;
    none: the bare system), the tilted plano-convex singlet and the
    sensor."""
    els = []
    if z_terms:
        els.append(rt.ZernikeLens(c1=0.0, c2=0.0, d=2.2 * EX20_BEAM_R, t=2.0,
                                  ior_glass=EX19_GLASS, z1=z_terms,
                                  z1_grad=True, norm_radius=EX20_BEAM_R,
                                  translation=[0, 0, -5.0],
                                  name='corrector'))
    els += [rt.SingletLens(c1=0.0, c2=-1.0 / (50.0 * (EX19_GLASS - 1.0)),
                           d=16.0, t=3.0, ior_glass=EX19_GLASS,
                           rotation=[EX20_TILT, 0.0, 0.0], name='lens'),
            rt.SensorElement(radius=10.0, translation=[0, 0, 52.0],
                             name='sensor')]
    return rt.SequentialScene(els)


def ex20_wavefront(rt, torch, scene, params, rays):
    """The traced wavefront through ``simulate_fused(track_opl=True)`` ->
    (RMS in waves about the refocused point, the 28 Noll coefficients of
    the OPD about best focus, in lens units)."""
    from raytracetorch_tpu_torch.utils import wavefront
    out, _, aux = scene.simulate_fused(params, rays, track_opl=True)
    w = out.intensity
    rms = wavefront.wavefront_rms(out, aux['opl'], weights=w,
                                  refocus=True) / EX20_WAVELEN
    focus = wavefront.best_focus(out)
    opd = wavefront.opl_to_point(out, aux['opl'], focus)
    pupil = torch.stack([rays.px, rays.py], 1)
    coef = wavefront.zernike_fit(pupil, opd, EX20_BEAM_R, weights=w,
                                 n_terms=EX20_N_TERMS)
    return rms, coef


def ex20_prescription(rt, torch, device):
    """Example 20's steps 1 and 2: the bare system's measured Noll terms
    from 4 on above EX20_MIN_WAVES, as plate coefficients W_j / (n - 1) ->
    (terms, the bare RMS in waves)."""
    rays = square_beam(rt, torch, 20_000, EX20_BEAM_R, device)
    bare = ex20_scene(rt)
    with torch.no_grad():
        rms, coef = ex20_wavefront(rt, torch, bare, bare.init_params(device),
                                   rays)
    terms = [(i + 1, float(c) / (EX19_GLASS - 1.0))
             for i, c in enumerate(coef.tolist())
             if i >= 3 and abs(c) / EX20_WAVELEN > EX20_MIN_WAVES]
    return terms, float(rms)


def ex26_scene(rt):
    """Example 26's Shack-Hartmann sensor: the hidden Zernike plate, the
    microlens array and the detector at its focal plane."""
    return rt.SequentialScene([
        rt.ZernikeLens(c1=0.0, c2=0.0, d=2 * EX26_R + 2, t=1.0,
                       ior_glass=EX26_GLASS, z1=sorted(EX26_HIDDEN.items()),
                       norm_radius=EX26_R, name='plate'),
        rt.MicrolensArray(half_x=EX26_R, half_y=EX26_R, pitch=EX26_PITCH,
                          f=EX26_F, translation=[0, 0, 4.0], name='mla'),
        rt.SensorElement(radius=2 * EX26_R, translation=[0, 0, 4.0 + EX26_F],
                         name='det')])


def ex26_rays(rt, torch, n, device, seed):
    """Collimated rays from z = -5 over the pupil's lenslet cells, each
    inside the middle of its cell as the example's 11 x 11 sub-grid is
    (within 5/11 of 0.8 pitch of the centre, so that no ray crosses into
    the neighbour lenslet), kept within radius R - pitch (numpy, seeded)
    -> (Rays, x, y)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    half = 5.0 / 11.0 * 0.8 * EX26_PITCH
    m = 2 * n + 1024
    cells = rng.integers(-4, 5, size=(2, m)) * EX26_PITCH
    xy = cells + rng.uniform(-half, half, size=(2, m))
    keep = np.hypot(xy[0], xy[1]) <= EX26_R - EX26_PITCH
    x, y = (xy[0][keep][:n].astype(np.float32),
            xy[1][keep][:n].astype(np.float32))
    pos = np.stack([x, y, np.full(n, -5.0, np.float32)], -1)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    return (rt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d),
                           device=device, wavelength=torch.zeros(n)), x, y)


def ex26_reconstruct(rt, out, x0, y0):
    """Example 26's modal least squares: per-cell centroid slopes of the
    detector hits against the Zernike slope basis averaged over the same
    rays -> {Noll j: recovered coefficient}."""
    import numpy as np
    from raytracetorch_tpu_torch.geom.zernike import noll_nm, zernike_xy_poly
    alive = out.intensity.cpu().numpy() > 0
    px, py = out.px.cpu().numpy(), out.py.cpu().numpy()
    cx = EX26_PITCH * np.floor(x0 / EX26_PITCH + 0.5)
    cy = EX26_PITCH * np.floor(y0 / EX26_PITCH + 0.5)
    cells = np.round(cx / EX26_PITCH).astype(np.int64) * 1000 + np.round(
        cy / EX26_PITCH).astype(np.int64)
    keys, inv = np.unique(cells[alive], return_inverse=True)
    count = np.bincount(inv).astype(np.float64)

    def cell_mean(v):
        return np.bincount(inv, weights=v[alive].astype(np.float64)) / count
    s_meas = np.concatenate([(cell_mean(px) - cell_mean(cx)) / EX26_F,
                             (cell_mean(py) - cell_mean(cy)) / EX26_F])
    js = sorted(EX26_HIDDEN) + list(EX26_CONTROLS)
    u, v = x0.astype(np.float64) / EX26_R, y0.astype(np.float64) / EX26_R
    scale = -(EX26_GLASS - 1.0) / EX26_R
    cols = []
    for j in js:
        dzdx, dzdy = np.zeros_like(u), np.zeros_like(u)
        for (i, k), c in zernike_xy_poly(*noll_nm(j)).items():
            c = float(c)
            if i > 0:
                dzdx += c * i * u ** (i - 1) * v ** k
            if k > 0:
                dzdy += c * k * u ** i * v ** (k - 1)
        cols.append(np.concatenate([cell_mean(dzdx) * scale,
                                    cell_mean(dzdy) * scale]))
    coef = np.linalg.lstsq(np.stack(cols, -1), s_meas, rcond=None)[0]
    return {j: float(c) for j, c in zip(js, coef)}, len(keys)


def freeform_case(rt, torch, name, n, device, seed, ex20_terms=None):
    """(scene, params, rays, cfg, nonseq) of a section 15 case: 'ex19',
    'ex19_scene', 'ex20' (the plate of ``ex20_terms``), 'ex20_wide' (of
    EX20_WIDE_TERMS) and 'ex26'."""
    if name.startswith('ex19'):
        sc = ex19_scene(rt, EX19_COEFFS, FF_NS_BOUNCES if name == 'ex19_scene'
                        else None)
        rays = square_beam(rt, torch, n, EX19_BEAM, device, seed)
    elif name.startswith('ex20'):
        sc = ex20_scene(rt, EX20_WIDE_TERMS if name == 'ex20_wide'
                        else ex20_terms)
        rays = square_beam(rt, torch, n, EX20_BEAM_R, device, seed)
    else:
        sc = ex26_scene(rt)
        rays = ex26_rays(rt, torch, n, device, seed)[0]
    return (sc, sc.init_params(device), rays, sc.sensor_config(),
            not sc.sequential)


def freeform_inputs(rt, torch, sc, params, rays, cfg):
    """The fused trace's inputs of a freeform scene: (TraceMeta, flat
    table, kinds, maps, coat side buffer, program buffer, exponent
    pairs)."""
    from raytracetorch_tpu_torch.ops import fused_trace
    dev = rays.px.device
    meta = fused_trace.TraceMeta(sc.static_meta(), sc.fuzzy_fns())
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    return (meta, flat, kinds, fused_trace.plate_maps(meta, {}),
            fused_trace.coat_side(meta, dev),
            fused_trace.fuzzy_buffer(meta, dev),
            fused_trace.ff_side(meta, dev))


def freeform_kernels_vs_plain(rt, torch, name, n, device, seed,
                              ex20_terms=None):
    """K1 and K2 (the Scene: K5 and K6) in their instantiation with freeform
    surfaces against their plain versions on a section 15 case: the rays
    and moments (example 20's with the path length), then the ray and table
    cotangents under seeded cotangents on the rays both trace alike; K6's
    replay against K5 bit for bit -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, cfg, nonseq = freeform_case(rt, torch, name, n, device,
                                                  seed, ex20_terms)
    meta, flat, kinds, maps, coat, prog, ff = freeform_inputs(
        rt, torch, sc, params, rays, cfg)
    ext = fused_trace.ext_kinds(meta)
    opl = name.startswith('ex20')
    if nonseq:
        nb = sc.n_bounces
        kfwd = (lambda r: fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, r, cfg, nb, maps, ext, coat=coat, fuzzy=prog, ff=ff))
        res_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps)
    else:
        kfwd = (lambda r: fused_trace.trace_seq_fwd_cuda(
            flat, kinds, r, cfg, maps, ext, track_opl=opl, coat=coat,
            fuzzy=prog, ff=ff))
        res_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, track_opl=opl)
    res_k = kfwd(rays)
    torch.cuda.synchronize()
    out_k, s_k, out_p, s_p = res_k[0], res_k[1], res_p[0], res_p[1]
    apart = traced_apart(torch, out_k, out_p)[0]
    n_apart = int(apart.sum())
    allowed = math.ceil(FF_FLIPS_PER_MILLION * rays.n / 1e6)
    res = compare(torch, out_k, s_k, out_p, s_p) if n_apart <= allowed \
        else dict(flipped=n_apart)
    res.update(rows=len(meta), flipped=n_apart, flips_allowed=allowed,
               ff_terms=[len(m.ff or ()) for m in meta],
               transmitted=float(out_k.intensity.double().mean()))
    check(n_apart <= allowed, f'{name}: {n_apart} rays apart (allowed '
          f'{allowed})')
    if opl:
        keep = ~apart
        res['opl_max_abs_err'] = float(
            (res_k[2]['opl'] - res_p[2]['opl'])[keep].abs().max())
        res['n_final_equal'] = bool(torch.equal(res_k[2]['n_final'][keep],
                                                res_p[2]['n_final'][keep]))
        res['opl_tol'] = opl_tol(torch, res_p[2]['opl'][keep], len(meta))
        check(res['opl_max_abs_err'] <= res['opl_tol'], f'{name}: opl {res}')
        check(res['n_final_equal'], f'{name}: n_final differs')
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, device,
                                         seed + 2)
    g_opl = (torch.randn(rays.n, generator=torch.Generator(
        device=device).manual_seed(seed + 3), device=device) if opl
        else None)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
            coat=coat, fuzzy=prog, ff=ff, replay=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, maps=maps)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=ext,
            g_opl=g_opl, opl=opl, coat=coat, fuzzy=prog, ff=ff)
        g_p = fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, g_rays, g_mom, maps=maps, g_opl=g_opl)
    torch.cuda.synchronize()
    if nonseq:
        out_r = kfwd(rays)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_r, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1], tol=DISP_BWD_TOL,
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq
        else None)
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True,
        coat=True, diff=True, freeform=True))
    ffc = list(fused_trace.FF_TERM_COLS)
    res['bwd']['ff_columns_used'] = int((g_p[0][:, ffc].abs().sum(0) > 0)
                                        .sum())
    return res


def ex19_design(rt, torch, device, simulate_name, rays,
                steps=EX19_DESIGN_STEPS):
    """Example 19's design as published: Adam, ``steps`` steps at
    EX19_DESIGN_LR on the spot RMS^2 through ``simulate_name``
    (simulate_fused: K1 and K2 each step) -> dict of the spot RMS before
    and after, the losses before each step, the coefficients and the
    seconds."""
    sc = ex19_scene(rt)
    simulate = getattr(sc, simulate_name)

    def rms(p):
        _, sens, _ = simulate(p, rays)
        return sens.spot_rms(0)[0]
    p0 = sc.init_params(device)
    with torch.no_grad():
        rms0 = float(rms(p0))
    t0 = time.perf_counter()
    p, hist = rt.fit(lambda p: rms(p) ** 2, p0, trainable=sc.trainable(),
                     steps=steps, lr=EX19_DESIGN_LR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        rms1 = float(rms(p))
    return dict(rms0=rms0, rms1=rms1, loss0=float(hist[0]),
                loss=float(hist[-1]), losses=[float(v) for v in hist],
                seconds=seconds,
                coeffs=[float(v) for v in p['corrector']['xy1']])


def fused_vs_eager(rt, torch, sc, params, rays, leaf, opl, counted=None):
    """A section 15 scene's loss (example 20's wavefront RMS^2 in waves with
    ``opl``, else the spot RMS^2) and its gradient in the corrector's
    ``leaf`` through simulate_fused against the eager trace -> dict; with
    ``opl`` also the rays the two trace apart, the path lengths' largest
    difference on the others against opl_tol, and the gradient of the eager
    trace taken at the fused run's values.  ``counted``: (reset_counters,
    counters), which then record the fused forward's and grad step's
    launches."""
    from raytracetorch_tpu_torch.ops import fused_trace
    from raytracetorch_tpu_torch.utils import wavefront
    dev = rays.px.device

    def run(simulate, p):
        if opl:
            out, _, aux = simulate(p, rays, track_opl=True)
            return out, aux['opl']
        return simulate(p, rays)[1], None

    def loss_of(res):
        if opl:
            return (wavefront.wavefront_rms(
                res[0], res[1], weights=res[0].intensity, refocus=True)
                / EX20_WAVELEN) ** 2
        return res[0].spot_rms(0)[0] ** 2

    def at_values(res, values):
        """The eager trace's (rays, opl) carrying the fused run's values
        (b - a is exact for float32 a, b within a factor 2 of each other,
        so a + (b - a) is b) and the eager trace's gradients."""
        (out, o), (out_v, o_v) = res, values
        return (out.replace(**{c: getattr(out, c) + (getattr(out_v, c)
                                                     - getattr(out, c))
                               .detach() for c in fused_trace.COMPS}),
                o + (o_v - o).detach())

    def grads(simulate, values=None):
        p = sc.init_params(dev)
        p['corrector'][leaf].requires_grad_(True)
        res = run(simulate, p)
        loss_of(res if values is None else at_values(res, values)).backward()
        return p['corrector'][leaf].grad

    def norm_err(a, b):
        return float((a - b).norm() / b.norm())
    reset, counters = counted or (lambda: None, lambda: None)
    reset()
    with torch.no_grad():
        res_f = run(sc.simulate_fused, params)
        l_f = float(loss_of(res_f))
    torch.cuda.synchronize()
    fl = counters()
    with torch.no_grad():
        res_e = run(sc.simulate, params)
        l_e = float(loss_of(res_e))
    reset()
    g_f = grads(sc.simulate_fused)
    torch.cuda.synchronize()
    gl = counters()
    g_e = grads(sc.simulate)
    out = dict(fwd_launches=fl, grad_launches=gl, loss=l_f, eager_loss=l_e,
               rel_err=float(((g_f - g_e).abs()
                              / g_e.abs().clamp(min=1e-30)).max()),
               norm_err=norm_err(g_f, g_e), grads=g_f.tolist(),
               eager_grads=g_e.tolist())
    if opl:
        # ray by ray: the rays both trace alike, their path lengths; the
        # weighted RMS of the path lengths' differences about their mean,
        # which bounds the two wavefront RMS's difference (the triangle
        # inequality: both remove the same piston, tilt and defocus)
        apart = traced_apart(torch, res_f[0], res_e[0])[0]
        keep = ~apart
        w = res_e[0].intensity.double()
        d = (res_f[1] - res_e[1]).double()
        d = d - (w * d).sum() / w.sum()
        g_x = grads(sc.simulate, res_f)
        out.update(
            apart=int(apart.sum()),
            allowed=math.ceil(FF_FLIPS_PER_MILLION * rays.n / 1e6),
            opl_max_abs_err=float((res_f[1] - res_e[1])[keep].abs().max()),
            opl_tol=opl_tol(torch, res_e[1][keep], len(sc.static_meta())),
            opl_rms_err=float(((w * d * d).sum() / w.sum()).sqrt()),
            rms_waves=l_f ** 0.5, eager_rms_waves=l_e ** 0.5,
            at_fused_values_norm_err=norm_err(g_f, g_x),
            at_fused_values_grads=g_x.tolist())
    return out


def freeform_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 15: freeform, Zernike and wedge lenses through K1, K2, K5 and
    K6 in their instantiation with freeform surfaces: each kernel against
    its plain version (at 2,999 and 1M rays) on examples 19 (also as a
    Scene), 20 and 26; the counted paths (forward and grad steps against
    the eager trace, example 20's measured prescription and wavefront,
    example 26's reconstruction); example 19's design as published against
    the eager one and the JAX package's anchors; then times, bounds (with
    the Newton steps' operations) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

    # example 20's prescription, measured through K1 with track_opl
    terms, bare_rms = ex20_prescription(rt, torch, dev)
    emit('freeform_prescription', n_terms=len(terms), bare_rms_waves=bare_rms,
         terms=terms)

    # 15a. each kernel against its plain version
    kern = {}
    for name in FREEFORM_CASES:
        for n in (N_SMALL, N_MAIN):
            kern[f'{name}_{n}'] = freeform_kernels_vs_plain(
                rt, torch, name, n, dev, FREEFORM_SEED + 11, terms)
    emit('freeform_kernels_vs_plain', **kern)

    # 15b. the counted paths at 1M rays
    paths = {}
    for name, leaf in (('ex19', 'xy1'), ('ex19_scene', 'xy1'),
                       ('ex20', 'z1')):
        sc, params, rays, cfg, nonseq = freeform_case(
            rt, torch, name, N_MAIN, dev, FREEFORM_SEED + 13, terms)
        fwd, bwd = (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                    else ('trace_seq_fwd', 'trace_seq_bwd'))
        paths[name] = res = fused_vs_eager(
            rt, torch, sc, params, rays, leaf, name == 'ex20',
            (reset_counters, counters))
        check(only(res['fwd_launches'], **{fwd: 1}, freeform=1),
              f'{name} launched {res["fwd_launches"]}')
        check(only(res['grad_launches'], **{fwd: 1, bwd: 1}, freeform=2),
              f'{name} grad step launched {res["grad_launches"]}')
        if name == 'ex20':
            check(res['apart'] <= res['allowed']
                  and res['opl_max_abs_err'] <= res['opl_tol'],
                  f'{name}: fused vs eager rays {res}')
            check(abs(res['rms_waves'] - res['eager_rms_waves'])
                  <= res['opl_rms_err'] / EX20_WAVELEN,
                  f'{name}: fused vs eager wavefront RMS {res}')
            check(res['at_fused_values_norm_err'] < GRAD_RTOL,
                  f'{name}: fused gradients vs eager at the fused values '
                  f'{res["at_fused_values_norm_err"]}')
        else:
            check(abs(res['loss'] - res['eager_loss'])
                  <= 1e-3 * abs(res['eager_loss']),
                  f'{name}: fused loss {res["loss"]} vs eager '
                  f'{res["eager_loss"]}')
            check(res['rel_err'] < GRAD_RTOL,
                  f'{name}: fused vs eager gradients {res["rel_err"]}')
    sc = ex26_scene(rt)
    rays, x0, y0 = ex26_rays(rt, torch, N_MAIN, dev, FREEFORM_SEED + 13)
    reset_counters()
    with torch.no_grad():
        out, _, _ = sc.simulate_fused(sc.init_params(dev), rays)
    torch.cuda.synchronize()
    fl = counters()
    # ex26's microlens array is of the diffractive family
    check(only(fl, trace_seq_fwd=1, diff=1, freeform=1),
          f'ex26 launched {fl}')
    coef, n_cells = ex26_reconstruct(rt, out, x0, y0)
    errs = {j: abs(c - EX26_HIDDEN.get(j, 0.0)) for j, c in coef.items()}
    paths['ex26'] = dict(fwd_launches=fl, recovered=coef, cells=n_cells,
                         max_abs_err=max(errs.values()), atol=EX26_ATOL,
                         transmitted=float(out.intensity.double().mean()))
    check(max(errs.values()) <= EX26_ATOL,
          f'ex26: reconstruction {coef} (hidden {EX26_HIDDEN})')
    # K0's counterpart, trace_sequential_v1, on example 19's corrector: K1's
    # kernel in its instantiation with freeform surfaces, every stream off
    sc, params, rays, cfg, _ = freeform_case(rt, torch, 'ex19', N_MAIN, dev,
                                             FREEFORM_SEED + 13)
    meta, flat, kinds, maps, coat, prog, ff = freeform_inputs(
        rt, torch, sc, params, rays, cfg)
    reset_counters()
    with torch.no_grad():
        v1_out, v1_sens, _ = rt.trace_sequential_v1(
            sc.build_table(params), rays, cfg, sc.static_meta())
    torch.cuda.synchronize()
    v1l = counters()
    check(only(v1l, trace_seq_v1=1, freeform=1), f'ex19 v1 launched {v1l}')
    v1_p, v1_sp = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                           meta, maps)
    paths['v1'] = compare(torch, v1_out, v1_sens, v1_p, v1_sp)
    paths['v1']['launches'] = v1l
    emit('freeform_main', n=N_MAIN, **paths)

    # 15c. example 19's design through K1 and K2 against the eager one and
    # the JAX package's anchors
    d_rays = square_beam(rt, torch, EX19_DESIGN_RAYS, EX19_BEAM, dev)
    reset_counters()
    fused = ex19_design(rt, torch, dev, 'simulate_fused', d_rays)
    fused['launches'] = counters()
    eager = ex19_design(rt, torch, dev, 'simulate', d_rays, EX19_EAGER_STEPS)
    fused_at = fused['losses'][EX19_EAGER_STEPS - 1]
    design = dict(fused={k: v for k, v in fused.items() if k != 'losses'},
                  eager={k: v for k, v in eager.items() if k != 'losses'},
                  steps=EX19_DESIGN_STEPS, eager_steps=EX19_EAGER_STEPS,
                  fused_loss_at_eager_steps=fused_at,
                  rms0_ref=EX19_RMS0_REF, rms1_ref=EX19_RMS1_REF)
    emit('freeform_design', **design)
    check(only(fused['launches'], trace_seq_fwd=EX19_DESIGN_STEPS + 2,
               trace_seq_bwd=EX19_DESIGN_STEPS,
               freeform=2 * EX19_DESIGN_STEPS + 2),
          f'ex19 design launched {fused["launches"]}')
    for run in (fused, eager):
        check(abs(run['rms0'] - EX19_RMS0_REF) <= EX19_RMS0_RTOL
              * EX19_RMS0_REF, f'ex19 uncorrected RMS {run["rms0"]}')
    check(abs(fused['rms1'] - EX19_RMS1_REF) <= EX19_RMS1_RTOL
          * EX19_RMS1_REF, f'ex19 corrected RMS {fused["rms1"]}')
    check(fused['coeffs'][0] * fused['coeffs'][1] < 0,
          f'ex19: x^2 and y^2 of one sign {fused["coeffs"]}')
    check(abs(fused_at - eager['loss']) <= EX19_DESIGN_RTOL * eager['loss'],
          f'ex19 design at step {EX19_EAGER_STEPS}: fused {fused_at} vs '
          f'eager {eager["loss"]}')

    # 15d. times at 1M rays against the plain versions, bounds (the Newton
    # steps' operations) and blocks per SM
    timing, bounds, occ = {}, {}, {}
    for name, key in (('ex19', 'k1'), ('ex20', 'k1_ex20'), ('ex26', 'k1_ex26'),
                      ('ex19_scene', 'k5')):
        sc, params, r, cfg, nonseq = freeform_case(
            rt, torch, name, N_MAIN, dev, FREEFORM_SEED + 7, terms)
        meta, flat, kinds, maps, coat, prog, ff = freeform_inputs(
            rt, torch, sc, params, r, cfg)
        ext = fused_trace.ext_kinds(meta)
        opl = name == 'ex20'
        g_rays, g_mom, _ = random_cotangents(torch, r.n, cfg, dev, SEED + 6)
        # the side data a launch reads: the pairs, and the side buffer and
        # programs where the table has them
        side_words = sum(t.numel() for t in (coat, prog, ff) if t is not None)
        io = (r.n * (36 + 28) + table_bytes(meta) + side_words * 4
              + (r.n * 8 if opl else 0))
        cols = len(fused_trace.grad_cols(
            (), True, False, coat is not None,
            fused_trace.diffractive_kinds(meta), True))
        ff_f = [freeform_ops(m) for m in meta]
        if nonseq:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, coat=coat, fuzzy=prog,
                ff=ff))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
                coat=coat, fuzzy=prog, ff=ff))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, maps=maps))
            reps = dict(reps=6, warmup=1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            # every scan intersects every freeform row (intersect_ops); K6
            # replays the scans and reverses the winners' steps, whose
            # adjoint nonseq_ops counts at twice the forward's size: the
            # rest of FF_BWD_FACTOR is added
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins,
                                        segment_replays(lives))
            bounds[key] = bound(io, k5_ops)
            bounds['k6'] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 k6_ops + sum(w * (b - 2 * f) for w, (f, b)
                                              in zip(wins, ff_f)))
        else:
            g_opl = torch.ones(r.n, device=dev) if opl else None
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, track_opl=opl, coat=coat,
                fuzzy=prog, ff=ff))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, track_opl=opl))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                g_opl=g_opl, opl=opl, coat=coat, fuzzy=prog, ff=ff))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps, g_opl=g_opl))
            reps = dict(reps=10, warmup=2)
            # intersect_ops counts the freeform rows' steps; K2 runs the
            # forward and an adjoint of twice its size (3 forwards), the
            # freeform steps' reverse at FF_BWD_FACTOR of theirs: the rest
            # of it is added
            k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m)
                               for m in meta)
            bounds[key] = bound(io, k1_ops)
            bounds[key.replace('k1', 'k2')] = bound(
                io + r.n * 28 + len(meta) * cols * 4,
                3 * k1_ops + r.n * sum(b - 2 * f for f, b in ff_f))
        k_ms, p_ms, k_runs, _ = time_pair(torch, kfn, pfn, **reps)
        timing[key] = dict(kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs,
                           ff_terms=[len(m.ff or ()) for m in meta])
        k_ms, p_ms, k_runs, _ = time_pair(torch, bk, bp, **reps)
        timing[key.replace('k1', 'k2').replace('k5', 'k6')] = dict(
            kernel_ms=k_ms, plain_ms=p_ms, kernel_runs=k_runs)
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if nonseq
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[f'{lib}_{name}'] = fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                diff=True, fuzzy_words=0 if prog is None else int(prog.numel()),
                freeform=True)
    sc, params, rays, _, _ = freeform_case(rt, torch, 'ex19', N_MAIN, dev,
                                           FREEFORM_SEED + 13)

    def step():
        p = sc.init_params(dev)
        p['corrector']['xy1'].requires_grad_(True)
        _, s_, _ = sc.simulate_fused(p, rays)
        (s_.spot_rms(0)[0] ** 2).backward()
    for label, fn in (
            ('simulate_fused_ex19', lambda: sc.simulate_fused(params, rays)),
            ('grad_step_fused_ex19', step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('freeform_timing', **timing)
    emit('freeform_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('freeform_occupancy', blocks_per_sm=occ)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds,
                design=design)


# ---- Section 16: convex solids, custom shapes and the point source ----
#
# The HALFSPACES volume bound (a convex solid's face: the AND of its other
# faces' outward half-spaces, which ride the row's hp columns) and the
# CONE_NAPPE surface bound (a single cone's nappe) run in the instantiation
# of the extended kinds of K1, K2, K5 and K6, and in every one built on it
# (the wedge with fresnel=True: the Fresnel instantiation).  The scenes, at
# N_MAIN rays: example 27's lightpipe homogenizer as published
# (examples/27_lightpipe_homogenizer.py:31-49: a mirrored 4 x 4
# Box4SideElement, the exit sensor at z = 40 with a 64^2 grid over +-2, 50
# bounces, PointSource(na=0.35) at (0.9, 0.5, 0) drawn from key 0 as the
# reference draws it, rays/reference_prng.py::point_source), also without
# the pipe and at LP_RAYS; the glass wedge polyhedron and the box absorber
# of tests/test_pallas.py:225-254 (6 bounces, the reference's collimated
# disk of key 0), also with fresnel=True; the axicon of
# tests/test_custom_elements.py:14-44 (a REFLECT single cone, slope 1,
# lit by a collimated annulus, axicon_rays); and a sequential table in
# which rays meet each bound (``bounds_scene``: the bench singlet, a box
# face as a rectangular obscuration, a refracting single cone, a sensor),
# for K1 and K2.  The design step: the lightpipe's width and height
# trainable, the exit spot's RMS from the moments as the loss (the grid's
# bins are flat in the hit positions and the mirrors keep the intensity, so
# the grid gives no useful gradient), backward() through K5 and K6.
SOLID_SEED = SEED + 1701
LP_WIDTH, LP_LENGTH, LP_NA, LP_SOURCE = 4.0, 40.0, 0.35, (0.9, 0.5, 0.0)
LP_RAYS, LP_BOUNCES, LP_GRID = 400_000, 50, (64, 64)
WEDGE_ALPHA, WEDGE_GLASS, WEDGE_BOUNCES = 0.2, 1.5, 6
AXICON_BOUNCES = 2
SOLID_CASES = ('bounds', 'lightpipe', 'wedge', 'wedge_fresnel', 'axicon')
# The central ~80% of the exit grid whose relative std the example checks
LP_CENTRAL = slice(12, 52)
# Example 27's anchors from the JAX package (tests/solid_anchors.py, on the
# same key's rays): flux, the central relative std and the exit moments
# (sum w, w x, w y, w x^2, w y^2, w x y, count) with and without the pipe at
# LP_RAYS and N_MAIN rays; the wedge scene's moments at N_MAIN.
LP_REF = {
    'pipe_400000': dict(
        flux=399973.0, rel_std=0.10219928330383267,
        moments=(399973.0, -15003.498046875, -8632.8349609375, 533925.5,
                 538592.5625, 1127.642822265625, 399973.0)),
    'bare_400000': dict(
        flux=10119.0, rel_std=0.6256432753757089,
        moments=(10119.0, -38.41034698486328, 154.45582580566406,
                 13442.572265625, 13322.3486328125, 113.84344482421875,
                 10119.0)),
    'pipe_1000000': dict(
        flux=999937.0, rel_std=0.07161883187621654,
        moments=(999937.0, -38185.96484375, -22008.609375, 1333472.875,
                 1346008.125, -1389.06103515625, 999937.0)),
    'bare_1000000': dict(
        flux=25303.0, rel_std=0.3908695053697903,
        moments=(25303.0, 161.34371948242188, 347.5049743652344,
                 33637.56640625, 33629.8125, 175.82382202148438, 25303.0)),
}
WEDGE_MOMENTS_REF = (1000000.0, -2879329.0, 383.2080383300781, 9248790.0,
                     1001488.875, -2530.645751953125, 1000000.0)
# Tolerances against the JAX anchors.  The port draws the source's
# directions with numpy's float32 cos, sin and arccos, the reference with
# XLA's (an ulp apart), and K5 contracts multiply-adds: a ray whose exit
# hit lies within rounding of the exit square's edge (the sensor's RECT
# bound, at the pipe's walls) or that meets a wall within rounding of a
# corner can end on the other side.  LP_FLIPS_PER_MILLION of them may flip,
# each moving the flux by 1 and a moment by at most its extreme (2 for x,
# 4 for x^2 on the 4 x 4 exit); the relative std moves by the bins'
# reshuffle of rays an ulp from a bin edge (LP_STD_ATOL).  The port's
# eager loop on the CPU on the same rays (tests/solid_anchors.py) reads 1
# ray flipped at 400,000 and at 1M rays (flux 1 apart, moments within 2 / 4
# of JAX's), its relative std 1.1e-5 and 2.7e-7 apart.
LP_FLIPS_PER_MILLION = 30
LP_STD_ATOL = 1e-3
# LP_WORLD notes: a Box4Side has no caps, so a ray that has crossed the
# exit sensor goes on reflecting down the pipe for the whole budget of 50
# bounces (as in the JAX package), to z ~ 400-1200 mm; float32 rounds each
# bounce's t and position to ~1e-7 of the coordinate, so K5 and the plain
# loop (or float32 and float64) part by up to ~3e-3 mm there.  Section 16
# therefore holds K5 and K6 to their plain versions by traced_apart's world
# rule (POS_TOL of 1 + the ray's largest coordinate: the plain loop in
# float32 against float64 reads 0 of 100,000 rays past 3e-6 of it); the
# exit statistics (grid, moments, flux) come from the first ~10 bounces.
# The HALFSPACES bound's operations: per active plane of a face, 3 products
# (2 contracted), the offset, a compare and the mask's (K1 and K5 stop at
# the first plane that rejects; the count is every active plane, an
# accepted hit's work); CONE_NAPPE a product and a compare a root.
HALFSPACE_PLANE_OPS, CONE_NAPPE_OPS = 7, 4


# The SASS of every instantiation without the extended kinds (kExt = false:
# the main path's and the plates-only ones), which a slice must not change
# unless it means to: sha256 (first 16 hex digits) of each kernel's
# `cuobjdump -sass` listing with addresses, encodings, whitespace and the
# anonymous namespace's hash stripped (sass_digests) -> {library: {template
# arguments: digest}}.  Read from the parent commit's build on an NVIDIA
# H100 80GB HBM3 (the A/B of PR 17's first call), but K6's '0,0', re-read
# when the family chain collapsed: its listing differs from the parent's
# only in the order of two independent predicate instructions (the same
# 4,290 lines, the same registers; PERF.md), which the rest of the library
# moved.
SASS_NO_EXT = {
    'trace_seq_fwd': {'0,0': '4dcffb06ba91d2c7',
        '1,0': 'abea182f20a732c1'},
    'trace_seq_bwd': {'0,0,0': '32d8c1114a5dcce5',
        '0,1,0': '0f698b264124fd4e',
        '1,0,0': 'd4967b555f6bc35c',
        '1,1,0': 'afd3ff09b28616af'},
    'trace_nonseq_fwd': {'1,0,0': 'a3dd8a66842f008d',
        '1,1,0': '743dfdc6af310d8b',
        '64,0,0': '2b72c16e13a3c5dd',
        '64,1,0': 'a0517998fbf76f95'},
    'trace_nonseq_bwd': {'0,0': '4075e21f4ad306c0',
        '1,0': 'a78d2d8c8d9b5f2a'},
}
_NS_HASH = r'_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}'


# The trace libraries' SASS is read in worker processes started right after
# the build (prefetch_sass), beside the sections before 16d and 17d, whose
# checks then take the result: {library path: future}.
_SASS_JOBS = {}


def cuobjdump_path():
    from raytracetorch_tpu_torch.ops.nvcc_build import nvcc_path
    return os.path.join(os.path.dirname(nvcc_path()), 'cuobjdump')


def read_sass(path, tool):
    """{mangled kernel (namespace hash stripped): sha256 hex} of a library's
    SASS (``tool``: cuobjdump), each listing with its addresses, encodings
    and spacing stripped (the lines up to the next function's header belong
    to the listing)."""
    import hashlib
    import re
    out = subprocess.run([tool, '-sass', str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            cur = re.sub(_NS_HASH, 'NS', m.group(1))
            funcs[cur] = []
            continue
        if cur is None:
            continue
        line = re.sub(r'/\*[0-9a-f]{4,}\*/', '', line)
        line = re.sub(r'/\* 0x[0-9a-f]+ \*/', '', line)
        line = re.sub(r'\s+', ' ', re.sub(_NS_HASH, 'NS', line)).strip()
        if line:
            funcs[cur].append(line)
    return {k: hashlib.sha256('\n'.join(v).encode()).hexdigest()
            for k, v in funcs.items()}


def prefetch_sass():
    """Start one worker process a trace library of SASS_NO_EXT and SASS_ALL
    that reads its SASS (read_sass) -> the pool (main shuts it down once
    17d has the results; the interpreter's exit joins it otherwise)."""
    import concurrent.futures
    import multiprocessing
    from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build
    libs = sorted(set(SASS_NO_EXT) | set(SASS_ALL))
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=len(libs), mp_context=multiprocessing.get_context('spawn'))
    tool = cuobjdump_path()
    for lib in libs:
        path = str(nvcc_build.library_path(lib,
                                           [fused_trace._LIBRARIES[lib][0]]))
        _SASS_JOBS[path] = pool.submit(read_sass, path, tool)
    return pool


@functools.lru_cache(maxsize=None)
def sass_digests(path):
    """read_sass of a library, once a run (16d's and 17d's checks read the
    same libraries: their file names carry the sources' hash), from its
    prefetch_sass worker where one was started."""
    job = _SASS_JOBS.pop(str(path), None)
    return job.result() if job else read_sass(path, cuobjdump_path())


def check_sass_no_ext():
    """The SASS of the kernels without the extended kinds in the four trace
    libraries as built here against SASS_NO_EXT -> dict; raises on a
    difference or a missing kernel."""
    import re
    from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build
    res = {}
    for lib, want in SASS_NO_EXT.items():
        path = nvcc_build.library_path(lib, [fused_trace._LIBRARIES[lib][0]])
        got = {}
        for fn, digest in sass_digests(path).items():
            m = re.search(r'_kernelI(\w+?)EEv', fn)
            if m:
                args = re.findall(r'L[ib](\d+)E', m.group(1) + 'E')
                if args[-1] == '0':
                    got[','.join(args)] = digest[:16]
        res[lib] = dict(kernels=len(got), equal=got == want)
        check(got == want, f'{lib}: the SASS of the kernels without the '
              f'extended kinds changed: {got} vs {want}')
    return res


def lightpipe_scene(rt, with_pipe=True, grad=False, n_bounces=LP_BOUNCES):
    """Example 27's scene (both packages: ``rt``): the mirrored pipe
    (``grad``: its width and height trainable) and the exit sensor."""
    els = []
    if with_pipe:
        els.append(rt.Box4SideElement(width=LP_WIDTH, height=LP_WIDTH,
                                      ph_kind=rt.PhysKind.REFLECT,
                                      w_grad=grad, h_grad=grad, name='pipe'))
    els.append(rt.SensorElement(half_x=LP_WIDTH / 2, half_y=LP_WIDTH / 2,
                                translation=[0, 0, LP_LENGTH], name='exit'))
    sc = rt.Scene(els, n_bounces=n_bounces)
    sc.grid_shape = LP_GRID
    sc.grid_half_extent = LP_WIDTH / 2
    return sc


def lightpipe_rays(torch, n, device):
    """The reference's PointSource(na=0.35) rays of key 0 at LP_SOURCE."""
    from raytracetorch_tpu_torch.rays import reference_prng
    return reference_prng.point_source(reference_prng.prng_key(0), n, LP_NA,
                                       LP_SOURCE, device=device)


def lightpipe_stats(grid, moments):
    """(flux, central relative std) of an exit grid [H, W] and its slot's
    moments [B, 7] (numpy or torch)."""
    c = grid[LP_CENTRAL, LP_CENTRAL]
    return (float(moments[0, 0]),
            float(c.std() / max(float(c.mean()), 1e-12)))


def wedge_scene(rt, fresnel=False, offsets_grad=False):
    """tests/test_pallas.py:225-254 (both packages): the glass wedge
    polyhedron (an entrance plane, a face tilted by WEDGE_ALPHA, four side
    planes), a box absorber beside its beam and a sensor, 6 bounces."""
    sa, ca = math.sin(WEDGE_ALPHA), math.cos(WEDGE_ALPHA)
    prism = rt.CvxPolyhedronElement(
        normals=[(0, 0, -1), (sa, 0, ca), (0, 1, 0), (0, -1, 0), (1, 0, 0),
                 (-1, 0, 0)],
        offsets=[0.0, 2.0, 5.0, 5.0, 8.0, 8.0], ior_glass=WEDGE_GLASS,
        fresnel=fresnel, offsets_grad=offsets_grad, name='wedge')
    return rt.Scene([prism,
                     rt.BoxElement(length=2.0, width=2.0, height=2.0,
                                   name='blocker',
                                   translation=[6.0, 0.0, 15.0]),
                     rt.SensorElement(radius=50.0, translation=[0, 0, 30.0],
                                      name='s')], n_bounces=WEDGE_BOUNCES)


def wedge_rays(torch, n, device):
    """The reference's CollimatedDisk(radius 2) rays of key 0 at z = -5."""
    from raytracetorch_tpu_torch.rays import reference_prng
    return reference_prng.collimated_disk(reference_prng.prng_key(0), n, 2.0,
                                          (0.0, 0.0, -5.0), device=device)


def axicon_scene(rt):
    """tests/test_custom_elements.py:14-44's 45-degree axicon mirror: a
    REFLECT single cone (slope 1, its upper nappe) at z = 10."""
    return rt.Scene([rt.ElementCustom(
        rt.single_cone, 1, rt.PhysKind.REFLECT, extra={'slope': 1.0},
        translation=[0.0, 0.0, 10.0], name='axicon')],
        n_bounces=AXICON_BOUNCES)


def axicon_rays(rt, torch, n, device, seed):
    """+z rays over the annulus 0.5 <= r <= 3 at z = 0: the cone's apex is
    a singular point (its normal and its hit's derivatives blow up as
    1 / r; float32 against float64 reads a third of the table cotangent's
    scale apart on a beam through it), so the beam leaves it out, as the
    JAX test's ray at r = 2 does."""
    from raytracetorch_tpu_torch.rays.sources import disk_sample
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = disk_sample(gen, n, 0.25, 9.0, torch.float32, torch.device(device))
    return rt.Rays.create(pos, torch.tensor([[0.0, 0.0, 1.0]],
                                            device=device).expand(n, 3))


def obscuration_face(p, Re, te):
    """A box face as an ElementCustom shape: a -z plane bounded by
    |x| <= 1.5 and |y| <= 1.0 (its four neighbours' half-spaces)."""
    from raytracetorch_tpu_torch.elements.base import compose_world
    from raytracetorch_tpu_torch.elements.solids import box_face_recs
    rec = box_face_recs([('-z', 0.0), ('+x', 1.5), ('-x', 1.5), ('+y', 1.0),
                         ('-y', 1.0)], dtype=te.dtype, device=te.device)[0]
    rec.Rw, rec.tw, _, _ = compose_world(Re, te, rec.Rs, rec.ts)
    return [rec]


def bounds_scene(rt):
    """A sequential table in which rays meet both bounds (tests/
    test_torch_solid_kernels.py::bounds_table): the bench singlet, the box
    face's obscuration at z = 4 (BLOCK inside its rectangle), a refracting
    single cone (slope 2, its slope trainable, apex at z = 7: every ray
    crosses the lower nappe's root first, which CONE_NAPPE rejects) and a
    sensor at z = 20."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.ElementCustom(obscuration_face, 1, rt.PhysKind.BLOCK,
                         translation=[0, 0, 4.0], name='stop'),
        rt.ElementCustom(rt.single_cone, 1, rt.PhysKind.SNELL,
                         ph=(1.0, 1.3), extra={'slope': 2.0},
                         extra_grad={'slope': True},
                         translation=[0, 0, 7.0], name='cone'),
        rt.SensorElement(radius=50.0, translation=[0, 0, 20.0],
                         name='sensor')])


def solid_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, key) of a section 16 case; ``key`` the Philox
    key of the FRESNEL wedge (else None)."""
    if name == 'bounds':
        sc = bounds_scene(rt)
        rays = sample_rays(rt, torch, n, device, seed)
    elif name == 'lightpipe':
        sc, rays = lightpipe_scene(rt), lightpipe_rays(torch, n, device)
    elif name.startswith('wedge'):
        sc = wedge_scene(rt, fresnel=name == 'wedge_fresnel')
        rays = wedge_rays(torch, n, device)
    else:
        sc, rays = axicon_scene(rt), axicon_rays(rt, torch, n, device, seed)
    return (sc, sc.init_params(device), rays,
            FRESNEL_KEY if name == 'wedge_fresnel' else None)


def halfspace_ops(table):
    """Per row, the HALFSPACES bound's operations over its active planes
    ([K] list)."""
    return [HALFSPACE_PLANE_OPS * int(m) for m in
            table.hp_mask.sum(1).tolist()]


def solid_row_ops(meta, planes):
    """A row's intersection operations with its bounds' (intersect_ops plus
    its half-spaces' planes and a nappe's two roots)."""
    return (intersect_ops(meta) + planes
            + (2 * CONE_NAPPE_OPS if meta.sb == 6 else 0))


def solid_kernels_vs_plain(rt, torch, name, n, device, seed):
    """K1 and K2 (the Scenes: K5 and K6) in the instantiation with the
    extended kinds (the FRESNEL wedge: with the Fresnel kinds) against their
    plain versions on a section 16 case: the rays, moments and grid, then
    the ray and table cotangents under seeded cotangents on the rays both
    trace alike; K6's replay against K5 bit for bit -> dict; raises on a
    breach."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    sc, params, rays, key = solid_case(rt, torch, name, n, device, seed)
    meta, cfg = sc.static_meta(), sc.sensor_config()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    maps = fused_trace.plate_maps(meta, {})
    ext, fresnel = fused_trace.ext_kinds(meta), key is not None
    check(ext, f'{name}: the table has no extended kind')
    nonseq = not sc.sequential
    if nonseq:
        nb = sc.n_bounces
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=fresnel, key=key)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps, key=key)
        torch.cuda.synchronize()
        # world rule: the lightpipe's rays run the whole budget down the
        # uncapped pipe, to z ~ 400-1200 mm after 50 reflections, where
        # float32 rounds a coordinate to 3-12e-5 (LP_WORLD notes)
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p, world=True)
        apart = traced_apart(torch, out_k, out_p, NS_INT_TOL, world=True)[0]
    else:
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg,
                                                    maps, ext)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps)
        torch.cuda.synchronize()
        res = compare(torch, out_k, s_k, out_p, s_p)
        apart = traced_apart(torch, out_k, out_p)[0]
    res.update(rows=len(meta), apart=int(apart.sum()),
               blocked=int((out_k.intensity == 0).sum()),
               sensor_weight=s_k.moments[..., 0].sum().item())
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    if nonseq:
        g_k = fused_nonseq.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, ext=ext, fresnel=fresnel, key=key, replay=True)
        g_p = fused_nonseq.trace_nonseq_bwd_plain(
            flat, rays, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
            maps=maps, key=key)
    else:
        g_k = fused_trace.trace_seq_bwd_cuda(flat, kinds, rays, cfg, g_rays,
                                             g_mom, maps=maps, ext=ext)
        g_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta, g_rays,
                                              g_mom, maps=maps)
    torch.cuda.synchronize()
    if nonseq:
        out_r = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, fresnel=fresnel,
            key=key)[0]
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_r, c))
                                  for c in fused_trace.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1],
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)) if nonseq
        else None,
        intensity_allowed=(math.ceil(GRID_SHARE * rays.n)
                           if nonseq and cfg.grid_shape else 0))
    res['bwd'].update(compare_table_cotangents(
        torch, fused_trace, g_k[0], g_p[0], plates=True, ext=True))
    return res


def lightpipe_run(rt, torch, with_pipe, n, device, simulate='simulate_fused'):
    """Example 27 at ``n`` rays through ``simulate`` -> dict of the flux,
    the central relative std and the exit moments."""
    sc = lightpipe_scene(rt, with_pipe)
    rays = lightpipe_rays(torch, n, device)
    with torch.no_grad():
        _, sens, _ = getattr(sc, simulate)(sc.init_params(device), rays)
    torch.cuda.synchronize()
    flux, std = lightpipe_stats(sens.grid[0].double(),
                                sens.moments[0].double())
    return dict(flux=flux, rel_std=std, n=n,
                moments=sens.moments[0, 0].double().tolist())


def check_lightpipe_anchors(runs, n):
    """Example 27's own checks and the JAX anchors (LP_REF) on the runs
    {'pipe': ..., 'bare': ...} at ``n`` rays -> dict of the differences."""
    pipe, bare = runs['pipe'], runs['bare']
    check(pipe['flux'] > bare['flux'], f'{n}: pipe flux {pipe["flux"]} not '
          f'above bare {bare["flux"]}')
    check(pipe['flux'] > 0.999 * n, f'{n}: pipe flux {pipe["flux"]}')
    check(bare['rel_std'] > 3 * pipe['rel_std'],
          f'{n}: bare std {bare["rel_std"]} vs pipe {pipe["rel_std"]}')
    check(pipe['rel_std'] < 0.12, f'{n}: pipe std {pipe["rel_std"]}')
    flips = math.ceil(LP_FLIPS_PER_MILLION * n / 1e6)
    out = {}
    for label, run in runs.items():
        ref = LP_REF[f'{label}_{n}']
        d_mom = [abs(a - b) for a, b in zip(run['moments'], ref['moments'])]
        limits = [flips, 2 * flips, 2 * flips, 4 * flips, 4 * flips,
                  4 * flips, flips]
        out[label] = dict(flux_err=abs(run['flux'] - ref['flux']),
                          rel_std_err=abs(run['rel_std'] - ref['rel_std']),
                          moment_errs=d_mom, moment_limits=limits)
        check(abs(run['flux'] - ref['flux']) <= flips,
              f'{label} {n}: flux {run["flux"]} vs JAX {ref["flux"]}')
        check(abs(run['rel_std'] - ref['rel_std']) <= LP_STD_ATOL,
              f'{label} {n}: std {run["rel_std"]} vs JAX {ref["rel_std"]}')
        check(all(d <= m for d, m in zip(d_mom, limits)),
              f'{label} {n}: moments {run["moments"]} vs JAX '
              f'{ref["moments"]}')
    return out


def solid_grads(rt, torch, sc, params, rays, element, leaves, loss_fn):
    """The loss and gradient in ``element``'s ``leaves`` through
    simulate_fused and through the eager trace -> (loss_f, loss_e, {leaf:
    (fused, eager)})."""
    out = {}
    losses = []
    for simulate in (sc.simulate_fused, sc.simulate):
        p = {k: dict(v) for k, v in params.items()}
        for leaf in leaves:
            p[element][leaf] = params[element][leaf].detach().clone() \
                .requires_grad_(True)
        res = simulate(p, rays)
        loss = loss_fn(res)
        loss.backward()
        losses.append(float(loss.detach()))
        for leaf in leaves:
            out.setdefault(leaf, []).append(p[element][leaf].grad.clone())
    torch.cuda.synchronize()
    return losses[0], losses[1], out


def solid_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 16: the HALFSPACES and CONE_NAPPE bounds through K1, K2, K5
    and K6: each kernel against its plain version at N_MAIN rays on the
    lightpipe, the wedge (also with fresnel=True), the axicon and the
    bounds table; the counted paths (example 27 with and without the pipe
    at LP_RAYS and N_MAIN against its own checks and the JAX anchors, the
    eager loop, the lightpipe's design step and the wedge's and the bounds
    table's grad steps against the eager gradients); then times, bounds
    (the half-spaces' planes counted) and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
    t0 = time.perf_counter()

    # 16a. each kernel against its plain version
    kern = {name: solid_kernels_vs_plain(rt, torch, name, N_MAIN, dev,
                                         SOLID_SEED + 11)
            for name in SOLID_CASES}
    emit('solid_kernels_vs_plain', n=N_MAIN, **kern)

    # 16b. example 27: simulate_fused (K5 once) with and without the pipe,
    # at LP_RAYS and N_MAIN, against the example's checks and JAX's
    paths = {}
    for n in (LP_RAYS, N_MAIN):
        runs = {}
        for label in ('pipe', 'bare'):
            reset_counters()
            runs[label] = lightpipe_run(rt, torch, label == 'pipe', n, dev)
            runs[label]['launches'] = fl = counters()
            want = dict(trace_nonseq_fwd=1, ext=1) if label == 'pipe' \
                else dict(trace_nonseq_fwd=1)
            check(only(fl, **want), f'lightpipe {label} launched {fl}')
        runs['anchors'] = check_lightpipe_anchors(
            {k: runs[k] for k in ('pipe', 'bare')}, n)
        paths[f'ex27_{n}'] = runs
    # the eager loop (K3 per bounce) on the pipe at LP_RAYS
    reset_counters()
    eager = lightpipe_run(rt, torch, True, LP_RAYS, dev, 'simulate')
    eager['launches'] = el = counters()
    check(el['grid_bin'] >= 1 and only(el, grid_bin=el['grid_bin']),
          f'eager lightpipe launched {el}')
    fused = paths[f'ex27_{LP_RAYS}']['pipe']
    check(abs(eager['flux'] - fused['flux'])
          <= math.ceil(LP_FLIPS_PER_MILLION * LP_RAYS / 1e6)
          and abs(eager['rel_std'] - fused['rel_std']) <= LP_STD_ATOL,
          f'eager lightpipe {eager} vs fused {fused}')
    paths['ex27_eager'] = eager

    # the design step: the exit spot's RMS in the pipe's width and height
    sc = lightpipe_scene(rt, grad=True)
    rays = lightpipe_rays(torch, N_MAIN, dev)
    params = sc.init_params(dev)
    reset_counters()
    with torch.no_grad():
        sc.simulate_fused(params, rays)
    torch.cuda.synchronize()
    fl = counters()
    check(only(fl, trace_nonseq_fwd=1, ext=1), f'design fwd launched {fl}')
    reset_counters()
    p = {k: dict(v) for k, v in params.items()}
    for leaf in ('width', 'height'):
        p['pipe'][leaf] = params['pipe'][leaf].clone().requires_grad_(True)
    sc.simulate_fused(p, rays)[1].spot_rms(0)[0].backward()
    torch.cuda.synchronize()
    gl = counters()
    check(only(gl, trace_nonseq_fwd=1, trace_nonseq_bwd=1, ext=2),
          f'design step launched {gl}')
    lf, le, g = solid_grads(rt, torch, sc, params, rays, 'pipe',
                            ('width', 'height'),
                            lambda res: res[1].spot_rms(0)[0])
    design = dict(fwd_launches=fl, grad_launches=gl, loss=lf, eager_loss=le,
                  grads={k: [float(v[0]), float(v[1])] for k, v in g.items()})
    for leaf, (gf, ge) in g.items():
        check(abs(float(gf) - float(ge)) <= GRAD_RTOL * abs(float(ge)),
              f'design step: {leaf} gradient {float(gf)} vs eager '
              f'{float(ge)}')
    check(abs(lf - le) <= 1e-3 * abs(le), f'design loss {lf} vs {le}')
    paths['lightpipe_design'] = design

    # the wedge's grad step in its offsets (K5 + K6) and the bounds table's
    # in the cone's slope (K1 + K2), against the eager gradients
    for name, element, leaf, sc, rays, fwd, bwd in (
            ('wedge', 'wedge', 'offsets', wedge_scene(rt, offsets_grad=True),
             wedge_rays(torch, N_MAIN, dev), 'trace_nonseq_fwd',
             'trace_nonseq_bwd'),
            ('bounds', 'cone', 'slope', bounds_scene(rt),
             sample_rays(rt, torch, N_MAIN, dev, SOLID_SEED + 13),
             'trace_seq_fwd', 'trace_seq_bwd')):
        params = sc.init_params(dev)
        reset_counters()
        with torch.no_grad():
            sc.simulate_fused(params, rays)
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, **{fwd: 1}, ext=1), f'{name} launched {fl}')
        reset_counters()
        lf, le, g = solid_grads(
            rt, torch, sc, params, rays, element, (leaf,),
            lambda res: res[1].spot_rms(0)[0] + res[1].centroid(0)[0][0])
        gl = counters()
        check(only(gl, **{fwd: 1, bwd: 1}, ext=2),
              f'{name} grad step launched {gl}')
        gf, ge = g[leaf]
        err = float((gf - ge).norm() / ge.norm())
        paths[f'{name}_grad'] = dict(fwd_launches=fl, grad_launches=gl,
                                     loss=lf, eager_loss=le, norm_err=err,
                                     grads=gf.tolist(), eager=ge.tolist())
        check(err < GRAD_RTOL, f'{name}: fused vs eager gradients {err}')
        check(abs(lf - le) <= 1e-3 * abs(le), f'{name} loss {lf} vs {le}')
    # the wedge's moments against the JAX anchor
    sc = wedge_scene(rt)
    with torch.no_grad():
        _, s_w, _ = sc.simulate_fused(sc.init_params(dev),
                                      wedge_rays(torch, N_MAIN, dev))
    wm = s_w.moments[0, 0].double().tolist()
    paths['wedge_moments'] = dict(moments=wm, ref=list(WEDGE_MOMENTS_REF))
    scale = moment_scale(torch, torch.tensor(WEDGE_MOMENTS_REF))
    check(all(abs(a - b) <= NS_MOMENT_RTOL * max(float(s), abs(b)) + 1e-6
              for a, b, s in zip(wm, WEDGE_MOMENTS_REF, scale)),
          f'wedge moments {wm} vs JAX {WEDGE_MOMENTS_REF}')
    emit('solid_main', n=N_MAIN, **paths)

    # 16c. times at N_MAIN against the plain versions, bounds and blocks
    timing, bounds, occ = {}, {}, {}
    for name, key1, key2 in (('bounds', 'k1', 'k2'), ('lightpipe', 'k5', 'k6'),
                             ('wedge', 'k5_wedge', 'k6_wedge')):
        sc, params, r, key = solid_case(rt, torch, name, N_MAIN, dev,
                                        SOLID_SEED + 7)
        meta, cfg = sc.static_meta(), sc.sensor_config()
        table = sc.build_table(params)
        flat = rt.flatten_table_rows(table).detach()
        kinds = torch.tensor(fused_trace.kind_rows(meta, cfg),
                             dtype=torch.int32, device=dev)
        maps = fused_trace.plate_maps(meta, {})
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 6)
        planes = halfspace_ops(table)
        io = r.n * (36 + 28) + table_bytes(meta) + grid_bytes(cfg)
        cols = len(fused_trace.grad_cols((), True))
        if sc.sequential:
            kfn = (lambda: fused_trace.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, True))
            pfn = (lambda: fused_trace.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps))
            bk = (lambda: fused_trace.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=True))
            bp = (lambda: fused_trace.trace_seq_bwd_plain(
                flat, r, cfg, meta, g_rays, g_mom, maps=maps))
            plain_reps = (4, 1)
            k1_ops = r.n * sum(solid_row_ops(m, h) + apply_ops(m)
                               for m, h in zip(meta, planes))
            bounds[key1] = bound(io, k1_ops)
            bounds[key2] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 3 * k1_ops)
        else:
            nb = sc.n_bounces
            kfn = (lambda: fused_nonseq.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, True))
            pfn = (lambda: fused_nonseq.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps))
            bk = (lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps, ext=True))
            bp = (lambda: fused_nonseq.trace_nonseq_bwd_plain(
                flat, r, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid,
                maps=maps))
            # the lightpipe's plain K5 and K6 take ~5-6 s a call at 1M rays
            # and 50 bounces: one call each, without a warm-up, keeps the
            # smoke well inside its time (a reference only)
            plain_reps = (1, 0) if name == 'lightpipe' else (4, 1)
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            replayed = segment_replays(lives)
            # nonseq_ops with every row's scan counting its planes
            scan_extra = sum(h + (2 * CONE_NAPPE_OPS if m.sb == 6 else 0)
                             for m, h in zip(meta, planes))
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins, replayed)
            k5_ops += scans * scan_extra
            k6_ops += (scans + replayed) * scan_extra + 3 * sum(
                w * h for w, h in zip(wins, planes))
            bounds[key1] = bound(io, k5_ops)
            bounds[key2] = bound(io + r.n * 28 + len(meta) * cols * 4,
                                 k6_ops)
            timing[f'{name}_work'] = dict(scans=scans, wins=wins,
                                          replayed=replayed,
                                          max_bounces=int(lives.max()))
        # each kernel: 10 events after 2 warm-ups; its plain version, a
        # reference only, plain_reps events after as many warm-ups
        for key, kf, pf in ((key1, kfn, pfn), (key2, bk, bp)):
            k_runs = time_ms(torch, kf, warmup=2, reps=10)
            p_runs = time_ms(torch, pf, warmup=plain_reps[1],
                             reps=plain_reps[0])
            timing[key] = dict(kernel_ms=statistics.median(k_runs),
                               plain_ms=statistics.median(p_runs),
                               kernel_runs=k_runs)
        for lib in (('trace_seq_fwd', 'trace_seq_bwd') if sc.sequential
                    else ('trace_nonseq_fwd', 'trace_nonseq_bwd')):
            occ[f'{lib}_{name}'] = fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True)
    sc = lightpipe_scene(rt, grad=True)
    params, rays = sc.init_params(dev), lightpipe_rays(torch, N_MAIN, dev)

    def step():
        p = {k: dict(v) for k, v in params.items()}
        p['pipe']['width'] = params['pipe']['width'].clone() \
            .requires_grad_(True)
        sc.simulate_fused(p, rays)[1].spot_rms(0)[0].backward()
    for label, fn in (
            ('simulate_fused_lightpipe', lambda: sc.simulate_fused(params,
                                                                   rays)),
            ('grad_step_fused_lightpipe', step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('solid_timing', **timing)
    emit('solid_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('solid_occupancy', blocks_per_sm=occ)
    # 16d. the kernels without the extended kinds keep their SASS
    emit('solid_sass_no_ext', **check_sass_no_ext())
    emit('solid_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds)



# ---- Section 17: the polarized field on the sequential path (K1's and
# K2's instantiation with the field; examples 07, 22, 33 and 06(c)) ----
#
# Tolerances, each with its reason: the six field streams of the rays both
# trace alike within FIELD_TOL of |E| <= 1 (each component a few contracted
# multiply-adds and a square root per row: the kernel's FMA contraction
# against the plain version's separate roundings moves the last bits, ~1e-7
# a row); |E|^2 within FIELD_POWER_TOL; the launch field's cotangents under
# BWD_TOL's rule; the anchors against the JAX package's numbers on the
# reference's own rays (rays/reference_prng.py, each ray within an ulp of
# JAX's) within FIELD_REF_ATOL of a mean, the examples' own checks at the
# examples' own tolerances (Malus < 1e-5, Stokes atol 1e-5, the design's
# angle within 1e-3 of the analytic one and leakage < 1e-6, chi within
# 0.05 degrees), the design's final angle within FIELD_DESIGN_ATOL of
# JAX's (60 steps of lr 0.5 converge; float32 gradients move the last
# digits), and the grad loss of tests/test_pallas.py:628-665 fused against
# eager: E0's cotangent within rtol 1e-3 and c1's within 3e-2, the JAX
# test's own tolerances (c1's gradient sums cancelling per-ray terms); the
# lens cases' per-ray cotangents off their axis (FIELD_AXIS_R,
# FIELD_F64_RATIO).
FIELD_SEED = SEED + 1801
FIELD_CASES = ('ex07_s', 'ex07_p', 'ex07_circ', 'brewster_mc',
               'brewster_w', 'singlet', 'analyzer', 'qwp', 'quartz',
               'stack', 'window')
# the cases with a lens, whose faces meet the rays near the axis at near
# normal incidence
FIELD_LENS_CASES = ('singlet', 'stack')
FIELD_TOL = 1e-5
FIELD_POWER_TOL = 1e-5
FIELD_REF_ATOL = 1e-5
FIELD_DESIGN_ATOL = 1e-4
FIELD_DESIGN_STEPS = 60
# The lens cases: their rays within FIELD_AXIS_R mm of the axis are left out
# of the per-ray kernel-vs-plain rule (field_kernels_vs_plain says why; on
# an NVIDIA H100 80GB HBM3 every differing ray of the singlet's 1M lay
# within 0.61 mm of it), and on every ray the kernel may break BWD_TOL's
# rule against the plain version's float64 cotangents, the rays' and the
# launch field's, on at most FIELD_F64_RATIO times the rays the plain
# version itself does (the singlet's ray cotangents: 750 and 789 of 1M
# there)
FIELD_AXIS_R = 0.75
FIELD_F64_RATIO = 1.25
FIELD_LAM0 = 0.5876
# The field's operations a row (csrc/field.cuh), counted as in intersect_ops:
# the Fresnel kinds' transport (two s/p bases ~30 each, the amplitudes ~45,
# the projections and the rebuild ~50, the renormalization ~20), a JONES
# row's (its axes ~45, two sincos ~40, the products ~60, a chromatic
# plate's crystal ~30), the s/p rebuild of DOE and PHASE_GRID (~110), a
# scale (~8); a FRESNEL_W or REFLECT_W row's polarized R (a basis and its
# projections, ~50); the sensor's |E|^2 (6).
FIELD_OPS = {'fresnel': 175, 'jones': 145, 'crystal': 30, 'sp': 110,
             'scale': 8, 'pol_r': 50, 'sensor': 6}
# The JAX package's numbers (JAX_PLATFORMS=cpu python tests/field_anchors.py)
FIELD_REF = {'ex07': {'200000': {'s': {'T': 0.8520716428756714,
                                       'dop': 1.0,
                                       's3': 0.0,
                                       'grid': 47283.05859375},
                                 'p': {'T': 0.9999998807907104,
                                       'dop': 1.0,
                                       's3': 0.0,
                                       'grid': 55491.99609375},
                                 'circular': {'T': 0.9260349869728088,
                                              'dop': 1.0,
                                              's3': 0.9968051314353943,
                                              'grid': 51387.5390625}},
                      '1000000': {'s': {'T': 0.8520717024803162,
                                        'dop': 1.0,
                                        's3': 0.0,
                                        'grid': 235664.375},
                                  'p': {'T': 0.9999999403953552,
                                        'dop': 1.0,
                                        's3': 0.0,
                                        'grid': 276579.0},
                                  'circular': {'T': 0.9260349273681641,
                                               'dop': 1.0000001192092896,
                                               's3': 0.9968051314353943,
                                               'grid': 256121.875}}},
             'ex22': {'20000': {'malus': [1.0,
                                          0.9698466658592224,
                                          0.883022129535675,
                                          0.75,
                                          0.586824357509613,
                                          0.4131756126880646,
                                          0.2499999701976776,
                                          0.11697769165039062,
                                          0.030153688043355942,
                                          1.9106858886811786e-15,
                                          0.030153749510645866,
                                          0.11697793006896973,
                                          0.2500000298023224,
                                          0.4131757318973541,
                                          0.5868244171142578,
                                          0.7500000596046448,
                                          0.8830222487449646,
                                          0.9698466658592224,
                                          1.0],
                                'stokes': {'none': [1.0, 0.0, 0.0],
                                           'qwp45': [0.0, 0.0, -1.0],
                                           'hwp22': [-1.4901161193847656e-07,
                                                     0.9999998807907104,
                                                     6.181721801112872e-08]},
                                'design_angle': -0.8967962861061096,
                                'design_leakage': 9.327932332187853e-16},
                      '1000000': {'malus': [1.0,
                                            0.9698466658592224,
                                            0.8830223083496094,
                                            0.75,
                                            0.5868244171142578,
                                            0.4131755828857422,
                                            0.2499999850988388,
                                            0.11697769165039062,
                                            0.03015369176864624,
                                            1.9106861004394154e-15,
                                            0.030153749510645866,
                                            0.11697793006896973,
                                            0.2500000298023224,
                                            0.4131756126880646,
                                            0.5868244171142578,
                                            0.7500000596046448,
                                            0.8830223083496094,
                                            0.9698466658592224,
                                            1.0],
                                  'stokes': {'none': [1.0, 0.0, 0.0],
                                             'qwp45': [0.0, 0.0, -1.0],
                                             'hwp22': [-1.4901161193847656e-07,
                                                       0.9999999403953552,
                                                       6.181721801112872e-08]},
                                  'design_angle': -0.8967962861061096,
                                  'design_leakage': 9.327932332187853e-16}},
             'ex33': {'512': {'0.5376': {'chi_deg': -40.39021303135766,
                                         'modulation': 0.16021773219108582},
                              '0.5876': {'chi_deg': -45.0, 'modulation': 0.0},
                              '0.6376': {'chi_deg': -41.184368084604806,
                                         'modulation': 0.1327971299169737}},
                      '1000000': {
                          '0.5376': {'chi_deg': -40.39045816312569,
                                     'modulation': 0.16021746397018433},
                          '0.5876': {'chi_deg': -45.0, 'modulation': 0.0},
                          '0.6376': {'chi_deg': -41.184200930273974,
                                     'modulation': 0.1327972193239462}}},
             'ex06': {'rays': 7080,
                      'alive': 7080,
                      'mean': 0.9174299240112305,
                      'edge_min': 0.9136030673980713}}


def ex07_scene(rt, kind=None, grid=True):
    """Example 07's Brewster plane (n = 1.5 at Brewster incidence to the
    +z beam) and sensor, with its 96^2 grid; ``kind`` another physics for
    the plane (None: SNELL)."""
    from raytracetorch_tpu_torch.constants import PhysKind
    theta_b = math.atan(1.5)
    sc = rt.SequentialScene([
        rt.ElementCustom(rt.shapes.plane, 1,
                         PhysKind.SNELL if kind is None else kind,
                         ph=(1.5, 1.0), name='brewster',
                         rotation=[theta_b, 0.0, 0.0],
                         translation=[0.0, 0.0, 10.0]),
        rt.SensorElement(half_x=6.0, half_y=6.0, translation=[0, 0, 30.0],
                         name='sensor')])
    if grid:
        sc.grid_shape, sc.grid_half_extent = (96, 96), 6.0
    return sc


def field_singlet(rt, grad=False):
    """tests/test_pallas.py:343-376's singlet and sensor (c1 trainable with
    ``grad``: :628-665)."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5168,
                       c1_grad=grad, name='lens'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.0],
                         name='sensor')])


def field_stack(rt):
    """field_singlet's lens with a polarizer, a quarter-wave plate and an
    analyzer between it and its sensor: six rows."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5168,
                       name='lens'),
        rt.LinearPolarizer(radius=8.0, angle=0.3, translation=[0, 0, 14.0],
                           name='pol'),
        rt.QuarterWaveplate(radius=8.0, angle=math.pi / 4,
                            translation=[0, 0, 15.0], name='qwp'),
        rt.LinearPolarizer(radius=8.0, angle=1.2, translation=[0, 0, 16.0],
                           name='analyzer'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.0],
                         name='sensor')])


def field_window(rt):
    """A flat window of n = 1.5, 5 mm thick, and a sensor: its entry face
    at z = 0 and its exit face at z = 5 turned over, so that a ray along z
    meets the first from outside and the second from inside."""
    from raytracetorch_tpu_torch.constants import PhysKind
    return rt.SequentialScene([
        rt.ElementCustom(rt.shapes.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                         name='entry'),
        rt.ElementCustom(rt.shapes.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                         rotation=[math.pi, 0.0, 0.0],
                         translation=[0.0, 0.0, 5.0], name='exit'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 10.0],
                         name='sensor')])


def ex22_scene(rt, label):
    """Example 22's scenes: 'malus' (the analyzer alone), 'none', 'qwp45',
    'hwp22' (the Stokes cases) and 'design' (the hidden HWP and the
    analyzer)."""
    if label == 'malus':
        return rt.SequentialScene([
            rt.LinearPolarizer(radius=8.0, angle=0.0, angle_grad=True,
                               name='analyzer'),
            rt.SensorElement(radius=20.0, translation=[0, 0, 20.0],
                             name='s')])
    if label == 'design':
        return rt.SequentialScene([
            rt.HalfWaveplate(radius=8.0, angle=0.337, name='rot'),
            rt.LinearPolarizer(radius=8.0, angle=0.2, angle_grad=True,
                               translation=[0, 0, 5.0], name='analyzer'),
            rt.SensorElement(radius=20.0, translation=[0, 0, 20.0],
                             name='s')])
    els = {'none': [],
           'qwp45': [rt.QuarterWaveplate(radius=8.0, angle=math.pi / 4,
                                         name='q')],
           'hwp22': [rt.HalfWaveplate(radius=8.0, angle=math.pi / 8,
                                      name='h')]}[label]
    return rt.SequentialScene(els + [rt.SensorElement(
        radius=20.0, translation=[0, 0, 30.0], name='s')])


def ex33_scene(rt):
    """Example 33's polarizer, quartz QWP at 45 degrees and sensor."""
    return rt.SequentialScene([
        rt.LinearPolarizer(radius=10.0, angle=0.0, name='pol'),
        rt.Waveplate(radius=10.0, retardance=0.25, angle=math.pi / 4,
                     material='quartz', design_wavelength=FIELD_LAM0,
                     translation=[0, 0, 5.0], name='qwp'),
        rt.SensorElement(radius=50.0, translation=[0, 0, 30.0],
                         name='sens')])


def ex06_rays(rt, torch, device):
    """Example 06's 96^2 pupil grid of collimated rays (radius 6 at z =
    -10, the d line)."""
    import numpy as np
    n, r = 96, 6.0
    gx, gy = np.meshgrid(np.linspace(-r, r, n), np.linspace(-r, r, n))
    keep = gx ** 2 + gy ** 2 <= r ** 2
    px, py = gx[keep], gy[keep]
    pos = np.stack([px, py, np.full_like(px, -10.0)], axis=1)
    d = np.tile([0.0, 0.0, 1.0], (len(px), 1))
    return rt.Rays.create(torch.tensor(pos, dtype=torch.float32),
                          torch.tensor(d, dtype=torch.float32),
                          wavelength=torch.full((len(px),), 0.5876),
                          device=device)


def ref_disk(rt, n, radius, z, device, wavelength=0.0):
    """The reference's CollimatedDisk rays of PRNGKey(0)."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    return rp.collimated_disk(rp.prng_key(0), n, radius, (0.0, 0.0, z),
                              wavelength, device)


def field_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, E0, uniforms) of a section 17 case: example
    07's plane with s, p and circular E0; the Brewster plane as FRESNEL
    (uniforms drawn from ``seed``) and FRESNEL_W, lit at Brewster by a
    tilted beam of tests/test_pallas.py:379-414 and
    tests/test_polarization.py:264-290; the singlet of :343-376 with E0 at
    45 degrees; example 22's design and QWP scenes; example 33's quartz QWP
    at lam0 - 0.05 um; 'stack', the singlet with a polarizer, a QWP and an
    analyzer behind it (six rows: K2 keeps their saved fields in local
    memory); 'window', a flat SNELL window (its exit face turned over) lit
    along z, every ray at normal incidence (the s/p basis's fallback),
    with an elliptical E0."""
    import numpy as np
    from raytracetorch_tpu_torch.constants import PhysKind
    gen = torch.Generator(device=device).manual_seed(seed)
    uniforms, E0 = None, None
    if name.startswith('ex07'):
        sc = ex07_scene(rt)
        rays = rt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0]) \
            .sample(gen, n, device)
        E0 = {'ex07_s': [[1.0, 0.0, 0.0]], 'ex07_p': [[0.0, 1.0, 0.0]],
              'ex07_circ': np.array([[1.0, 1.0j, 0.0]]) / np.sqrt(2)}[name]
    elif name.startswith('brewster'):
        th_b = math.atan(1.5168)
        kind = PhysKind.FRESNEL if name == 'brewster_mc' \
            else PhysKind.FRESNEL_W
        sc = rt.SequentialScene([
            rt.ElementCustom(rt.shapes.plane, 1, kind, ph=(1.5168, 1.0),
                             name='iface'),
            rt.SensorElement(radius=100.0, translation=[0, 0, 25.0],
                             name='sensor')])
        rays = rt.CollimatedDisk.make(
            radius=2.0, translation=[0, 0, -10.0],
            rotation=[th_b, 0.0, 0.0]).sample(gen, n, device)
        E0 = [[math.sqrt(0.5), math.cos(th_b) * math.sqrt(0.5),
               math.sin(th_b) * math.sqrt(0.5)]]
        if kind == PhysKind.FRESNEL:
            uniforms = torch.rand(1, n, generator=gen, device=device)
    elif name in ('singlet', 'stack'):
        sc = field_singlet(rt) if name == 'singlet' else field_stack(rt)
        rays = rt.CollimatedDisk.make(radius=3.0, translation=[0, 0, -10.0]) \
            .sample(gen, n, device)
        E0 = [[math.sqrt(0.5), math.sqrt(0.5), 0.0]]
    elif name == 'window':
        sc = field_window(rt)
        rays = rt.CollimatedDisk.make(radius=3.0, translation=[0, 0, -10.0]) \
            .sample(gen, n, device)
        E0 = np.array([[0.8, 0.6j, 0.0]])
    elif name in ('analyzer', 'qwp'):
        sc = ex22_scene(rt, 'design' if name == 'analyzer' else 'qwp45')
        rays = rt.CollimatedDisk.make(radius=2.0, translation=[0, 0, -5.0]) \
            .sample(gen, n, device)
    else:
        sc = ex33_scene(rt)
        rays = rt.CollimatedDisk.make(radius=1.0, translation=[0, 0, -5.0]) \
            .sample(gen, n, device)
        rays = rays.replace(wavelength=torch.full_like(rays.px,
                                                       FIELD_LAM0 - 0.05))
    return sc, sc.init_params(device), rays, E0, uniforms


def compare_field(torch, aux_k, aux_p, keep):
    """The final field's six streams and |E|^2, kernel vs plain, on the
    rays ``keep`` that both trace alike -> dict; raises on a breach."""
    from raytracetorch_tpu_torch.ops.fused_trace import FIELD_KEYS
    errs = {k: float((aux_k[k] - aux_p[k])[keep].abs().max())
            for k in FIELD_KEYS}
    pk = sum(aux_k[k] * aux_k[k] for k in FIELD_KEYS)
    pp = sum(aux_p[k] * aux_p[k] for k in FIELD_KEYS)
    p_err = float((pk - pp)[keep].abs().max())
    finite = all(bool(torch.isfinite(aux_k[k]).all()) for k in FIELD_KEYS)
    res = dict(field_max_abs_err=max(errs.values()),
               field_power_max_abs_err=p_err,
               field_power_mean=float(pp.mean()))
    check(finite, 'the kernel\'s field is not finite')
    check(res['field_max_abs_err'] <= FIELD_TOL,
          f'field streams differ: {errs}')
    check(p_err <= FIELD_POWER_TOL, f'field power differs by {p_err}')
    return res


def field_inputs(rt, torch, sc, params, rays, E0, device):
    """(meta, cfg, flat, kinds, maps, launch field, side buffers) of a
    field trace: the ``TraceMeta`` with ``field``."""
    from raytracetorch_tpu_torch.core.field import FieldState
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    meta = ft.TraceMeta(sc.static_meta(), None, field=True)
    cfg = sc.sensor_config()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(ft.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    side = dict(coat=ft.coat_side(meta, device),
                fuzzy=ft.fuzzy_buffer(meta, device),
                ff=ft.ff_side(meta, device))
    field = FieldState.init(rays, E0).streams()
    return meta, cfg, flat, kinds, ft.plate_maps(meta, {}), field, side


def ray_slice(ft, rays, sl):
    """The rays ``sl`` (a slice) of ``rays``."""
    return rays.replace(**{c: getattr(rays, c)[sl]
                           for c in ft.COMPS + ('ray_id', 'wavelength')})


def ray_chunks(n, size):
    """Slices of at most ``size`` rays covering n (``size`` None: one)."""
    size = size or n
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


def join_chunks(torch, parts):
    """One run's result from a plain version's results on consecutive
    chunks of rays (ray_chunks).  A forward's (rays, sensors, aux): the rays
    and the aux streams joined, the moments and the grid summed.  A
    backward's (table, rays'[, maps'][, wavelength's][, launch field's]):
    the table's and the maps' cotangents summed, the per-ray ones joined."""
    if len(parts) == 1:
        return parts[0]
    last = len(parts[0]) - 1

    def join(i, xs):
        x = xs[0]
        if torch.is_tensor(x):
            return sum(xs) if i == 0 else torch.cat(xs)
        if isinstance(x, tuple):
            if i in (1, last):
                return tuple(torch.cat(c) for c in zip(*xs))
            return tuple(sum(c) for c in zip(*xs))
        if isinstance(x, dict):
            return {k: torch.cat([a[k] for a in xs]) for k in x}
        if hasattr(x, 'moments'):
            return dataclasses.replace(x, moments=sum(a.moments for a in xs),
                                       grid=sum(a.grid for a in xs))
        return x.replace(**{f.name: torch.cat([getattr(o, f.name)
                                               for o in xs])
                            for f in dataclasses.fields(x)})
    return tuple(join(i, [p[i] for p in parts]) for i in range(last + 1))


def plain_field_fwd(torch, ft, flat, rays, cfg, meta, maps, uniforms, field,
                    chunk=None):
    """trace_sequential_fused_plain with the field, ``chunk`` rays at a time
    (a ray's trace does not depend on the others'; join_chunks)."""
    return join_chunks(torch, [ft.trace_sequential_fused_plain(
        flat, ray_slice(ft, rays, sl), cfg, meta, maps,
        uniforms=None if uniforms is None else uniforms[:, sl],
        field=[f[sl] for f in field]) for sl in ray_chunks(rays.n, chunk)])


def plain_field_bwd(torch, ft, flat, rays, cfg, meta, g_rays, g_mom, g_grid,
                    maps, uniforms, field, g_field, need_wavelength,
                    chunk=None):
    """trace_seq_bwd_plain with the field, ``chunk`` rays at a time
    (join_chunks)."""
    return join_chunks(torch, [ft.trace_seq_bwd_plain(
        flat, ray_slice(ft, rays, sl), cfg, meta,
        [None if g is None else g[sl] for g in g_rays], g_mom,
        g_grid=g_grid, maps=maps,
        uniforms=None if uniforms is None else uniforms[:, sl],
        field=[f[sl] for f in field], g_field=[g[sl] for g in g_field],
        need_wavelength=need_wavelength) for sl in ray_chunks(rays.n, chunk)])


def field_kernels_vs_plain(rt, torch, name, n, device, seed, case=None,
                           lens_cases=FIELD_LENS_CASES, flips=0,
                           wavelength=False, f64_chunk=None, chunk=None):
    """K1 and K2 in their instantiation with the field against their plain
    versions on a section 17 case (``case``: another section's, such as
    field_coat_case; ``lens_cases``: its cases with a lens): the rays,
    moments, grid and the final field's six streams and |E|^2; on a FRESNEL
    row the branch of every ray (at most ``flips`` may differ, left out as
    traced apart); then the ray, table and launch-field cotangents under
    seeded cotangents (the final field's too) on the rays both trace alike,
    and with ``wavelength`` the wavelength's where the rays carry one ->
    dict; raises on a breach.  Each kernel runs once on all n rays; the
    plain versions run ``chunk`` rays at a time (None: all at once), and
    the lens cases' float64 reference ``f64_chunk`` at a time, over every
    ray (a ray's trace and cotangents do not depend on the others', and
    the table's are sums over the rays)."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    sc, params, rays, E0, uniforms = (case or field_case)(rt, torch, name, n,
                                                          device, seed)
    meta, cfg, flat, kinds, maps, field, side = field_inputs(
        rt, torch, sc, params, rays, E0, device)
    fresnel = ft.fresnel_kinds(meta)
    out_k, s_k, aux_k = ft.trace_seq_fwd_cuda(
        flat, kinds, rays, cfg, maps, True, fresnel=fresnel,
        uniforms=uniforms, diff=True, field=field, **side)
    out_p, s_p, aux_p = plain_field_fwd(torch, ft, flat, rays, cfg, meta,
                                        maps, uniforms, field, chunk)
    torch.cuda.synchronize()
    res = compare(torch, out_k, s_k, out_p, s_p, FRESNEL_I_RTOL)
    apart = traced_apart(torch, out_k, out_p, FRESNEL_I_RTOL)[0]
    res.update(compare_field(torch, aux_k, aux_p, ~apart))
    if cfg.grid_shape:
        res.update(compare_grid(torch, s_k.grid, s_p.grid, GRID_TOTAL_RTOL))
    if uniforms is not None:
        res['branches_differ'] = int(((out_k.dz < 0) != (out_p.dz < 0))
                                     .sum())
        res['reflected'] = int((out_p.dz < 0).sum())
        check(res['branches_differ'] <= flips,
              f'{name}: {res["branches_differ"]} FRESNEL branches differ')
    res.update(rows=len(meta), apart=int(apart.sum()))
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    g_field = [torch.randn(rays.n, generator=gen, device=device)
               for _ in range(6)]
    wl = wavelength and bool((rays.wavelength > 0).any())
    g_k = ft.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps,
        ext=True, fresnel=fresnel, uniforms=uniforms, diff=True,
        field=field, g_field=g_field, need_wavelength=wl, **side)
    g_p = plain_field_bwd(torch, ft, flat, rays, cfg, meta, g_rays, g_mom,
                          g_grid, maps, uniforms, field, g_field, wl, chunk)
    torch.cuda.synchronize()
    # a lens's rays near its axis meet its faces near normal incidence,
    # where s = normalize(d x n) of a short d x n amplifies float32
    # rounding into their position cotangents: the rays within FIELD_AXIS_R
    # of the axis are left out of the kernel-vs-plain rule, and on every
    # ray the kernel's ray and launch-field cotangents must be as close to
    # the plain version's float64 run as the plain version's own are
    # (FIELD_F64_RATIO)
    keep = torch.ones_like(rays.px, dtype=torch.bool)
    if name in lens_cases:
        keep = (rays.px ** 2 + rays.py ** 2).sqrt() >= FIELD_AXIS_R
        parts = [plain_float64_cotangents(
            torch, ft, flat, ray_slice(ft, rays, sl), cfg, meta, maps,
            [f[sl] for f in field],
            [None if g is None else g[sl] for g in g_rays], g_mom, g_grid,
            [g[sl] for g in g_field],
            None if uniforms is None else uniforms[:, sl])
            for sl in ray_chunks(rays.n, f64_chunk)]
        g64, g64_field = ([torch.cat(c) for c in zip(*(p[j] for p in parts))]
                          for j in (0, 1))
        res['near_axis'] = int((~keep).sum())
        res['f64_rays'] = rays.n
        allowed = math.ceil(BWD_FLIPS_PER_MILLION * rays.n / 1e6)
        for label, gk, gp, g64_, groups in (
                ('rays', g_k[1], g_p[1], g64, ((0, 1, 2), (3, 4, 5), (6,))),
                ('field', g_k[-1], g_p[-1], g64_field, (tuple(range(6)),))):
            off_k = rays_off_float64(torch, gk, g64_, groups)
            off_p = rays_off_float64(torch, gp, g64_, groups)
            res[f'{label}_off_f64'] = dict(kernel=off_k, plain=off_p)
            check(off_k <= FIELD_F64_RATIO * off_p + allowed,
                  f'{name}: the kernel departs from the float64 {label} '
                  f'cotangents on {off_k} rays, the plain version on {off_p}')
    res['bwd'] = compare_ray_cotangents(
        torch, [g[keep] for g in g_k[1]], [g[keep] for g in g_p[1]])
    res['bwd'].update(compare_table_cotangents(
        torch, ft, g_k[0], g_p[0], plates=True, ext=True, coat=True,
        diff=True, freeform=True))
    res['bwd']['field'] = compare_field_cotangents(
        torch, [g[keep] for g in g_k[-1]], [g[keep] for g in g_p[-1]])
    if wl:
        res['bwd']['wavelength'] = compare_wavelength_cotangents(
            torch, g_k[3][keep], g_p[3][keep])
    return res


def plain_float64_cotangents(torch, ft, flat, rays, cfg, meta, maps, field,
                             g_rays, g_mom, g_grid, g_field, uniforms=None):
    """The plain version's 7 input-ray and 6 launch-field cotangents in
    float64 (table, rays, field and cotangents widened; FRESNEL rows on
    ``uniforms``): the reference of the plain version's own float32
    rounding."""
    from raytracetorch_tpu_torch.core.field import FieldState
    d = torch.float64
    r64 = rays.replace(**{c: getattr(rays, c).to(d) for c in ft.COMPS},
                       wavelength=rays.wavelength.to(d))
    f64 = FieldState(*(f.to(d) for f in field)).streams()
    flags = ft.StreamFlags(False, False, False, True)
    res = ft.plain_vjp(
        lambda f, r, m, fld=None: ft._chain(f, r, cfg, meta, m, flags,
                                            uniforms=uniforms, field=fld),
        flat.to(d), r64, [g.to(d) for g in g_rays], g_mom.to(d),
        None if g_grid is None else g_grid.to(d), maps, False,
        dict(zip(ft.FIELD_KEYS, (g.to(d) for g in g_field))), field=f64)
    return res[1], res[-1]


def rays_off(torch, g, g_ref, groups):
    """The mask of the rays whose cotangents ``g`` break BWD_TOL's rule
    against ``g_ref``, each against the largest |g_ref| of its group in
    ``groups`` (compare_ray_cotangents's groups and scales for the rays' 7,
    compare_field_cotangents's one group for the field's 6)."""
    bad = torch.zeros_like(g_ref[0], dtype=torch.bool)
    for grp in groups:
        scale = max(float(g_ref[j].abs().max()) for j in grp)
        for j in grp:
            bad |= ((g[j].double() - g_ref[j]).abs() > BWD_TOL * (
                g_ref[j].abs() + scale)) | ~torch.isfinite(g[j])
    return bad


def rays_off_float64(torch, g, g64, groups):
    """The number of rays whose cotangents ``g`` break BWD_TOL's rule
    against the float64 ones ``g64`` (``rays_off``)."""
    return int(rays_off(torch, g, g64, groups).sum())


def compare_field_cotangents(torch, g_k, g_p):
    """The launch field's six cotangents, kernel vs plain -> dict; raises
    unless every ray's are within BWD_TOL of |plain| + the largest |plain|
    (BWD_FLIPS_PER_MILLION rays may differ, as compare_ray_cotangents
    allows)."""
    n = g_p[0].shape[0]
    scale = max(float(g.abs().max()) for g in g_p)
    bad = torch.zeros(n, dtype=torch.bool, device=g_p[0].device)
    err = 0.0
    for a, b in zip(g_k, g_p):
        e = (a - b).abs()
        err = max(err, float(e.max()))
        bad |= (e > BWD_TOL * (b.abs() + scale)) | ~torch.isfinite(a)
    allowed = math.ceil(BWD_FLIPS_PER_MILLION * n / 1e6)
    res = dict(scale=scale, max_abs_err=err,
               max_err_over_scale=err / max(scale, 1e-30),
               rays_differ=int(bad.sum()), allowed=allowed)
    check(res['rays_differ'] <= allowed,
          f'{res["rays_differ"]} rays have other field cotangents')
    return res


def stokes_means(torch, aux, out):
    """Mean normalized Stokes (S1, S2, S3) / S0, the mean degree of
    polarization and mean |E|^2 of a field trace."""
    from raytracetorch_tpu_torch.utils.polarization import (
        degree_of_polarization, stokes_parameters)
    s0, s1, s2, s3 = stokes_parameters(aux['field'], out.dir_c)
    s0c = s0.clamp(min=1e-12)
    return dict(T=float(aux['field_power'].mean()),
                dop=float(degree_of_polarization(s0, s1, s2, s3).mean()),
                s1=float((s1 / s0c).mean()), s2=float((s2 / s0c).mean()),
                s3=float((s3 / s0c).mean()), raw=[float(x.double().mean())
                                                for x in (s0, s1, s2, s3)])


def field_examples(rt, torch, dev, reset_counters, counters, only):
    """Examples 07, 22, 33 and 06(c) through simulate_fused on the
    reference's own rays at their published sizes and N_MAIN, against the
    examples' own checks and FIELD_REF (the JAX package's numbers), with
    the launches of each run counted -> dict; raises on a breach."""
    import numpy as np
    res = {}
    ref07, ref22, ref33 = (FIELD_REF['ex07'], FIELD_REF['ex22'],
                           FIELD_REF['ex33'])
    sc = ex07_scene(rt)
    params = sc.init_params(dev)
    for n in (200_000, N_MAIN):
        rays = ref_disk(rt, n, 4.0, -10.0, dev)
        runs = {}
        for label, E0 in (('s', [[1.0, 0.0, 0.0]]), ('p', [[0.0, 1.0, 0.0]]),
                          ('circular', np.array([[1.0, 1.0j, 0.0]])
                           / np.sqrt(2))):
            reset_counters()
            with torch.no_grad():
                out, sens, aux = sc.simulate_fused(params, rays,
                                                   track_field=True, E0=E0)
            torch.cuda.synchronize()
            fl = counters()
            check(only(fl, trace_seq_fwd=1, field=1),
                  f'example 07 launched {fl}')
            st = stokes_means(torch, aux, out)
            st['grid'] = float(sens.grid.sum())
            ref = ref07[str(n)][label]
            for k in ('T', 'dop', 's3'):
                check(abs(st[k] - ref[k]) <= FIELD_REF_ATOL,
                      f'example 07 {label} {k} {st[k]} vs JAX {ref[k]}')
            check(abs(st['grid'] - ref['grid']) <= 1e-5 * ref['grid'],
                  f'example 07 {label} grid {st["grid"]} vs {ref["grid"]}')
            runs[label] = dict(st, launches=fl)
        check(runs['p']['T'] > 0.99 and runs['s']['T'] < 0.90,
              f'example 07 T_p {runs["p"]["T"]}, T_s {runs["s"]["T"]}')
        res[f'ex07_{n}'] = runs
    thetas = [math.pi * j / 18 for j in range(19)]
    for n in (20_000, N_MAIN):
        rays = ref_disk(rt, n, 2.0, -5.0, dev)
        ref = ref22[str(n)]
        sc = ex22_scene(rt, 'malus')
        params = sc.init_params(dev)
        malus = []
        for th in thetas:
            params['analyzer']['angle'] = torch.tensor(th, device=dev)
            with torch.no_grad():
                aux = sc.simulate_fused(params, rays, track_field=True)[2]
            malus.append(float(aux['field_power'].mean()))
        worst = max(abs(t - math.cos(th) ** 2) for t, th in zip(malus, thetas))
        vs_jax = max(abs(a - b) for a, b in zip(malus, ref['malus']))
        check(worst < 1e-5, f'Malus curve off by {worst}')
        check(vs_jax <= FIELD_REF_ATOL, f'Malus vs JAX off by {vs_jax}')
        stokes = {}
        for label, expect in (('none', (1, 0, 0)), ('qwp45', (0, 0, -1)),
                              ('hwp22', (0, -1, 0))):
            s = ex22_scene(rt, label)
            with torch.no_grad():
                out, _, aux = s.simulate_fused(s.init_params(dev), rays,
                                               track_field=True)
            st = stokes_means(torch, aux, out)
            got = [st['s1'], st['s2'], st['s3']]
            check(all(abs(abs(a) - abs(b)) <= 1e-5
                      for a, b in zip(got, expect)),
                  f'Stokes {label}: {got} vs {expect}')
            check(all(abs(a - b) <= FIELD_REF_ATOL
                      for a, b in zip(got, ref['stokes'][label])),
                  f'Stokes {label}: {got} vs JAX {ref["stokes"][label]}')
            stokes[label] = got
        design = field_design(rt, torch, dev, rays, reset_counters, counters,
                              only)
        check(abs(design['angle'] - ref['design_angle'])
              <= FIELD_DESIGN_ATOL,
              f'design angle {design["angle"]} vs JAX '
              f'{ref["design_angle"]}')
        res[f'ex22_{n}'] = dict(malus_worst=worst, malus_vs_jax=vs_jax,
                                stokes=stokes, design=design)
    for n in (512, N_MAIN):
        sc = ex33_scene(rt)
        params = sc.init_params(dev)
        rows = {}
        for lam in (FIELD_LAM0 - 0.05, FIELD_LAM0, FIELD_LAM0 + 0.05):
            rays = ref_disk(rt, n, 1.0, -5.0, dev, lam)
            with torch.no_grad():
                out, _, aux = sc.simulate_fused(params, rays,
                                                track_field=True)
            s0, s1, s2, s3 = stokes_means(torch, aux, out)['raw']
            chi = math.degrees(0.5 * math.asin(max(-1.0, min(1.0, s3 / s0))))
            mod = math.hypot(s1, s2) / s0
            from raytracetorch_tpu_torch.utils.birefringence import \
                birefringence
            d = (math.pi / 2) * (FIELD_LAM0 / lam) \
                * birefringence('quartz', lam) \
                / birefringence('quartz', FIELD_LAM0)
            chi_ana = math.degrees(-0.5 * math.asin(math.sin(d)))
            ref = ref33[str(n)][f'{lam:.4f}']
            check(abs(chi - chi_ana) < 0.05,
                  f'example 33 chi {chi} vs analytic {chi_ana} at {lam}')
            check(abs(chi - ref['chi_deg']) <= 1e-3
                  and abs(mod - ref['modulation']) <= 1e-4,
                  f'example 33 at {lam}: {chi}, {mod} vs JAX {ref}')
            rows[f'{lam:.4f}'] = dict(chi_deg=chi, chi_analytic=chi_ana,
                                      modulation=mod)
        lams = sorted(rows)
        check(abs(rows[lams[1]]['chi_deg'] + 45.0) < 0.05
              and rows[lams[1]]['modulation'] < 1e-3,
              f'example 33 at the design wavelength: {rows[lams[1]]}')
        for k in (0, 2):
            err = abs(rows[lams[k]]['chi_deg'] + 45.0)
            check(1.0 < err < 6.0 and rows[lams[k]]['modulation'] > 0.05,
                  f'example 33 off design: {rows[lams[k]]}')
        res[f'ex33_{n}'] = rows
    sc = rt.SequentialScene([rt.SingletLens(
        c1=0.02, c2=-0.02, d=16.0, t=4.0, ior_glass=1.5168, name='lens')])
    rays = ex06_rays(rt, torch, dev)
    from raytracetorch_tpu_torch.utils.polarization import \
        polarized_sequential_trace
    with torch.no_grad():
        out, power, _ = polarized_sequential_trace(
            sc, sc.init_params(dev), rays, [[1.0, 0.0, 0.0]], fused=True)
    alive = out.intensity > 0
    ex06 = dict(rays=rays.n, alive=int(alive.sum()),
                mean=float(power[alive].mean()),
                edge_min=float(power[alive].min()))
    ref = FIELD_REF['ex06']
    check(ex06['alive'] == ref['alive']
          and abs(ex06['mean'] - ref['mean']) <= FIELD_REF_ATOL
          and abs(ex06['edge_min'] - ref['edge_min']) <= FIELD_REF_ATOL,
          f'example 06(c) {ex06} vs JAX {ref}')
    res['ex06'] = ex06
    return res


def field_design(rt, torch, dev, rays, reset_counters=None, counters=None,
                 only=None, steps=FIELD_DESIGN_STEPS):
    """Example 22's analyzer design through simulate_fused: ``steps``
    gradient steps of lr 0.5 on the transmitted power in the analyzer's
    angle (K1 and K2 once each a step) -> dict; raises unless it lands
    within 1e-3 of the analytic angle with leakage < 1e-6."""
    sc = ex22_scene(rt, 'design')
    params = sc.init_params(dev)
    angle = params['analyzer']['angle'].clone()
    if reset_counters is not None:
        reset_counters()
    for _ in range(steps):
        p = {k: dict(v) for k, v in params.items()}
        p['analyzer']['angle'] = angle.clone().requires_grad_(True)
        power = sc.simulate_fused(p, rays, track_field=True)[2][
            'field_power'].mean()
        g, = torch.autograd.grad(power, p['analyzer']['angle'])
        angle = angle - 0.5 * g
    torch.cuda.synchronize()
    res = dict(angle=float(angle))
    if counters is not None:
        res['launches'] = fl = counters()
        check(only(fl, trace_seq_fwd=steps, trace_seq_bwd=steps,
                   field=2 * steps), f'the design launched {fl}')
    params['analyzer']['angle'] = angle
    with torch.no_grad():
        res['leakage'] = float(sc.simulate_fused(
            params, rays, track_field=True)[2]['field_power'].mean())
    found = res['angle'] % math.pi
    target = (2 * 0.337 + math.pi / 2) % math.pi
    res.update(target=target, off=abs(found - target))
    check(res['leakage'] < 1e-6 and res['off'] < 1e-3,
          f'the analyzer design: {res}')
    return res


def field_grad_loss(rt, torch, dev):
    """tests/test_pallas.py:628-665's loss, total weight plus sum of
    |E|^2 squared, on the singlet at N_MAIN rays: c1's and E0's gradients
    through simulate_fused (K1 + K2) against the eager trace's -> dict."""
    sc = field_singlet(rt, grad=True)
    params = sc.init_params(dev)
    gen = torch.Generator(device=dev).manual_seed(FIELD_SEED + 5)
    rays = rt.CollimatedDisk.make(radius=3.0, translation=[0, 0, -10.0]) \
        .sample(gen, N_MAIN, dev)
    grads = {}
    for name in ('simulate_fused', 'simulate'):
        p = {k: dict(v) for k, v in params.items()}
        p['lens']['c1'] = params['lens']['c1'].clone().requires_grad_(True)
        E0 = torch.tensor([[math.sqrt(0.5), math.sqrt(0.5), 0.0]],
                          device=dev, requires_grad=True)
        _, sens, aux = getattr(sc, name)(p, rays, track_field=True, E0=E0)
        loss = sens.total_weight(0)[0] + (aux['field_power'] ** 2).sum()
        g_c1, g_e0 = torch.autograd.grad(loss, [p['lens']['c1'], E0])
        grads[name] = dict(loss=float(loss), c1=float(g_c1),
                           E0=g_e0[0].tolist())
    f, e = grads['simulate_fused'], grads['simulate']
    check(abs(f['loss'] - e['loss']) <= 1e-5 * abs(e['loss']),
          f'grad loss {f["loss"]} vs eager {e["loss"]}')
    check(abs(f['c1'] - e['c1']) <= 3e-2 * abs(e['c1']),
          f'c1 gradient {f["c1"]} vs eager {e["c1"]}')
    check(all(abs(a - b) <= 1e-3 * abs(b) + 1e-5
              for a, b in zip(f['E0'], e['E0'])),
          f'E0 gradient {f["E0"]} vs eager {e["E0"]}')
    return grads


def field_row_ops(meta):
    """A row's field operations (FIELD_OPS) beside its intersect_ops and
    apply_ops."""
    from raytracetorch_tpu_torch.constants import PhysKind
    ops = FIELD_OPS['sensor'] if meta.sensor else 0
    if meta.ph in (PhysKind.SNELL, PhysKind.FRESNEL, PhysKind.FRESNEL_W,
                   PhysKind.REFLECT_W):
        ops += FIELD_OPS['fresnel']
        if meta.ph in (PhysKind.FRESNEL, PhysKind.FRESNEL_W,
                       PhysKind.REFLECT_W):
            ops += FIELD_OPS['pol_r']
    elif meta.ph == PhysKind.JONES:
        ops += FIELD_OPS['jones'] + (FIELD_OPS['crystal']
                                     if meta.jones_bire else 0)
    elif meta.ph in (PhysKind.DOE, PhysKind.PHASE_GRID):
        ops += FIELD_OPS['sp']
    else:
        ops += FIELD_OPS['scale']
    return ops


def field_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 17: the polarized field through K1 and K2 (their
    instantiation with the field): each against its plain version at
    N_MAIN rays on FIELD_CASES (the Brewster FRESNEL plane's branches ray
    for ray); examples 07, 22, 33 and 06(c) through simulate_fused at their
    published sizes and N_MAIN against their own checks and the JAX
    package's numbers, example 22's design through K2 and the grad loss of
    tests/test_pallas.py:628-665; times, bounds (the field's work counted),
    blocks per SM; the SASS of every earlier instantiation."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 17a. each kernel against its plain version
    kern = {name: field_kernels_vs_plain(rt, torch, name, N_MAIN, dev,
                                         FIELD_SEED + 11)
            for name in FIELD_CASES}
    emit('field_kernels_vs_plain', n=N_MAIN, **kern)

    # 17b. the examples on the reference's rays, the design, the grad loss
    paths = field_examples(rt, torch, dev, reset_counters, counters, only)
    reset_counters()
    paths['grad_loss'] = field_grad_loss(rt, torch, dev)
    gl = counters()
    check(only(gl, trace_seq_fwd=1, trace_seq_bwd=1, field=2),
          f'the grad loss launched {gl}')
    paths['grad_loss']['launches'] = gl
    emit('field_main', **paths)

    # 17c. times at N_MAIN against the plain versions, bounds and blocks
    timing, bounds, occ = {}, {}, {}
    for name in ('analyzer', 'ex07_circ'):
        sc, params, r, E0, _ = field_case(rt, torch, name, N_MAIN, dev,
                                          FIELD_SEED + 7)
        meta, cfg, flat, kinds, maps, field, side = field_inputs(
            rt, torch, sc, params, r, E0, dev)
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 6)
        g_field = [g_rays[0]] * 6
        kfn = (lambda: ft.trace_seq_fwd_cuda(
            flat, kinds, r, cfg, maps, True, fresnel=True, diff=True,
            field=field, **side))
        pfn = (lambda: ft.trace_sequential_fused_plain(
            flat, r, cfg, meta, maps, field=field))
        bk = (lambda: ft.trace_seq_bwd_cuda(
            flat, kinds, r, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps,
            ext=True, fresnel=True, diff=True, field=field, g_field=g_field,
            **side))
        bp = (lambda: ft.trace_seq_bwd_plain(
            flat, r, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps,
            field=field, g_field=g_field))
        cols = len(ft.grad_cols((), True, coat=True, diff=True,
                                freeform=True))
        io = r.n * (36 + 28 + 48) + table_bytes(meta) + grid_bytes(cfg)
        k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m)
                           + field_row_ops(m) for m in meta)
        bounds[f'k1_{name}'] = bound(io, k1_ops)
        # K2 reads the final field's cotangent (24 B) and writes the launch
        # field's (the 24 B K1 reads and writes more are in io)
        bounds[f'k2_{name}'] = bound(io + r.n * (28 + 24)
                                     + len(meta) * cols * 4, 3 * k1_ops)
        for key, kf, pf in ((f'k1_{name}', kfn, pfn),
                            (f'k2_{name}', bk, bp)):
            k_runs = time_ms(torch, kf, warmup=2, reps=10)
            p_runs = time_ms(torch, pf, warmup=1, reps=3)
            timing[key] = dict(kernel_ms=statistics.median(k_runs),
                               plain_ms=statistics.median(p_runs),
                               kernel_runs=k_runs)
        for lib in ('trace_seq_fwd', 'trace_seq_bwd'):
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, ext=True, disp=False,
                fuzzy_words=len(meta), field=True)
    sc = ex22_scene(rt, 'design')
    params = sc.init_params(dev)
    rays = ref_disk(rt, N_MAIN, 2.0, -5.0, dev)

    def step():
        p = {k: dict(v) for k, v in params.items()}
        p['analyzer']['angle'] = params['analyzer']['angle'].clone() \
            .requires_grad_(True)
        sc.simulate_fused(p, rays, track_field=True)[2][
            'field_power'].mean().backward()
    for label, fn in (
            ('simulate_fused_analyzer', lambda: sc.simulate_fused(
                params, rays, track_field=True)),
            ('grad_step_fused_analyzer', step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('field_timing', **timing)
    emit('field_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('field_occupancy', blocks_per_sm=occ)
    # 17d. every earlier instantiation keeps its SASS
    emit('field_sass', **check_sass_all())
    emit('field_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds)


# ---- Section 18: the polarized field through coated interfaces and metal
# mirrors (K1's and K2's instantiation with the field) ----
#
# The coated bench singlet (a quarter-wave MgF2 coat on both faces, its
# thickness trainable) in FRESNEL_W and FRESNEL with s, p and circular E0;
# the stress rows of section 12 as SequentialScenes (stack8, gold at 0.45
# and 0.70 um, mangin); the absorbing silver-film beamsplitter of
# tests/test_coatings.py:779-800 (45 degrees, pure s) in FRESNEL_W and
# FRESNEL; the aluminium mirrors of :362-385 and :573-595 (fixed, and
# dispersive at 0.80 um); a 20-step Adam design of the coat thickness
# through K2; the Jones pupil of the coated singlet tilted 0.3 rad and of
# stack8.  The JAX anchors come from tests/field_anchors.py (the JAX package
# on the CPU, on the reference's own rays and, on FRESNEL rows, its very
# uniforms; metals and the silver film in float64, where the JAX package's
# float32 complex square root cancels: ROADMAP Queue 3).
#
# Tolerances, each with its reason: K1 and K2 against their plain versions
# under section 17's rules (FIELD_TOL, FIELD_POWER_TOL, BWD_TOL, TAB_RTOL,
# the lens cases' rays near the axis and their float64 cotangents), with up
# to FLIPS_PER_MILLION FRESNEL branches apart (a stack's R_pol rounds
# otherwise in the kernel than in the plain version, and a draw within an
# ulp of it flips); the paths' means against the JAX package's within
# FIELD_COAT_REF_ATOL (float32 sums of a million rays in another order, and
# on FRESNEL rows FRESNEL_FLIPS / n of draws within an ulp of R), their
# sensor weights within FIELD_COAT_MOMENT_RTOL; the beamsplitter's
# transmitted weights against the analytic polarized Ts and Ts / (1 - Rs)
# (rtol 1e-4, the JAX test's) and its reflected share within
# FRESNEL_NS_SIGMAS binomial sigmas of Rs (its FRESNEL draw has no JAX
# anchor: enable_x64 would draw float64 uniforms, and the JAX package's
# float32 R of the film is 1e-4 off); the mirrors' intensity * |E|^2
# against R (rtol 2e-3, the JAX tests') and |E|^2 = 1 (rtol 1e-4); the
# design's final thickness within FIELD_COAT_DESIGN_ATOL of JAX's (Adam
# steps of lr FIELD_COAT_DESIGN_LR follow the gradient's sign, which both
# packages agree on; the last steps move by less than 1e-4); the Jones pupil
# traced eagerly against simulate_fused under JONES_TOL's rule, its maps at
# 16^2 against JAX's within JONES_MAP_ATOL (float32 fields through a few
# rows).
FIELD_COAT_SEED = SEED + 1901
FIELD_COAT_CASES = ('coated_w', 'coated_mc', 'stack8', 'gold', 'mangin',
                    'splitter_w', 'splitter_mc', 'al', 'al_disp')
# the cases whose rays meet a face at near normal incidence near the axis,
# where s = normalize(d x n) amplifies float32 rounding (section 17's lens
# rule, FIELD_AXIS_R and the float64 reference on every ray): the coated
# lenses, and the aluminium mirrors lit by a 2 mm beam (on an NVIDIA H100
# 80GB HBM3 without the rule, 160 and 177 of their 1M rays' direction
# cotangents broke BWD_TOL's against the plain version by up to 3e-4 of
# the scale)
FIELD_COAT_LENS_CASES = ('coated_w', 'coated_mc', 'stack8', 'al', 'al_disp')
# The plain versions' autograd graphs of an 8-layer stack take ~68 GB per 1M
# rays (float32; float64 twice that): the kernels run once on all N_MAIN
# rays, and stack8's plain versions (the kernel-vs-plain check's and the
# grad step's eager trace) FIELD_COAT_CHUNK rays at a time, the lens cases'
# float64 reference FIELD_COAT_F64_CHUNK at a time, over every ray (a
# ray's trace does not depend on the others'; the table's cotangents and
# the gradients are sums over the rays)
FIELD_COAT_CHUNK = {'stack8': 250_000}
FIELD_COAT_F64_CHUNK = 100_000
FIELD_COAT_REF_ATOL = 2e-5
FIELD_COAT_MOMENT_RTOL = 2e-5
# a ray near a rim that the JAX package's float64 trace and the card's
# float32 one take past or through a face moves a first moment by up to the
# beam's radius / n (the Mangin mirror's y moment: 1.4e-5 off JAX's at 1M
# rays on an NVIDIA H100 80GB HBM3, its weight and flux within 3e-6)
FIELD_COAT_RIM_RAYS = 4
# The Jones pupil traced eagerly against simulate_fused: every sample within
# JONES_TOL, all but JONES_FLIPS_PER_MILLION of them within FIELD_TOL (where
# a tilted face meets a ray at normal incidence, s = normalize(d x n)
# amplifies float32 rounding: 4.1e-5 on the tilted singlet at 1024^2 on an
# NVIDIA H100 80GB HBM3)
JONES_TOL = 1e-4
JONES_FLIPS_PER_MILLION = FLIPS_PER_MILLION
FIELD_COAT_DESIGN_STEPS = 20
FIELD_COAT_DESIGN_LR = 0.004
FIELD_COAT_DESIGN_START = 0.08
FIELD_COAT_DESIGN_RAYS = 20_000
FIELD_COAT_DESIGN_ATOL = 2e-4
JONES_N = 1024
JONES_REF_N = 16
JONES_MAP_ATOL = 2e-5
SPLITTER_AG = 0.04
# The stack's operations of one ray at a coated or metal row under the
# field: one evaluation a polarization (counted as coat_ops counts it) gives
# R and T for the weight or the draw and, ~FIELD_COAT_AMP_OPS more, the
# complex r and t for the transport; a metal mirror's transport is the
# Fresnel kinds' (FIELD_OPS['fresnel']) without their bare amplitudes
# (~FIELD_BARE_AMP_OPS), and it weighs by the polarized R (pol_r)
FIELD_COAT_AMP_OPS = 20
FIELD_BARE_AMP_OPS = 45
# The JAX package's numbers (JAX_PLATFORMS=cpu python tests/field_anchors.py)
FIELD_COAT_REF = {'paths': {'coated_w': {'s': {'flux': 0.9718529042403297,
                              'power': 0.9999999952294827,
                              'weight': 0.971852875,
                              'mx': -5.663705825805664e-05,
                              'my': 3.426519775390625e-05},
                        'p': {'flux': 0.9718576598878519,
                              'power': 0.9999999950259923,
                              'weight': 0.9718576875,
                              'mx': -5.6778553009033203e-05,
                              'my': 3.4808055877685545e-05},
                        'circular': {'flux': 0.9718554106267063,
                                     'power': 1.000000126775086,
                                     'weight': 0.9718555625,
                                     'mx': -5.670777893066406e-05,
                                     'my': 3.453662109375e-05}},
           'coated_mc': {'s': {'flux': 0.9999999952712059,
                               'power': 0.9999999952712059,
                               'weight': 0.971865,
                               'mx': -5.636759185791016e-05,
                               'my': 2.1839881896972657e-05},
                         'p': {'flux': 0.9999999951117039,
                               'power': 0.9999999951117039,
                               'weight': 0.97187,
                               'mx': -6.650080871582031e-05,
                               'my': 6.457409381866455e-06},
                         'circular': {'flux': 1.0000001266812681,
                                      'power': 1.0000001266812681,
                                      'weight': 0.971861,
                                      'mx': -6.291032409667969e-05,
                                      'my': 1.4598093986511231e-05}},
           'stack8': {'flux': 0.0014971404793918325,
                      'power': 1.0,
                      'weight': 0.0014971404793918317,
                      'mx': -1.0572776907603549e-07,
                      'my': 2.9744914474851767e-08},
           'mangin': {'flux': 0.8050963689914901,
                      'power': 0.9172570584232536,
                      'weight': 0.6700387118690301,
                      'mx': 0.0009233218285371362,
                      'my': -0.001062181502466623},
           'gold_0.45': {'flux': 0.43100828291699117,
                         'power': 1.0,
                         'weight': 0.4310082829169912,
                         'mx': 0.00021028793344087554,
                         'my': -0.00014317167474970258},
           'gold_0.7': {'flux': 0.959456270062545,
                        'power': 1.0,
                        'weight': 0.9594562700625453,
                        'mx': 0.00046684748658547563,
                        'my': -0.00031311588139731965},
           'splitter_w': {'flux': 0.04112501961569343,
                          'power': 1.0,
                          'weight': 0.04112501961569344,
                          'mx': -5.953709422099655e-06,
                          'my': -0.2548084556637324},
           'al': {'flux': 0.9154468327899591,
                  'power': 1.0,
                  'weight': 0.9154468327899592,
                  'mx': -0.00023881949409116344,
                  'my': 0.00015856453329935258},
           'al_disp': {'flux': 0.8695285017498849,
                       'power': 1.0,
                       'weight': 0.8695285017498854,
                       'mx': -0.00022684042142202498,
                       'my': 0.00015061101941506083}},
 'design': {'thickness': 0.11178287118673325},
 'jones': {'tilted': {'diattenuation': [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.001936913, 0.000643134, 0.000643194,
                                         0.001936913, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.003981799,
                                         0.002812892, 0.001675308, 0.000556439,
                                         0.000556499, 0.001675367, 0.002812833,
                                         0.003981739, 0.0, 0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.004465997,
                                         0.003423125, 0.002418727, 0.001441031,
                                         0.000478595, 0.000478595, 0.001440972,
                                         0.002418727, 0.003423065, 0.004465997,
                                         0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.004735291, 0.003804236,
                                         0.002916634, 0.002061308, 0.001228154,
                                         0.000407964, 0.000407964, 0.001228094,
                                         0.002061248, 0.002916814, 0.003804355,
                                         0.00473535, 0.0, 0.0],
                                        [0.0, 0.004808635, 0.003979653,
                                         0.003197461, 0.002451807, 0.001732856,
                                         0.001032591, 0.000342965, 0.000342965,
                                         0.001032591, 0.001732796, 0.002451867,
                                         0.003197461, 0.003979712, 0.004808575,
                                         0.0],
                                        [0.0, 0.003963173, 0.003279,
                                         0.002634555, 0.002019673, 0.001427263,
                                         0.000850528, 0.000282526, 0.000282466,
                                         0.000850469, 0.001427263, 0.002019613,
                                         0.002634495, 0.00327894, 0.003963173,
                                         0.0],
                                        [0.00376162, 0.003171622, 0.002622754,
                                         0.00210604, 0.001613885, 0.001140207,
                                         0.000679135, 0.000225604, 0.000225544,
                                         0.000679135, 0.001140207, 0.001613766,
                                         0.002106099, 0.002622754, 0.003171682,
                                         0.00376162],
                                        [0.002878041, 0.002422959, 0.002000659,
                                         0.001604408, 0.001228631, 0.000867397,
                                         0.000516564, 0.000171542, 0.000171542,
                                         0.000516385, 0.000867397, 0.001228571,
                                         0.001604348, 0.002000481, 0.002422899,
                                         0.002878041],
                                        [0.002034396, 0.001706242, 0.00140506,
                                         0.001123995, 0.000858635, 0.000605583,
                                         0.000360101, 0.000119567, 0.000119567,
                                         0.000360042, 0.000605643, 0.000858635,
                                         0.001123756, 0.001405, 0.001706361,
                                         0.002034396],
                                        [0.001219571, 0.001013577, 0.000828415,
                                         0.000658572, 0.000500828, 0.000351518,
                                         0.000208616, 6.9141e-05, 6.9141e-05,
                                         0.000208557, 0.000351518, 0.000500887,
                                         0.000658512, 0.000828534, 0.001013577,
                                         0.001219571],
                                        [0.0, 0.000338316, 0.000266194,
                                         0.000203729, 0.000150502, 0.000103235,
                                         6.038e-05, 1.9908e-05, 1.9908e-05,
                                         6.026e-05, 0.000103235, 0.000150561,
                                         0.000204027, 0.000266015, 0.000338316,
                                         0.0],
                                        [0.0, 0.000326634, 0.000288844,
                                         0.0002442, 0.000194907, 0.00014174,
                                         8.5771e-05, 2.8789e-05, 2.867e-05,
                                         8.5711e-05, 0.000141621, 0.000194907,
                                         0.000244319, 0.000288904, 0.000326812,
                                         0.0],
                                        [0.0, 0.0, 0.000840098, 0.000690162,
                                         0.000538081, 0.000385016, 0.000231147,
                                         7.7307e-05, 7.7188e-05, 0.000231028,
                                         0.000385016, 0.000538081, 0.000690281,
                                         0.000840217, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.001137287,
                                         0.000882655, 0.000629842, 0.000377327,
                                         0.000125885, 0.000125825, 0.000377268,
                                         0.000629723, 0.000882655, 0.001137108,
                                         0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.001230955,
                                         0.000876874, 0.000525326, 0.00017488,
                                         0.00017494, 0.000525326, 0.000876993,
                                         0.001231015, 0.0, 0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.000675678, 0.000224471, 0.000224412,
                                         0.000675678, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.0]],
                      'retardance': [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.008737855, 0.003456319, 0.003456328,
                                      0.008737894, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.018116673,
                                      0.012888923, 0.007786165, 0.002936688,
                                      0.002936651, 0.007786209, 0.012889027,
                                      0.018116776, 0.0, 0.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.020986376, 0.016183516,
                                      0.011503931, 0.006924065, 0.002515072,
                                      0.002515117, 0.006924088, 0.011503939,
                                      0.016183516, 0.020986479, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.023041522, 0.018638842,
                                      0.014372425, 0.010210709, 0.006130166,
                                      0.002165003, 0.002165019, 0.006130143,
                                      0.010210724, 0.014372359, 0.018638911,
                                      0.023041522, 0.0, 0.0],
                                     [0.0, 0.02431496, 0.020291712,
                                      0.016417161, 0.012659295, 0.008990533,
                                      0.00538864, 0.001865663, 0.001865708,
                                      0.005388559, 0.008990548, 0.012659304,
                                      0.016417235, 0.020291669, 0.024315078,
                                      0.0],
                                     [0.0, 0.021166869, 0.017668545,
                                      0.01429712, 0.011024871, 0.007828358,
                                      0.004687087, 0.001601683, 0.001601661,
                                      0.004687064, 0.00782841, 0.011024998,
                                      0.014296995, 0.017668605, 0.021166869,
                                      0.0],
                                     [0.021271851, 0.018142901, 0.01514695,
                                      0.012258231, 0.009453315, 0.006711818,
                                      0.004016198, 0.001361682, 0.00136162,
                                      0.004016154, 0.00671184, 0.009453383,
                                      0.012258216, 0.015146935, 0.018142872,
                                      0.021271851],
                                     [0.017837694, 0.015216353, 0.012705589,
                                      0.010283481, 0.007930896, 0.005630946,
                                      0.003368582, 0.001137906, 0.001137965,
                                      0.003368493, 0.005630849, 0.007930866,
                                      0.010283517, 0.012705723, 0.015216338,
                                      0.017837694],
                                     [0.01449382, 0.012365342, 0.010325632,
                                      0.00835791, 0.006446249, 0.004577169,
                                      0.002738471, 0.000925764, 0.000925728,
                                      0.002738483, 0.004577139, 0.006446249,
                                      0.008357814, 0.010325813, 0.012365306,
                                      0.01449382],
                                     [0.011215436, 0.009568488, 0.007990743,
                                      0.006468618, 0.004989474, 0.003543353,
                                      0.002121311, 0.000722733, 0.000722688,
                                      0.002121363, 0.003543368, 0.004989496,
                                      0.006468517, 0.007990736, 0.009568577,
                                      0.011215436],
                                     [0.0, 0.006808396, 0.005685851,
                                      0.004602977, 0.003551539, 0.002523941,
                                      0.001514795, 0.000531091, 0.00053108,
                                      0.001514795, 0.002523863, 0.00355155,
                                      0.0046032, 0.005685905, 0.006808337,
                                      0.0],
                                     [0.0, 0.004068559, 0.003398416,
                                      0.002752662, 0.002126801, 0.001516796,
                                      0.000921528, 0.000364188, 0.000364217,
                                      0.000921524, 0.00151684, 0.002126834,
                                      0.002752714, 0.003398386, 0.004068618,
                                      0.0],
                                     [0.0, 0.0, 0.001132632, 0.000929218,
                                      0.000735006, 0.000551987, 0.000387968,
                                      0.000272746, 0.000272742, 0.00038799,
                                      0.000551927, 0.000735021, 0.000929213,
                                      0.001132699, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.001030746, 0.00082243,
                                      0.000625785, 0.000451689, 0.000332869,
                                      0.000332873, 0.000451659, 0.000625945,
                                      0.000822445, 0.001030855, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.002246068,
                                      0.001618727, 0.001016774, 0.000498708,
                                      0.000498708, 0.001016908, 0.001618897,
                                      0.002246196, 0.0, 0.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.001638219, 0.000705579, 0.0007056,
                                      0.00163814, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.0]]},
           'stack8': {'diattenuation': [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.063402955, 0.021135507, 0.021135507,
                                         0.063402955, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.126993903,
                                         0.090614259, 0.054333022, 0.018105358,
                                         0.018105358, 0.054333022, 0.090614259,
                                         0.126993903, 0.0, 0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.137496087,
                                         0.106645337, 0.076025468, 0.04555787,
                                         0.015176636, 0.015176636, 0.04555787,
                                         0.076025468, 0.106645337, 0.137496087,
                                         0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.137496087, 0.111939177,
                                         0.086736393, 0.061787129, 0.037007538,
                                         0.012325277, 0.012325277, 0.037007538,
                                         0.061787129, 0.086736393, 0.111939177,
                                         0.137496087, 0.0, 0.0],
                                        [0.0, 0.126993903, 0.106645337,
                                         0.086736393, 0.067155493, 0.047810962,
                                         0.028625568, 0.009531874, 0.009531874,
                                         0.028625568, 0.047810962, 0.067155493,
                                         0.086736393, 0.106645337, 0.126993903,
                                         0.0],
                                        [0.0, 0.090614259, 0.076025468,
                                         0.061787129, 0.047810962, 0.034024244,
                                         0.020365416, 0.006780427, 0.006780427,
                                         0.020365416, 0.034024244, 0.047810962,
                                         0.061787129, 0.076025468, 0.090614259,
                                         0.0],
                                        [0.063402955, 0.054333022, 0.04555787,
                                         0.037007538, 0.028625568, 0.020365416,
                                         0.012187602, 0.004057357, 0.004057357,
                                         0.012187602, 0.020365416, 0.028625568,
                                         0.037007538, 0.04555787, 0.054333022,
                                         0.063402955],
                                        [0.021135507, 0.018105358, 0.015176636,
                                         0.012325277, 0.009531874, 0.006780427,
                                         0.004057357, 0.001350703, 0.001350703,
                                         0.004057357, 0.006780427, 0.009531874,
                                         0.012325277, 0.015176636, 0.018105358,
                                         0.021135507],
                                        [0.021135507, 0.018105358, 0.015176636,
                                         0.012325277, 0.009531874, 0.006780427,
                                         0.004057357, 0.001350703, 0.001350703,
                                         0.004057357, 0.006780427, 0.009531874,
                                         0.012325277, 0.015176636, 0.018105358,
                                         0.021135507],
                                        [0.063402955, 0.054333022, 0.04555787,
                                         0.037007538, 0.028625568, 0.020365416,
                                         0.012187602, 0.004057357, 0.004057357,
                                         0.012187602, 0.020365416, 0.028625568,
                                         0.037007538, 0.04555787, 0.054333022,
                                         0.063402955],
                                        [0.0, 0.090614259, 0.076025468,
                                         0.061787129, 0.047810962, 0.034024244,
                                         0.020365416, 0.006780427, 0.006780427,
                                         0.020365416, 0.034024244, 0.047810962,
                                         0.061787129, 0.076025468, 0.090614259,
                                         0.0],
                                        [0.0, 0.126993903, 0.106645337,
                                         0.086736393, 0.067155493, 0.047810962,
                                         0.028625568, 0.009531874, 0.009531874,
                                         0.028625568, 0.047810962, 0.067155493,
                                         0.086736393, 0.106645337, 0.126993903,
                                         0.0],
                                        [0.0, 0.0, 0.137496087, 0.111939177,
                                         0.086736393, 0.061787129, 0.037007538,
                                         0.012325277, 0.012325277, 0.037007538,
                                         0.061787129, 0.086736393, 0.111939177,
                                         0.137496087, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.137496087,
                                         0.106645337, 0.076025468, 0.04555787,
                                         0.015176636, 0.015176636, 0.04555787,
                                         0.076025468, 0.106645337, 0.137496087,
                                         0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.126993903,
                                         0.090614259, 0.054333022, 0.018105358,
                                         0.018105358, 0.054333022, 0.090614259,
                                         0.126993903, 0.0, 0.0, 0.0, 0.0],
                                        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.063402955, 0.021135507, 0.021135507,
                                         0.063402955, 0.0, 0.0, 0.0, 0.0, 0.0,
                                         0.0]],
                      'retardance': [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.009039022, 0.003164942, 0.003164942,
                                      0.009039022, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.013864447,
                                      0.010651265, 0.006761165, 0.002644976,
                                      0.002644976, 0.006761165, 0.010651265,
                                      0.013864447, 0.0, 0.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.011209585, 0.009885975,
                                      0.007720662, 0.005000454, 0.002181157,
                                      0.002181157, 0.005000454, 0.007720662,
                                      0.009885975, 0.011209585, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.007419253, 0.007626258,
                                      0.006895024, 0.005471597, 0.003602673,
                                      0.001678108, 0.001678108, 0.003602673,
                                      0.005471597, 0.006895024, 0.007626258,
                                      0.007419253, 0.0, 0.0],
                                     [0.0, 0.003354212, 0.004691501,
                                      0.005048974, 0.004664012, 0.003743257,
                                      0.002481182, 0.001165725, 0.001165725,
                                      0.002481182, 0.003743257, 0.004664012,
                                      0.005048974, 0.004691501, 0.003354212,
                                      0.0],
                                     [0.0, 0.00194918, 0.002945436,
                                      0.003238284, 0.00300938, 0.002413611,
                                      0.001586378, 0.000704214, 0.000704214,
                                      0.001586378, 0.002413611, 0.00300938,
                                      0.003238284, 0.002945436, 0.00194918,
                                      0.0],
                                     [0.000877731, 0.00146779, 0.001942118,
                                      0.002011703, 0.001790941, 0.001386617,
                                      0.000879223, 0.000343807, 0.000343807,
                                      0.000879223, 0.001386617, 0.001790941,
                                      0.002011703, 0.001942118, 0.00146779,
                                      0.000877731],
                                     [0.000848418, 0.001389748, 0.001496366,
                                      0.001310587, 0.000983546, 0.000630363,
                                      0.000326313, 9.833e-05, 9.833e-05,
                                      0.000326313, 0.000630363, 0.000983546,
                                      0.001310587, 0.001496366, 0.001389748,
                                      0.000848418],
                                     [0.000848418, 0.001389748, 0.001496366,
                                      0.001310587, 0.000983546, 0.000630363,
                                      0.000326313, 9.833e-05, 9.833e-05,
                                      0.000326313, 0.000630363, 0.000983546,
                                      0.001310587, 0.001496366, 0.001389748,
                                      0.000848418],
                                     [0.000877731, 0.00146779, 0.001942118,
                                      0.002011703, 0.001790941, 0.001386617,
                                      0.000879223, 0.000343807, 0.000343807,
                                      0.000879223, 0.001386617, 0.001790941,
                                      0.002011703, 0.001942118, 0.00146779,
                                      0.000877731],
                                     [0.0, 0.00194918, 0.002945436,
                                      0.003238284, 0.00300938, 0.002413611,
                                      0.001586378, 0.000704214, 0.000704214,
                                      0.001586378, 0.002413611, 0.00300938,
                                      0.003238284, 0.002945436, 0.00194918,
                                      0.0],
                                     [0.0, 0.003354212, 0.004691501,
                                      0.005048974, 0.004664012, 0.003743257,
                                      0.002481182, 0.001165725, 0.001165725,
                                      0.002481182, 0.003743257, 0.004664012,
                                      0.005048974, 0.004691501, 0.003354212,
                                      0.0],
                                     [0.0, 0.0, 0.007419253, 0.007626258,
                                      0.006895024, 0.005471597, 0.003602673,
                                      0.001678108, 0.001678108, 0.003602673,
                                      0.005471597, 0.006895024, 0.007626258,
                                      0.007419253, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.011209585, 0.009885975,
                                      0.007720662, 0.005000454, 0.002181157,
                                      0.002181157, 0.005000454, 0.007720662,
                                      0.009885975, 0.011209585, 0.0, 0.0,
                                      0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.013864447,
                                      0.010651265, 0.006761165, 0.002644976,
                                      0.002644976, 0.006761165, 0.010651265,
                                      0.013864447, 0.0, 0.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.009039022, 0.003164942, 0.003164942,
                                      0.009039022, 0.0, 0.0, 0.0, 0.0, 0.0,
                                      0.0]]}}}


def splitter_scene(rt, mode):
    """tests/test_coatings.py:779-800's beamsplitter: a plane of n = 1.5168
    under a 40 nm silver film, turned 45 degrees about x, in FRESNEL_W
    (``mode`` 'weighted') or FRESNEL, and a sensor behind it."""
    from raytracetorch_tpu_torch.constants import PhysKind
    kind = PhysKind.FRESNEL_W if mode == 'weighted' else PhysKind.FRESNEL
    return rt.SequentialScene([
        rt.ElementCustom(rt.shapes.plane, 1, kind, ph=(1.5168, 1.0),
                         coating=[('Ag', SPLITTER_AG)], coating_grad=True,
                         rotation=[math.pi / 4, 0.0, 0.0], name='bs'),
        rt.SensorElement(radius=100.0, translation=[0, 0, 20.0],
                         name='sensor')])


def metal_mirror_scene(rt, dispersive=False):
    """tests/test_coatings.py:362-385's aluminium parabola (``dispersive``:
    :573-595's, on its knots) and its sensor, as a SequentialScene."""
    return rt.SequentialScene([
        rt.ParabolicMirror(c1=-0.001, d=30.0, translation=[0, 0, 50.0],
                           metal='Al', metal_dispersion=dispersive,
                           name='m'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 0.5], name='s')])


def field_coat_scene(rt, name):
    """The scene of a section 18 case, a SequentialScene."""
    if name.startswith('coated'):
        return coated_scene(rt, 'weighted' if name == 'coated_w' else True)
    if name in STRESS_CASES:
        return stress_scene(rt, rt, name)
    if name.startswith('splitter'):
        return splitter_scene(rt, 'weighted' if name == 'splitter_w'
                              else True)
    return metal_mirror_scene(rt, name == 'al_disp')


# name: (reference disk radius, z, wavelength, E0); gold's rays carry its
# two wavelengths
FIELD_COAT_RAYS = {
    'coated_w': (4.0, -10.0, 0.0, None), 'coated_mc': (4.0, -10.0, 0.0, None),
    'stack8': (4.0, -10.0, 0.0, [[math.sqrt(0.5), math.sqrt(0.5), 0.0]]),
    'mangin': (10.0, -3.0, 0.0, [[0.0, 1.0, 0.0]]),
    'gold': (15.0, -3.0, 0.0, [[1.0, 0.0, 0.0]]),
    'splitter_w': (0.5, -5.0, 0.0, [[1.0, 0.0, 0.0]]),
    'splitter_mc': (0.5, -5.0, 0.0, [[1.0, 0.0, 0.0]]),
    'al': (1.0, 1.0, 0.0, [[1.0, 0.0, 0.0]]),
    'al_disp': (1.0, 1.0, 0.80, [[0.6, 0.8, 0.0]]),
}
# the coated singlet's launch fields
FIELD_COAT_E0 = {'s': [[1.0, 0.0, 0.0]], 'p': [[0.0, 1.0, 0.0]],
                 'circular': [[complex(math.sqrt(0.5)),
                               complex(0.0, math.sqrt(0.5)), 0.0]]}


def field_coat_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, E0, uniforms) of a section 18 case on seeded
    rays: the coated singlet on the bench rays with circular E0
    ('coated_w') or s ('coated_mc', its FRESNEL draws from ``seed``); the
    stress rows on section 12's bundles (gold's two, registered on the
    scene); the beamsplitter on a 1 mm beam; the mirrors on a 2 mm one."""
    import numpy as np
    from raytracetorch_tpu_torch.rays.draws import row_uniforms
    gen = torch.Generator(device=device).manual_seed(seed)
    sc = field_coat_scene(rt, name)
    if name.startswith('coated'):
        rays = sample_rays(rt, torch, n, device, seed)
        E0 = (np.array([[1.0, 1.0j, 0.0]]) / np.sqrt(2) if name == 'coated_w'
              else FIELD_COAT_E0['s'])
    elif name == 'gold':
        for b, k in stress_bundles(rt, name, n):
            sc.add_bundle(b, k)
        rays = sc.sample_rays(gen, device)
        E0 = FIELD_COAT_RAYS[name][3]
    elif name in STRESS_CASES:
        rays = rt.sample_bundles(gen, stress_bundles(rt, name, n), device)
        E0 = FIELD_COAT_RAYS[name][3]
    else:
        radius, z, wl, E0 = FIELD_COAT_RAYS[name]
        rays = rt.CollimatedDisk.make(
            radius=radius, translation=[0.0, 0.0, z],
            wavelength=wl).sample(gen, n, device)
    uniforms = None
    if any(m.ph == 4 for m in sc.static_meta()):
        uniforms = row_uniforms(sc.static_meta(), n, torch.Generator(
            device=device).manual_seed(seed + 1))
    return sc, sc.init_params(device), rays, E0, uniforms


def field_coat_ref_rays(rt, name, n, device, wavelength=None):
    """The reference's CollimatedDisk rays of PRNGKey(0) of a section 18
    path (``wavelength``: gold's)."""
    radius, z, wl, _ = FIELD_COAT_RAYS[name]
    return ref_disk(rt, n, radius, z, device,
                    wl if wavelength is None else wavelength)


def field_coat_uniforms(torch, sc, n, device):
    """The JAX package's FRESNEL uniforms of PRNGKey(0) for ``sc`` (None
    without a FRESNEL row)."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    if not any(m.ph == 4 for m in sc.static_meta()):
        return None
    return rp.fresnel_uniforms(rp.prng_key(0), sc.static_meta(), n, device)


def field_coat_stats(torch, out, sens, aux):
    """A path's means: the flux intensity * |E|^2, |E|^2, the sensor's
    weight and its first moments (per ray launched)."""
    n = out.n
    m = sens.moments[0].double().sum(0)
    return dict(flux=float((out.intensity * aux['field_power']).double()
                           .mean()),
                power=float(aux['field_power'].double().mean()),
                weight=float(m[0]) / n, mx=float(m[1]) / n,
                my=float(m[2]) / n)


def check_coat_ref(stats, ref, what, flips=0, n=N_MAIN, radius=0.0):
    """A path's stats against the JAX package's: the means within
    FIELD_COAT_REF_ATOL (plus 2 flips / n of a FRESNEL path), the sensor's
    weight within FIELD_COAT_MOMENT_RTOL, its first moments within that
    plus FIELD_COAT_RIM_RAYS rays at the beam's ``radius`` / n."""
    slack = 2.0 * flips / n
    for k in ('flux', 'power'):
        check(abs(stats[k] - ref[k]) <= FIELD_COAT_REF_ATOL + slack,
              f'{what} {k} {stats[k]} vs JAX {ref[k]}')
    scale = max(abs(ref['weight']), abs(ref['mx']), abs(ref['my']), 1e-3)
    for k in ('weight', 'mx', 'my'):
        rim = FIELD_COAT_RIM_RAYS * radius / n if k != 'weight' else 0.0
        check(abs(stats[k] - ref[k])
              <= FIELD_COAT_MOMENT_RTOL * scale + slack * scale + rim,
              f'{what} {k} {stats[k]} vs JAX {ref[k]}')


def splitter_rt(torch):
    """The silver film's analytic (Rs, Ts) at 45 degrees in float64 (the
    characteristic-matrix formula, utils/coatings.py::coating_rt)."""
    from raytracetorch_tpu_torch.utils import coatings
    n, k = coatings.METALS['AG']
    r, t = coatings.coating_rt(
        [n], [torch.tensor(SPLITTER_AG, dtype=torch.float64)], 1.0, 1.5168,
        torch.tensor(math.sqrt(0.5), dtype=torch.float64), 0.5876, pol='s',
        k_stack=[k])
    return float(r), float(t)


def aluminium_r(torch, wavelength):
    """Bare aluminium's normal-incidence R at ``wavelength`` (0: the fixed
    d-line index; else on its knots)."""
    from raytracetorch_tpu_torch.utils import coatings
    if wavelength:
        n_m, k_m = (float(v) for v in coatings.metal_nk_at(
            *coatings.METAL_NK['AL'],
            torch.tensor(wavelength, dtype=torch.float64)))
    else:
        n_m, k_m = coatings.METALS['AL']
    return ((n_m - 1) ** 2 + k_m ** 2) / ((n_m + 1) ** 2 + k_m ** 2)


def field_coat_paths(rt, torch, dev, reset_counters, counters, only):
    """The section 18 paths through simulate_fused at N_MAIN on the
    reference's rays, each launch counted: the coated singlet (FRESNEL_W and
    FRESNEL) with s, p and circular E0, the stress rows, the beamsplitter and
    the mirrors, against the JAX package's means and the analytic anchors ->
    dict; raises on a breach."""
    ref = FIELD_COAT_REF['paths']
    res = {}
    for name in ('coated_w', 'coated_mc'):
        sc = field_coat_scene(rt, name)
        params = sc.init_params(dev)
        rays = field_coat_ref_rays(rt, name, N_MAIN, dev)
        u = field_coat_uniforms(torch, sc, N_MAIN, dev)
        for label, E0 in FIELD_COAT_E0.items():
            reset_counters()
            with torch.no_grad():
                out, sens, aux = sc.simulate_fused(
                    params, rays, track_field=True, E0=E0, uniforms=u)
            torch.cuda.synchronize()
            fl = counters()
            check(only(fl, trace_seq_fwd=1, field=1),
                  f'{name} {label} launched {fl}')
            st = field_coat_stats(torch, out, sens, aux)
            check_coat_ref(st, ref[name][label], f'{name} {label}',
                           FRESNEL_FLIPS if u is not None else 0,
                           radius=FIELD_COAT_RAYS[name][0])
            res[f'{name}_{label}'] = dict(st, launches=fl)
    for name in ('stack8', 'mangin', 'gold_0.45', 'gold_0.7'):
        base = name.split('_')[0]
        sc = field_coat_scene(rt, base)
        wl = float(name.split('_')[1]) if base == 'gold' else None
        rays = field_coat_ref_rays(rt, base, N_MAIN, dev, wl)
        E0 = FIELD_COAT_RAYS[base][3]
        reset_counters()
        with torch.no_grad():
            out, sens, aux = sc.simulate_fused(sc.init_params(dev), rays,
                                               track_field=True, E0=E0)
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, trace_seq_fwd=1, field=1), f'{name} launched {fl}')
        st = field_coat_stats(torch, out, sens, aux)
        check_coat_ref(st, ref[name], name, radius=FIELD_COAT_RAYS[base][0])
        res[name] = dict(st, launches=fl)
    # the beamsplitter: T_s of the film (FRESNEL_W) and its draw (FRESNEL)
    rs, ts = splitter_rt(torch)
    for name in ('splitter_w', 'splitter_mc'):
        sc = field_coat_scene(rt, name)
        rays = field_coat_ref_rays(rt, name, N_MAIN, dev)
        u = field_coat_uniforms(torch, sc, N_MAIN, dev)
        with torch.no_grad():
            out, sens, aux = sc.simulate_fused(
                sc.init_params(dev), rays, track_field=True,
                E0=FIELD_COAT_RAYS[name][3], uniforms=u)
        through = out.dz > 0.5      # a reflected ray leaves along +-y
        want = ts if name == 'splitter_w' else ts / (1.0 - rs)
        st = field_coat_stats(torch, out, sens, aux)
        st.update(ts=ts, rs=rs,
                  weight_err=float((out.intensity[through] - want).abs()
                                   .max()) / want,
                  power_err=float((aux['field_power'] - 1.0).abs().max()),
                  reflected=float((~through).double().mean()))
        check(st['weight_err'] <= 1e-4 and st['power_err'] <= 1e-4,
              f'{name}: {st} (T_s {ts})')
        if name == 'splitter_mc':
            sigma = math.sqrt(rs * (1 - rs) / rays.n)
            check(abs(st['reflected'] - rs) <= FRESNEL_NS_SIGMAS * sigma,
                  f'{name}: reflected share {st["reflected"]} vs R_s {rs}')
        if name == 'splitter_w':
            check_coat_ref(st, ref[name], name,
                           radius=FIELD_COAT_RAYS[name][0])
        res[name] = st
    # the aluminium mirrors: intensity * |E|^2 = R, |E|^2 = 1
    for name in ('al', 'al_disp'):
        sc = field_coat_scene(rt, name)
        rays = field_coat_ref_rays(rt, name, N_MAIN, dev)
        with torch.no_grad():
            out, sens, aux = sc.simulate_fused(
                sc.init_params(dev), rays, track_field=True,
                E0=FIELD_COAT_RAYS[name][3])
        alive = out.intensity > 0
        r_al = aluminium_r(torch, FIELD_COAT_RAYS[name][2])
        st = field_coat_stats(torch, out, sens, aux)
        st.update(r=r_al, flux_alive=float(
            (out.intensity * aux['field_power'])[alive].double().mean()),
            power_err=float((aux['field_power'][alive] - 1.0).abs().max()))
        check(abs(st['flux_alive'] - r_al) <= 2e-3 * r_al
              and st['power_err'] <= 1e-4, f'{name}: {st}')
        check_coat_ref(st, ref[name], name, radius=FIELD_COAT_RAYS[name][0])
        res[name] = st
    return res


def field_coat_grads(rt, torch, dev, reset_counters, counters, only):
    """Grad steps through simulate_fused (K1 + K2 once each) against the
    eager trace's on the card, at N_MAIN rays: the coated FRESNEL_W
    singlet's flux (intensity * |E|^2 on the sensor) in c1, c2, the coat
    thickness and E0; stack8's in its coat thicknesses (its eager trace
    FIELD_COAT_CHUNK rays at a time, the flux and the gradients summed)
    -> dict; raises on a breach (section 17's tolerances: the flux within
    1e-5, E0's and the thicknesses' gradients within rtol 1e-3, a
    curvature's, a cancelling sum, within 3e-2)."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    res = {}
    for name, leaves in (('coated_w', ('c1', 'c2', 'coat_d')),
                         ('stack8', ('coat_d',))):
        sc = field_coat_scene(rt, name)
        params = sc.init_params(dev)
        rays = field_coat_ref_rays(rt, name, N_MAIN, dev)
        grads = {}
        for sim in ('simulate_fused', 'simulate'):
            p = {k: dict(v) for k, v in params.items()}
            for k in leaves:
                p['lens'][k] = params['lens'][k].clone().requires_grad_(True)
            E0 = torch.tensor([[0.8, 0.6, 0.0]], device=dev,
                              requires_grad=True)
            wrt = [p['lens'][k] for k in leaves] + [E0]
            reset_counters()
            loss, g = 0.0, [torch.zeros_like(w) for w in wrt]
            for sl in ray_chunks(rays.n, None if sim == 'simulate_fused'
                                 else FIELD_COAT_CHUNK.get(name)):
                _, sens, _ = getattr(sc, sim)(p, ray_slice(ft, rays, sl),
                                              track_field=True, E0=E0)
                part = sens.total_weight(0)[0] / rays.n
                g = [a + b for a, b in zip(g, torch.autograd.grad(part, wrt))]
                loss += float(part.detach())
            torch.cuda.synchronize()
            grads[sim] = dict(loss=loss, launches=counters(),
                              **{k: g[j].flatten().tolist()
                                 for j, k in enumerate(leaves)},
                              E0=g[-1].flatten().tolist())
        f, e = grads['simulate_fused'], grads['simulate']
        check(only(f['launches'], trace_seq_fwd=1, trace_seq_bwd=1, field=2),
              f'{name} grad step launched {f["launches"]}')
        check(abs(f['loss'] - e['loss']) <= 1e-5 * abs(e['loss']),
              f'{name} flux {f["loss"]} vs eager {e["loss"]}')
        for k in leaves + ('E0',):
            tol = 3e-2 if k in ('c1', 'c2') else 1e-3
            scale = max(abs(x) for x in e[k])
            check(all(abs(a - b) <= tol * abs(b) + 1e-3 * tol * scale
                      for a, b in zip(f[k], e[k])),
                  f'{name} {k} gradient {f[k]} vs eager {e[k]}')
        res[name] = grads
        torch.cuda.empty_cache()
    return res


def field_coat_design(rt, torch, dev, reset_counters=None, counters=None,
                      only=None, steps=FIELD_COAT_DESIGN_STEPS):
    """The coat thickness of the coated FRESNEL_W singlet by ``steps`` Adam
    steps (lr FIELD_COAT_DESIGN_LR, from FIELD_COAT_DESIGN_START) that
    maximize the x-polarized flux intensity * |E|^2 on its sensor, on the
    reference's FIELD_COAT_DESIGN_RAYS rays, through simulate_fused (K1 and
    K2 once a step) -> dict; raises unless it lands within
    FIELD_COAT_DESIGN_ATOL of the JAX package's thickness and raises the
    flux."""
    sc = field_coat_scene(rt, 'coated_w')
    params = sc.init_params(dev)
    rays = field_coat_ref_rays(rt, 'coated_w', FIELD_COAT_DESIGN_RAYS, dev)
    d = torch.full_like(params['lens']['coat_d'], FIELD_COAT_DESIGN_START)
    d.requires_grad_(True)
    opt = torch.optim.Adam([d], lr=FIELD_COAT_DESIGN_LR)
    if reset_counters is not None:
        reset_counters()
    fluxes = []
    for _ in range(steps):
        p = {k: dict(v) for k, v in params.items()}
        p['lens']['coat_d'] = d
        _, sens, _ = sc.simulate_fused(p, rays, track_field=True,
                                       E0=FIELD_COAT_E0['s'])
        flux = sens.total_weight(0)[0] / rays.n
        opt.zero_grad()
        (-flux).backward()
        opt.step()
        fluxes.append(float(flux))
    torch.cuda.synchronize()
    res = dict(thickness=float(d.detach()[0]), flux_first=fluxes[0],
               flux_last=fluxes[-1],
               jax=FIELD_COAT_REF['design']['thickness'])
    if counters is not None:
        res['launches'] = fl = counters()
        check(only(fl, trace_seq_fwd=steps, trace_seq_bwd=steps,
                   field=2 * steps), f'the coat design launched {fl}')
    res['off'] = abs(res['thickness'] - res['jax'])
    check(res['off'] <= FIELD_COAT_DESIGN_ATOL
          and res['flux_last'] > res['flux_first'],
          f'the coat design: {res}')
    return res


def jones_scene(rt, name):
    """The Jones pupil's scenes: the coated FRESNEL_W singlet tilted 0.3
    rad about x ('tilted') and stack8."""
    if name == 'tilted':
        return rt.SequentialScene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           fresnel='weighted', coating=[(COAT_NC, COAT_QW)],
                           rotation=[0.3, 0.0, 0.0], name='lens'),
            rt.SensorElement(radius=20.0, translation=[0, 0, 19.0],
                             name='sensor')])
    return stress_scene(rt, rt, 'stack8')


def field_coat_jones(rt, torch, dev):
    """jones_pupil (two eager traces) at JONES_N^2 rays against the same
    grid traced by simulate_fused (K1 twice), and its diattenuation and
    retardance maps at JONES_REF_N^2 against the JAX package's -> dict;
    raises on a breach."""
    from raytracetorch_tpu_torch.utils import polarization as pol
    res = {}
    for name in ('tilted', 'stack8'):
        sc = jones_scene(rt, name)
        params = sc.init_params(dev)
        t0 = time.perf_counter()
        jp = pol.jones_pupil(sc, params, 3.0, n=JONES_N)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        rays, xs, inside = pol.pupil_rays(3.0, JONES_N, device=dev)
        cols = []
        with torch.no_grad():
            for E0 in ([[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]):
                out, _, aux = sc.simulate_fused(params, rays,
                                                track_field=True, E0=E0)
                cols.append((out, aux['field']))
        fp = pol.pupil_of(cols, inside, xs)
        err_map = torch.maximum((fp.j_re - jp.j_re).abs().amax((-2, -1)),
                                (fp.j_im - jp.j_im).abs().amax((-2, -1)))
        err = float(err_map.max())
        worst = divmod(int(err_map.argmax()), JONES_N)
        beyond = int((err_map > FIELD_TOL).sum())
        allowed = math.ceil(JONES_FLIPS_PER_MILLION * JONES_N ** 2 / 1e6)
        masks_equal = bool(torch.equal(fp.mask, jp.mask))
        small = pol.jones_pupil(sc, params, 3.0, n=JONES_REF_N)
        ref = FIELD_COAT_REF['jones'][name]
        maps = {}
        for k in ('diattenuation', 'retardance'):
            got = getattr(small, k).cpu().double()
            want = torch.tensor(ref[k], dtype=torch.float64)
            maps[k] = dict(max_abs_err=float((got - want).abs().max()),
                           max=float(want.abs().max()))
        res[name] = dict(n=JONES_N, samples=int(jp.mask.sum()),
                         vs_fused_max_abs_err=err,
                         worst_at=[float(xs[worst[1]]), float(xs[worst[0]])],
                         beyond_field_tol=beyond, allowed=allowed,
                         masks_equal=masks_equal, eager_s=eager_s, maps=maps,
                         diattenuation_max=float(fp.diattenuation.max()))
        check(masks_equal and err <= JONES_TOL and beyond <= allowed,
              f'Jones pupil {name}: eager vs fused {res[name]}')
        check(all(m['max_abs_err'] <= JONES_MAP_ATOL for m in maps.values()),
              f'Jones pupil {name} maps vs JAX: {maps}')
    return res


def field_coat_row_ops(meta):
    """A row's work under the field with its stack: field_row_ops, plus on
    a coated or metal row one evaluation of its stack a polarization, which
    gives R and T (coat_ops's count) and the amplitudes r and t
    (FIELD_COAT_AMP_OPS more); a metal mirror's transport and its polarized
    R in place of field_row_ops's scaling (a coated Fresnel kind's polarized
    weighing is field_row_ops's pol_r)."""
    from raytracetorch_tpu_torch.core.static_dispatch import field_coat_acts
    ops = field_row_ops(meta)
    if not field_coat_acts(meta):
        return ops
    layer = COAT_ABS_LAYER_OPS if meta.coat_k is not None else COAT_LAYER_OPS
    ops += 2 * (meta.n_coat * layer + COAT_RT_OPS + FIELD_COAT_AMP_OPS
                + (COAT_METAL_OPS if meta.metal else 0))
    if meta.metal:
        ops += (FIELD_OPS['fresnel'] - FIELD_BARE_AMP_OPS - FIELD_OPS['scale']
                + FIELD_OPS['pol_r'])
    return ops


def field_coat_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 18: the polarized field through coated interfaces and metal
    mirrors in K1 and K2 (their instantiation with the field): each against
    its plain version at N_MAIN rays on FIELD_COAT_CASES; the counted paths
    against the JAX package's means and the analytic anchors; grad steps
    and the coat design through K2; the Jones pupil; times, bounds (the
    stacks' work counted) and blocks per SM.  17d holds the SASS of every
    earlier instantiation."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 18a. each kernel against its plain version (branches on FRESNEL rows)
    kern = {}
    for name in FIELD_COAT_CASES:
        kern[name] = field_kernels_vs_plain(
            rt, torch, name, N_MAIN, dev, FIELD_COAT_SEED + 11,
            case=field_coat_case, lens_cases=FIELD_COAT_LENS_CASES,
            flips=math.ceil(FLIPS_PER_MILLION * N_MAIN / 1e6),
            wavelength=True, f64_chunk=FIELD_COAT_F64_CHUNK,
            chunk=FIELD_COAT_CHUNK.get(name))
        torch.cuda.empty_cache()
    emit('field_coat_kernels_vs_plain', n=N_MAIN, **kern)

    # 18b. the counted paths and their anchors, the grad steps, the design
    paths = field_coat_paths(rt, torch, dev, reset_counters, counters, only)
    paths['grads'] = field_coat_grads(rt, torch, dev, reset_counters,
                                      counters, only)
    paths['design'] = field_coat_design(rt, torch, dev, reset_counters,
                                        counters, only)
    emit('field_coat_main', **paths)
    # 18c. the Jones pupil
    jones = field_coat_jones(rt, torch, dev)
    emit('field_coat_jones', **jones)

    # 18d. times at N_MAIN against the plain versions, bounds and blocks
    timing, bounds, occ = {}, {}, {}
    for name in ('coated_w', 'stack8'):
        sc, params, r, E0, u = field_coat_case(rt, torch, name, N_MAIN, dev,
                                               FIELD_COAT_SEED + 7)
        meta, cfg, flat, kinds, maps, field, side = field_inputs(
            rt, torch, sc, params, r, E0, dev)
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 6)
        g_field = [g_rays[0]] * 6
        kfn = (lambda: ft.trace_seq_fwd_cuda(
            flat, kinds, r, cfg, maps, True, fresnel=True, diff=True,
            field=field, **side))
        pfn = (lambda: ft.trace_sequential_fused_plain(
            flat, r, cfg, meta, maps, field=field))
        bk = (lambda: ft.trace_seq_bwd_cuda(
            flat, kinds, r, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps,
            ext=True, fresnel=True, diff=True, field=field, g_field=g_field,
            **side))
        bp = (lambda: ft.trace_seq_bwd_plain(
            flat, r, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps,
            field=field, g_field=g_field))
        cols = len(ft.grad_cols((), True, coat=True, diff=True,
                                freeform=True))
        io = r.n * (36 + 28 + 48) + table_bytes(meta) + grid_bytes(cfg)
        k1_ops = r.n * sum(intersect_ops(m) + apply_ops(m)
                           + field_coat_row_ops(m) for m in meta)
        bounds[f'k1_{name}'] = bound(io, k1_ops)
        bounds[f'k2_{name}'] = bound(io + r.n * (28 + 24)
                                     + len(meta) * cols * 4, 3 * k1_ops)
        for key, kf, pf in ((f'k1_{name}', kfn, pfn),
                            (f'k2_{name}', bk, bp)):
            k_runs = time_ms(torch, kf, warmup=2, reps=10)
            p_runs = time_ms(torch, pf, warmup=1, reps=3)
            timing[key] = dict(kernel_ms=statistics.median(k_runs),
                               plain_ms=statistics.median(p_runs),
                               kernel_runs=k_runs)
        for lib in ('trace_seq_fwd', 'trace_seq_bwd'):
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, ext=True, disp=False,
                fuzzy_words=len(meta), field=True)
    sc = field_coat_scene(rt, 'coated_w')
    params = sc.init_params(dev)
    rays = field_coat_ref_rays(rt, 'coated_w', N_MAIN, dev)
    E0 = FIELD_COAT_E0['circular']

    def step():
        p = {k: dict(v) for k, v in params.items()}
        for k in ('c1', 'c2', 'coat_d'):
            p['lens'][k] = params['lens'][k].clone().requires_grad_(True)
        sc.simulate_fused(p, rays, track_field=True, E0=E0)[1] \
            .total_weight(0)[0].backward()
    for label, fn in (
            ('simulate_fused_coated_w', lambda: sc.simulate_fused(
                params, rays, track_field=True, E0=E0)),
            ('grad_step_fused_coated_w', step)):
        runs = time_ms(torch, fn, warmup=2, reps=10)
        timing[f'{label}_ms'] = statistics.median(runs)
        timing[f'{label}_runs'] = runs
    emit('field_coat_timing', **timing)
    emit('field_coat_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('field_coat_occupancy', blocks_per_sm=occ)
    emit('field_coat_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, jones=jones, timing=timing,
                bounds=bounds)


# ---- Section 19: the polarized field in the non-sequential scene (K5's
# and K6's instantiation with the field) ----
#
# Tolerances, each with its reason: K5 and K6 against their plain versions
# under section 17's and 18's rules (NS_* for the rays and moments, as
# sections 11 and 12 hold K5; FIELD_TOL and FIELD_POWER_TOL for the six
# field streams and |E|^2 of the rays both trace alike; BWD_TOL's rule for
# the ray, table and launch-field cotangents), K6's replay equal to K5 bit
# for bit, rays and field; the grad step's c1 and E0 cotangents, fused
# against eager, within the JAX test's own rtol (tests/test_pallas.py:
# 628-665: 3e-2 for c1, whose per-ray terms cancel, 1e-3 for E0); the
# JAX package's numbers (JAX_PLATFORMS=cpu python tests/field_anchors.py
# --nonseq) on the reference's own rays within FIELD_REF_ATOL of a mean
# where the trace draws nothing (the aluminium mirror against the JAX
# package in float64, as section 18), and where it draws (the Brewster
# plane, the coated singlet: K5 draws Philox, the JAX package its own
# generator) within FIELD_NS_SIGMAS standard errors of the difference of
# two Monte-Carlo means; the Brewster analytics: p transmits with Tp = 1
# within FIELD_NS_TP_ATOL (no p ray reflects), s with Ts = 1 - Rs within
# FIELD_NS_SIGMAS binomial standard errors.
FIELD_NS_SEED = SEED + 2001
FIELD_NS_CASES = ('fold', 'brewster_p', 'brewster_s', 'brewster_45',
                  'jones', 'coated', 'al', 'naive')
FIELD_NS_SIGMAS = 5.0
FIELD_NS_TP_ATOL = 1e-5
# the grad step's gradients, fused against eager, each within
# FIELD_NS_GRAD_RTOL of the eager one (c1) or of |eager| + 1e-3 of the
# largest (E0): an H100 reads them within 5e-7 (PERF.md section 6)
FIELD_NS_GRAD_RTOL = 1e-4
# K6 keeps fused_nonseq.K6_FIELD_CHECKPOINTS bounces under the field: the
# metal light guide's rays (FIELD_NS_GUIDE_BOUNCES) are reversed in
# segments, which no other case reaches
FIELD_NS_SEGMENT_CASES = ('guide',)
FIELD_NS_GUIDE_BOUNCES = 16
FIELD_NS_GUIDE_TILT = 0.7
FIELD_NS_BREWSTER_N = 1.5168
FIELD_NS_QW = 0.5876 / (4 * 1.38)


def field_ns_scene(rt, name):
    """Section 19's Scene of a case, in either package: the mirror fold of
    tests/test_pallas.py:667 ('fold'); the Brewster FRESNEL plane of
    tests/test_polarization.py:207-262 ('brewster_*'); the polarizer and
    quarter-wave plate of tests/test_polarization_optics.py:230 ('jones');
    the coated FRESNEL singlet of tests/test_coatings.py:239 ('coated'); the
    aluminium parabola of :365 ('al', and 'al_disp', its dispersive metal
    of :576); the naive scene ('naive'); a light guide of two flat
    aluminium walls 2 apart, unbounded, and a sensor ('guide'), between
    which every ray lives FIELD_NS_GUIDE_BOUNCES bounces."""
    import importlib
    shapes = importlib.import_module(rt.__name__ + '.elements.shapes')
    mirror = importlib.import_module(rt.__name__ + '.elements.mirror')
    if name == 'fold':
        return mirror_fold_scene(rt)
    if name == 'naive':
        return naive_scene(rt)
    if name.startswith('brewster'):
        kinds = importlib.import_module(rt.__name__ + '.constants').PhysKind
        return rt.Scene([rt.ElementCustom(
            shapes.plane, 1, kinds.FRESNEL, ph=(FIELD_NS_BREWSTER_N, 1.0),
            name='iface')], n_bounces=3)
    if name == 'jones':
        return rt.Scene([
            rt.LinearPolarizer(radius=10.0, angle=0.4,
                               translation=[0, 0, 8.0], name='pol'),
            rt.QuarterWaveplate(radius=10.0, angle=math.pi / 4,
                                translation=[0, 0, 14.0], name='q'),
            rt.SensorElement(radius=40.0, translation=[0, 0, 30.0],
                             name='s')], n_bounces=4)
    if name == 'guide':
        return rt.Scene([mirror.ParabolicMirror(
            c1=0.0, d=0.0, metal='Al', rotation=[math.pi / 2, 0.0, 0.0],
            translation=[0.0, y, 0.0], name=f'wall{i}')
            for i, y in enumerate((1.0, -1.0))] + [rt.SensorElement(
                radius=3.0, translation=[0.0, 0.0, 30.0], name='s')],
            n_bounces=FIELD_NS_GUIDE_BOUNCES)
    if name == 'coated':
        return rt.Scene([
            rt.SingletLens(c1=0.02, c2=-0.02, d=10.0, t=3.0,
                           ior_glass=FIELD_NS_BREWSTER_N, fresnel=True,
                           coating=[(1.38, FIELD_NS_QW)], name='lens'),
            rt.SensorElement(radius=8.0, translation=[0, 0, 19.3],
                             name='s')], n_bounces=6)
    return rt.Scene([
        mirror.ParabolicMirror(c1=-0.001, d=30.0, translation=[0, 0, 50.0],
                               metal='Al', metal_dispersion=name == 'al_disp',
                               name='m'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 0.5], name='s')],
        n_bounces=3)


def field_ns_source(name):
    """(radius, z, rotation about x, wavelength, E0) of a section 19 case's
    collimated beam and launch field."""
    th_b = math.atan(FIELD_NS_BREWSTER_N)
    s2 = math.sqrt(0.5)
    e_p = [0.0, math.cos(th_b), math.sin(th_b)]
    brewster = {'brewster_p': [e_p], 'brewster_s': [[1.0, 0.0, 0.0]],
                'brewster_45': [[s2, s2 * e_p[1], s2 * e_p[2]]]}
    if name in brewster:
        return 2.0, -10.0, th_b, 0.0, brewster[name]
    if name == 'guide':
        tilt = FIELD_NS_GUIDE_TILT
        return 0.5, -2.0, tilt, 0.0, [[0.6, 0.8 * math.cos(tilt),
                                       0.8 * math.sin(tilt)]]
    return {'fold': (2.0, 1.0, 0.0, 0.0, [[s2, s2, 0.0]]),
            'jones': (1.0, -5.0, 0.0, 0.0, None),
            'coated': (1.0, -10.0, 0.0, 0.0, [[1.0, 0.0, 0.0]]),
            'al': (1.0, 1.0, 0.0, 0.0, [[1.0, 0.0, 0.0]]),
            'al_disp': (1.0, 1.0, 0.0, 0.80, [[0.6, 0.8, 0.0]]),
            'naive': (4.0, -10.0, 0.0, 0.0,
                      [[complex(s2), complex(0.0, s2), 0.0]])}[name]


def field_ns_bundle(rt, name):
    """The CollimatedDisk of a section 19 case, in either package."""
    radius, z, rot, wl, _ = field_ns_source(name)
    kw = dict(rotation=[rot, 0.0, 0.0]) if rot else {}
    if wl:
        kw['wavelength'] = wl
    return rt.CollimatedDisk.make(radius=radius, translation=[0.0, 0.0, z],
                                  **kw)


def brewster_rs():
    """The s reflectance of the Brewster plane at its Brewster angle."""
    n2 = FIELD_NS_BREWSTER_N ** 2
    return ((n2 - 1.0) / (n2 + 1.0)) ** 2


# the cases whose rays meet a lens face or a metal mirror near normal
# incidence near the axis (section 17's FIELD_AXIS_R rule, float64 checks)
FIELD_NS_LENS_CASES = ('coated', 'al', 'naive')
FIELD_NS_CHUNK = 250_000
# The JAX package's numbers (JAX_PLATFORMS=cpu python tests/field_anchors.py
# --nonseq): per case on the reference's own rays of PRNGKey(0) (the
# Brewster plane: N_MAIN rays of its own tilted beam and its own draws) at
# N_MAIN rays, the means of |E|^2 ('power'), of intensity * |E|^2 over the
# rays that leave forward ('flux') and its per-ray standard deviation
# ('flux_std'), and the sensor's weight and first moments per ray
FIELD_NS_REF = {
    'fold': {'power': 1.0000001332411765, 'flux': 0.0, 'flux_std': 0.0,
             'weight': 1.0, 'mx': 0.0005668544311523437, 'my':
             -0.000376492919921875},
    'brewster_p': {'power': 0.9999998807907104, 'flux': 0.9999998807907104,
                   'flux_std': 0.0, 'weight': 0.0, 'mx': 0.0, 'my': 0.0},
    'brewster_s': {'power': 1.0, 'flux': 0.844827, 'flux_std':
                   0.36206970484351664, 'weight': 0.0, 'mx': 0.0, 'my': 0.0},
    'brewster_45': {'power': 0.9999999450194835, 'flux': 0.9224199450194835,
                    'flux_std': 0.267509638388283, 'weight': 0.0, 'mx': 0.0,
                    'my': 0.0},
    'jones': {'power': 0.8483532667160034, 'flux': 0.8483532667160034,
              'flux_std': 0.0, 'weight': 0.8483524375, 'mx':
              -0.0002456339569091797, 'my': 0.00016308888244628906},
    'coated': {'power': 0.9999999758201241, 'flux': 0.9746129762044549,
               'flux_std': 0.15729756439737685, 'weight': 0.974613, 'mx':
               -0.00020014199829101561, 'my': 0.00010007659149169922},
    'al': {'power': 1.0, 'flux': 0.0, 'flux_std': 0.0, 'weight':
           0.9154468327899592, 'mx': -0.00023881949409116333, 'my':
           0.0001585645332993524},
    'naive': {'power': 0.9214589553720355, 'flux': 0.9214589553720355,
              'flux_std': 0.00013222069909448605, 'weight': 0.9214589375, 'mx':
              -5.376567840576172e-05, 'my': 3.274417495727539e-05}}


def field_ns_case(rt, torch, name, n, device, seed):
    """(scene, params, rays, E0, Philox key) of a section 19 case on seeded
    rays (the key None without a FRESNEL row), or of a section 21 field case
    (MIX_FIELD_CASES) on the JAX package's rays."""
    if name in MIX_FIELD_CASES:
        sc = mix_scene(rt, name, torch)
        return (sc, sc.init_params(device),
                mix_rays(rt, torch, name, n, device), list(MIX_E0), None)
    gen = torch.Generator(device=device).manual_seed(seed)
    sc = field_ns_scene(rt, name)
    rays = field_ns_bundle(rt, name).sample(gen, n, device)
    key = FRESNEL_KEY if any(m.ph == 4 for m in sc.static_meta()) else None
    return sc, sc.init_params(device), rays, field_ns_source(name)[4], key


def field_ns_inputs(rt, torch, sc, params, rays, E0, device):
    """(meta, cfg, flat, kinds, maps, launch field, family arguments) of a
    non-sequential field trace: the ``TraceMeta`` with ``field``, and the
    K5 and K6 wrappers' ``coat``, ``diff``, ``fuzzy`` and ``ff``."""
    from raytracetorch_tpu_torch.core.field import FieldState
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    meta = ft.TraceMeta(sc.static_meta(), sc.fuzzy_fns(), field=True)
    cfg = sc.sensor_config()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(ft.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    return (meta, cfg, flat, kinds, ft.plate_maps(meta, {}),
            FieldState.init(rays, E0).streams(),
            fn.side_buffers(meta, device))


def chunk_draws(torch, key, sl, device):
    """K5's Philox draws of the rays ``sl`` (a slice of the launch), as the
    plain versions take them for a chunk of rays (None without a key)."""
    if key is None:
        return None
    from raytracetorch_tpu_torch.rays.draws import philox_uniform
    index = torch.arange(sl.start, sl.stop, dtype=torch.int64, device=device)
    return lambda b, k: philox_uniform(index, b, k, key)


def plain_ns_field_fwd(torch, flat, rays, cfg, meta, nb, maps, key, field,
                       chunk=None):
    """trace_nonseq_fused_plain with the field, ``chunk`` rays at a time on
    K5's draws (join_chunks)."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    return join_chunks(torch, [fn.trace_nonseq_fused_plain(
        flat, ray_slice(ft, rays, sl), cfg, meta, nb, maps,
        draws=chunk_draws(torch, key, sl, rays.px.device),
        field=[f[sl] for f in field]) for sl in ray_chunks(rays.n, chunk)])


def plain_ns_field_bwd(torch, flat, rays, cfg, meta, nb, g_rays, g_mom,
                       g_grid, maps, key, field, g_field, chunk=None,
                       dtype=None):
    """trace_nonseq_bwd_plain with the field, ``chunk`` rays at a time on
    K5's draws (join_chunks) -> (table, 7 ray and 6 launch-field
    cotangents); with ``dtype`` (torch.float64) the table, rays, field and
    cotangents widened to it."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    wide = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))

    def part(sl):
        r = ray_slice(ft, rays, sl)
        r = r.replace(**{c: wide(getattr(r, c)) for c in ft.COMPS},
                      wavelength=None if r.wavelength is None
                      else wide(r.wavelength))
        return fn.trace_nonseq_bwd_plain(
            wide(flat), r, cfg, meta, nb,
            [None if g is None else wide(g[sl]) for g in g_rays],
            wide(g_mom), g_grid=None if g_grid is None else wide(g_grid),
            maps=maps, draws=chunk_draws(torch, key, sl, rays.px.device),
            field=[wide(f[sl]) for f in field],
            g_field=[wide(g[sl]) for g in g_field])
    res = join_chunks(torch, [part(sl) for sl in ray_chunks(rays.n, chunk)])
    return res[0], res[1], res[-1]


def field_ns_kernels_vs_plain(rt, torch, name, n, device, seed):
    """K5 and K6 in their instantiation with the field against their plain
    versions on a section 19 case, on K5's draws: the rays, moments, grid,
    the final field's six streams and |E|^2 (the NS_* rules; the field on
    the rays both trace alike); then, on those rays under seeded
    cotangents (the final field's too), the ray, table and launch-field
    cotangents, and K6's replay against K5 bit for bit, its rays and its
    field.  The launch-field cotangents are held on the rays whose
    position and direction cotangents agree (the others number at most
    the NS rule's).  On the segment cases (FIELD_NS_SEGMENT_CASES) rays
    live beyond two segments of K6's checkpoints.  The lens cases
    (FIELD_NS_LENS_CASES) leave the rays within FIELD_AXIS_R of the axis
    out of the per-ray cotangent rule and hold the kernel's ray and
    launch-field cotangents on every ray to the plain version's float64
    ones, as section 17 does -> dict; raises on a breach.  The plain
    versions run FIELD_NS_CHUNK rays at a time."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    sc, params, rays, E0, key = field_ns_case(rt, torch, name, n, device,
                                              seed)
    meta, cfg, flat, kinds, maps, field, side = field_ns_inputs(
        rt, torch, sc, params, rays, E0, device)
    nb, disp = sc.n_bounces, ft.dispersive(meta)
    out_k, s_k, aux_k = fn.trace_nonseq_fwd_cuda(
        flat, kinds, rays, cfg, nb, maps, True, fresnel=True, key=key,
        field=field, **side)
    out_p, s_p, aux_p = plain_ns_field_fwd(torch, flat, rays, cfg, meta, nb,
                                           maps, key, field, FIELD_NS_CHUNK)
    torch.cuda.synchronize()
    res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
    apart = ~((torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                            for c in ('px', 'py', 'pz')]).amax(0)
               <= NS_POS_TOL)
              & ((out_k.intensity - out_p.intensity).abs() <= NS_INT_TOL))
    res.update(compare_field(torch, aux_k, aux_p, ~apart))
    res.update(rows=len(meta), apart=int(apart.sum()))
    if name in FIELD_NS_SEGMENT_CASES:
        lives = nonseq_work(rt, torch, sc, params, rays)[2]
        res['max_live_bounces'] = int(lives.max())
        res['replayed_bounces'] = segment_replays(lives,
                                                  fn.K6_FIELD_CHECKPOINTS)
        check(res['max_live_bounces'] > 2 * fn.K6_FIELD_CHECKPOINTS,
              f'{name}: no ray lives beyond two segments of K6\'s '
              f'{fn.K6_FIELD_CHECKPOINTS} checkpoints')
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, g_grid = random_cotangents(torch, rays.n, cfg, device,
                                              seed + 2)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    g_field = [torch.randn(rays.n, generator=gen, device=device)
               for _ in range(6)]
    g_k = fn.trace_nonseq_bwd_cuda(
        flat, kinds, rays, cfg, nb, g_rays, g_mom, g_grid=g_grid, maps=maps,
        ext=True, disp=disp, fresnel=True, key=key, replay=True,
        need_wavelength=disp, field=field, g_field=g_field, **side)
    g_p = plain_ns_field_bwd(torch, flat, rays, cfg, meta, nb, g_rays, g_mom,
                             g_grid, maps, key, field, g_field,
                             FIELD_NS_CHUNK)
    out_k, _, aux_k = fn.trace_nonseq_fwd_cuda(
        flat, kinds, rays, cfg, nb, maps, True, fresnel=True, key=key,
        field=field, **side)
    torch.cuda.synchronize()
    res['replay_equal'] = all(torch.equal(getattr(g_k[-2], c),
                                          getattr(out_k, c))
                              for c in ft.COMPS)
    res['replay_field_equal'] = all(torch.equal(a, aux_k[k]) for a, k in
                                    zip(g_k[-1], ft.FIELD_KEYS))
    check(res['replay_equal'] and res['replay_field_equal'],
          f'{name}: K6 replay differs from K5 (rays '
          f'{res["replay_equal"]}, field {res["replay_field_equal"]})')
    keep = torch.ones_like(rays.px, dtype=torch.bool)
    g64 = None
    if name in FIELD_NS_LENS_CASES + MIX_FIELD_CASES:
        keep = (rays.px ** 2 + rays.py ** 2).sqrt() >= FIELD_AXIS_R
        g64 = plain_ns_field_bwd(torch, flat, rays, cfg, meta, nb, g_rays,
                                 g_mom, g_grid, maps, key, field, g_field,
                                 FIELD_NS_CHUNK, torch.float64)
        res['near_axis'] = int((~keep).sum())
        allowed = math.ceil(BWD_FLIPS_PER_MILLION * rays.n / 1e6)
        for label, gk, gp, g64_, groups in (
                ('rays', g_k[1], g_p[1], g64[1], ((0, 1, 2), (3, 4, 5),
                                                  (6,))),
                ('field', g_k[-3], g_p[2], g64[2], (tuple(range(6)),))):
            off_k = rays_off_float64(torch, gk, g64_, groups)
            off_p = rays_off_float64(torch, gp, g64_, groups)
            res[f'{label}_off_f64'] = dict(kernel=off_k, plain=off_p)
            check(off_k <= FIELD_F64_RATIO * off_p + allowed,
                  f'{name}: the kernel departs from the float64 {label} '
                  f'cotangents on {off_k} rays, the plain version on {off_p}')
    allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n))
    grid_allowed = math.ceil(GRID_SHARE * rays.n) if cfg.grid_shape else 0
    res['bwd'] = compare_ray_cotangents(
        torch, [g[keep] for g in g_k[1]], [g[keep] for g in g_p[1]],
        allowed=allowed, intensity_allowed=grid_allowed)
    res['bwd'].update(compare_table_cotangents(
        torch, ft, g_k[0], g_p[0], plates=True, ext=True, disp=disp,
        coat=side['coat'] is not None, diff=side['diff'],
        freeform=side['ff'] is not None,
        ref64=None if g64 is None else g64[0]))
    # a ray whose position or direction cotangents differ (the NS rule
    # above: a hit that flips at a rim in one of the two runs) has other
    # field cotangents too; the others' are held to sections 17 and 18's
    # rule
    same = ~rays_off(torch, [g[keep] for g in g_k[1]],
                     [g[keep] for g in g_p[1]], ((0, 1, 2), (3, 4, 5)))
    res['bwd']['field'] = compare_field_cotangents(
        torch, [g[keep][same] for g in g_k[-3]],
        [g[keep][same] for g in g_p[2]])
    res['bwd']['field']['geometry_differ'] = int((~same).sum())
    return res


def field_ns_stats(torch, out, sens, aux):
    """A section 19 path's means: |E|^2, intensity * |E|^2 over the rays
    that leave forward and its per-ray standard deviation, the sensor's
    weight and first moments per ray (FIELD_NS_REF's keys)."""
    n = out.px.shape[0]
    w = (out.intensity * aux['field_power']).double()
    w = torch.where((out.dz > 0) & (out.intensity > 0), w, 0.0)
    m = sens.moments[0, 0].double()
    return dict(power=float(aux['field_power'].double().mean()),
                flux=float(w.mean()), flux_std=float(w.std()),
                weight=float(m[0]) / n, mx=float(m[1]) / n,
                my=float(m[2]) / n)


def field_ns_paths(rt, torch, dev, reset_counters, counters, only):
    """Each case through Scene.simulate_fused at N_MAIN rays (K5 once, in
    its instantiation with the field), against the JAX package's means
    (FIELD_NS_REF) and the Brewster analytics -> dict; raises on a
    breach."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    res, rs = {}, brewster_rs()
    for name in FIELD_NS_CASES:
        sc = field_ns_scene(rt, name)
        radius, z, rot, wl, E0 = field_ns_source(name)
        gen = torch.Generator(device=dev).manual_seed(FIELD_NS_SEED + 5)
        rays = (field_ns_bundle(rt, name).sample(gen, N_MAIN, dev) if rot
                else ref_disk(rt, N_MAIN, radius, z, dev, wl))
        reset_counters()
        out, sens, aux = sc.simulate_fused(sc.init_params(dev), rays,
                                           generator=gen, track_field=True,
                                           E0=E0)
        torch.cuda.synchronize()
        stats = field_ns_stats(torch, out, sens, aux)
        stats['launches'] = counters()
        check(only(stats['launches'], trace_nonseq_fwd=1, field=1),
              f'{name}: simulate_fused launched {stats["launches"]}')
        check(bool(torch.isfinite(aux['field_power']).all()),
              f'{name}: the field is not finite')
        ref = FIELD_NS_REF[name]
        if rot or name == 'coated':   # Monte-Carlo: two sets of draws
            sigma = max(math.hypot(stats['flux_std'], ref['flux_std'])
                        / math.sqrt(N_MAIN), FIELD_REF_ATOL)
            stats['flux_sigmas'] = abs(stats['flux'] - ref['flux']) / sigma
            check(stats['flux_sigmas'] <= FIELD_NS_SIGMAS,
                  f'{name} flux {stats["flux"]} vs JAX {ref["flux"]}')
            check(abs(stats['power'] - ref['power']) <= FIELD_REF_ATOL,
                  f'{name} power {stats["power"]} vs JAX {ref["power"]}')
        else:
            for k in ('power', 'flux', 'weight', 'mx', 'my'):
                check(abs(stats[k] - ref[k]) <= FIELD_REF_ATOL,
                      f'{name} {k} {stats[k]} vs JAX {ref[k]}')
        if name == 'brewster_p':
            stats['reflected'] = int(((out.dz < 0) & (out.intensity > 0))
                                     .sum())
            check(stats['reflected'] == 0 and abs(stats['flux'] - 1.0)
                  <= FIELD_NS_TP_ATOL, f'Brewster p: {stats}')
        if name == 'brewster_s':
            sigma = math.sqrt(rs * (1.0 - rs) / N_MAIN)
            stats['ts_sigmas'] = abs(stats['flux'] - (1.0 - rs)) / sigma
            check(stats['ts_sigmas'] <= FIELD_NS_SIGMAS,
                  f'Brewster s: Ts {stats["flux"]} vs 1 - Rs {1.0 - rs}')
        res[name] = stats
        torch.cuda.empty_cache()
    return res


def field_ns_loss(s, aux):
    """The grad loss of the mirror fold (tests/test_torch_field_nonseq.py):
    |E|^2, the sensor's weight and first moment, a sum of squares and the
    final field's x-real and y-imaginary parts, which carry E0's
    polarization past the mirror (|E|^2 alone does not)."""
    f = aux['field']
    return (aux['field_power'].mean() + s.total_weight(0)[0] * 1e-3
            + s.moments[0, 0, 1] * 1e-3 + (aux['field_power'] ** 2).sum()
            * 1e-4 + (f.erx + f.eiy).mean())


def field_ns_grads(rt, torch, dev, reset_counters, counters, only):
    """The mirror fold's grad step through simulate_fused (K5 + K6 once
    each, in their instantiation with the field) against the eager
    Scene.simulate's at N_MAIN rays: the gradients in the mirror's c1 and
    in a complex E0 of ``field_ns_loss`` -> dict; raises on a breach
    (FIELD_NS_GRAD_RTOL)."""
    sc = field_ns_scene(rt, 'fold')
    params = sc.init_params(dev)
    radius, z, _, _, _ = field_ns_source('fold')
    rays = ref_disk(rt, N_MAIN, radius, z, dev)
    res = {}
    for sim in ('simulate_fused', 'simulate'):
        p = {k: dict(v) for k, v in params.items()}
        p['mirror']['c'] = params['mirror']['c'].clone().requires_grad_(True)
        re = torch.tensor([[0.6, 0.8 * math.sqrt(0.5), 0.0]], device=dev,
                          requires_grad=True)
        im = torch.tensor([[0.0, 0.8 * math.sqrt(0.5), 0.0]], device=dev,
                          requires_grad=True)
        reset_counters()
        _, s, aux = getattr(sc, sim)(p, rays, track_field=True,
                                     E0=torch.complex(re, im))
        loss = field_ns_loss(s, aux)
        g = torch.autograd.grad(loss, [p['mirror']['c'], re, im])
        torch.cuda.synchronize()
        res[sim] = dict(loss=float(loss.detach()), launches=counters(),
                        c1=float(g[0]), E0=[float(x) for x in
                                            torch.cat([g[1], g[2]]).flatten()])
    f, e = res['simulate_fused'], res['simulate']
    check(only(f['launches'], trace_nonseq_fwd=1, trace_nonseq_bwd=1,
               field=2), f'fold grad step launched {f["launches"]}')
    check(e['launches']['trace_nonseq_fwd'] == 0
          and e['launches']['trace_nonseq_bwd'] == 0,
          f'the eager grad step launched {e["launches"]}')
    tol = FIELD_NS_GRAD_RTOL
    check(abs(f['c1'] - e['c1']) <= tol * abs(e['c1']),
          f'fold c1 gradient {f["c1"]} vs eager {e["c1"]}')
    scale = max(abs(x) for x in e['E0'])
    check(all(abs(a - b) <= tol * (abs(b) + 1e-3 * scale)
              for a, b in zip(f['E0'], e['E0'])),
          f'fold E0 gradient {f["E0"]} vs eager {e["E0"]}')
    return res


def field_ns_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 19: the polarized field in the non-sequential scene, K5 and
    K6 in their instantiation with the field: each against its plain
    version at N_MAIN rays on FIELD_NS_CASES and the light guide, whose
    rays K6 reverses in segments (K6's replay bit for bit); the counted
    simulate_fused paths against the JAX package's means and the Brewster
    analytics; the mirror fold's grad step fused against eager; times, bounds (the field's work counted on the winners) and
    blocks per SM on the naive scene and the mirror fold.  17d holds the
    SASS of every earlier kernel."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 19a. each kernel against its plain version
    kern = {}
    for name in FIELD_NS_CASES + FIELD_NS_SEGMENT_CASES:
        t1 = time.perf_counter()
        kern[name] = field_ns_kernels_vs_plain(rt, torch, name, N_MAIN, dev,
                                               FIELD_NS_SEED + 11)
        kern[name]['seconds'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    emit('field_ns_kernels_vs_plain', n=N_MAIN, **kern)

    # 19b. the counted paths and their anchors, the grad step
    paths = field_ns_paths(rt, torch, dev, reset_counters, counters, only)
    grads = field_ns_grads(rt, torch, dev, reset_counters, counters, only)
    emit('field_ns_main', paths=paths, grads=grads)

    # 19c. times at N_MAIN against the plain versions, bounds and blocks
    timing, bounds, occ = {}, {}, {}
    for name in ('naive', 'fold'):
        sc, params, r, E0, key = field_ns_case(rt, torch, name, N_MAIN, dev,
                                               FIELD_NS_SEED + 7)
        meta, cfg, flat, kinds, maps, field, side = field_ns_inputs(
            rt, torch, sc, params, r, E0, dev)
        nb = sc.n_bounces
        g_rays, g_mom, g_grid = random_cotangents(torch, r.n, cfg, dev,
                                                  SEED + 6)
        g_field = [g_rays[0]] * 6
        kfn = (lambda: fn.trace_nonseq_fwd_cuda(
            flat, kinds, r, cfg, nb, maps, True, fresnel=True, field=field,
            **side))
        pfn = (lambda: fn.trace_nonseq_fused_plain(
            flat, r, cfg, meta, nb, maps, field=field))
        bk = (lambda: fn.trace_nonseq_bwd_cuda(
            flat, kinds, r, cfg, nb, g_rays, g_mom, g_grid=g_grid, maps=maps,
            ext=True, fresnel=True, field=field, g_field=g_field, **side))
        bp = (lambda: fn.trace_nonseq_bwd_plain(
            flat, r, cfg, meta, nb, g_rays, g_mom, g_grid=g_grid, maps=maps,
            field=field, g_field=g_field))
        scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
        replayed = segment_replays(lives, fn.K6_FIELD_CHECKPOINTS)
        k5_ops, k6_ops = nonseq_ops(meta, scans, wins, replayed)
        # a winner's work under the field: section 18's count of a row
        field_ops = sum(w * field_coat_row_ops(m)
                        for w, m in zip(wins, meta))
        cols = len(ft.grad_cols((), True, ft.dispersive(meta),
                                side['coat'] is not None))
        # K5 reads 9 streams and the launch field and writes 7 and the
        # final field; K6 reads K5's inputs, the 7 ray and 6 field
        # cotangents and writes their 13 cotangents and its partials
        io5 = r.n * (36 + 28 + 48) + table_bytes(meta) + grid_bytes(cfg)
        io6 = (r.n * (36 + 24 + 52 + 52) + table_bytes(meta)
               + grid_bytes(cfg) + -(-r.n // 256) * len(meta) * cols * 4)
        bounds[f'k5_{name}'] = bound(io5, k5_ops + field_ops)
        bounds[f'k6_{name}'] = bound(io6, k6_ops + 3 * field_ops)
        timing[f'{name}_work'] = dict(k5_row_scans=scans,
                                      k5_winners_per_row=wins,
                                      k6_replayed=replayed)
        for key_, kf, pf in ((f'k5_{name}', kfn, pfn),
                             (f'k6_{name}', bk, bp)):
            k_runs = time_ms(torch, kf, warmup=2, reps=10)
            p_runs = time_ms(torch, pf, warmup=1, reps=3)
            timing[key_] = dict(kernel_ms=statistics.median(k_runs),
                                plain_ms=statistics.median(p_runs),
                                kernel_runs=k_runs)
        for lib in ('trace_nonseq_fwd', 'trace_nonseq_bwd'):
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, nb, ext=True, field=True)
        torch.cuda.empty_cache()
    emit('field_ns_timing', **timing)
    emit('field_ns_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('field_ns_occupancy', blocks_per_sm=occ)
    emit('field_ns_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, grads=grads, timing=timing,
                bounds=bounds)


# GRIN rods (section 20): example 24's scenes (examples/24_grin_relay.py)
# and tests/test_grin.py's rods, through K1, K2, K5 and K6 in their
# instantiation with GRIN rods (csrc/grin.cuh).  The quarter-pitch rod (A =
# 0.01 1/mm^2, n0 = 1.6, radius 5, L = pi / (2 sqrt(A))) with a sensor 1e-3
# behind its exit face: the example's collimated fan (1M rays over x in
# [-0.5, 0.5] at z = -3) focuses under GRIN_RMS_MAX, the example's anchor
# (a disk of radius 0.5, which the kernels are held to their plain versions
# on, reads 5.5e-4: its rays weigh the rim, where the exact profile's
# aberration grows as r^3).  Two half-pitch rods 0.05 apart relay a point
# source (NA 0.05) at x = 1.2 to a centroid within GRIN_RELAY_TOL of 1.2.  A
# mixed table (a rod, the bench singlet, the sensor) runs the kinds of the
# instantiation with the streams beside the rod, with the path length.
# Example 24's design: L = 12, the sensor 8 behind the exit face, 400 Adam
# steps on grin_A from 0.008 (the example's scale 0.005, lr 2e-2) on its
# 256-ray fan over x in [-0.8, 0.8]: spot RMS under GRIN_DESIGN_RMS and the
# paraxial working distance of the fitted A within GRIN_WD_TOL of 8 (the
# example's assertions).  tests/test_grin.py:203's rod (L = 30, sensor 5
# behind) as a 4-bounce Scene, lit over a disk of radius 4.8 with slopes up
# to 0.3: ~2% of its rays die in the barrel; the same rod with an axial term
# az = -0.07 (n^2 falls to 0.46 at the exit), lit over radius 3 with slopes
# up to 0.6: ~11% reach a turning point (pz^2 <= 1e-10) and none the barrel
# (tests/test_torch_grin.py counts both on the CPU).
GRIN_SEED = SEED + 2001
GRIN_A0, GRIN_N0, GRIN_R = 0.01, 1.6, 5.0
GRIN_LQ = math.pi / (2.0 * math.sqrt(GRIN_A0))
GRIN_GAP = 0.05
GRIN_RMS_MAX = 5e-4
GRIN_RELAY_X, GRIN_RELAY_TOL, GRIN_RELAY_NA = 1.2, 5e-3, 0.05
GRIN_DESIGN_L, GRIN_DESIGN_WD, GRIN_DESIGN_A = 12.0, 8.0, 0.008
GRIN_DESIGN_STEPS, GRIN_DESIGN_LR, GRIN_DESIGN_SCALE = 400, 2e-2, 0.005
GRIN_DESIGN_RAYS = 256
GRIN_DESIGN_RMS, GRIN_WD_TOL = 2e-3, 0.05
GRIN_NS_L, GRIN_NS_BOUNCES, GRIN_TURN_AZ = 30.0, 4, -0.07
GRIN_SEQ_CASES = ('quarter', 'relay', 'mixed')
GRIN_NS_CASES = ('ns', 'ns_turn')
# Kernel vs plain: sections 3's, 10's and 19's rules (POS_TOL, BWD_TOL,
# OPL_RTOL, the NS_* rules).  The plain K2 and K6 run GRIN_CHUNK rays at a
# time: 64 RK4 steps keep ~2,000 tensors of autograd graph a ray batch.
GRIN_CHUNK = 250_000
# The turning-point rod: a ray that passes within rounding of its turning
# point, where the rates carry 1 / pz, turns an ulp of its entry hit (the
# kernel's intersection contracts multiply-adds, the plain version's does
# not; the rod itself rounds alike in both, csrc/grin.cuh) into a visible
# difference in its path.  So up to GRIN_TURN_SHARE of that case's rays may
# trace apart from the plain version, in place of the NS rule's count: PR
# 22's second chip call read 369 of 1M (3.7e-4), after the rod was made to
# round as the plain version does, and the limit keeps 2.7x of margin over
# it (chip_fmad.py builds the kernels with -fmad=false, which closes the
# gap).  The backward runs on the rays both trace alike and keeps the NS
# rule's count (NS_MISMATCH_SHARE): the same call read 14 of 1M rays with
# other cotangents.
GRIN_TURN_SHARE = 1e-3
# The same rays' cotangents reach 6.8e6 (the others' median 13): their
# rounding dominates the table's sums, so that case's table cotangent is
# held to GRIN_TURN_TAB_RTOL of its field's scale in place of TAB_RTOL
# (PR 22's second chip call read 3.0e-4 in tw and ph[0:2]).
GRIN_TURN_TAB_RTOL = 2e-3
# Fused against eager gradients (the design scene with every GrinRod
# parameter trainable, a spot loss; the mixed table's grad step with the
# path length): each within GRIN_GRAD_RTOL of the eager one, relative to
# the largest of its leaf (float32 adjoints of 64 steps in another order).
GRIN_GRAD_RTOL = 1e-3
GRIN_GRAD_RAYS = 65_536
GRIN_LEAVES = ('n0', 'grin_A', 'a4', 'az', 't')
# The count behind the bounds: one RK4 step is four rate evaluations (~24
# operations each, an IEEE division and square root among them), three
# state updates (8 each) and the step's sum (~35): ~160; the couplings and
# the exit's frame ~60 a ray.  A step's reverse is the four rates again and
# their adjoints (~40 each) and the sum's: ~340.  The backward bounds count
# the rod's steps forward once and their reverse once, as section 15 counts
# the freeform steps: the kernels' re-runs from checkpoints are their design,
# not the function's work.
GRIN_STEP_OPS, GRIN_COUPLE_OPS, GRIN_REV_STEP_OPS = 160, 60, 340


def grin_rod(rt, L, z0, name='rod', **kw):
    """A GrinRod of radius GRIN_R and A = GRIN_A0 (or ``grin_A``) whose
    entry face is at z0 (both packages: ``rt``)."""
    kw.setdefault('grin_A', GRIN_A0)
    return rt.GrinRod(radius=GRIN_R, thickness=L, n0=GRIN_N0,
                      translation=[0.0, 0.0, z0 + 0.5 * L], name=name, **kw)


def grin_scene(rt, name):
    """A section 20 case's scene (both packages: ``rt``): 'quarter',
    'relay', 'mixed' and 'design' are SequentialScenes; 'ns' and 'ns_turn'
    4-bounce Scenes, and 'ns_seq' the 'ns' rod as a SequentialScene."""
    lq, lh = GRIN_LQ, 2.0 * GRIN_LQ
    if name == 'quarter':
        return rt.SequentialScene([
            grin_rod(rt, lq, 0.0),
            rt.SensorElement(radius=2.0, translation=[0.0, 0.0, lq + 1e-3],
                             name='s')])
    if name == 'relay':
        return rt.SequentialScene([
            grin_rod(rt, lh, 0.0, 'r1'),
            grin_rod(rt, lh, lh + GRIN_GAP, 'r2'),
            rt.SensorElement(radius=5.0,
                             translation=[0.0, 0.0, 2 * lh + 2 * GRIN_GAP],
                             name='s')])
    if name == 'mixed':
        return rt.SequentialScene([
            grin_rod(rt, 8.0, 0.0),
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           ior_media=1.0, translation=[0.0, 0.0, 12.0],
                           name='lens'),
            rt.SensorElement(radius=6.0, translation=[0.0, 0.0, 31.0],
                             name='sensor')])
    if name == 'design':
        L = GRIN_DESIGN_L
        return rt.SequentialScene([
            grin_rod(rt, L, 0.0, grin_A=GRIN_DESIGN_A, grin_A_grad=True),
            rt.SensorElement(radius=5.0,
                             translation=[0.0, 0.0, L + GRIN_DESIGN_WD],
                             name='s')])
    L = GRIN_NS_L
    els = [grin_rod(rt, L, 0.0,
                    **(dict(az=GRIN_TURN_AZ) if name == 'ns_turn' else {})),
           rt.SensorElement(radius=6.0, translation=[0.0, 0.0, L + 5.0],
                            name='s')]
    if name == 'ns_seq':
        return rt.SequentialScene(els)
    return rt.Scene(els, n_bounces=GRIN_NS_BOUNCES)


def grin_fan(rt, torch, n, half, device):
    """Example 24's collimated fan: n rays over x in [-half, half], y = 0,
    at z = -3, travelling +z."""
    x = torch.linspace(-half, half, n, device=device)
    pos = torch.stack([x, torch.zeros_like(x), torch.full_like(x, -3.0)], -1)
    d = torch.zeros_like(pos)
    d[:, 2] = 1.0
    return rt.Rays.create(pos, d)


def grin_rays(rt, torch, name, n, device, seed):
    """A section 20 case's rays: a collimated disk of radius 0.5 ('quarter')
    or 4 ('mixed') at z = -3, the relay's point source, the design's fan,
    and for the rods of the Scenes positions over a disk (radius 4.8, or 3
    for 'ns_turn') at z = -3 with slopes up to 0.3 (0.6) in any azimuth."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if name in ('quarter', 'mixed'):
        return rt.CollimatedDisk.make(
            radius=0.5 if name == 'quarter' else 4.0,
            translation=[0.0, 0.0, -3.0]).sample(gen, n, device)
    if name == 'relay':
        return rt.PointSource.make(
            na=GRIN_RELAY_NA,
            translation=[GRIN_RELAY_X, 0.0, -0.001]).sample(gen, n, device)
    if name == 'design':
        return grin_fan(rt, torch, n, 0.8, device)
    r_max, s_max = (3.0, 0.6) if name == 'ns_turn' else (4.8, 0.3)

    def uniform():
        return torch.rand(n, generator=gen, device=device)
    r, a = r_max * uniform().sqrt(), 2.0 * math.pi * uniform()
    s, b = s_max * uniform().sqrt(), 2.0 * math.pi * uniform()
    pos = torch.stack([r * a.cos(), r * a.sin(), torch.full_like(r, -3.0)],
                      -1)
    d = torch.stack([s * b.cos(), s * b.sin(), (1.0 - s * s).sqrt()], -1)
    return rt.Rays.create(pos, d)


def grin_inputs(rt, torch, sc, params):
    """(meta, cfg, flat, kinds, maps, ext) of a section 20 scene, as its
    fused trace passes them."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    meta, cfg = sc.static_meta(), sc.sensor_config()
    flat = rt.flatten_table_rows(sc.build_table(params))
    kinds = torch.tensor(ft.kind_rows(meta, cfg), dtype=torch.int32,
                         device=flat.device)
    return meta, cfg, flat, kinds, ft.plate_maps(meta, {}), ft.ext_kinds(meta)


def grin_ops(meta):
    """A GRIN row's forward operations a ray (its RK4 steps and couplings;
    0 for every other row)."""
    return (meta.grin_steps * GRIN_STEP_OPS + GRIN_COUPLE_OPS
            if meta.grin_steps else 0)


def grin_kernels_vs_plain(rt, torch, name, n, device, seed):
    """K1 and K2 (sequential cases) or K5 and K6 (the Scenes) in their
    instantiation with GRIN rods against their plain versions on a section
    20 case at n rays, with the path length: the rays, moments and path
    lengths and final media of the rays both trace alike (sections 3's,
    10's and 19's rules), the rays a rod kills in both; then under seeded
    cotangents (the path length's and the final medium's too) the ray and
    table cotangents, and K6's replay against K5 bit for bit -> dict;
    raises on a breach.  The plain backward runs GRIN_CHUNK rays at a
    time."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    sc = grin_scene(rt, name)
    params = sc.init_params(device)
    rays = grin_rays(rt, torch, name, n, device, seed)
    meta, cfg, flat, kinds, maps, ext = grin_inputs(rt, torch, sc, params)
    nonseq = name in GRIN_NS_CASES
    nb = sc.n_bounces if nonseq else 0
    if nonseq:
        out_k, s_k, aux_k = fn.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, track_opl=True)
        out_p, s_p, aux_p = fn.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps, track_opl=True)
    else:
        out_k, s_k, aux_k = ft.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, track_opl=True)
        out_p, s_p, aux_p = ft.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, track_opl=True)
    torch.cuda.synchronize()
    turn = (math.ceil(GRIN_TURN_SHARE * rays.n) if name == 'ns_turn'
            else None)
    if nonseq:
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p, allowed=turn)
        pos = torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                           for c in ('px', 'py', 'pz')]).amax(0)
        apart = ((pos > NS_POS_TOL)
                 | ((out_k.intensity - out_p.intensity).abs() > NS_INT_TOL))
    else:
        res = compare(torch, out_k, s_k, out_p, s_p)
        apart = traced_apart(torch, out_k, out_p)[0]
    res.update(compare_streams(
        torch, *({k: v[~apart] for k, v in aux.items()}
                 for aux in (aux_k, aux_p))))
    killed_k = (rays.intensity > 0) & (out_k.intensity == 0)
    killed_p = (rays.intensity > 0) & (out_p.intensity == 0)
    res.update(rows=len(meta), apart=int(apart.sum()),
               killed=int(killed_k.sum()), killed_plain=int(killed_p.sum()),
               killed_differ=int((killed_k != killed_p).sum()))
    check(int((killed_k != killed_p).sum()) <= int(apart.sum()),
          f'{name}: the kernel and the plain version kill other rays')
    if name.startswith('ns'):
        check(res['killed'] > 0, f'{name}: no ray died in the rod')
    # the backward on the rays both trace alike
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, device,
                                         seed + 2)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    g_opl, g_nf = (torch.randn(rays.n, generator=gen, device=device)
                   for _ in range(2))

    def part(sl, dtype=torch.float32):
        r = ray_slice(ft, rays, sl)
        r = r.replace(**{c: getattr(r, c).to(dtype) for c in ft.COMPS})
        gr = [g[sl].to(dtype) for g in g_rays]
        kw = dict(maps=maps, g_opl=g_opl[sl].to(dtype),
                  g_nfinal=g_nf[sl].to(dtype))
        if nonseq:
            return fn.trace_nonseq_bwd_plain(flat.to(dtype), r, cfg, meta,
                                             nb, gr, g_mom.to(dtype), **kw)
        return ft.trace_seq_bwd_plain(flat.to(dtype), r, cfg, meta, gr,
                                      g_mom.to(dtype), **kw)
    g_p = join_chunks(torch, [part(sl)
                              for sl in ray_chunks(rays.n, GRIN_CHUNK)])
    if nonseq:
        g_k = fn.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
            opl=True, g_opl=g_opl, g_nfinal=g_nf, replay=True)
        out_r = fn.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, nb, maps,
                                         ext, track_opl=True)[0]
        torch.cuda.synchronize()
        differ = torch.zeros_like(rays.px, dtype=torch.bool)
        for c in ft.COMPS:
            differ |= getattr(g_k[-1], c) != getattr(out_r, c)
        res['replay_equal'] = not bool(differ.any())
        res['replay_differ'] = int(differ.sum())
        check(res['replay_equal'], f'{name}: K6 replay differs from K5 on '
              f'{res["replay_differ"]} rays')
        allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n))
    else:
        g_k = ft.trace_seq_bwd_cuda(flat, kinds, rays, cfg, g_rays, g_mom,
                                    maps=maps, ext=ext, opl=True,
                                    g_opl=g_opl, g_nfinal=g_nf)
        torch.cuda.synchronize()
        allowed = None
    g64 = None
    if name == 'ns_turn':
        # near a turning point 1 / pz amplifies float32 rounding: each
        # float32 side breaks BWD_TOL's rule against the plain version's
        # float64 cotangents on its own few rays (12 and 12 of 2,999 on an
        # NVIDIA H100 80GB HBM3, not the same rays), which may part the
        # kernel from the plain version beyond the NS rule's count; on
        # every ray the kernel may break it against the float64 run on
        # FIELD_F64_RATIO times as many rays as the plain version (section
        # 17's rule), and only where the NS count is exceeded do the rays
        # either side breaks it on join that count
        g64 = join_chunks(torch, [part(sl, torch.float64) for sl in
                                  ray_chunks(rays.n, GRIN_CHUNK)])
        groups = ((0, 1, 2), (3, 4, 5), (6,))
        off_k, off_p = (rays_off(torch, g[1], g64[1], groups)
                        for g in (g_k, g_p))
        res['rays_off_f64'] = dict(kernel=int(off_k.sum()),
                                   plain=int(off_p.sum()))
        check(int(off_k.sum()) <= FIELD_F64_RATIO * int(off_p.sum())
              + math.ceil(BWD_FLIPS_PER_MILLION * rays.n / 1e6),
              f'{name}: the kernel departs from the float64 cotangents on '
              f'{res["rays_off_f64"]} rays (kernel, plain)')
        if int(rays_off(torch, g_k[1], g_p[1], groups).sum()) > allowed:
            allowed += int((off_k | off_p).sum())
    res['bwd'] = compare_ray_cotangents(torch, g_k[1], g_p[1],
                                        allowed=allowed)
    res['bwd'].update(compare_table_cotangents(
        torch, ft, g_k[0], g_p[0], plates=True, ext=True,
        rtol=GRIN_TURN_TAB_RTOL if name == 'ns_turn' else TAB_RTOL,
        ref64=None if g64 is None else g64[0]))
    return res


def grin_spot_grads(rt, torch, sc, rays, simulate, leaves=('n0', 'grin_A'),
                    dtype=None):
    """The gradient of spot_rms(0) in the rod's ``leaves`` through
    ``sc.<simulate>`` -> [len(leaves)] tensor; with ``dtype``
    (torch.float64) the parameters and rays widened to it, the reference of
    the float32 runs' rounding."""
    p = sc.init_params(rays.px.device)
    if dtype is not None:
        p = {e: {k: v.to(dtype) if torch.is_tensor(v)
                 and v.is_floating_point() else v for k, v in d.items()}
             for e, d in p.items()}
        rays = rays.replace(**{c: getattr(rays, c).to(dtype) for c in
                               ('px', 'py', 'pz', 'dx', 'dy', 'dz',
                                'intensity')})
    xs = [p['rod'][k].requires_grad_(True) for k in leaves]
    loss = getattr(sc, simulate)(p, rays)[1].spot_rms(0)[0]
    return torch.stack(torch.autograd.grad(loss, xs)).detach()


def grin_paths(rt, torch, dev, reset_counters, counters, only):
    """The counted paths: the quarter-pitch fan and the relay through
    simulate_fused at N_MAIN rays (K1 once, its instantiation with GRIN
    rods) against the example's anchors; the 'ns' rod as a Scene (K5 once)
    against the same rod as a SequentialScene (K1 once), with the path
    length (tests/test_grin.py:203's rule) -> dict; raises on a breach."""
    res = {}
    for name in ('quarter', 'relay'):
        sc = grin_scene(rt, name)
        rays = (grin_fan(rt, torch, N_MAIN, 0.5, dev) if name == 'quarter'
                else grin_rays(rt, torch, name, N_MAIN, dev, GRIN_SEED + 5))
        reset_counters()
        out, sens = sc.simulate_fused(sc.init_params(dev), rays)[:2]
        torch.cuda.synchronize()
        stats = dict(launches=counters(),
                     rms=float(sens.spot_rms(0)[0]),
                     centroid=[float(c) for c in sens.centroid(0)[0]],
                     alive=float((out.intensity > 0).float().mean()))
        check(only(stats['launches'], trace_seq_fwd=1, grin=1),
              f'{name}: simulate_fused launched {stats["launches"]}')
        if name == 'quarter':
            check(stats['rms'] < GRIN_RMS_MAX,
                  f'quarter-pitch spot RMS {stats["rms"]}')
        else:
            check(abs(stats['centroid'][0] - GRIN_RELAY_X) < GRIN_RELAY_TOL,
                  f'relay centroid {stats["centroid"]}')
        res[name] = stats
    # the Scene against the SequentialScene
    sq, ns = grin_scene(rt, 'ns_seq'), grin_scene(rt, 'ns')
    params = sq.init_params(dev)
    rays = grin_rays(rt, torch, 'ns', N_MAIN, dev, GRIN_SEED + 6)
    reset_counters()
    o1, s1, a1 = sq.simulate_fused(params, rays, track_opl=True)
    torch.cuda.synchronize()
    l1 = counters()
    reset_counters()
    o2, s2, a2 = ns.simulate_fused(params, rays, track_opl=True)
    torch.cuda.synchronize()
    l2 = counters()
    check(only(l1, trace_seq_fwd=1, grin=1)
          and only(l2, trace_nonseq_fwd=1, grin=1),
          f'the rod launched {l1} as a SequentialScene, {l2} as a Scene')
    apart = ~((torch.stack([(getattr(o1, c) - getattr(o2, c)).abs()
                            for c in ('px', 'py', 'pz')]).amax(0) <= 1e-5)
              & (torch.stack([(getattr(o1, c) - getattr(o2, c)).abs()
                              for c in ('dx', 'dy', 'dz')]).amax(0) <= 1e-6)
              & ((o1.intensity - o2.intensity).abs() <= 1e-6)
              & torch.isclose(a1['opl'], a2['opl'], rtol=1e-6, atol=0.0))
    mom_err = (s1.moments - s2.moments).abs()
    res['scene'] = dict(
        launches_seq=l1, launches_scene=l2, apart=int(apart.sum()),
        allowed=max(3, math.ceil(NS_MISMATCH_SHARE * rays.n)),
        killed=int((o2.intensity == 0).sum()),
        moment_err_over_bound=float(
            (mom_err / (1e-5 + 1e-5 * s1.moments.abs())).max()))
    check(res['scene']['apart'] <= res['scene']['allowed'],
          f'the Scene and the SequentialScene differ: {res["scene"]}')
    check(bool((mom_err <= 1e-5 + 1e-5 * s1.moments.abs()).all()),
          f'the Scene\'s moments differ: {res["scene"]}')
    return res


def grin_grad_check(rt, torch, dev, reset_counters, counters, only):
    """Fused against eager gradients: the design scene with every GrinRod
    leaf trainable (a spot loss on GRIN_GRAD_RAYS rays over a disk of radius
    0.8; K1 + K2 once), the mixed table with the path length (K1 + K2), the
    'ns' rod as a Scene (K5 + K6) -> dict; raises on a breach of
    GRIN_GRAD_RTOL."""
    res = {}
    for name, sim_kw in (('design', {}), ('mixed', dict(track_opl=True)),
                         ('ns', dict(track_opl=True))):
        sc = grin_scene(rt, name)
        gen = torch.Generator(device=dev).manual_seed(GRIN_SEED + 8)
        rays = (rt.CollimatedDisk.make(radius=0.8,
                                       translation=[0.0, 0.0, -3.0])
                .sample(gen, GRIN_GRAD_RAYS, dev) if name == 'design'
                else grin_rays(rt, torch, name, GRIN_GRAD_RAYS, dev,
                               GRIN_SEED + 8))
        got = {}
        for sim in ('simulate_fused', 'simulate'):
            p = sc.init_params(dev)
            leaves = [p['rod'][k].requires_grad_(True) for k in GRIN_LEAVES]
            if name == 'mixed':
                leaves.append(p['lens']['c1'].requires_grad_(True))
            reset_counters()
            out = getattr(sc, sim)(p, rays, **sim_kw)
            loss = out[1].spot_rms(0)[0] ** 2
            if sim_kw:
                loss = loss + 1e-3 * out[2]['opl'].mean()
            g = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            got[sim] = dict(loss=float(loss.detach()), launches=counters(),
                            grads=[float(x) for x in g])
        f, e = got['simulate_fused'], got['simulate']
        want = (dict(trace_nonseq_fwd=1, trace_nonseq_bwd=1, grin=2)
                if name == 'ns' else
                dict(trace_seq_fwd=1, trace_seq_bwd=1, grin=2))
        check(only(f['launches'], **want),
              f'{name}: the fused grad step launched {f["launches"]}')
        err = [abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(f['grads'], e['grads'])]
        res[name] = dict(fused=f, eager=e, rel_err=err)
        check(max(err) <= GRIN_GRAD_RTOL,
              f'{name}: fused gradients {f["grads"]} vs eager {e["grads"]}')
    return res


def grin_design(rt, torch, dev, reset_counters, counters, only):
    """Example 24's design through simulate_fused (K1 + K2 each step):
    400 Adam steps on grin_A (the example's scale and rate) on its 256-ray
    fan -> dict; raises unless the spot RMS is under GRIN_DESIGN_RMS and the
    paraxial working distance of the fitted A within GRIN_WD_TOL of 8."""
    sc = grin_scene(rt, 'design')
    rays = grin_rays(rt, torch, 'design', GRIN_DESIGN_RAYS, dev, 0)

    def loss(p):
        return sc.simulate_fused(p, rays)[1].spot_rms(0)[0] ** 2
    t0 = time.perf_counter()
    reset_counters()
    p, hist = rt.fit(loss, sc.init_params(dev), trainable=sc.trainable(),
                     steps=GRIN_DESIGN_STEPS, lr=GRIN_DESIGN_LR,
                     scales={'rod': {'grin_A': GRIN_DESIGN_SCALE}})
    torch.cuda.synchronize()
    launches = counters()
    with torch.no_grad():
        rms = math.sqrt(float(loss(p)))
    A = float(p['rod']['grin_A'])
    g = math.sqrt(A)
    wd = math.cos(g * GRIN_DESIGN_L) / (GRIN_N0 * g * math.sin(
        g * GRIN_DESIGN_L))
    res = dict(seconds=time.perf_counter() - t0, launches=launches,
               grin_A=A, rms=rms, wd=wd, first_loss=float(hist[0]),
               last_loss=float(hist[-1]))
    steps = GRIN_DESIGN_STEPS
    check(only(launches, trace_seq_fwd=steps, trace_seq_bwd=steps,
               grin=2 * steps), f'the design launched {launches}')
    check(rms < GRIN_DESIGN_RMS, f'designed spot RMS {rms}')
    check(abs(wd - GRIN_DESIGN_WD) < GRIN_WD_TOL,
          f'paraxial wd of the fitted A {wd}')
    return res


def grin_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 20: GRIN rods, K1, K2, K5 and K6 in their instantiation with
    GRIN rods: each against its plain version at N_MAIN rays on the
    quarter-pitch rod, the relay, the mixed table (K1 and K2) and the two
    rods as Scenes (K5 and K6; K6's replay bit for bit, barrel and
    turning-point kills); the counted paths against example 24's anchors
    and the Scene against the SequentialScene; fused against eager
    gradients; example 24's design; times, bounds and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 20a. each kernel against its plain version
    kern = {}
    for name in GRIN_SEQ_CASES + GRIN_NS_CASES:
        t1 = time.perf_counter()
        kern[name] = grin_kernels_vs_plain(rt, torch, name, N_MAIN, dev,
                                           GRIN_SEED + 11)
        kern[name]['seconds'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    emit('grin_kernels_vs_plain', n=N_MAIN, **kern)

    # 20b. the counted paths, the gradients, the design
    paths = grin_paths(rt, torch, dev, reset_counters, counters, only)
    grads = grin_grad_check(rt, torch, dev, reset_counters, counters, only)
    design = grin_design(rt, torch, dev, reset_counters, counters, only)
    emit('grin_main', paths=paths, grads=grads, design=design)

    # 20c. times at N_MAIN against the plain versions, bounds and blocks
    timing, bounds, occ = {}, {}, {}
    for name in ('quarter', 'ns'):
        sc = grin_scene(rt, name)
        params = sc.init_params(dev)
        r = grin_rays(rt, torch, name, N_MAIN, dev, GRIN_SEED + 7)
        meta, cfg, flat, kinds, maps, ext = grin_inputs(rt, torch, sc,
                                                        params)
        g_rays, g_mom, _ = random_cotangents(torch, r.n, cfg, dev, SEED + 6)
        g_opl = g_rays[0]
        one = slice(0, GRIN_CHUNK)
        r1 = ray_slice(ft, r, one)
        g1 = [g[one] for g in g_rays]
        steps = max(m.grin_steps for m in meta)
        if name == 'ns':
            nb = sc.n_bounces
            kf = (lambda: fn.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, track_opl=True,
                grin=True))
            pf = (lambda: fn.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps, track_opl=True))
            bk = (lambda: fn.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
                opl=True, g_opl=g_opl, grin=True))
            bp = (lambda: fn.trace_nonseq_bwd_plain(
                flat, r1, cfg, meta, nb, g1, g_mom, maps=maps,
                g_opl=g_opl[one]))
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins, 0)
            rod = sum(w * grin_ops(m) for w, m in zip(wins, meta))
            # K6: the replay (K5 and its rods) and each rod winner's steps
            # reversed and couplings' adjoint, twice their size
            rod_rev = sum(w * (steps * GRIN_REV_STEP_OPS
                               + 2 * GRIN_COUPLE_OPS)
                          for w, m in zip(wins, meta) if m.grin_steps)
            timing['ns_work'] = dict(k5_row_scans=scans,
                                     k5_winners_per_row=wins)
            fwd_ops, bwd_ops = k5_ops + rod, k6_ops + rod + rod_rev
            keys = ('k5', 'k6')
        else:
            kf = (lambda: ft.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, track_opl=True, grin=True))
            pf = (lambda: ft.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, track_opl=True))
            bk = (lambda: ft.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                opl=True, g_opl=g_opl, grin=True))
            bp = (lambda: ft.trace_seq_bwd_plain(
                flat, r1, cfg, meta, g1, g_mom, maps=maps, g_opl=g_opl[one]))
            chain = r.n * sum(intersect_ops(m) + (grin_ops(m) or apply_ops(m))
                              for m in meta)
            # K2: the forward and an adjoint of twice its size, the rod's
            # steps reversed once in place of that estimate
            fwd_ops = chain
            bwd_ops = 3 * chain + r.n * steps * (GRIN_REV_STEP_OPS
                                                 - 2 * GRIN_STEP_OPS)
            keys = ('k1', 'k2')
        # the forward reads 9 streams and writes 7 and the path length and
        # medium; the backward reads the forward's inputs, 7 ray and 2
        # stream cotangents and writes 7 and its partials
        cols = len(ft.grad_cols((), True))
        io_f = r.n * (36 + 28 + 8) + table_bytes(meta)
        io_b = (r.n * (36 + 28 + 8 + 28) + table_bytes(meta)
                + -(-r.n // 256) * len(meta) * cols * 4)
        bounds[f'{keys[0]}_{name}'] = bound(io_f, fwd_ops)
        bounds[f'{keys[1]}_{name}'] = bound(io_b, bwd_ops)
        for key_, kfn, pfn, share in ((f'{keys[0]}_{name}', kf, pf, 1.0),
                                      (f'{keys[1]}_{name}', bk, bp,
                                       r.n / r1.n)):
            k_runs = time_ms(torch, kfn, warmup=2, reps=10)
            # the plain versions take 0.2-3 s a call: one call after one
            # warm-up
            p_runs = time_ms(torch, pfn, warmup=1, reps=1)
            # the plain backward runs GRIN_CHUNK rays (its graph of 1M
            # does not fit beside the rest): its time scaled to N_MAIN
            timing[key_] = dict(kernel_ms=statistics.median(k_runs),
                                plain_ms=statistics.median(p_runs) * share,
                                plain_rays=r.n / share, kernel_runs=k_runs)
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if name == 'ns'
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces if name == 'ns'
                else 0, ext=True, grin=True)
        torch.cuda.empty_cache()
    # what the K1, K2, K5 and K6 wrappers' read of the kinds tensor
    # (fused_trace.grin_rows: a copy to the host) adds to a launch whose
    # caller does not pass grin= (the traces do; the timings above too),
    # host µs
    reads = []
    for _ in range(200):
        t1 = time.perf_counter()
        ft.grin_rows(kinds)
        reads.append((time.perf_counter() - t1) * 1e6)
    timing['grin_rows_us'] = statistics.median(reads)
    emit('grin_timing', **timing)
    emit('grin_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('grin_occupancy', blocks_per_sm=occ)
    emit('grin_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, grads=grads, design=design,
                timing=timing, bounds=bounds)


# ---- 21. the kind mix: families of kinds together in one table ----

MIX_SEED = SEED + 2101
# A GRIN rod away from its turning point (8 of its quarter pitch's 15.7 mm,
# 16 RK4 steps) before a row of another family, a sensor after them
# (SequentialScenes, K1 and K2); the rod as a Scene beside a coated window
# and a grating (K5 and K6); and Scenes under the field with the families
# that K5's and K6's field instantiation took from this slice on: a DOE, a
# microlens array, a fuzzy (apodized) pupil before a singlet and example
# 19's freeform corrector (tilted, alone before a sensor: a shallow
# Scene).
MIX_SEQ_CASES = ('fresnel_w', 'fresnel_mc', 'coated', 'doe', 'fuzzy',
                 'freeform')
MIX_NS_CASES = ('ns',)
MIX_FIELD_CASES = ('field_doe', 'field_mla', 'field_pupil', 'field_ff')
MIX_ROD_L, MIX_ROD_STEPS = 8.0, 16
MIX_NS_BOUNCES, MIX_FIELD_BOUNCES = 6, 3
MIX_WL = 0.55
MIX_E0 = (0.6, 0.8, 0.0)
# The plain versions run MIX_CHUNK rays at a time (GRIN_CHUNK's reason).
MIX_CHUNK = 250_000


def mix_apodizer(xp):
    """exp(-(x^2 + y^2) / 32) of the array module ``xp`` (torch or
    jax.numpy): the fuzzy case's component-style callable."""
    def apod(x, y, z):
        return xp.exp(-(x * x + y * y) / 32.0)
    return apod


def mix_scene(rt, name, xp):
    """A section 21 case's scene (both packages: ``rt``; ``xp`` the array
    module of the fuzzy case's apodizer)."""
    import importlib
    kinds = importlib.import_module(rt.__name__ + '.constants').PhysKind
    shapes = importlib.import_module(rt.__name__ + '.elements.shapes')
    z = MIX_ROD_L + 7.0

    def sensor(zs, r=12.0):
        return rt.SensorElement(radius=r, translation=[0.0, 0.0, zs],
                                name='s')
    if name in MIX_SEQ_CASES:
        if name == 'fresnel_w':
            # tests/test_grin.py:283's FRESNEL_W plate, tilted 0.4 rad so
            # that the rod's rays cross it clear of total reflection
            other = rt.ElementCustom(
                shapes.disk, 1, kinds.FRESNEL_W, ph=(1.0, 1.5),
                extra={'radius': 30.0}, rotation=[0.0, 0.4, 0.0],
                translation=[0.0, 0.0, z], name='plate')
        elif name == 'fresnel_mc':
            other = rt.SingletLens(c1=0.0, c2=0.0, d=20.0, t=2.0,
                                   ior_glass=1.5, fresnel=True,
                                   translation=[0.0, 0.0, z], name='window')
        elif name == 'coated':
            other = rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0,
                                   ior_glass=1.5, fresnel='weighted',
                                   coating=[(COAT_NC, COAT_QW)],
                                   translation=[0.0, 0.0, z], name='lens')
        elif name == 'doe':
            # tests/test_doe.py:133's DiffractiveLens
            other = rt.DiffractiveLens(radius=10.0, coeffs=[-8.0, 0.02],
                                       efficiency=True,
                                       translation=[0.0, 0.0, z], name='doe')
        elif name == 'fuzzy':
            other = rt.FuzzyAperture(mix_apodizer(xp), components=True,
                                     translation=[0.0, 0.0, z], name='apod')
        else:
            other = rt.FreeformLens(c1=0.0, c2=0.0, d=20.0, t=2.0,
                                    ior_glass=1.5,
                                    xy1=[(2, 0, 2e-3), (0, 2, -1e-3),
                                         (2, 1, 1e-4)],
                                    translation=[0.0, 0.0, z], name='ff')
        return rt.SequentialScene([
            grin_rod(rt, MIX_ROD_L, 0.0, n_steps=MIX_ROD_STEPS), other,
            sensor(z + 15.0)])
    if name == 'ns':
        return rt.Scene([
            grin_rod(rt, MIX_ROD_L, 0.0, n_steps=MIX_ROD_STEPS),
            rt.SingletLens(c1=0.0, c2=0.0, d=20.0, t=2.0, ior_glass=1.5,
                           fresnel='weighted', coating=[(COAT_NC, COAT_QW)],
                           translation=[0.0, 0.0, z], name='window'),
            rt.DiffractionGrating(period_um=10.0, order=1,
                                  translation=[0.0, 0.0, z + 8.0], name='g'),
            sensor(z + 25.0, 20.0)], n_bounces=MIX_NS_BOUNCES)
    nb = MIX_FIELD_BOUNCES
    if name == 'field_doe':
        return rt.Scene([rt.DiffractiveLens(radius=10.0, coeffs=[-8.0, 0.02],
                                            efficiency=True, name='doe'),
                         sensor(40.0, 50.0)], n_bounces=nb)
    if name == 'field_mla':
        return rt.Scene([rt.MicrolensArray(half_x=4.0, half_y=4.0, pitch=1.0,
                                           f=10.0, name='mla'),
                         sensor(10.0, 8.0)], n_bounces=nb)
    if name == 'field_pupil':
        # an apodized pupil before the bench singlet
        return rt.Scene([
            rt.FuzzyAperture(mix_apodizer(xp), components=True, name='apod'),
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           c1_grad=True, translation=[0.0, 0.0, 6.0],
                           name='lens'),
            sensor(25.0)], n_bounces=nb + 1)
    # example 19's freeform corrector, tilted so that no ray meets it at
    # normal incidence (where the field's s and p basis is undefined and
    # its cotangents cancel in float32), before a sensor
    return rt.Scene([
        rt.FreeformLens(c1=0.0, c2=0.0, d=24.0, t=2.0, ior_glass=EX19_GLASS,
                        translation=[0, 0, 20.0], rotation=[0.2, 0.0, 0.0],
                        xy1=[(i, j, c) for (i, j), c in zip(EX19_TERMS,
                                                             EX19_COEFFS)],
                        xy1_grad=True, name='corrector'),
        sensor(40.0)], n_bounces=nb)


def mix_source(name):
    """(radius, translation, wavelength) of a section 21 case's collimated
    disk (the JAX package's CollimatedDisk, reference_prng.collimated_disk's
    draws)."""
    if name == 'fresnel_w':
        # the rod's beam kept clear of grazing incidence on the plate, where
        # 1 - R takes the rod's rounding at many times its size
        return 2.0, (0.0, 0.0, -3.0), MIX_WL
    if name in MIX_SEQ_CASES or name == 'ns':
        return 4.0, (0.0, 0.0, -3.0), MIX_WL
    if name == 'field_pupil':
        return 4.0, (0.0, 0.0, -3.0), 0.5876
    if name == 'field_ff':
        return EX19_BEAM, (0.0, 0.0, -10.0), 0.5876
    return (6.0 if name == 'field_doe' else 3.5), (0.0, 0.0, -5.0), MIX_WL


def mix_rays(rt, torch, name, n, device, seed=MIX_SEED):
    """A section 21 case's rays: the JAX package's very collimated disk
    under PRNGKey(seed) (reference_prng), on ``device``."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    radius, trans, wl = mix_source(name)
    return rp.collimated_disk(rp.prng_key(seed), n, radius, trans, wl,
                              device=device)


def mix_uniforms(torch, meta, n, device, seed=MIX_SEED):
    """The FRESNEL rows' [F, N] uniforms the JAX package draws under
    PRNGKey(seed) (reference_prng.fresnel_uniforms); None without a
    FRESNEL row."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    u = rp.fresnel_uniforms(rp.prng_key(seed), meta, n, device)
    return u if u.shape[0] else None


def mix_stats(torch, out, sens, aux=None):
    """A section 21 case's numbers: the sensor's total weight, centroid and
    RMS spot size (slot 0, bundle 0), the mean intensity and, under the
    field, the mean |E|^2."""
    m = sens.moments[0, 0].double()
    w = float(m[0])
    cx, cy = float(m[1] / m[0]), float(m[2] / m[0])
    var = float(m[3] / m[0] - (m[1] / m[0]) ** 2
                + m[4] / m[0] - (m[2] / m[0]) ** 2)
    res = dict(weight=w, cx=cx, cy=cy, rms=math.sqrt(max(var, 0.0)),
               mean_intensity=float(out.intensity.double().mean()))
    if aux is not None and 'field_power' in aux:
        res['field_power'] = float(aux['field_power'].double().mean())
    return res


# The leaves of each case's fused-against-eager gradient (and
# tests/test_torch_kind_mix.py's against jax.grad): the rod's and the other
# row's, or the field case's element's.
MIX_LEAVES = {'fresnel_w': (('rod', 'n0'), ('rod', 'grin_A')),
              'fresnel_mc': (('rod', 'grin_A'), ('rod', 't')),
              'coated': (('rod', 'grin_A'), ('lens', 'coat_d')),
              'doe': (('rod', 'n0'), ('doe', 'phase')),
              'fuzzy': (('rod', 'grin_A'), ('rod', 't')),
              'freeform': (('rod', 'grin_A'), ('ff', 'xy1')),
              'ns': (('rod', 'grin_A'), ('window', 'coat_d')),
              'field_doe': (('doe', 'phase'),),
              'field_mla': (('mla', 'f'),),
              'field_pupil': (('lens', 'c1'), ('s', 'trans')),
              'field_ff': (('corrector', 'xy1'),)}
# The counted paths at N_MAIN against the JAX package's numbers on its own
# rays (its CollimatedDisk under PRNGKey(MIX_SEED), its FRESNEL draws under
# the same key), recorded on the CPU by `JAX_PLATFORMS=cpu python
# tests/mix_anchors.py`: the sensor's weight, centroid and RMS, the mean
# intensity and, under the field, the mean |E|^2.  Each is held within
# MIX_REF_RTOL (MOMENT_RTOL: sums over 1M rays in another order) of its
# value, a centroid of its value and the spot's RMS (its moment's scale).
MIX_REF = {
    'fresnel_w': {'weight': 941725.1875, 'cx': -3.7585975685714574,
        'cy': -0.005795567130850209, 'rms': 4.574830961074835,
        'mean_intensity': 0.9505330733476282},
    'fresnel_mc': {'weight': 920656.0, 'cx': -0.006971004341096185,
        'cy': -0.006303822865163535, 'rms': 6.00249622179683,
        'mean_intensity': 1.0},
    'coated': {'weight': 971384.1875, 'cx': -0.007373914861955687,
        'cy': -0.0071581708595344, 'rms': 5.391130171365142,
        'mean_intensity': 0.9713841186243296},
    'doe': {'weight': 984718.375, 'cx': -0.008637585205198898,
        'cy': -0.00822121606041042, 'rms': 6.150108588404815,
        'mean_intensity': 0.9847187399864197},
    'fuzzy': {'weight': 983446.625, 'cx': -0.008608307082120497,
        'cy': -0.008276478754153282, 'rms': 6.241491375155073,
        'mean_intensity': 0.9834465917540193},
    'freeform': {'weight': 1000000.0, 'cx': -0.008444048828125,
        'cy': -0.00812194189453125, 'rms': 6.00092165688732,
        'mean_intensity': 1.0},
    'ns': {'weight': 971313.875, 'cx': 1.0551518426523043,
        'cy': -0.012943751382631078, 'rms': 9.731984377264288,
        'mean_intensity': 0.9713138532560468},
    'field_doe': {'weight': 968798.8125, 'cx': 0.003056979032217796,
        'cy': -1.314209651758837, 'rms': 2.6161957368137982,
        'mean_intensity': 0.9847187399864197,
        'field_power': 0.9838329928219653},
    'field_mla': {'weight': 1000000.0625, 'cx': 0.0031769998014375125,
        'cy': 0.0031999998000000127, 'rms': 2.494256758603647,
        'mean_intensity': 1.0, 'field_power': 1.0},
    'field_pupil': {'weight': 582470.375, 'cx': 6.477163432730177e-05,
        'cy': 0.0001436354705113892, 'rms': 0.16396900335527137,
        'mean_intensity': 0.7869024709564447,
        'field_power': 0.7251148800349235},
    'field_ff': {'weight': 918612.3125, 'cx': 0.007414565151328461,
        'cy': -0.13209596989263084, 'rms': 5.6593887090032835,
        'mean_intensity': 1.0, 'field_power': 0.9186124250827432}}
MIX_REF_RTOL = MOMENT_RTOL


def mix_inputs(rt, torch, sc, params, name, device):
    """(meta, cfg, flat, kinds, maps, ext, the wrappers' family arguments) of
    a section 21 case, as its fused trace passes them."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    meta = ft.TraceMeta(sc.static_meta(), sc.fuzzy_fns(),
                        name in MIX_FIELD_CASES)
    cfg = sc.sensor_config()
    flat = rt.flatten_table_rows(sc.build_table(params)).detach()
    kinds = torch.tensor(ft.kind_rows(meta, cfg), dtype=torch.int32,
                         device=device)
    side = dict(fresnel=ft.fresnel_kinds(meta), grin=ft.grin_kinds(meta),
                **fn.side_buffers(meta, device))
    return meta, cfg, flat, kinds, ft.plate_maps(meta, {}), ft.ext_kinds(
        meta), side


def mix_family_counts(meta, launches):
    """The family counters a launch of the family instantiation on ``meta``
    moves (one count in each of its families): {counter: launches}."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    fam = ft.families(meta)
    names = ((ft.FAM_FRESNEL, 'fresnel'), (ft.FAM_COAT, 'coat'),
             (ft.FAM_DIFF, 'diff'), (ft.FAM_FUZZY, 'fuzzy'),
             (ft.FAM_FREEFORM, 'freeform'), (ft.FAM_GRIN, 'grin'))
    return {k: launches for bit, k in names if fam & bit}


def mix_kernels_vs_plain(rt, torch, name, n, device, seed=MIX_SEED):
    """The family instantiation of K1 and K2 (a sequential case) or of K5
    and K6 (the Scene) against their plain versions on a section 21 case at
    n rays, with the path length: the rays, moments, path lengths and final
    media of the rays both trace alike (sections 3's, 10's and 20's rules;
    behind a weighting Fresnel row intensities within FRESNEL_I_RTOL), then
    on those rays under seeded cotangents the ray and table cotangents
    (BWD_TOL; with the diffractive kinds DISP_BWD_TOL, as section 13) and
    K6's
    replay against K5 bit for bit -> dict; raises on a breach.  The field
    cases run section 19's field_ns_kernels_vs_plain.  The plain backward
    runs MIX_CHUNK rays at a time."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    if name in MIX_FIELD_CASES:
        return field_ns_kernels_vs_plain(rt, torch, name, n, device, seed)
    sc = mix_scene(rt, name, torch)
    params = sc.init_params(device)
    rays = mix_rays(rt, torch, name, n, device, seed)
    meta, cfg, flat, kinds, maps, ext, side = mix_inputs(rt, torch, sc,
                                                         params, name, device)
    nonseq = name in MIX_NS_CASES
    u = None if nonseq else mix_uniforms(torch, meta, n, device, seed)
    weighted = any(m.ph in (8, 9) or m.n_coat for m in meta)
    # behind a weighting Fresnel row (FRESNEL_I_RTOL) or a fuzzy program
    # (FUZZY_I_RTOL, section 14's) the intensities within a share
    i_rtol = max(FRESNEL_I_RTOL if weighted else 0.0,
                 FUZZY_I_RTOL if ft.fuzzy_kinds(meta) else 0.0)
    if nonseq:
        nb = sc.n_bounces
        out_k, s_k, aux_k = fn.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, ext, track_opl=True, **side)
        out_p, s_p, aux_p = fn.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, nb, maps, track_opl=True)
    else:
        out_k, s_k, aux_k = ft.trace_seq_fwd_cuda(
            flat, kinds, rays, cfg, maps, ext, track_opl=True, uniforms=u,
            **side)
        out_p, s_p, aux_p = ft.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps, track_opl=True, uniforms=u)
    torch.cuda.synchronize()
    if nonseq:
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
        pos = torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                           for c in ('px', 'py', 'pz')]).amax(0)
        apart = ((pos > NS_POS_TOL)
                 | ((out_k.intensity - out_p.intensity).abs() > NS_INT_TOL))
    else:
        res = compare(torch, out_k, s_k, out_p, s_p, i_rtol)
        apart = traced_apart(torch, out_k, out_p, i_rtol)[0]
    res.update(compare_streams(
        torch, *({k: v[~apart] for k, v in aux.items()}
                 for aux in (aux_k, aux_p))))
    res.update(rows=len(meta), apart=int(apart.sum()),
               families=ft.families(meta),
               killed=int(((rays.intensity > 0)
                           & (out_k.intensity == 0)).sum()))
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, device,
                                         seed + 2)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    g_opl, g_nf = (torch.randn(rays.n, generator=gen, device=device)
                   for _ in range(2))

    def part(sl):
        r = ray_slice(ft, rays, sl)
        gr = [g[sl] for g in g_rays]
        if nonseq:
            return fn.trace_nonseq_bwd_plain(flat, r, cfg, meta, nb, gr,
                                             g_mom, maps=maps,
                                             g_opl=g_opl[sl],
                                             g_nfinal=g_nf[sl])
        return ft.trace_seq_bwd_plain(
            flat, r, cfg, meta, gr, g_mom, maps=maps, g_opl=g_opl[sl],
            g_nfinal=g_nf[sl], uniforms=None if u is None else u[:, sl])
    g_p = join_chunks(torch, [part(sl)
                              for sl in ray_chunks(rays.n, MIX_CHUNK)])
    if nonseq:
        g_k = fn.trace_nonseq_bwd_cuda(
            flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
            opl=True, g_opl=g_opl, g_nfinal=g_nf, replay=True, **side)
        out_r = fn.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, nb, maps,
                                         ext, track_opl=True, **side)[0]
        torch.cuda.synchronize()
        res['replay_equal'] = all(torch.equal(getattr(g_k[-1], c),
                                              getattr(out_r, c))
                                  for c in ft.COMPS)
        check(res['replay_equal'], f'{name}: K6 replay differs from K5')
        allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n))
    else:
        g_k = ft.trace_seq_bwd_cuda(flat, kinds, rays, cfg, g_rays, g_mom,
                                    maps=maps, ext=ext, opl=True,
                                    g_opl=g_opl, g_nfinal=g_nf, uniforms=u,
                                    **side)
        torch.cuda.synchronize()
        allowed = None
    res['bwd'] = compare_ray_cotangents(
        torch, g_k[1], g_p[1], allowed=allowed,
        tol=DISP_BWD_TOL if side['diff'] else BWD_TOL)
    res['bwd'].update(compare_table_cotangents(
        torch, ft, g_k[0], g_p[0], plates=True, ext=True,
        coat=side['coat'] is not None, diff=side['diff'],
        freeform=side['ff'] is not None))
    return res


def mix_loss(sens):
    """A section 21 case's loss: the spot's mean square radius and a share
    of its weight."""
    return sens.spot_rms(0)[0] ** 2 + 1e-3 * sens.total_weight(0)[0]


def mix_paths(rt, torch, dev, reset_counters, counters, only):
    """The counted paths at N_MAIN: each case through simulate_fused (K1 or
    K5 once, in the family instantiation or the field's) against the JAX
    package's numbers (MIX_REF), and a grad step of GRIN_GRAD_RAYS rays in
    the case's leaves (K1 + K2 or K5 + K6 once each) against the eager
    trace's gradients (GRIN_GRAD_RTOL of the leaf's scale) -> dict; raises
    on a breach."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    res = {}
    for name in MIX_SEQ_CASES + MIX_NS_CASES + MIX_FIELD_CASES:
        sc = mix_scene(rt, name, torch)
        meta = ft.TraceMeta(sc.static_meta(), sc.fuzzy_fns(),
                            name in MIX_FIELD_CASES)
        fwd, bwd = (('trace_seq_fwd', 'trace_seq_bwd') if sc.sequential
                    else ('trace_nonseq_fwd', 'trace_nonseq_bwd'))
        kw = {}
        if name in MIX_FIELD_CASES:
            kw.update(track_field=True, E0=list(MIX_E0))
        ent = {}
        for n, label in ((N_MAIN, 'forward'), (GRIN_GRAD_RAYS, 'grad')):
            rays = mix_rays(rt, torch, name, n, dev)
            u = mix_uniforms(torch, meta, n, dev)
            kw_n = dict(kw, uniforms=u) if u is not None else dict(kw)
            if label == 'forward':
                reset_counters()
                with torch.no_grad():
                    out, sens, *aux = sc.simulate_fused(
                        sc.init_params(dev), rays, **kw_n)
                torch.cuda.synchronize()
                fl = counters()
                want = ({fwd: 1, 'field': 1} if name in MIX_FIELD_CASES
                        else {fwd: 1, **mix_family_counts(meta, 1)})
                check(only(fl, **want), f'{name} launched {fl}')
                st = mix_stats(torch, out, sens, aux[0] if aux else None)
                ent['forward'] = dict(launches=fl, **st)
                ref = MIX_REF.get(name)
                if ref is not None:
                    err = {k: abs(st[k] - v) for k, v in ref.items()}
                    ent['ref_err'] = err
                    check(all(err[k] <= MIX_REF_RTOL * (
                        abs(v) + (ref['rms'] if k in ('cx', 'cy') else 0.0))
                        for k, v in ref.items()),
                          f'{name}: {st} vs the JAX package {ref}')
                continue
            got = {}
            for sim in ('simulate_fused', 'simulate'):
                p = sc.init_params(dev)
                leaves = [p[el][k].requires_grad_(True)
                          for el, k in MIX_LEAVES[name]]
                reset_counters()
                g = torch.autograd.grad(
                    mix_loss(getattr(sc, sim)(p, rays, **kw_n)[1]), leaves)
                torch.cuda.synchronize()
                got[sim] = dict(launches=counters(),
                                grads=[x.detach().flatten().tolist()
                                       for x in g])
            f, e = got['simulate_fused'], got['simulate']
            want = ({fwd: 1, bwd: 1, 'field': 2} if name in MIX_FIELD_CASES
                    else {fwd: 1, bwd: 1, **mix_family_counts(meta, 2)})
            check(only(f['launches'], **want),
                  f'{name}: the fused grad step launched {f["launches"]}')
            err = [max(abs(a - b) for a, b in zip(fa, ea))
                   / max(max(abs(b) for b in ea), 1e-30)
                   for fa, ea in zip(f['grads'], e['grads'])]
            ent['grad'] = dict(fused=f, eager=e, rel_err=err)
            check(max(err) <= GRIN_GRAD_RTOL,
                  f'{name}: fused gradients {f["grads"]} vs eager '
                  f'{e["grads"]}')
        res[name] = ent
        torch.cuda.empty_cache()
    return res


def mix_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 21: the kind mix, K1, K2, K5 and K6 in their family
    instantiation (and K5 and K6 in the field's) on tables that mix
    families: each against its plain version at N_MAIN rays (K6's replay
    bit for bit); the counted paths against the JAX package's numbers and
    fused against eager gradients; times, bounds and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 21a. each kernel against its plain version
    kern = {}
    for name in MIX_SEQ_CASES + MIX_NS_CASES + MIX_FIELD_CASES:
        t1 = time.perf_counter()
        kern[name] = mix_kernels_vs_plain(rt, torch, name, N_MAIN, dev)
        kern[name]['seconds'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    emit('mix_kernels_vs_plain', n=N_MAIN, **kern)

    # 21b. the counted paths and the gradients
    paths = mix_paths(rt, torch, dev, reset_counters, counters, only)
    emit('mix_main', paths=paths)

    # 21c. times at N_MAIN against the plain versions, bounds and blocks:
    # the family instantiation of K1 and K2 on the rod and the coated
    # singlet, of K5 and K6 on the Scene, the field's on the freeform
    # corrector
    timing, bounds, occ = {}, {}, {}
    for name, keys in (('coated', ('k1', 'k2')), ('ns', ('k5', 'k6')),
                       ('field_ff', ('k5f', 'k6f'))):
        sc = mix_scene(rt, name, torch)
        params = sc.init_params(dev)
        r = mix_rays(rt, torch, name, N_MAIN, dev, MIX_SEED + 7)
        meta, cfg, flat, kinds, maps, ext, side = mix_inputs(
            rt, torch, sc, params, name, dev)
        g_rays, g_mom, _ = random_cotangents(torch, r.n, cfg, dev, SEED + 6)
        one = slice(0, MIX_CHUNK)
        r1 = ray_slice(ft, r, one)
        g1 = [g[one] for g in g_rays]
        field = field1 = None
        if name in MIX_FIELD_CASES:
            from raytracetorch_tpu_torch.core.field import FieldState
            field = FieldState.init(r, list(MIX_E0)).streams()
            field1 = [f[one] for f in field]
        g_field = [g_rays[0]] * 6 if field is not None else None
        g_field1 = [g_rays[0][one]] * 6 if field is not None else None
        cols = len(ft.grad_cols((), True, ft.dispersive(meta),
                                side['coat'] is not None, side['diff'],
                                side['ff'] is not None))
        prog = fuzzy_program_ops(meta) if ft.fuzzy_kinds(meta) else \
            [0] * len(meta)
        row = [intersect_ops(m) + (grin_ops(m) or apply_ops(m))
               + coat_ops(m) + prog[k] for k, m in enumerate(meta)]
        if sc.sequential:
            kf = (lambda: ft.trace_seq_fwd_cuda(
                flat, kinds, r, cfg, maps, ext, track_opl=True, **side))
            pf = (lambda: ft.trace_sequential_fused_plain(
                flat, r, cfg, meta, maps, track_opl=True))
            bk = (lambda: ft.trace_seq_bwd_cuda(
                flat, kinds, r, cfg, g_rays, g_mom, maps=maps, ext=ext,
                opl=True, g_opl=g_rays[0], **side))
            bp = (lambda: ft.trace_seq_bwd_plain(
                flat, r1, cfg, meta, g1, g_mom, maps=maps, g_opl=g1[0]))
            steps = max(m.grin_steps for m in meta)
            fwd_ops = r.n * sum(row)
            # K2: the forward and an adjoint of twice its size, the rod's
            # steps reversed once in place of that estimate (section 20)
            bwd_ops = 3 * fwd_ops + r.n * steps * (GRIN_REV_STEP_OPS
                                                   - 2 * GRIN_STEP_OPS)
        else:
            nb = sc.n_bounces
            kf = (lambda: fn.trace_nonseq_fwd_cuda(
                flat, kinds, r, cfg, nb, maps, ext, track_opl=True,
                field=field, **side))
            pf = (lambda: fn.trace_nonseq_fused_plain(
                flat, r, cfg, meta, nb, maps, track_opl=True, field=field))
            bk = (lambda: fn.trace_nonseq_bwd_cuda(
                flat, kinds, r, cfg, nb, g_rays, g_mom, maps=maps, ext=ext,
                opl=True, g_opl=g_rays[0], field=field, g_field=g_field,
                **side))
            bp = (lambda: fn.trace_nonseq_bwd_plain(
                flat, r1, cfg, meta, nb, g1, g_mom, maps=maps,
                g_opl=g1[0], field=field1, g_field=g_field1))
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            replayed = segment_replays(
                lives, fn.K6_FIELD_CHECKPOINTS if field is not None
                else fn.K6_CHECKPOINTS)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins, replayed)
            extra = sum(w * (grin_ops(m) + coat_ops(m) + prog[k]
                             + (field_coat_row_ops(m) if field else 0))
                        for k, (w, m) in enumerate(zip(wins, meta)))
            fwd_ops, bwd_ops = k5_ops + extra, k6_ops + 3 * extra
            timing[f'{name}_work'] = dict(k5_row_scans=scans,
                                          k5_winners_per_row=wins,
                                          k6_replayed=replayed)
        # the forward reads 9 streams (and the launch field) and writes 7,
        # the path length and medium (and the final field); the backward
        # reads the forward's inputs, 7 ray and 2 stream cotangents (and 6
        # field cotangents) and writes 7 (and 6) and its partials
        f_io = 48 if field is not None else 0
        io_f = r.n * (36 + 28 + 8 + 2 * f_io) + table_bytes(meta)
        io_b = (r.n * (36 + 28 + 8 + 28 + 3 * f_io) + table_bytes(meta)
                + -(-r.n // 256) * len(meta) * cols * 4)
        bounds[f'{keys[0]}_{name}'] = bound(io_f, fwd_ops)
        bounds[f'{keys[1]}_{name}'] = bound(io_b, bwd_ops)
        for key_, kfn, pfn, share in ((f'{keys[0]}_{name}', kf, pf, 1.0),
                                      (f'{keys[1]}_{name}', bk, bp,
                                       r.n / r1.n)):
            k_runs = time_ms(torch, kfn, warmup=2, reps=10)
            p_runs = time_ms(torch, pfn, warmup=1, reps=1)
            timing[key_] = dict(kernel_ms=statistics.median(k_runs),
                                plain_ms=statistics.median(p_runs) * share,
                                plain_rays=r.n / share, kernel_runs=k_runs)
        libs = (('trace_seq_fwd', 'trace_seq_bwd') if sc.sequential
                else ('trace_nonseq_fwd', 'trace_nonseq_bwd'))
        words = 0 if side['fuzzy'] is None else int(side['fuzzy'].numel())
        for lib in libs:
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, getattr(sc, 'n_bounces', 0),
                ext=True, disp=ft.dispersive(meta), fresnel=side['fresnel'],
                coat=side['coat'] is not None, diff=side['diff'],
                fuzzy_words=words, freeform=side['ff'] is not None,
                grin=side['grin'], field=field is not None)
        torch.cuda.empty_cache()
    emit('mix_timing', **timing)
    emit('mix_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('mix_occupancy', blocks_per_sm=occ)
    emit('mix_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds)


# ---- 22. the polarized field through GRIN rods ----

GRIN_FIELD_SEED = SEED + 2201
# The cases (both packages: grin_field_scene): the quarter-pitch rod of
# section 20 (64 RK4 steps) with its sensor GRIN_FIELD_DEFOCUS past the
# focus (a spot loss away from a focus: at it, n0's gradient is float32
# rounding, ROADMAP Queue 3), lit by a 0.5 mm collimated disk, E0 at 53
# degrees to x (K1, K2); tests/test_grin.py:283's 25 mm rod before a
# FRESNEL_W plate at Brewster's angle to the exit of a ray launched at x =
# GRIN_FIELD_X, lit by a GRIN_FIELD_BEAM disk about that ray, p-polarized
# there (T_p = 1 only for a field carried correctly through the rod; K1,
# K2), its media ordered (glass, air) so that the ray enters the glass
# (with tests/test_grin.py's (1.0, 1.5) it meets the plate from the glass
# side and is totally reflected, with the same unit weight); and section
# 20's 30 mm rod as a 4-bounce Scene lit by an off-axis
# point source (skew rays, whose field the rod turns out of their planes),
# circular E0 (K5, K6).  The rays are the JAX package's own
# (rays/reference_prng.py), so that the counted paths compare with its
# numbers.
GRIN_FIELD_SEQ_CASES = ('quarter', 'brewster')
GRIN_FIELD_NS_CASES = ('ns',)
GRIN_FIELD_CASES = GRIN_FIELD_SEQ_CASES + GRIN_FIELD_NS_CASES
GRIN_FIELD_DEFOCUS = 2.0
GRIN_FIELD_L, GRIN_FIELD_X, GRIN_FIELD_BEAM = 25.0, 2.0, 0.05
GRIN_FIELD_GLASS = 1.5
GRIN_FIELD_NA, GRIN_FIELD_SRC = 0.15, (1.5, 0.5, -3.0)
GRIN_FIELD_E0 = {'quarter': [0.6, 0.8, 0.0], 'brewster': [1.0, 0.0, 0.0],
                 'ns': [complex(math.sqrt(0.5)), complex(0.0, math.sqrt(0.5)),
                        0.0]}
# The grad step's leaves (the rod's n0 and grin_A, and E0) and rays (the
# section's time: with 65,536 rays here it took 83 s).
GRIN_FIELD_LEAVES = ('n0', 'grin_A')
GRIN_FIELD_GRAD_RAYS = 16_384
# The counted paths at N_MAIN against the JAX package's numbers on its own
# rays, recorded on the CPU by `JAX_PLATFORMS=cpu python
# tests/grin_field_anchors.py`: the sensor's weight, centroid and RMS, the
# mean intensity and the mean |E|^2, held as section 21 holds them (the
# mean |E|^2 within FIELD_REF_ATOL); the Brewster case's mean intensity, T_p
# over the beam, also within FIELD_NS_TP_ATOL of 1.
GRIN_FIELD_REF = {
    'quarter': {'weight': 1000000.0, 'cx': 9.880071258544921e-05, 'cy':
        2.014238357543945e-05, 'rms': 0.11384701429872822, 'mean_intensity':
        1.0, 'field_power': 1.0000001197947859},
    'brewster': {'weight': 999998.0625, 'cx': 0.7892175291089627, 'cy':
        3.264555580447531e-05, 'rms': 0.19408834308199094, 'mean_intensity':
        0.9999982703154683, 'field_power': 0.9999998037086725},
    'ns': {'weight': 1000000.0, 'cx': -1.611028375, 'cy': -0.537445, 'rms':
        0.8061341060393481, 'mean_intensity': 1.0, 'field_power':
        0.9999999535813928}}
# The field's work a rod step adds (csrc/grin.cuh): two rotate_between of
# its direction (the field's real and imaginary parts, ~37 operations
# each) and one more _p_dir (~18); the couplings' two rotations, two
# _p_dir and the frame's two rotations of both parts ~250 a ray.  Their
# reverse is counted at twice the forward's size.
GRIN_FIELD_STEP_OPS, GRIN_FIELD_COUPLE_OPS = 92, 250


def grin_exit_angle(x0, L):
    """The exit direction's angle to the axis (about y) of a ray entering
    a rod of GRIN_N0 and GRIN_A0 parallel to the axis at x0: in the
    parabolic profile n^2 = n0^2 (1 - A r^2) pz is conserved, x = x0 cos(w
    z) with w = n0 sqrt(A) / pz, and the exit's px = -x0 n0 sqrt(A)
    sin(w L) (the rod's exact ray; its 64 RK4 steps lie within 1e-9)."""
    pz = GRIN_N0 * math.sqrt(1.0 - GRIN_A0 * x0 * x0)
    px = -x0 * GRIN_N0 * math.sqrt(GRIN_A0) * math.sin(
        GRIN_N0 * math.sqrt(GRIN_A0) / pz * L)
    return math.atan2(px, math.sqrt(1.0 - px * px))


def grin_field_scene(rt, name):
    """A section 22 case's scene (both packages: ``rt``)."""
    import importlib
    from raytracetorch_tpu_torch.constants import PhysKind
    if name == 'ns':
        return grin_scene(rt, 'ns')
    if name == 'quarter':
        return rt.SequentialScene([
            grin_rod(rt, GRIN_LQ, 0.0),
            rt.SensorElement(radius=3.0, translation=[
                0.0, 0.0, GRIN_LQ + GRIN_FIELD_DEFOCUS], name='s')])
    shapes = importlib.import_module(rt.__name__ + '.elements.shapes')
    L = GRIN_FIELD_L
    tilt = (grin_exit_angle(GRIN_FIELD_X, L)
            + math.atan(GRIN_FIELD_GLASS))
    return rt.SequentialScene([
        grin_rod(rt, L, 0.0),
        rt.ElementCustom(shapes.disk, 1, PhysKind.FRESNEL_W,
                         ph=(GRIN_FIELD_GLASS, 1.0), extra={'radius': 30.0},
                         rotation=[0.0, tilt, 0.0],
                         translation=[0.0, 0.0, L + 20.0], name='plate'),
        rt.SensorElement(radius=30.0, translation=[0.0, 0.0, L + 60.0],
                         name='s')])


def grin_field_rays(rt, torch, name, n, device, seed=GRIN_FIELD_SEED):
    """A section 22 case's rays: the JAX package's CollimatedDisk (or, for
    the Scene, PointSource) under PRNGKey(seed)."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    key = rp.prng_key(seed)
    if name == 'ns':
        return rp.point_source(key, n, GRIN_FIELD_NA, GRIN_FIELD_SRC,
                               device=device)
    if name == 'quarter':
        return rp.collimated_disk(key, n, 0.5, (0.0, 0.0, -3.0),
                                  device=device)
    return rp.collimated_disk(key, n, GRIN_FIELD_BEAM,
                              (GRIN_FIELD_X, 0.0, -3.0), device=device)


def grin_field_loss(torch, sens, aux):
    """The grad step's loss: the spot's RMS^2, the weight (through the
    Brewster plate's polarized T) and the final field's mean x component
    (through the rod's rotations)."""
    return (sens.spot_rms(0)[0] ** 2 + 1e-6 * sens.total_weight(0)[0]
            + 1e-3 * aux['field'].erx.mean())


def grin_field_kernels_vs_plain(rt, torch, name, n, device):
    """K1 and K2 (the sequential cases) or K5 and K6 (the Scene) in their
    instantiation with the field and GRIN rods against their plain versions
    on a section 22 case: the rays, moments and the final field's six
    streams and |E|^2 (sections 19's and 20's rules: compare_field, the NS
    rule's count on the Scene); then under seeded cotangents (the final
    field's too), on the rays both trace alike, the ray, table and
    launch-field cotangents (the launch field's on the rays whose geometry
    cotangents agree), and K6's replay against K5 bit for bit, its field
    too -> dict; raises on a breach.  The plain versions run GRIN_CHUNK
    rays at a time, and the dict's ``timing`` holds the ms of the compared
    call of each (one call) beside the kernels' runs on the same inputs
    (time_ms, 10 after 2)."""
    from raytracetorch_tpu_torch.ops import fused_nonseq as fn
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    sc = grin_field_scene(rt, name)
    params = sc.init_params(device)
    rays = grin_field_rays(rt, torch, name, n, device)
    meta, cfg, flat, kinds, maps, field, side = field_ns_inputs(
        rt, torch, sc, params, rays, GRIN_FIELD_E0[name], device)
    nonseq = name in GRIN_FIELD_NS_CASES
    nb = sc.n_bounces if nonseq else 0
    if nonseq:
        def fwd_k(r=rays):
            return fn.trace_nonseq_fwd_cuda(flat, kinds, r, cfg, nb, maps,
                                            True, field=field, **side)
        out_k, s_k, aux_k = fwd_k()
        (out_p, s_p, aux_p), p_fwd = timed(torch, lambda: plain_ns_field_fwd(
            torch, flat, rays, cfg, meta, nb, maps, None, field, GRIN_CHUNK))
        res = compare_nonseq(torch, out_k, s_k, out_p, s_p)
        apart = ~((torch.stack([(getattr(out_k, c) - getattr(out_p, c)).abs()
                                for c in ('px', 'py', 'pz')]).amax(0)
                   <= NS_POS_TOL)
                  & ((out_k.intensity - out_p.intensity).abs() <= NS_INT_TOL))
    else:
        def fwd_k(r=rays):
            return ft.trace_seq_fwd_cuda(flat, kinds, r, cfg, maps, True,
                                         field=field, **side)
        out_k, s_k, aux_k = fwd_k()
        (out_p, s_p, aux_p), p_fwd = timed(torch, lambda: plain_field_fwd(
            torch, ft, flat, rays, cfg, meta, maps, None, field, GRIN_CHUNK))
        # the Brewster plate's polarized T rounds apart (section 17's rule)
        res = compare(torch, out_k, s_k, out_p, s_p, FRESNEL_I_RTOL)
        apart = traced_apart(torch, out_k, out_p, FRESNEL_I_RTOL)[0]
    res.update(compare_field(torch, aux_k, aux_p, ~apart))
    killed = (rays.intensity > 0) & (out_k.intensity == 0)
    res.update(rows=len(meta), apart=int(apart.sum()),
               killed=int(killed.sum()))
    k_fwd = time_ms(torch, fwd_k, warmup=2, reps=10)
    rays = rays.replace(intensity=torch.where(apart, 0.0, rays.intensity))
    g_rays, g_mom, _ = random_cotangents(torch, rays.n, cfg, device,
                                         GRIN_FIELD_SEED + 2)
    gen = torch.Generator(device=device).manual_seed(GRIN_FIELD_SEED + 3)
    g_field = [torch.randn(rays.n, generator=gen, device=device)
               for _ in range(6)]
    if nonseq:
        def bwd_k(replay=False):
            return fn.trace_nonseq_bwd_cuda(
                flat, kinds, rays, cfg, nb, g_rays, g_mom, maps=maps,
                ext=True, replay=replay, field=field, g_field=g_field, **side)
        g_k = bwd_k(replay=True)
        g_p, p_bwd = timed(torch, lambda: plain_ns_field_bwd(
            torch, flat, rays, cfg, meta, nb, g_rays, g_mom, None, maps,
            None, field, g_field, GRIN_CHUNK))
        out_r, _, aux_r = fn.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, nb, maps, True, field=field, **side)
        torch.cuda.synchronize()
        res['replay_equal'] = all(torch.equal(getattr(g_k[-2], c),
                                              getattr(out_r, c))
                                  for c in ft.COMPS)
        res['replay_field_equal'] = all(torch.equal(a, aux_r[k]) for a, k in
                                        zip(g_k[-1], ft.FIELD_KEYS))
        check(res['replay_equal'] and res['replay_field_equal'],
              f'{name}: K6 replay differs from K5 (rays '
              f'{res["replay_equal"]}, field {res["replay_field_equal"]})')
        g_kf, g_pf = g_k[-3], g_p[2]
        allowed = max(3, math.ceil(NS_MISMATCH_SHARE * rays.n))
    else:
        def bwd_k():
            return ft.trace_seq_bwd_cuda(
                flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=True,
                field=field, g_field=g_field, **side)
        g_k = bwd_k()
        g_p, p_bwd = timed(torch, lambda: plain_field_bwd(
            torch, ft, flat, rays, cfg, meta, g_rays, g_mom, None, maps, None,
            field, g_field, False, GRIN_CHUNK))
        g_kf, g_pf = g_k[-1], g_p[-1]
        allowed = None
    res['bwd'] = compare_ray_cotangents(torch, g_k[1], g_p[1],
                                        allowed=allowed)
    res['bwd'].update(compare_table_cotangents(
        torch, ft, g_k[0], g_p[0], plates=True, ext=True,
        coat=side['coat'] is not None, diff=side['diff'],
        freeform=side['ff'] is not None))
    same = ~rays_off(torch, g_k[1], g_p[1], ((0, 1, 2), (3, 4, 5)))
    res['bwd']['field'] = compare_field_cotangents(
        torch, [g[same] for g in g_kf], [g[same] for g in g_pf])
    res['bwd']['field']['geometry_differ'] = int((~same).sum())
    k_bwd = time_ms(torch, bwd_k, warmup=2, reps=10)
    res['timing'] = dict(fwd=dict(kernel_runs=k_fwd, plain_ms=p_fwd),
                         bwd=dict(kernel_runs=k_bwd, plain_ms=p_bwd))
    return res


def grin_field_paths(rt, torch, dev, reset_counters, counters, only):
    """The counted paths: each case through simulate_fused with the field at
    N_MAIN rays (K1 or K5 once, in the field's instantiation with GRIN rods)
    against the JAX package's numbers (GRIN_FIELD_REF: the weight and
    centroid as section 21 holds them, the mean |E|^2 within
    FIELD_REF_ATOL); and a grad step of GRIN_FIELD_GRAD_RAYS rays in the rod's n0
    and grin_A and in E0 (K1 + K2 or K5 + K6 once each) against the eager
    trace's (GRIN_GRAD_RTOL of the leaf's scale) -> dict; raises on a
    breach."""
    res = {}
    for name in GRIN_FIELD_CASES:
        sc = grin_field_scene(rt, name)
        fwd, bwd = (('trace_nonseq_fwd', 'trace_nonseq_bwd')
                    if name in GRIN_FIELD_NS_CASES
                    else ('trace_seq_fwd', 'trace_seq_bwd'))
        E0 = GRIN_FIELD_E0[name]
        rays = grin_field_rays(rt, torch, name, N_MAIN, dev)
        reset_counters()
        with torch.no_grad():
            out, sens, aux = sc.simulate_fused(sc.init_params(dev), rays,
                                               track_field=True, E0=E0)
        torch.cuda.synchronize()
        fl = counters()
        check(only(fl, **{fwd: 1, 'field': 1, 'grin': 1}),
              f'{name} launched {fl}')
        st = mix_stats(torch, out, sens, aux)
        ref = GRIN_FIELD_REF[name]
        err = {k: abs(st[k] - v) for k, v in ref.items()}
        ent = dict(forward=dict(launches=fl, **st), ref_err=err)
        check(all(err[k] <= (FIELD_REF_ATOL if k == 'field_power'
                             else MIX_REF_RTOL * (abs(v) + (
                                 ref['rms'] if k in ('cx', 'cy') else 0.0)))
                  for k, v in ref.items()),
              f'{name}: {st} vs the JAX package {ref}')
        if name == 'brewster':
            check(abs(st['mean_intensity'] - 1.0) <= FIELD_NS_TP_ATOL,
                  f'T_p at Brewster\'s angle after the rod: '
                  f'{st["mean_intensity"]}')
        rays = grin_field_rays(rt, torch, name, GRIN_FIELD_GRAD_RAYS, dev)
        got = {}
        for sim in ('simulate_fused', 'simulate'):
            p = sc.init_params(dev)
            leaves = [p['rod'][k].requires_grad_(True)
                      for k in GRIN_FIELD_LEAVES]
            e0 = torch.tensor(E0, device=dev, requires_grad=True)
            reset_counters()
            _, sens, aux = getattr(sc, sim)(p, rays, track_field=True, E0=e0)
            g = torch.autograd.grad(grin_field_loss(torch, sens, aux),
                                    leaves + [e0])
            torch.cuda.synchronize()
            got[sim] = dict(launches=counters(), grads=[
                torch.view_as_real(x).flatten().tolist() if x.is_complex()
                else x.detach().flatten().tolist() for x in g])
        f, e = got['simulate_fused'], got['simulate']
        check(only(f['launches'], **{fwd: 1, bwd: 1, 'field': 2, 'grin': 2}),
              f'{name}: the fused grad step launched {f["launches"]}')
        rel = [max(abs(a - b) for a, b in zip(fa, ea))
               / max(max(abs(b) for b in ea), 1e-30)
               for fa, ea in zip(f['grads'], e['grads'])]
        ent['grad'] = dict(fused=f, eager=e, rel_err=rel)
        check(max(rel) <= GRIN_GRAD_RTOL,
              f'{name}: fused gradients {f["grads"]} vs eager {e["grads"]}')
        res[name] = ent
        torch.cuda.empty_cache()
    return res


def grin_field_phases(rt, torch, dev, reset_counters, counters, only):
    """Section 22: the polarized field through GRIN rods, K1, K2, K5 and K6
    in their field instantiation with GRIN rods: each against its plain
    version at N_MAIN rays (K6's replay bit for bit, its field too); the
    counted paths against the JAX package's numbers and fused against eager
    gradients; times, bounds and blocks per SM."""
    from raytracetorch_tpu_torch.ops import fused_trace as ft
    t0 = time.perf_counter()

    # 22a. each kernel against its plain version
    kern = {}
    for name in GRIN_FIELD_CASES:
        t1 = time.perf_counter()
        kern[name] = grin_field_kernels_vs_plain(rt, torch, name, N_MAIN,
                                                 dev)
        kern[name]['seconds'] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    emit('grin_field_kernels_vs_plain', n=N_MAIN, **kern)

    # 22b. the counted paths and the gradients
    paths = grin_field_paths(rt, torch, dev, reset_counters, counters, only)
    emit('grin_field_main', paths=paths)

    # 22c. times at N_MAIN against the plain versions (22a's runs, on the
    # compared inputs), bounds and blocks: K1 and K2 on the quarter-pitch
    # rod, K5 and K6 on the Scene
    timing, bounds, occ = {}, {}, {}
    for name, keys in (('quarter', ('k1', 'k2')), ('ns', ('k5', 'k6'))):
        sc = grin_field_scene(rt, name)
        params = sc.init_params(dev)
        r = grin_field_rays(rt, torch, name, N_MAIN, dev)
        meta = ft.TraceMeta(sc.static_meta(), sc.fuzzy_fns(), field=True)
        cfg = sc.sensor_config()
        steps = max(m.grin_steps for m in meta)
        rod_f = steps * GRIN_FIELD_STEP_OPS + GRIN_FIELD_COUPLE_OPS
        if name == 'ns':
            scans, wins, lives = nonseq_work(rt, torch, sc, params, r)
            k5_ops, k6_ops = nonseq_ops(meta, scans, wins, 0)
            rod = sum(w * (grin_ops(m) + rod_f)
                      for w, m in zip(wins, meta) if m.grin_steps)
            # K6: the replay (K5 and its rods) and each rod winner's steps
            # reversed and couplings' adjoint, the field's at twice its
            # forward's size (section 20's count with the field's)
            rod_rev = sum(w * (steps * GRIN_REV_STEP_OPS
                               + 2 * GRIN_COUPLE_OPS + 2 * rod_f)
                          for w, m in zip(wins, meta) if m.grin_steps)
            timing['ns_work'] = dict(k5_row_scans=scans,
                                     k5_winners_per_row=wins)
            fwd_ops, bwd_ops = k5_ops + rod, k6_ops + rod + rod_rev
        else:
            chain = r.n * sum(intersect_ops(m) + (grin_ops(m) + rod_f
                                                  if m.grin_steps
                                                  else apply_ops(m))
                              for m in meta)
            # K2: the forward and an adjoint of twice its size, the rod's
            # steps reversed once in place of that estimate (section 20)
            fwd_ops = chain
            bwd_ops = 3 * chain + r.n * steps * (GRIN_REV_STEP_OPS
                                                 - 2 * GRIN_STEP_OPS)
        # the forward reads 9 streams and the launch field and writes 7, the
        # path length and medium and the final field; the backward reads the
        # forward's inputs, 7 ray and 6 field cotangents and writes 7 and 6
        # and its partials
        cols = len(ft.grad_cols((), True))
        io_f = r.n * (36 + 28 + 8 + 2 * 24) + table_bytes(meta)
        io_b = (r.n * (36 + 28 + 24 + 28 + 24 + 24) + table_bytes(meta)
                + -(-r.n // 256) * len(meta) * cols * 4)
        bounds[f'{keys[0]}_{name}'] = bound(io_f, fwd_ops)
        bounds[f'{keys[1]}_{name}'] = bound(io_b, bwd_ops)
        for key_, part in zip(keys, ('fwd', 'bwd')):
            t = kern[name]['timing'][part]
            timing[f'{key_}_{name}'] = dict(
                kernel_ms=statistics.median(t['kernel_runs']),
                plain_ms=t['plain_ms'], plain_rays=r.n,
                kernel_runs=t['kernel_runs'])
        for lib in (('trace_nonseq_fwd', 'trace_nonseq_bwd') if name == 'ns'
                    else ('trace_seq_fwd', 'trace_seq_bwd')):
            occ[f'{lib}_{name}'] = ft.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces if name == 'ns'
                else 0, ext=True, grin=True, field=True)
        torch.cuda.empty_cache()
    emit('grin_field_timing', **timing)
    emit('grin_field_bounds', n=N_MAIN,
         **{k: dict(bound_ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    emit('grin_field_occupancy', blocks_per_sm=occ)
    emit('grin_field_seconds', seconds=time.perf_counter() - t0)
    return dict(kernels=kern, paths=paths, timing=timing, bounds=bounds)


# The SASS of every kernel of the four trace libraries (76: K1's 12, K2's
# 26, K5's 25, K6's 13), which a later slice must not change unless it
# means to: sha256 (first 16 hex digits) of each kernel's normalized
# `cuobjdump -sass` listing (sass_digests), keyed by the first 12 hex
# digits of the sha256 of its mangled name (the anonymous namespace's hash
# stripped), read from this tree's build on an NVIDIA H100 80GB HBM3 when
# the family chain collapsed: the kernels that kept their code kept their
# digests, but K6's instantiations without dispersion, with it and with
# the path length, whose listings moved two independent predicate
# instructions (PERF.md); and the field's instantiations with every family,
# for tables with a GRIN rod (K1 one, K2 two, K5 two, K6 one), read when
# they came -> {library: {name key: digest}}.
SASS_ALL = {
    'trace_nonseq_bwd': {
        '03df43c7e5e9': '33691adada7802a5',
        '08244a1bf7e2': '4075e21f4ad306c0',
        '1a141c888635': '92d4b78af3dbf07e',
        '7b291c5d10e6': '787c894f94c7f330',
        '8845e74a8174': '112128958f092289',
        '890121c01118': 'dde89048293c22aa',
        '934c4c3721a8': '8912f19f0e71dc88',
        '9fb6f9ef47b2': 'c0100c0bc0dbdff6',
        'be39b3457e72': '5899b7eacd76d69a',
        'd2b0a0757307': 'f30ed5853daea54e',
        'e5328c4bb36d': '9a9ece152bd43ffa',
        'ed6702cc88ee': '8f9a69e0fe4d738d',
        'efd221452f49': 'a78d2d8c8d9b5f2a'},
    'trace_nonseq_fwd': {
        '069afa8fc02e': 'f22476b559971682',
        '0e7f8f95cf21': '42f80af41fd9d51c',
        '167dc62ca7ba': 'a0517998fbf76f95',
        '168d45467d41': '0f7f6e4372a3b094',
        '172bf2bab62f': 'faed464783f26bf8',
        '409ca9948ad0': 'a3dd8a66842f008d',
        '446f69431326': 'd8c4cf014061dd68',
        '4631f0a57922': '87162240d0ff255c',
        '4f9725044bc5': 'cf734ce216a28839',
        '63b98f7c3418': '743dfdc6af310d8b',
        '8ece81f19a33': '5006a8ebac560e71',
        '9887ea03277d': 'a2b42ccbc7a9f2c8',
        'a69da8a34718': '5fa4bbf53bb53ab5',
        'a95f8af70d7d': 'cf478798b278ed3e',
        'aa7325da1eb9': 'd555d803c9eb251b',
        'bf2fb8301d57': 'cc6600d8603c2591',
        'c05fe594c11a': 'cdb9550d8dd1fed8',
        'c1ffee5a363b': '30d16f809fe109e6',
        'd6e73ed266ee': '0dd5386947a5843a',
        'e3989ed9b356': '9dae38d5609657e0',
        'ede4017e7976': '432e6c6465189d61',
        'ef63c80cdf39': '6ac47e1fc1f49aff',
        'fa6ede60da44': '2b72c16e13a3c5dd',
        'fbd49f5bd426': 'e8205e302381af7a',
        'fd6c4573cf32': '956160ff3158b00a'},
    'trace_seq_bwd': {
        '1b1c8ca95e5f': 'c3dec1901cbbec0e',
        '27dec186cbaa': 'dc438c9dedec2f7d',
        '355d32931f62': 'd99a41bf18338a10',
        '388a1f6be95b': '173a212ed7f8ce76',
        '3eedf1deee4b': 'd4967b555f6bc35c',
        '42d3b9e6215c': '24e563443a3b5bd8',
        '4d733f812142': 'ab659b7c23503212',
        '57105bdc2e0b': 'b9422033e85ab6f2',
        '63e51899a554': 'f93c0e3de9fa3c29',
        '7dbc0d64159f': '3070d650848e6117',
        '838e6a6d04c7': '0f698b264124fd4e',
        '83e7f3681f0b': '0ea01155e408f645',
        '886f1bcf94e3': '94a3852495da1797',
        '88c096aee4a1': 'f6a31b3b772cdbb6',
        '8abdf665eb4e': '50dac8ca0f9949cf',
        '90d3e46e4d7c': '134d95db9b48eadd',
        '9398fdcc4d13': '9172a10c04414689',
        '9a56ef3383e0': 'c0f50fbdaffcdbf2',
        '9bcd32ef5f3f': 'ec6768b2b46c68a5',
        'a07eb81f1edd': 'afd3ff09b28616af',
        'a52b4e6eb558': 'ca096d846b6e88b2',
        'c65979489e95': 'a88254f81fe6cd7c',
        'd6d123094fce': 'd288b661e1bb16b0',
        'ea678026567c': '32d8c1114a5dcce5',
        'fb238beea4c2': '7149240fad92e3ca',
        'fd94565fe71d': 'e856cfef69d710c6'},
    'trace_seq_fwd': {
        '15c4a4872cdb': '9d9e7a657e1eb148',
        '16fa3b59cf26': '2273abadad990939',
        '74f8135ef41f': 'ae3d3dce30f0c652',
        '7f24aa638f84': '53a3de2d10a62d95',
        '87083c76f7fe': '034692c1d3d3deda',
        'ae165d077666': '3518c58d21cd8015',
        'bf04f1bf6e88': '7908e35cdb5af917',
        'cae7781557a1': '3e0e2ebbda134ea4',
        'd4fd4a6fbbe0': 'f6f6b4a629646b91',
        'dfddf45ad8d0': 'abea182f20a732c1',
        'eb17cd4764ff': '8d031725c92e153f',
        'fbe38a674d17': '4dcffb06ba91d2c7'}}


def sass_keyed(path):
    """{sha256(name)[:12]: sha256(listing)[:16]} of a library's kernels."""
    import hashlib
    return {hashlib.sha256(k.encode()).hexdigest()[:12]: v[:16]
            for k, v in sass_digests(path).items()}


def check_sass_all():
    """The SASS of every kernel in SASS_ALL as built here -> dict (with the
    keyed digests of the kernels it does not record, for a later slice to
    record); raises on a difference or a missing kernel."""
    from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build
    res = {}
    for lib, want in SASS_ALL.items():
        path = nvcc_build.library_path(lib, [fused_trace._LIBRARIES[lib][0]])
        got = sass_keyed(path)
        differ = [k for k, v in want.items() if got.get(k) != v]
        res[lib] = dict(kernels=len(want), built=len(got), differ=differ,
                        unrecorded={k: v for k, v in got.items()
                                    if k not in want})
        check(not differ, f'{lib}: the SASS of {len(differ)} earlier '
              f'kernels changed: {differ}')
    return res


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
        fused_trace.V1_LAUNCHES = fused_trace.EXT_LAUNCHES = 0
        fused_trace.STREAM_LAUNCHES = fused_trace.RECORD_RECOMPUTES = 0
        fused_trace.FRESNEL_LAUNCHES = fused_trace.COAT_LAUNCHES = 0
        fused_trace.DIFF_LAUNCHES = fused_trace.FUZZY_LAUNCHES = 0
        fused_trace.FREEFORM_LAUNCHES = fused_trace.FIELD_LAUNCHES = 0
        fused_trace.GRIN_LAUNCHES = 0
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
                    grid_corners_bwd=phase_grid.CORNER_BWD_LAUNCHES,
                    ext=fused_trace.EXT_LAUNCHES,
                    streams=fused_trace.STREAM_LAUNCHES,
                    record_recomputes=fused_trace.RECORD_RECOMPUTES,
                    fresnel=fused_trace.FRESNEL_LAUNCHES,
                    coat=fused_trace.COAT_LAUNCHES,
                    diff=fused_trace.DIFF_LAUNCHES,
                    fuzzy=fused_trace.FUZZY_LAUNCHES,
                    freeform=fused_trace.FREEFORM_LAUNCHES,
                    field=fused_trace.FIELD_LAUNCHES,
                    grin=fused_trace.GRIN_LAUNCHES)

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
    sass_pool = prefetch_sass()
    # K1's, K2's and K6's resident blocks per SM on their main paths'
    # launches (the bench scene, the naive scene; with plate code, the ring
    # former)
    occ, rs = {}, ring_scene(rt, bounces=DO_BOUNCES, grid=True)
    for lib, sc in (('trace_seq_fwd', bench_scene(rt)),
                    ('trace_seq_bwd', bench_scene(rt)),
                    ('trace_nonseq_bwd', naive_scene(rt))):
        occ[lib] = fused_trace.blocks_per_sm(lib, len(sc.static_meta()),
                                             sc.sensor_config(), False,
                                             sc.n_bounces)
        occ[lib + '_plate'] = fused_trace.blocks_per_sm(
            lib, len(rs.static_meta()), rs.sensor_config(), True,
            rs.n_bounces)
    cav = cavity_scene(rt)
    occ['trace_nonseq_bwd_cavity'] = fused_trace.blocks_per_sm(
        'trace_nonseq_bwd', len(cav.static_meta()), cav.sensor_config(),
        False, cav.n_bounces)
    # K5's on the naive scene (the main path's instantiation) and the plate
    # scene
    nsc0 = naive_scene(rt)
    occ['trace_nonseq_fwd'] = fused_trace.blocks_per_sm(
        'trace_nonseq_fwd', len(nsc0.static_meta()), nsc0.sensor_config(),
        False, nsc0.n_bounces)
    occ['trace_nonseq_fwd_plate'] = fused_trace.blocks_per_sm(
        'trace_nonseq_fwd', len(rs.static_meta()), rs.sensor_config(), True,
        rs.n_bounces)
    emit('occupancy', blocks_per_sm=occ)

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
    # K3 on its other paths: a 32 x 32 grid (whole in shared memory), 8
    # slots of 256 x 256 (2 MB: no window, one atomic per hit in device
    # memory), and every hit in one cell (the most contention), each against
    # its plain version
    paths = {}
    for key, shape in (('grid_32', (1, 32, 32)), ('slots_8', (8, 256, 256)),
                       ('one_cell', (1, 256, 256))):
        pcfg = rt.SensorConfig(n_sensors=shape[0], grid_shape=shape[1:],
                               grid_half_extent=GRID_E)
        px_, py_ = ((torch.full_like(hx, 0.1), torch.full_like(hy, -0.3))
                    if key == 'one_cell' else (hx, hy))
        pslot = torch.randint(0, shape[0], (N_MAIN,), generator=gen,
                              device=dev, dtype=torch.int32)
        unit_k = grid.bin_grid_cuda(px_, py_, ones, pslot, pcfg)
        unit_p = grid.bin_grid_slots_plain(px_, py_, ones, pslot, pcfg)
        rnd_k = grid.bin_grid_cuda(px_, py_, hw, pslot, pcfg)
        rnd_p = grid.bin_grid_slots_plain(px_, py_, hw, pslot, pcfg)
        torch.cuda.synchronize()
        err = float((rnd_k - rnd_p).abs().max())
        scale = float(rnd_p.abs().max())
        paths[key] = dict(
            shape=list(shape),
            unit_equal=bool(torch.equal(unit_k, unit_p)),
            unit_total=float(unit_k.sum()), cells_hit=int((unit_k > 0).sum()),
            rand_max_abs_err=err, rand_err_over_max_bin=err / scale)
        check(paths[key]['unit_equal'] and paths[key]['unit_total'] == N_MAIN,
              f'K3 ({key}) with unit weights differs from its plain version')
        check(err <= GRID_RAND_RTOL * scale,
              f'K3 ({key}) with random weights: {err} of {scale}')
    check(paths['one_cell']['cells_hit'] == 1, 'one-cell hits spread')
    emit('grid_bin_paths', **paths)

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
    reset_counters()
    out, sens, _ = scene.simulate_fused(params, rays)
    torch.cuda.synchronize()
    launches = fused_trace.LAUNCHES
    bwd_launches_fwd = fused_trace.BWD_LAUNCHES
    main_launches = counters()
    rms = float(sens.spot_rms(0)[0])
    cen = sens.centroid(0)[0].tolist()
    f = float(-1.0 / scene.paraxial(params)[1, 0])
    finite = all(bool(torch.isfinite(getattr(out, c)).all())
                 for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'))
    emit('main_path', launches=launches, bwd_launches=bwd_launches_fwd,
         counters=main_launches,
         n=N_MAIN, spot_rms=rms, centroid=cen, focal_length=f,
         finite=finite, shape=list(out.pos.shape),
         hits=float(sens.moments[0, 0, 6]))
    check(only(main_launches, trace_seq_fwd=1),
          f'simulate_fused launched {main_launches}, not K1 alone without '
          f'the extended kinds')
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
    reset_counters()
    g_fused, loss_fused = lens_grads(scene.simulate_fused)
    torch.cuda.synchronize()
    grad_launches = (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES)
    grad_counters = counters()
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
    check(grad_launches == (1, 1) and only(grad_counters, trace_seq_fwd=1,
                                           trace_seq_bwd=1),
          f'the grad step launched {grad_counters}, not K1 and K2 once '
          f'each without the extended kinds')
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
    reset_counters()
    p_opt, losses = rt.fit_lbfgs(design_loss(torch, dscene, drays), dparams,
                                 trainable=dscene.trainable(),
                                 steps=DESIGN_STEPS)
    torch.cuda.synchronize()
    design_s = time.perf_counter() - t0
    design_launches = (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES)
    design_ext = fused_trace.EXT_LAUNCHES
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
    check(design_launches[1] > 0 and design_ext == 0,
          f'the design loop launched K2 {design_launches[1]} times, '
          f'{design_ext} with the extended kinds')
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
                # its work, and K6's bound as timed in section 6 (these rays,
                # the moments' cotangent) under K6's checkpoints and under
                # the 8 of its earlier design
                cmeta = nsc.static_meta()
                c_scans, c_wins, lives = nonseq_work(
                    rt, torch, nsc, nsc.init_params(dev), rays)
                res['max_live_bounces'] = int(lives.max())
                ckpt = fused_nonseq.K6_CHECKPOINTS
                for ck in sorted({ckpt, 8}):
                    rep = segment_replays(lives, ck)
                    res[f'replayed_bounces_{ck}'] = rep
                    res[f'bound_{ck}'] = dict(zip(('ms', 'by'), bound(
                        n * (32 + 28) + table_bytes(cmeta)
                        + len(cmeta) * 19 * 4,
                        nonseq_ops(cmeta, c_scans, c_wins, rep)[1])))
                check(res['max_live_bounces'] > ckpt,
                      f'no cavity ray lives beyond the {ckpt} checkpoints')
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
    # that 1M ring-former rays read on the 256 x 256 and the 32 x 32 map and
    # on the largest map the scatter holds in shared memory and one row more
    # (its two paths), and on 2,999 cells partly outside the map (clamped
    # reads)
    do_rays = ring_rays(rt, torch, N_MAIN, dev, SEED + 91)
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    corner_cases, corner_inputs = {}, {}
    cap = k4_shared_cap()
    for shape in (DO_MAP, DO_SMALL_MAP, (cap // 100, 100),
                  (cap // 100 + 1, 100)):
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
                                    for a, b in zip(c_k, c_p)),
                   gather_max_abs_err=max(float((a - b).abs().max())
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

    # 8. the mixed-surface and asphere scenes, and the renderer
    extended_phases(rt, torch, dev, reset_counters, counters, only)

    # 9. chromatic dispersion: the achromat and the Cooke triplet
    dispersion_phases(rt, torch, dev, reset_counters, counters, only)

    # 10. the deterministic streams, the wavefront analysis, footprints
    streams = streams_phases(rt, torch, dev, reset_counters, counters, only)

    # 11. Fresnel physics and the random draws, ghosts
    fresnel = fresnel_phases(rt, torch, dev, reset_counters, counters, only)

    # 12. thin-film coatings and metal mirrors, the mirror family
    coating = coating_phases(rt, torch, dev, reset_counters, counters, only)

    # 13. the diffractive and ideal elements
    diffractive = diffractive_phases(rt, torch, dev, reset_counters,
                                     counters, only)

    # 14. fuzzy apodization and the obscured pupil
    fuzzy = fuzzy_phases(rt, torch, dev, reset_counters, counters, only)

    # 15. freeform, Zernike and wedge lenses
    freeform = freeform_phases(rt, torch, dev, reset_counters, counters, only)

    # 16. convex solids, custom shapes and the point source
    solid = solid_phases(rt, torch, dev, reset_counters, counters, only)

    # 17. the polarized field: polarizers, waveplates, E0
    field = field_phases(rt, torch, dev, reset_counters, counters, only)
    sass_pool.shutdown()

    # 18. the polarized field through coated interfaces and metal mirrors,
    # and the Jones pupil
    field_coat = field_coat_phases(rt, torch, dev, reset_counters, counters,
                                   only)

    # 19. the polarized field in the non-sequential scene
    field_ns = field_ns_phases(rt, torch, dev, reset_counters, counters, only)

    # 20. GRIN rods
    grin = grin_phases(rt, torch, dev, reset_counters, counters, only)

    # 21. the kind mix: families of kinds together in one table
    mix = mix_phases(rt, torch, dev, reset_counters, counters, only)

    # 22. the polarized field through GRIN rods
    grin_field = grin_field_phases(rt, torch, dev, reset_counters, counters,
                                   only)

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
    # K2 vs the plain backward at N_MAIN, with the moment cotangent of a
    # spot loss; at 16M rays K2 alone (the plain backward's eager graph of
    # 16M rays does not fit, and its smaller fallbacks cost the smoke ~1 min)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 1)
    k_ms, p_ms, k_runs, p_runs = time_pair(
        torch,
        lambda: fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays, cfg, no_rays, g_mom1),
        lambda: fused_trace.trace_seq_bwd_plain(
            flat, rays, cfg, meta, no_rays, g_mom1))
    timing[f'bwd_n{N_MAIN}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                    kernel_runs=k_runs, plain_runs=p_runs)
    rays = sample_rays(rt, torch, N_LARGE, dev, SEED + 1)
    k_runs = time_ms(torch, lambda: fused_trace.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, no_rays, g_mom1))
    timing[f'bwd_n{N_LARGE}'] = dict(kernel_ms=statistics.median(k_runs),
                                     kernel_runs=k_runs)
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
    # (at 16M rays K5 alone: the plain loop takes ~8 s a call there)
    rays = sample_rays(rt, torch, N_MAIN, dev, SEED + 1)
    k_ms, p_ms, k_runs, p_runs = time_pair(
        torch,
        lambda: fused_nonseq.trace_nonseq_fwd_cuda(
            nflat, nkinds, rays, ncfg, NS_BOUNCES),
        lambda: fused_nonseq.trace_nonseq_fused_plain(
            nflat, rays, ncfg, nmeta, NS_BOUNCES))
    timing[f'nonseq_n{N_MAIN}'] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                       kernel_runs=k_runs, plain_runs=p_runs)
    rays = sample_rays(rt, torch, N_LARGE, dev, SEED + 1)
    k_runs = time_ms(torch, lambda: fused_nonseq.trace_nonseq_fwd_cuda(
        nflat, nkinds, rays, ncfg, NS_BOUNCES), 1, 10)
    timing[f'nonseq_n{N_LARGE}'] = dict(kernel_ms=statistics.median(k_runs),
                                        kernel_runs=k_runs)
    # K6 against its plain version on the same scene, with the cotangents of
    # the spot and grid loss; at 16M rays K6 alone (the plain backward keeps
    # the eager graph of every bounce, ~9 GB per 1M rays)
    k6_args = ((None,) * 7, g_mom1)
    for n in (N_MAIN, N_LARGE):
        rays = sample_rays(rt, torch, n, dev, SEED + 1)
        k_runs = time_ms(torch, lambda: fused_nonseq.trace_nonseq_bwd_cuda(
            nflat, nkinds, rays, ncfg, NS_BOUNCES, *k6_args, g_grid=ns_w),
            1, 16 if n == N_MAIN else 10)
        res = dict(kernel_ms=statistics.median(k_runs), kernel_runs=k_runs)
        if n == N_MAIN:
            k_ms, p_ms, k_runs, p_runs = time_pair(
                torch,
                lambda: fused_nonseq.trace_nonseq_bwd_cuda(
                    nflat, nkinds, rays, ncfg, NS_BOUNCES, *k6_args,
                    g_grid=ns_w),
                lambda: fused_nonseq.trace_nonseq_bwd_plain(
                    nflat, rays, ncfg, nmeta, NS_BOUNCES, *k6_args,
                    g_grid=ns_w), reps=8, warmup=1)
            res.update(paired_kernel_ms=k_ms, plain_ms=p_ms,
                       paired_kernel_runs=k_runs, plain_runs=p_runs)
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
    put_runs = time_ms(torch, lambda: g_lib.index_put_(
        (flat_idx,), spot_w, accumulate=True))
    add_runs = time_ms(torch, lambda: g_lib.index_add_(0, flat_idx, spot_w))
    timing['grid_bin_spot'] = dict(
        kernel_ms=k3_ms, plain_ms=k3_plain_ms, library_ms=statistics.median(
            add_runs), index_put_ms=statistics.median(put_runs),
        kernel_runs=k3_runs, plain_runs=k3_plain_runs,
        library_runs=add_runs, index_put_runs=put_runs,
        cells_hit=int((g_k > 0).sum()), hits=float(g_k.sum()))
    timing['grid_bin_random'] = dict(zip(
        ('kernel_ms', 'plain_ms'), time_pair(
            torch, lambda: grid.bin_grid_cuda(hx, hy, hw, hslot, gcfg),
            lambda: grid.bin_grid_slots_plain(hx, hy, hw, hslot, gcfg))[:2]))
    # K3 on the random hits with their weights, all in one 256 x 256 slot,
    # against one index_add_ and one index_put_ at their flat cells
    rix, riy = bin_indices(GRID, GRID_E, hx, hy)
    r_idx = riy * GRID[1] + rix
    r_k, r_p, r_runs, _ = time_pair(
        torch, lambda: grid.bin_grid_cuda(hx, hy, hw, 0, gcfg1),
        lambda: grid.bin_grid_slots_plain(hx, hy, hw, 0, gcfg1))
    timing['grid_bin_random_1x256'] = dict(
        kernel_ms=r_k, plain_ms=r_p, library_ms=statistics.median(time_ms(
            torch, lambda: g_lib.index_add_(0, r_idx, hw))),
        index_put_ms=statistics.median(time_ms(
            torch, lambda: g_lib.index_put_((r_idx,), hw, accumulate=True))),
        kernel_runs=r_runs)
    # K3 on the bench spot with the 32 x 32 grid and with 8 slots of
    # 256 x 256, and each of the eager loop's launches on the naive scene
    # (one per bounce: section 5d), captured from Scene.simulate and timed
    # one by one
    for key, shape in (('grid_bin_spot_32', (1, 32, 32)),
                       ('grid_bin_spot_8x256', (8, 256, 256))):
        pcfg = rt.SensorConfig(n_sensors=shape[0], grid_shape=shape[1:],
                               grid_half_extent=GRID_E)
        timing[key] = dict(zip(('kernel_ms', 'plain_ms'), time_pair(
            torch, lambda: grid.bin_grid_cuda(spot_x, spot_y, spot_w,
                                              shape[0] - 1, pcfg),
            lambda: grid.bin_grid_slots_plain(spot_x, spot_y, spot_w,
                                              shape[0] - 1, pcfg))[:2]))
    eager_hits, bin_cuda = [], grid.bin_grid_cuda

    def spy(x, y, w, slot, c, g=None):
        eager_hits.append((x, y, w, slot, c))
        return bin_cuda(x, y, w, slot, c, g)
    grid.bin_grid_cuda = spy
    launched = grid.GRID_LAUNCHES
    try:
        nscene.simulate(nparams, rays)
    finally:
        grid.bin_grid_cuda = bin_cuda
    launched = grid.GRID_LAUNCHES - launched
    check(launched >= 1 and len(eager_hits) == launched,
          f'captured {len(eager_hits)} of the eager loop\'s {launched} K3 '
          'launches')
    eager_k3 = []
    for x, y, w, slot, c in eager_hits:
        runs = time_ms(torch, lambda: grid.bin_grid_cuda(x, y, w, slot, c))
        eager_k3.append(dict(kernel_ms=statistics.median(runs),
                             nonzero_weights=int((w != 0).sum()),
                             kernel_runs=runs))
    timing['grid_bin_eager_launches'] = eager_k3
    timing['nonseq_design_warm_s'] = nd_warm_s
    # K4 alone at 1M cells of the ring-former rays, on the 256 x 256 and the
    # 32 x 32 map: gather and scatter against their plain versions and the
    # library calls at precomputed clamped cells: for the gather one
    # torch.take of the 4N flat cells (and the four advanced-index reads),
    # for the scatter one index_add_ of the 4N cotangents at the 4N flat
    # cells (and four index_put_ with accumulate, which sort their indices)
    for shape in (DO_MAP, DO_SMALL_MAP):
        cmap, civ, ciu = corner_inputs[shape]
        g_c = tuple(torch.randn(N_MAIN, device=dev) for _ in range(4))
        cells = phase_grid._cells(shape, civ, ciu)
        v0, v1, u0, u1 = cells
        pairs = ((v0, u0), (v0, u1), (v1, u0), (v1, u1))
        flat4 = torch.cat([v * shape[1] + u for v, u in pairs])
        g_flat4 = torch.cat(g_c)
        g_lib = torch.zeros(shape, device=dev)
        g_add = torch.zeros(shape[0] * shape[1], device=dev)

        def lib_scatter():
            for g, cell in zip(g_c, pairs):
                g_lib.index_put_(cell, g, accumulate=True)
        k_ms, p_ms, k_runs, p_runs = time_pair(
            torch, lambda: phase_grid.grid_corners_cuda(cmap, civ, ciu),
            lambda: phase_grid.grid_corners_plain(cmap, civ, ciu))
        take_runs = time_ms(torch, lambda: torch.take(cmap, flat4))
        lib_runs = time_ms(torch, lambda: [cmap[cell] for cell in pairs])
        kb_ms, pb_ms, kb_runs, pb_runs = time_pair(
            torch, lambda: phase_grid.grid_corners_bwd_cuda(g_c, civ, ciu,
                                                            shape),
            lambda: phase_grid.grid_corners_bwd_plain(g_c, civ, ciu, shape))
        add_runs = time_ms(torch, lambda: g_add.index_add_(0, flat4, g_flat4))
        libb_runs = time_ms(torch, lib_scatter)
        timing['corners_' + 'x'.join(map(str, shape))] = dict(
            kernel_ms=k_ms, plain_ms=p_ms,
            library_ms=statistics.median(take_runs),
            index_reads_ms=statistics.median(lib_runs), bwd_kernel_ms=kb_ms,
            bwd_plain_ms=pb_ms, bwd_library_ms=statistics.median(add_runs),
            bwd_index_put_ms=statistics.median(libb_runs),
            kernel_runs=k_runs, plain_runs=p_runs, library_runs=take_runs,
            index_reads_runs=lib_runs, bwd_kernel_runs=kb_runs,
            bwd_plain_runs=pb_runs, bwd_library_runs=add_runs,
            bwd_index_put_runs=libb_runs)
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
    scans, wins, lives = nonseq_work(
        rt, torch, nscene, nparams, sample_rays(rt, torch, n, dev, SEED + 1))
    replayed = segment_replays(lives)
    k5_ops, k6_ops = nonseq_ops(nmeta, scans, wins, replayed)
    # with the 256 x 256 plate: K1 also reads the wavelength and the corners
    # (in L2); K2 also scatters into the map's cotangent; K5 and K6 on the
    # plate Scene with its 256 x 256 irradiance grid
    map_bytes = DO_MAP[0] * DO_MAP[1] * 4
    p_ops = n * sum(intersect_ops(m) + apply_ops(m) for m in smeta)
    p_scans, p_wins, p_lives = nonseq_work(
        rt, torch, do_ns, do_np, ring_rays(rt, torch, n, dev, SEED + 1))
    p_k5_ops, p_k6_ops = nonseq_ops(nmeta_p, p_scans, p_wins,
                                    segment_replays(p_lives))
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
              max(corner_cases[key]['gather_max_abs_err']
                  for key in corner_cases),
              timing['corners_256x256']['kernel_ms'],
              timing['corners_256x256']['plain_ms'],
              timing['corners_256x256']['library_ms']),
        entry('grid_corners_bwd', 'grid_corners.cu', 439,
              do_eager_launches['grid_corners_bwd'],
              max(corner_cases[key]['map_max_abs_err']
                  for key in corner_cases),
              timing['corners_256x256']['bwd_kernel_ms'],
              timing['corners_256x256']['bwd_plain_ms'],
              timing['corners_256x256']['bwd_library_ms']),
        entry('trace_seq_v1', 'trace_seq_fwd.cu', 81,
              v1_launches['trace_seq_v1'], v1_res['max_abs_err'],
              timing['v1']['kernel_ms'], timing['v1']['plain_ms']),
    ]}
    # the instantiations with the streams (section 10): launches on the
    # counted paths, errors at 1M rays, times and bounds of the path length
    st_k, st_t, st_b = (streams['kernels'], streams['timing'],
                        streams['bounds'])
    st_p = streams['paths']

    def st_err(*keys):
        return max(max([st_k[k]['max_abs_err']]
                       + list(st_k[k]['stream_max_abs_err'].values()))
                   for k in keys)
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_streams', 'trace_seq_fwd.cu', 489,
             st_p['sequential']['fwd_launches']['trace_seq_fwd'],
             st_err(f'k1k2_opl_bench_{N_MAIN}', f'k1_records_bench_{N_MAIN}'),
             'k1_bench_opl'),
            ('trace_seq_bwd_opl', 'trace_seq_bwd.cu', 1712,
             st_p['sequential']['grad_launches']['trace_seq_bwd'],
             st_k[f'k1k2_opl_bench_{N_MAIN}']['bwd']['max_abs_err'],
             'k2_bench_opl'),
            ('trace_nonseq_fwd_streams', 'trace_nonseq_fwd.cu', 1029,
             st_p['scene']['fwd_launches']['trace_nonseq_fwd'],
             st_err(f'k5k6_opl_bench_{N_MAIN}', f'k5_records_bench_{N_MAIN}'),
             'k5_bench_opl'),
            ('trace_nonseq_bwd_opl', 'trace_nonseq_bwd.cu', 2157,
             st_p['scene']['grad_launches']['trace_nonseq_bwd'],
             st_k[f'k5k6_opl_bench_{N_MAIN}']['bwd']['max_abs_err'],
             'k6_bench_opl')):
        bounds[name] = st_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, st_t[key]['kernel_ms'],
            st_t[key]['plain_ms']))
    # the instantiations with the Fresnel kinds (section 11): launches on
    # the counted paths with fresnel=True, errors at 1M rays, times and
    # bounds on the bench singlet (K1, K2) and the naive scene (K5, K6)
    fr_k, fr_t, fr_b = (fresnel['kernels'], fresnel['timing'],
                        fresnel['bounds'])
    fr_p = fresnel['paths']
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_fresnel', 'trace_seq_fwd.cu', 489,
             fr_p['sequential_mc']['fwd_launches']['trace_seq_fwd'],
             max(fr_k[f'k1k2_{c}_{N_MAIN}']['max_abs_err']
                 for c in FRESNEL_SEQ_CASES), 'k1_mc'),
            ('trace_seq_bwd_fresnel', 'trace_seq_bwd.cu', 1712,
             fr_p['sequential_mc']['grad_launches']['trace_seq_bwd'],
             max(fr_k[f'k1k2_{c}_{N_MAIN}']['bwd']['max_abs_err']
                 for c in FRESNEL_SEQ_CASES), 'k2_mc'),
            ('trace_nonseq_fwd_fresnel', 'trace_nonseq_fwd.cu', 1029,
             fr_p['scene_mc']['fwd_launches']['trace_nonseq_fwd'],
             max(fr_k[f'k5k6_{c}_{N_MAIN}']['max_abs_err']
                 for c in FRESNEL_NS_CASES), 'k5_mc'),
            ('trace_nonseq_bwd_fresnel', 'trace_nonseq_bwd.cu', 2157,
             fr_p['scene_mc']['grad_launches']['trace_nonseq_bwd'],
             max(fr_k[f'k5k6_{c}_{N_MAIN}']['bwd']['max_abs_err']
                 for c in FRESNEL_NS_CASES), 'k6_mc')):
        bounds[name] = fr_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, fr_t[key]['kernel_ms'],
            fr_t[key]['plain_ms']))
    # the instantiations with the coatings (section 12): launches on the
    # counted paths of the coated singlet (K1, K2) and the telescope (K5,
    # K6), errors at 1M rays over the cases, times and bounds on those two
    co_k, co_t, co_b = (coating['kernels'], coating['timing'],
                        coating['bounds'])
    co_p = coating['paths']
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_coat', 'trace_seq_fwd.cu', 489,
             co_p['coated_weighted']['fwd_launches']['trace_seq_fwd'],
             max(co_k[f'k1k2_{c}']['max_abs_err'] for c in COAT_SEQ_CASES),
             'k1'),
            ('trace_seq_bwd_coat', 'trace_seq_bwd.cu', 1712,
             co_p['coated_weighted']['grad_launches']['trace_seq_bwd'],
             max(co_k[f'k1k2_{c}']['bwd']['max_abs_err']
                 for c in COAT_SEQ_CASES), 'k2'),
            ('trace_nonseq_fwd_coat', 'trace_nonseq_fwd.cu', 1029,
             co_p['telescope']['fwd_launches']['trace_nonseq_fwd'],
             max(co_k[f'k5k6_{c}']['max_abs_err'] for c in COAT_NS_CASES
                 if c != 'telescope'), 'k5'),
            ('trace_nonseq_bwd_coat', 'trace_nonseq_bwd.cu', 2157,
             co_p['telescope']['grad_launches']['trace_nonseq_bwd'],
             max(co_k[f'k5k6_{c}']['bwd']['max_abs_err']
                 for c in COAT_NS_CASES), 'k6')):
        bounds[name] = co_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, co_t[key]['kernel_ms'],
            co_t[key]['plain_ms']))
    # the instantiations with the diffractive kinds (section 13): launches on
    # the counted paths of the hybrid achromat (K1, K2) and the Scene of
    # every new kind (K5, K6), errors at 1M rays over the cases, times and
    # bounds on those two
    df_k, df_t, df_b = (diffractive['kernels'], diffractive['timing'],
                        diffractive['bounds'])
    df_p = diffractive['paths']
    seq_cases = [k for k in df_k if not k.startswith('scene')]
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_diff', 'trace_seq_fwd.cu', 489,
             df_p['hybrid']['fwd_launches']['trace_seq_fwd'],
             max(df_k[c]['max_abs_err'] for c in seq_cases), 'k1'),
            ('trace_seq_bwd_diff', 'trace_seq_bwd.cu', 1712,
             df_p['hybrid']['grad_launches']['trace_seq_bwd'],
             max(df_k[c]['bwd']['max_abs_err'] for c in seq_cases), 'k2'),
            ('trace_nonseq_fwd_diff', 'trace_nonseq_fwd.cu', 1029,
             df_p['scene']['fwd_launches']['trace_nonseq_fwd'],
             df_k[f'scene_{N_MAIN}']['max_abs_err'], 'k5'),
            ('trace_nonseq_bwd_diff', 'trace_nonseq_bwd.cu', 2157,
             df_p['scene']['grad_launches']['trace_nonseq_bwd'],
             df_k[f'scene_{N_MAIN}']['bwd']['max_abs_err'], 'k6')):
        bounds[name] = df_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, df_t[key]['kernel_ms'],
            df_t[key]['plain_ms']))
    # the instantiations with fuzzy programs (section 14): launches on the
    # counted paths of the Gaussian apodizer (K1, K2) and the Lorentzian
    # Scene (K5, K6), errors at 1M rays over the cases, times and bounds on
    # those two
    fz_k, fz_t, fz_b = fuzzy['kernels'], fuzzy['timing'], fuzzy['bounds']
    fz_p = fuzzy['paths']
    seq_cases = [k for k in fz_k if 'scene' not in k]
    ns_cases = [k for k in fz_k if 'scene' in k]
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_fuzzy', 'trace_seq_fwd.cu', 489,
             fz_p['apodizer']['fwd_launches']['trace_seq_fwd'],
             max(fz_k[c]['max_abs_err'] for c in seq_cases), 'k1'),
            ('trace_seq_bwd_fuzzy', 'trace_seq_bwd.cu', 1712,
             fz_p['apodizer']['grad_launches']['trace_seq_bwd'],
             max(fz_k[c]['bwd']['max_abs_err'] for c in seq_cases), 'k2'),
            ('trace_nonseq_fwd_fuzzy', 'trace_nonseq_fwd.cu', 1029,
             fz_p['lorentz_scene']['fwd_launches']['trace_nonseq_fwd'],
             max(fz_k[c]['max_abs_err'] for c in ns_cases), 'k5'),
            ('trace_nonseq_bwd_fuzzy', 'trace_nonseq_bwd.cu', 2157,
             fz_p['lorentz_scene']['grad_launches']['trace_nonseq_bwd'],
             max(fz_k[c]['bwd']['max_abs_err'] for c in ns_cases), 'k6')):
        bounds[name] = fz_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, fz_t[key]['kernel_ms'],
            fz_t[key]['plain_ms']))
    # the instantiations with freeform surfaces (section 15): launches on
    # the counted paths of example 19's corrector (K1, K2) and its Scene
    # (K5, K6), errors at 1M rays over the cases, times and bounds on those
    # two
    ff_k, ff_t, ff_b = (freeform['kernels'], freeform['timing'],
                        freeform['bounds'])
    ff_p = freeform['paths']
    seq_cases = [k for k in ff_k if 'scene' not in k]
    ns_cases = [k for k in ff_k if 'scene' in k]
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_freeform', 'trace_seq_fwd.cu', 489,
             ff_p['ex19']['fwd_launches']['trace_seq_fwd'],
             max(ff_k[c]['max_abs_err'] for c in seq_cases), 'k1'),
            ('trace_seq_bwd_freeform', 'trace_seq_bwd.cu', 1712,
             ff_p['ex19']['grad_launches']['trace_seq_bwd'],
             max(ff_k[c]['bwd']['max_abs_err'] for c in seq_cases), 'k2'),
            ('trace_nonseq_fwd_freeform', 'trace_nonseq_fwd.cu', 1029,
             ff_p['ex19_scene']['fwd_launches']['trace_nonseq_fwd'],
             max(ff_k[c]['max_abs_err'] for c in ns_cases), 'k5'),
            ('trace_nonseq_bwd_freeform', 'trace_nonseq_bwd.cu', 2157,
             ff_p['ex19_scene']['grad_launches']['trace_nonseq_bwd'],
             max(ff_k[c]['bwd']['max_abs_err'] for c in ns_cases), 'k6')):
        bounds[name] = ff_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, ff_t[key]['kernel_ms'],
            ff_t[key]['plain_ms']))
    # the extended kinds' instantiation with the solids' and cones' bounds
    # (section 16): launches on the counted paths of the bounds table (K1,
    # K2) and example 27's lightpipe (K5, K6), errors at 1M rays over the
    # cases, times and bounds on those two
    so_k, so_t, so_b = solid['kernels'], solid['timing'], solid['bounds']
    so_p = solid['paths']
    ns_cases = [c for c in SOLID_CASES if c != 'bounds']
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_solids', 'trace_seq_fwd.cu', 489,
             so_p['bounds_grad']['fwd_launches']['trace_seq_fwd'],
             so_k['bounds']['max_abs_err'], 'k1'),
            ('trace_seq_bwd_solids', 'trace_seq_bwd.cu', 1712,
             so_p['bounds_grad']['grad_launches']['trace_seq_bwd'],
             so_k['bounds']['bwd']['max_abs_err'], 'k2'),
            ('trace_nonseq_fwd_solids', 'trace_nonseq_fwd.cu', 1029,
             so_p['lightpipe_design']['fwd_launches']['trace_nonseq_fwd'],
             max(so_k[c]['max_abs_err'] for c in ns_cases), 'k5'),
            ('trace_nonseq_bwd_solids', 'trace_nonseq_bwd.cu', 2157,
             so_p['lightpipe_design']['grad_launches']['trace_nonseq_bwd'],
             max(so_k[c]['bwd']['max_abs_err'] for c in ns_cases), 'k6')):
        bounds[name] = so_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, so_t[key]['kernel_ms'],
            so_t[key]['plain_ms']))
    # the instantiations with the field (section 17): launches on the
    # counted path of example 22's design (K1, K2), errors at 1M rays over
    # the cases (rays and field), times and bounds on its analyzer scene
    fd_k, fd_t, fd_b = field['kernels'], field['timing'], field['bounds']
    fd_l = field['paths'][f'ex22_{N_MAIN}']['design']['launches']
    for name, line, launches_, err, key in (
            ('trace_seq_fwd_field', 489, fd_l['trace_seq_fwd'],
             max(max(c['max_abs_err'], c['field_max_abs_err'])
                 for c in fd_k.values()), 'k1_analyzer'),
            ('trace_seq_bwd_field', 1712, fd_l['trace_seq_bwd'],
             max(max(c['bwd']['max_abs_err'],
                     c['bwd']['field']['max_abs_err'])
                 for c in fd_k.values()), 'k2_analyzer')):
        bounds[name] = fd_b[key]
        summary['kernels'].append(entry(
            name, 'trace_seq_fwd.cu' if 'fwd' in name else 'trace_seq_bwd.cu',
            line, launches_, err, fd_t[key]['kernel_ms'],
            fd_t[key]['plain_ms']))
    # the same instantiations through coated interfaces and metal mirrors
    # (section 18): launches on the counted path of the coat design (K1,
    # K2), errors at 1M rays over the cases (rays and field), times and
    # bounds on the coated FRESNEL_W singlet
    fc_k, fc_t, fc_b = (field_coat['kernels'], field_coat['timing'],
                        field_coat['bounds'])
    fc_l = field_coat['paths']['design']['launches']
    for name, line, launches_, err, key in (
            ('trace_seq_fwd_field_coat', 489, fc_l['trace_seq_fwd'],
             max(max(c['max_abs_err'], c['field_max_abs_err'])
                 for c in fc_k.values()), 'k1_coated_w'),
            ('trace_seq_bwd_field_coat', 1712, fc_l['trace_seq_bwd'],
             max(max(c['bwd']['max_abs_err'],
                     c['bwd']['field']['max_abs_err'])
                 for c in fc_k.values()), 'k2_coated_w')):
        bounds[name] = fc_b[key]
        summary['kernels'].append(entry(
            name, 'trace_seq_fwd.cu' if 'fwd' in name else 'trace_seq_bwd.cu',
            line, launches_, err, fc_t[key]['kernel_ms'],
            fc_t[key]['plain_ms']))
    # K5's and K6's instantiation with the field (section 19): launches on
    # the counted grad step of the mirror fold, errors at 1M rays over the
    # cases (rays and field), times and bounds on the naive scene
    fn_k, fn_t, fn_b = (field_ns['kernels'], field_ns['timing'],
                        field_ns['bounds'])
    fn_l = field_ns['grads']['simulate_fused']['launches']
    for name, source, line, launches_, err, key in (
            ('trace_nonseq_fwd_field', 'trace_nonseq_fwd.cu', 1029,
             fn_l['trace_nonseq_fwd'],
             max(max(c['max_abs_err'], c['field_max_abs_err'])
                 for c in fn_k.values()), 'k5_naive'),
            ('trace_nonseq_bwd_field', 'trace_nonseq_bwd.cu', 2157,
             fn_l['trace_nonseq_bwd'],
             max(max(c['bwd']['max_abs_err'],
                     c['bwd']['field']['max_abs_err'])
                 for c in fn_k.values()), 'k6_naive')):
        bounds[name] = fn_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, fn_t[key]['kernel_ms'],
            fn_t[key]['plain_ms']))
    # the instantiations with GRIN rods (section 20): launches on example
    # 24's design (K1, K2) and the counted grad step of the rod as a Scene
    # (K5, K6), errors at 1M rays over the cases, times and bounds on the
    # quarter-pitch rod and that Scene
    gr_k, gr_t, gr_b = grin['kernels'], grin['timing'], grin['bounds']
    gr_d = grin['design']['launches']
    gr_n = grin['grads']['ns']['fused']['launches']
    for name, source, line, launches_, err, key in (
            ('trace_seq_fwd_grin', 'trace_seq_fwd.cu', 1569,
             gr_d['trace_seq_fwd'],
             max(gr_k[c]['max_abs_err'] for c in GRIN_SEQ_CASES),
             'k1_quarter'),
            ('trace_seq_bwd_grin', 'trace_seq_bwd.cu', 1714,
             gr_d['trace_seq_bwd'],
             max(gr_k[c]['bwd']['max_abs_err'] for c in GRIN_SEQ_CASES),
             'k2_quarter'),
            ('trace_nonseq_fwd_grin', 'trace_nonseq_fwd.cu', 881,
             gr_n['trace_nonseq_fwd'],
             max(gr_k[c]['max_abs_err'] for c in GRIN_NS_CASES), 'k5_ns'),
            ('trace_nonseq_bwd_grin', 'trace_nonseq_bwd.cu', 2160,
             gr_n['trace_nonseq_bwd'],
             max(gr_k[c]['bwd']['max_abs_err'] for c in GRIN_NS_CASES),
             'k6_ns')):
        bounds[name] = gr_b[key]
        summary['kernels'].append(entry(
            name, source, line, launches_, err, gr_t[key]['kernel_ms'],
            gr_t[key]['plain_ms']))
    # the family instantiation on tables that mix families (section 21):
    # launches on the counted grad steps of the coated case (K1, K2) and
    # the Scene (K5, K6), and the field's on the freeform corrector's;
    # errors at 1M rays over the cases, times and bounds on those three
    mx_k, mx_t, mx_b = mix['kernels'], mix['timing'], mix['bounds']
    mx_p = mix['paths']
    for name, source, line, case, key, cases in (
            ('trace_seq_fwd_family', 'trace_seq_fwd.cu', 1528, 'coated',
             'k1_coated', MIX_SEQ_CASES),
            ('trace_seq_bwd_family', 'trace_seq_bwd.cu', 1712, 'coated',
             'k2_coated', MIX_SEQ_CASES),
            ('trace_nonseq_fwd_family', 'trace_nonseq_fwd.cu', 830, 'ns',
             'k5_ns', MIX_NS_CASES),
            ('trace_nonseq_bwd_family', 'trace_nonseq_bwd.cu', 2157, 'ns',
             'k6_ns', MIX_NS_CASES),
            ('trace_nonseq_fwd_field_family', 'trace_nonseq_fwd.cu', 861,
             'field_ff', 'k5f_field_ff', MIX_FIELD_CASES),
            ('trace_nonseq_bwd_field_family', 'trace_nonseq_bwd.cu', 2054,
             'field_ff', 'k6f_field_ff', MIX_FIELD_CASES)):
        bwd_entry = '_bwd' in name
        lib = name.split('_family')[0].replace('_field', '')
        err = max(mx_k[c]['bwd']['max_abs_err'] if bwd_entry
                  else mx_k[c]['max_abs_err'] for c in cases)
        bounds[name] = mx_b[key]
        summary['kernels'].append(entry(
            name, source, line,
            mx_p[case]['grad']['fused']['launches'][lib], err,
            mx_t[key]['kernel_ms'], mx_t[key]['plain_ms']))
    # the field's instantiation with GRIN rods (section 22): launches on the
    # counted grad steps of the Brewster case (K1, K2) and the Scene (K5,
    # K6), errors at 1M rays over the cases (rays and field), times and
    # bounds on the quarter-pitch rod and the Scene
    gf_k, gf_t, gf_b = (grin_field['kernels'], grin_field['timing'],
                        grin_field['bounds'])
    gf_p = grin_field['paths']
    for name, source, line, case, key, cases in (
            ('trace_seq_fwd_field_grin', 'trace_seq_fwd.cu', 1570,
             'brewster', 'k1_quarter', GRIN_FIELD_SEQ_CASES),
            ('trace_seq_bwd_field_grin', 'trace_seq_bwd.cu', 1712,
             'brewster', 'k2_quarter', GRIN_FIELD_SEQ_CASES),
            ('trace_nonseq_fwd_field_grin', 'trace_nonseq_fwd.cu', 881, 'ns',
             'k5_ns', GRIN_FIELD_NS_CASES),
            ('trace_nonseq_bwd_field_grin', 'trace_nonseq_bwd.cu', 2160,
             'ns', 'k6_ns', GRIN_FIELD_NS_CASES)):
        bwd_entry = '_bwd' in name
        err = max(max(gf_k[c]['bwd']['max_abs_err'],
                      gf_k[c]['bwd']['field']['max_abs_err']) if bwd_entry
                  else max(gf_k[c]['max_abs_err'],
                           gf_k[c]['field_max_abs_err']) for c in cases)
        bounds[name] = gf_b[key]
        summary['kernels'].append(entry(
            name, source, line,
            gf_p[case]['grad']['fused']['launches'][name.split('_field')[0]],
            err, gf_t[key]['kernel_ms'], gf_t[key]['plain_ms']))
    print(json.dumps(summary))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
