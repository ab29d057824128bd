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

- the kernel wrappers: K1 (with and without the 256 x 256 grid), K2 (also
  at 16M rays), K3 on the bench spot (256 x 256 and 32 x 32 grids), K5 on
  the naive scene (8 bounces, grid) and K6 on the same scene with the
  cotangents of a spot and grid loss (also at 16M rays); K4's gather and
  scatter on the 256 x 256 ring-former map, and K1, K2, K5 and K6 with
  that plate (chip_smoke.py section 7);
- the library calls that compute K3's and K4's functions, as chip_smoke.py
  times them: one ``index_add_`` and one ``index_put_`` (accumulate) of the
  bench spot's unit weights into the 256 x 256 grid, and of random weights
  spread over it; one ``torch.take`` and four advanced-index reads of K4's
  corners on the 256 x 256 map, one ``index_add_`` and four ``index_put_``
  (accumulate) of their cotangents, and K4's scatter on the 32 x 32 map
  with its ``index_add_``;
- the end-to-end calls: ``SequentialScene.simulate_fused``, the fused grad
  step, ``Scene.simulate_fused``, its grad step (K5 + K6), the eager
  ``Scene.simulate`` and the deep-optics grad step (the ring former, the
  map the only trainable leaf: K1 + K2);
- the mixed-surface and asphere scenes (chip_smoke.py section 8): K1, K2,
  K5 and K6 in their instantiation with the extended kinds, and
  ``simulate_fused`` on each (benchmarks/suite.py's
  ``mixed_surfaces_sequential_1M`` and ``asphere_sequential_1M``), and
  ``Renderer.render_3d`` at 1024 x 1024 on the naive scene
  (``render_1024x1024``);
- the dispersive scenes (chip_smoke.py section 9: the achromat with Abbe
  and with Sellmeier glasses, the Sellmeier Cooke triplet) on their own
  rays: K1 and K5 in their extended instantiation, K2 and K6 in the one
  with dispersion, ``simulate_fused`` and its grad step;
- the deterministic streams (chip_smoke.py section 10): K1, K2, K5 and K6
  in their instantiations with the streams (the path length on the bench
  singlet and the naive scene; K1 with the records on the bench singlet and
  the Cooke triplet, K5 with them on the naive scene),
  ``simulate_fused(track_opl=True)`` on both scene types, the wavefront
  grad step (``wavefront_rms(refocus=True)`` in c1 and c2, K1 + K2) and
  ``footprints`` on the Cooke triplet;
- the Fresnel kinds (chip_smoke.py section 11): K1, K2, K5 and K6 in their
  instantiations with them (the bench singlet with ``fresnel=True`` and
  ``'weighted'``, the naive scene in both modes, the Cooke triplet's
  27-row ghost), ``simulate_fused`` with a generator on both scene types
  and its spot-loss grad step;
- thin-film coatings and metal mirrors (chip_smoke.py section 12): K1 and
  K2 in their instantiations with the coatings on the coated bench singlet
  (``'weighted'``), K5 and K6 on example 11's telescope, the coated
  singlet's ``simulate_fused`` and grad step (c1, c2 and the coat), and
  the telescope's ``Scene.simulate_fused``;
- the diffractive and ideal elements (chip_smoke.py section 13): K1 and K2
  in their instantiations with them on example 25's hybrid achromat and
  example 05's nine-channel spectrometer, K5 and K6 on the Scene of every
  new kind, the hybrid's ``simulate_fused`` and grad step (c1, c2 and the
  DOE's phase) and the Scene's ``Scene.simulate_fused``;
- fuzzy apodization (chip_smoke.py section 14): K1 and K2 in their
  instantiations with fuzzy programs on the Gaussian apodizer and the
  obscured pupil, K5 and K6 on the Lorentzian Scene and the pupil as a
  Scene, the apodizer's ``simulate_fused`` and grad step (c1, c2) and the
  pupil's ``simulate_fused``;
- freeform surfaces (chip_smoke.py section 15): K1 and K2 in their
  instantiations with them on example 19's corrector, example 20's Zernike
  corrector (with the path length) and example 26's Shack-Hartmann sensor,
  K5 and K6 on example 19's corrector as a Scene, and example 19's
  ``simulate_fused`` and grad step (its freeform coefficients);
- convex solids, custom shapes and the point source (chip_smoke.py section
  16): K1 and K2 on the bounds table, K5 and K6 on example 27's lightpipe,
  the wedge and the axicon, the lightpipe's ``Scene.simulate_fused`` and
  design step (its width and height);
- the polarized field (chip_smoke.py section 17): K1 and K2 in their
  instantiation with the field on example 22's analyzer scene and example
  07's Brewster plane (circular E0, its grid), and example 22's
  ``simulate_fused`` and design step (the analyzer's angle);
- the field through coated interfaces and metal mirrors (chip_smoke.py
  section 18): K1 and K2 in the same instantiation on the coated FRESNEL_W
  bench singlet (circular E0) and on stack8, and the coated singlet's
  ``simulate_fused`` and grad step (c1, c2 and the coat);
- the field in the non-sequential scene (chip_smoke.py section 19): K5 and
  K6 in their instantiation with the field on the naive scene (circular
  E0, its grid) and the mirror fold, and the mirror fold's
  ``simulate_fused`` and grad step (its curvature and E0);
- GRIN rods (chip_smoke.py section 20): K1 and K2 in their instantiation
  with GRIN rods on the quarter-pitch rod and the mixed table (with the
  path length), K5 and K6 on the rod as a Scene, and example 24's design
  scene's ``simulate_fused`` and grad step (n0 and grin_A) on 1M rays;
- the kind mix (chip_smoke.py section 21): K1 and K2 in their family
  instantiation on each sequential case (a GRIN rod beside a Fresnel,
  coated, diffractive, fuzzy or freeform row), K5 and K6 on the rod as a
  Scene beside a coated window and a grating, and K5 and K6 in the field's
  instantiation on the field cases (a DOE, a microlens array, an apodized
  pupil, example 19's corrector), each with the path length or the field,
  on the JAX package's rays;
- the field through GRIN rods (chip_smoke.py section 22): K1 and K2 in
  their field instantiation with GRIN rods on the quarter-pitch rod with
  E0, K5 and K6 on the rod as a Scene under skew rays, circular E0.

Arguments, if any, are prefixes: only the calls whose names start with
one of them are profiled (``python3 chip_profile.py grin_field``).  The
last line names the card and its power limit as nvidia-smi gives them.  A call whose profile holds no device time reports null there.
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
    civ32, ciu32 = cs.plate_cells(torch, do_rays, cs.DO_SMALL_MAP)
    g_c = tuple(torch.randn(n, device=dev) for _ in range(4))
    g_c4 = torch.cat(g_c)
    do_grad_p = cs.ring_params(do_seq, dev, grad=True)
    # the library calls of K3 and K4 (chip_smoke.py section 6)
    from raytracetorch_tpu_torch.core.sensor import bin_indices
    ix, iy = bin_indices(cs.GRID, cs.GRID_E, spot.px, spot.py)
    spot_idx = (iy * cs.GRID[1] + ix,)
    g_spot = torch.zeros(cs.GRID[0] * cs.GRID[1], device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    hx, hy = (torch.randn(n, generator=gen, device=dev) * 0.6
              for _ in range(2))
    hw = torch.rand(n, generator=gen, device=dev)
    rix, riy = bin_indices(cs.GRID, cs.GRID_E, hx, hy)
    rand_idx = riy * cs.GRID[1] + rix
    cfg32 = rt.SensorConfig(n_sensors=1, grid_shape=(32, 32),
                            grid_half_extent=cs.GRID_E)
    v0, v1, u0, u1 = phase_grid._cells(cs.DO_MAP, civ, ciu)
    corner_cells = ((v0, u0), (v0, u1), (v1, u0), (v1, u1))
    flat4 = torch.cat([v * cs.DO_MAP[1] + u for v, u in corner_cells])
    g_corner = torch.zeros(cs.DO_MAP, device=dev)
    g_corner_flat = torch.zeros(cs.DO_MAP[0] * cs.DO_MAP[1], device=dev)
    v0, v1, u0, u1 = phase_grid._cells(cs.DO_SMALL_MAP, civ32, ciu32)
    flat4_32 = torch.cat([v * cs.DO_SMALL_MAP[1] + u for v, u in
                          ((v0, u0), (v0, u1), (v1, u0), (v1, u1))])
    g_corner_32 = torch.zeros(cs.DO_SMALL_MAP[0] * cs.DO_SMALL_MAP[1],
                              device=dev)

    def corner_scatter_library():
        for g, cell in zip(g_c, corner_cells):
            g_corner.index_put_(cell, g, accumulate=True)

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
        'k2_16m': (lambda: fused_trace.trace_seq_bwd_cuda(
            flat, kinds, rays16, cfg, (None,) * 7, g_mom), 'trace_seq_bwd'),
        'k3_spot': (lambda: grid.bin_grid_cuda(spot.px, spot.py, ones, 0,
                                               gcfg), 'grid_bin_kernel'),
        'k3_spot_32': (lambda: grid.bin_grid_cuda(spot.px, spot.py, ones, 0,
                                                  cfg32), 'grid_bin_kernel'),
        'k3_library': (lambda: g_spot.index_add_(0, spot_idx[0], ones),
                       None),
        'k3_index_put': (lambda: g_spot.index_put_(spot_idx, ones,
                                                   accumulate=True), None),
        'k3_random': (lambda: grid.bin_grid_cuda(hx, hy, hw, 0, gcfg),
                      'grid_bin'),
        'k3_random_library': (lambda: g_spot.index_add_(0, rand_idx, hw),
                              None),
        'k3_random_index_put': (lambda: g_spot.index_put_(
            (rand_idx,), hw, accumulate=True), None),
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
            g_c, civ, ciu, cs.DO_MAP), 'grid_corners_bwd'),
        'k4_scatter_32': (lambda: phase_grid.grid_corners_bwd_cuda(
            g_c, civ32, ciu32, cs.DO_SMALL_MAP), 'grid_corners_bwd'),
        'k4_library': (lambda: torch.take(cmap, flat4), None),
        'k4_index_reads': (lambda: [cmap[cell] for cell in corner_cells],
                           None),
        'k4_scatter_library': (lambda: g_corner_flat.index_add_(
            0, flat4, g_c4), None),
        'k4_scatter_index_put': (corner_scatter_library, None),
        'k4_scatter_32_library': (lambda: g_corner_32.index_add_(
            0, flat4_32, g_c4), None),
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
    # the extended kinds (chip_smoke.py section 8) and the renderer
    from raytracetorch_tpu_torch.render.camera import Camera, Renderer
    for case, make in (('mixed', cs.mixed_scene),
                       ('asphere', cs.asphere_scene)):
        sc, ns = make(rt), make(rt, cs.EXT_BOUNCES)
        emeta, ecfg = sc.static_meta(), sc.sensor_config()
        ep = sc.init_params(dev)
        eflat = rt.flatten_table_rows(sc.build_table(ep))
        ekinds = torch.tensor(fused_trace.kind_rows(emeta, ecfg),
                              dtype=torch.int32, device=dev)
        nb, necfg = ns.n_bounces, ns.sensor_config()
        calls.update({
            f'{case}_k1': (lambda f=eflat, k=ekinds, c=ecfg:
                           fused_trace.trace_seq_fwd_cuda(
                               f, k, rays, c, (), ext=True),
                           'trace_seq_fwd_kernel'),
            f'{case}_k2': (lambda f=eflat, k=ekinds, c=ecfg:
                           fused_trace.trace_seq_bwd_cuda(
                               f, k, rays, c, (None,) * 7, g_mom, maps=(),
                               ext=True), 'trace_seq_bwd'),
            f'{case}_k5': (lambda f=eflat, k=ekinds, c=necfg, b=nb:
                           fused_nonseq.trace_nonseq_fwd_cuda(
                               f, k, rays, c, b, (), ext=True),
                           'trace_nonseq_fwd_kernel'),
            f'{case}_k6': (lambda f=eflat, k=ekinds, c=necfg, b=nb:
                           fused_nonseq.trace_nonseq_bwd_cuda(
                               f, k, rays, c, b, (None,) * 7, g_mom,
                               maps=(), ext=True),
                           'trace_nonseq_bwd_kernel'),
            f'{case}_simulate_fused': (lambda sc=sc, p=ep:
                                       sc.simulate_fused(p, rays),
                                       'trace_seq_fwd_kernel')})
    # dispersion (chip_smoke.py section 9): the achromat (Abbe, Sellmeier)
    # and the Cooke triplet, their own rays; K2 and K6 in the instantiation
    # with dispersion, and the entry points
    for case in cs.DISP_CASES:
        sc, _, nbd = cs.disp_case(rt, case)
        ns = cs.disp_case(rt, case, cs.DISP_BOUNCES)[0]
        dmeta, dcfg = sc.static_meta(), sc.sensor_config(nbd)
        dp = sc.init_params(dev)
        dflat = rt.flatten_table_rows(sc.build_table(dp))
        dkinds = torch.tensor(fused_trace.kind_rows(dmeta, dcfg),
                              dtype=torch.int32, device=dev)
        drays = cs.disp_rays(rt, torch, case, n, dev, cs.SEED + 1)
        dg = torch.randn(1, nbd, 7, generator=torch.Generator(
            device=dev).manual_seed(cs.SEED), device=dev)
        ndcfg = ns.sensor_config(nbd)
        dgrad = sc.init_params(dev)
        for el, k in cs.DISP_TRAINED[case]:
            dgrad[el][k].requires_grad_(True)

        def disp_step(sc=sc, p=dgrad, r=drays, b=nbd):
            _, s_, _ = sc.simulate_fused(p, r, b)
            rt.spot_size_loss(s_).backward()

        calls.update({
            f'{case}_k1': (lambda f=dflat, k=dkinds, r=drays, c=dcfg:
                           fused_trace.trace_seq_fwd_cuda(
                               f, k, r, c, (), ext=True),
                           'trace_seq_fwd_kernel'),
            f'{case}_k2': (lambda f=dflat, k=dkinds, r=drays, c=dcfg, g=dg:
                           fused_trace.trace_seq_bwd_cuda(
                               f, k, r, c, (None,) * 7, g, maps=(),
                               ext=True, disp=True), 'trace_seq_bwd'),
            f'{case}_k5': (lambda f=dflat, k=dkinds, r=drays, c=ndcfg:
                           fused_nonseq.trace_nonseq_fwd_cuda(
                               f, k, r, c, cs.DISP_BOUNCES, (), ext=True),
                           'trace_nonseq_fwd_kernel'),
            f'{case}_k6': (lambda f=dflat, k=dkinds, r=drays, c=ndcfg, g=dg:
                           fused_nonseq.trace_nonseq_bwd_cuda(
                               f, k, r, c, cs.DISP_BOUNCES, (None,) * 7, g,
                               maps=(), ext=True, disp=True),
                           'trace_nonseq_bwd_kernel'),
            f'{case}_simulate_fused': (lambda sc=sc, p=dp, r=drays, b=nbd:
                                       sc.simulate_fused(p, r, b),
                                       'trace_seq_fwd_kernel'),
            f'{case}_grad_step_fused': (disp_step, 'trace_seq_bwd')})
    # the deterministic streams (chip_smoke.py section 10)
    opl = dict(track_opl=True)
    rec = dict(track_opl=True, record_paths=True, record_hits=True)
    for label, name, nonseq, flags in (('k1_opl', 'bench', False, opl),
                                       ('k1_records', 'bench', False, rec),
                                       ('k1_records_cooke', 'cooke', False,
                                        rec),
                                       ('k5_opl', 'bench', True, opl),
                                       ('k5_records', 'bench', True, rec)):
        sc, sp, sr, snb = cs.stream_case(rt, torch, name, n, dev,
                                         cs.SEED + 1,
                                         cs.NS_BOUNCES if nonseq else None)
        smeta, scfg, sflat, skinds, smaps, sext, _ = cs.stream_inputs(
            rt, torch, sc, sp, snb)
        if nonseq:
            calls[f'streams_{label}'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, b=sc.n_bounces,
                m=smaps, x=sext, fl=flags: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, x, **fl), 'trace_nonseq_fwd_kernel')
        else:
            calls[f'streams_{label}'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, m=smaps, x=sext,
                fl=flags: fused_trace.trace_seq_fwd_cuda(
                    f, k, r, c, m, x, **fl), 'trace_seq_fwd_kernel')
        if flags is opl:
            g1 = torch.ones(sr.n, device=dev)
            gm = torch.zeros(1, 1, 7, device=dev)
            calls[f'streams_{label.replace("k1", "k2").replace("k5", "k6")}'] = (
                (lambda f=sflat, k=skinds, r=sr, c=scfg, b=sc.n_bounces,
                 m=smaps, g=g1: fused_nonseq.trace_nonseq_bwd_cuda(
                     f, k, r, c, b, (None,) * 7, gm, maps=m, g_opl=g,
                     opl=True), 'trace_nonseq_bwd_kernel') if nonseq else
                (lambda f=sflat, k=skinds, r=sr, c=scfg, m=smaps, g=g1:
                 fused_trace.trace_seq_bwd_cuda(
                     f, k, r, c, (None,) * 7, gm, maps=m, g_opl=g, opl=True),
                 'trace_seq_bwd'))
    bench = cs.bench_scene(rt)
    wf_p = bench.init_params(dev)
    wf_g = bench.init_params(dev)
    for k in ('c1', 'c2'):
        wf_g['lens'][k].requires_grad_(True)
    wf_rays = cs.sample_rays(rt, torch, n, dev, cs.SEED)

    def wf_step():
        o, _, a = bench.simulate_fused(wf_g, wf_rays, track_opl=True)
        rt.wavefront_rms(o, a['opl'], refocus=True).backward()
    cooke = cs.cooke_scene(rt)
    c_p = cooke.init_params(dev)
    c_rays = rt.sample_bundles(torch.Generator(device=dev).manual_seed(
        cs.SEED), cs.cooke_bundles(rt, n), dev)
    calls.update({
        'simulate_fused_opl': (lambda: bench.simulate_fused(
            wf_p, wf_rays, track_opl=True), 'trace_seq_fwd_kernel'),
        'scene_simulate_fused_opl': (lambda: nscene.simulate_fused(
            nparams, wf_rays, track_opl=True), 'trace_nonseq_fwd_kernel'),
        'wavefront_grad_step_fused': (wf_step, 'trace_seq_bwd'),
        'footprints_cooke': (lambda: rt.footprints(cooke, c_p, c_rays),
                             'trace_seq_fwd_kernel')})
    # the Fresnel kinds (chip_smoke.py section 11)
    for name, nonseq in (('mc', False), ('weighted', False),
                         ('cooke_ghost', False), ('mc', True),
                         ('weighted', True)):
        fsc, build, fp, fr, fcfg, fdraws = cs.fresnel_case(
            rt, torch, name, n, dev, cs.FRESNEL_SEED + 5, nonseq)
        ftable, fmeta = build(fp)
        fflat = rt.flatten_table_rows(ftable).detach()
        fkinds = torch.tensor(fused_trace.kind_rows(fmeta, fcfg),
                              dtype=torch.int32, device=dev)
        fmaps = fused_trace.plate_maps(fmeta, {})
        fdisp = fused_trace.dispersive(fmeta)
        fgm = torch.ones(1, fcfg.n_bundles, 7, device=dev)
        label = f'fresnel_{name}'
        if nonseq:
            calls[f'{label}_k5'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, d=fdraws: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, False, fresnel=True, key=d),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, d=fdraws, g=fgm: fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, fresnel=True,
                    key=d), 'trace_nonseq_bwd_kernel')
        else:
            calls[f'{label}_k1'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, d=fdraws:
                fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, True,
                                               fresnel=True, uniforms=d),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, d=fdraws,
                g=fgm, x=fdisp: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (None,) * 7, g, maps=m, disp=x,
                    fresnel=True, uniforms=d), 'trace_seq_bwd')
    f_seq = cs.fresnel_scene(rt, True)
    f_ns = cs.fresnel_scene(rt, True, cs.NS_BOUNCES)
    f_sp, f_np = f_seq.init_params(dev), f_ns.init_params(dev)
    f_gp = f_seq.init_params(dev)
    for k in ('c1', 'c2'):
        f_gp['lens'][k].requires_grad_(True)

    def fresnel_step():
        _, s, _ = f_seq.simulate_fused(
            f_gp, wf_rays, generator=torch.Generator(device=dev))
        rt.spot_size_loss(s).backward()
    calls.update({
        'fresnel_simulate_fused_mc': (lambda: f_seq.simulate_fused(
            f_sp, wf_rays, generator=torch.Generator(device=dev)),
            'trace_seq_fwd_kernel'),
        'fresnel_grad_step_fused_mc': (fresnel_step, 'trace_seq_bwd'),
        'fresnel_scene_simulate_fused_mc': (lambda: f_ns.simulate_fused(
            f_np, wf_rays, generator=torch.Generator(device=dev)),
            'trace_nonseq_fwd_kernel')})
    # thin-film coatings and metal mirrors (chip_smoke.py section 12)
    for name, nonseq in (('coated_w', False), ('telescope', True)):
        csc, cp, cr, ccfg, cdraws = cs.coating_case(
            rt, torch, name, n, dev, cs.COAT_SEED + 7, nonseq)
        cmeta = csc.static_meta()
        cflat = rt.flatten_table_rows(csc.build_table(cp)).detach()
        ckinds = torch.tensor(fused_trace.kind_rows(cmeta, ccfg),
                              dtype=torch.int32, device=dev)
        cmaps = fused_trace.plate_maps(cmeta, {})
        cside = fused_trace.coat_side(cmeta, dev)
        cdisp = fused_trace.dispersive(cmeta)
        cgm = torch.ones(1, ccfg.n_bundles, 7, device=dev)
        label = f'coat_{name}'
        if nonseq:
            calls[f'{label}_k5'] = (
                lambda f=cflat, k=ckinds, r=cr, c=ccfg, b=csc.n_bounces,
                m=cmaps, x=cside: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, True, coat=x),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=cflat, k=ckinds, r=cr, c=ccfg, b=csc.n_bounces,
                m=cmaps, g=cgm, x=cside, y=cdisp:
                fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, disp=y, coat=x),
                'trace_nonseq_bwd_kernel')
        else:
            calls[f'{label}_k1'] = (
                lambda f=cflat, k=ckinds, r=cr, c=ccfg, m=cmaps, x=cside:
                fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, True,
                                               fresnel=True, coat=x),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=cflat, k=ckinds, r=cr, c=ccfg, m=cmaps, g=cgm,
                x=cside, y=cdisp: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (None,) * 7, g, maps=m, disp=y, coat=x),
                'trace_seq_bwd')
    c_seq = cs.coated_scene(rt, 'weighted')
    c_sp, c_gp = c_seq.init_params(dev), c_seq.init_params(dev)
    for k in ('c1', 'c2', 'coat_d'):
        c_gp['lens'][k].requires_grad_(True)
    tel = cs.telescope_scene(rt, rt, rt.glass, list(cs.TELESCOPE_PAIR))
    tel_p = tel.init_params(dev)
    tel_rays = rt.CollimatedDisk.make(
        radius=50.0, translation=[0.0, 0.0, 2.0],
        wavelength=cs.TELESCOPE_WL).sample(
            torch.Generator(device=dev).manual_seed(cs.COAT_SEED), n, dev)

    def coat_step():
        _, s, _ = c_seq.simulate_fused(c_gp, wf_rays)
        rt.spot_size_loss(s).backward()
    calls.update({
        'coat_simulate_fused_weighted': (lambda: c_seq.simulate_fused(
            c_sp, wf_rays), 'trace_seq_fwd_kernel'),
        'coat_grad_step_fused_weighted': (coat_step, 'trace_seq_bwd'),
        'coat_scene_simulate_fused_telescope': (lambda: tel.simulate_fused(
            tel_p, tel_rays), 'trace_nonseq_fwd_kernel')})
    # the diffractive and ideal elements (chip_smoke.py section 13)
    for name in cs.DIFF_CASES:
        dsc, dp, dr, dcfg, dnonseq = cs.diffractive_case(
            rt, torch, name, n, dev, cs.DIFF_SEED + 7)
        dmeta = dsc.static_meta()
        dflat = rt.flatten_table_rows(dsc.build_table(dp)).detach()
        dkinds = torch.tensor(fused_trace.kind_rows(dmeta, dcfg),
                              dtype=torch.int32, device=dev)
        dmaps = fused_trace.plate_maps(dmeta, {})
        dside = fused_trace.coat_side(dmeta, dev)
        ddisp = fused_trace.dispersive(dmeta)
        dgm = torch.ones(1, dcfg.n_bundles, 7, device=dev)
        label = f'diff_{name}'
        if dnonseq:
            calls[f'{label}_k5'] = (
                lambda f=dflat, k=dkinds, r=dr, c=dcfg, b=dsc.n_bounces,
                m=dmaps, x=dside: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, True, coat=x, diff=True),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=dflat, k=dkinds, r=dr, c=dcfg, b=dsc.n_bounces,
                m=dmaps, g=dgm, x=dside, y=ddisp:
                fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, disp=y, coat=x,
                    diff=True),
                'trace_nonseq_bwd_kernel')
            d_ns, d_np, d_nr = dsc, dp, dr
        else:
            calls[f'{label}_k1'] = (
                lambda f=dflat, k=dkinds, r=dr, c=dcfg, m=dmaps, x=dside:
                fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, True, coat=x,
                                               diff=True),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=dflat, k=dkinds, r=dr, c=dcfg, m=dmaps, g=dgm,
                x=dside, y=ddisp: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (None,) * 7, g, maps=m, disp=y, coat=x,
                    diff=True),
                'trace_seq_bwd')
    hyb = cs.hybrid_scene(rt)
    h_sp = hyb.init_params(dev)
    h_rays = cs.diffractive_case(rt, torch, 'hybrid', n, dev,
                                 cs.DIFF_SEED + 13)[2]

    def hybrid_step():
        p = hyb.init_params(dev)
        for el, k in (('lens', 'c1'), ('lens', 'c2'), ('doe', 'phase')):
            p[el][k].requires_grad_(True)
        _, s, _ = hyb.simulate_fused(p, h_rays, 3)
        rt.spot_size_loss(s).backward()
    calls.update({
        'diff_simulate_fused_hybrid': (lambda: hyb.simulate_fused(
            h_sp, h_rays, 3), 'trace_seq_fwd_kernel'),
        'diff_grad_step_fused_hybrid': (hybrid_step, 'trace_seq_bwd'),
        'diff_scene_simulate_fused': (lambda: d_ns.simulate_fused(
            d_np, d_nr, 2), 'trace_nonseq_fwd_kernel')})
    # fuzzy apodization and the obscured pupil (chip_smoke.py section 14)
    for name in cs.FUZZY_CASES:
        fsc, fp, fr, fcfg, fnonseq = cs.fuzzy_case(rt, torch, name, n, dev,
                                                   cs.FUZZY_SEED + 7)
        _, fflat, fkinds, fmaps, fside, fprog = cs.fuzzy_inputs(
            rt, torch, fsc, fp, fr, fcfg)
        fgm = torch.ones(1, 1, 7, device=dev)
        label = f'fuzzy_{name}'
        if fnonseq:
            calls[f'{label}_k5'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, x=fside, z=fprog: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, False, coat=x, fuzzy=z),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, g=fgm, x=fside, z=fprog:
                fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, coat=x, fuzzy=z),
                'trace_nonseq_bwd_kernel')
        else:
            calls[f'{label}_k1'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, x=fside,
                z=fprog: fused_trace.trace_seq_fwd_cuda(
                    f, k, r, c, m, False, coat=x, fuzzy=z),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, g=fgm,
                x=fside, z=fprog: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (None,) * 7, g, maps=m, coat=x, fuzzy=z),
                'trace_seq_bwd')
    apsc, ap_p, ap_rays, _, _ = cs.fuzzy_case(rt, torch, 'gauss', n, dev,
                                              cs.FUZZY_SEED + 13)
    pusc, pu_p, pu_rays, _, _ = cs.fuzzy_case(rt, torch, 'pupil', n, dev,
                                              cs.FUZZY_SEED + 13)

    def apod_step():
        p = apsc.init_params(dev)
        for k in ('c1', 'c2'):
            p['lens'][k].requires_grad_(True)
        _, s, _ = apsc.simulate_fused(p, ap_rays)
        s.spot_rms(0)[0].backward()
    calls.update({
        'fuzzy_simulate_fused_apodizer': (lambda: apsc.simulate_fused(
            ap_p, ap_rays), 'trace_seq_fwd_kernel'),
        'fuzzy_grad_step_fused_apodizer': (apod_step, 'trace_seq_bwd'),
        'fuzzy_simulate_fused_pupil': (lambda: pusc.simulate_fused(
            pu_p, pu_rays), 'trace_seq_fwd_kernel')})
    # freeform, Zernike and wedge lenses (chip_smoke.py section 15)
    ex20_terms = cs.ex20_prescription(rt, torch, dev)[0]
    for name in cs.FREEFORM_CASES:
        fsc, fp, fr, fcfg, fnonseq = cs.freeform_case(
            rt, torch, name, n, dev, cs.FREEFORM_SEED + 7, ex20_terms)
        _, fflat, fkinds, fmaps, fside, fprog, fpw = cs.freeform_inputs(
            rt, torch, fsc, fp, fr, fcfg)
        fgm = torch.ones(1, 1, 7, device=dev)
        label = f'freeform_{name}'
        if fnonseq:
            calls[f'{label}_k5'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, x=fside, z=fprog, w=fpw:
                fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, b, m, True, coat=x, fuzzy=z, ff=w),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, b=fsc.n_bounces,
                m=fmaps, g=fgm, x=fside, z=fprog, w=fpw:
                fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, ext=True, coat=x,
                    fuzzy=z, ff=w),
                'trace_nonseq_bwd_kernel')
        else:
            opl = name == 'ex20'
            calls[f'{label}_k1'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, x=fside,
                z=fprog, w=fpw, o=opl: fused_trace.trace_seq_fwd_cuda(
                    f, k, r, c, m, True, track_opl=o, coat=x, fuzzy=z, ff=w),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, g=fgm,
                x=fside, z=fprog, w=fpw, o=opl: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (None,) * 7, g, maps=m, ext=True, opl=o,
                    coat=x, fuzzy=z, ff=w),
                'trace_seq_bwd')
    ffsc, ff_p, ff_rays, _, _ = cs.freeform_case(rt, torch, 'ex19', n, dev,
                                                 cs.FREEFORM_SEED + 13)

    def ff_step():
        p = ffsc.init_params(dev)
        p['corrector']['xy1'].requires_grad_(True)
        _, s, _ = ffsc.simulate_fused(p, ff_rays)
        (s.spot_rms(0)[0] ** 2).backward()
    calls.update({
        'freeform_simulate_fused_ex19': (lambda: ffsc.simulate_fused(
            ff_p, ff_rays), 'trace_seq_fwd_kernel'),
        'freeform_grad_step_fused_ex19': (ff_step, 'trace_seq_bwd')})
    # convex solids, custom shapes and the point source (section 16)
    for name in ('bounds', 'lightpipe', 'wedge', 'axicon'):
        ssc, sp, sr, _ = cs.solid_case(rt, torch, name, n, dev,
                                       cs.SOLID_SEED + 7)
        smeta, scfg = ssc.static_meta(), ssc.sensor_config()
        sflat = rt.flatten_table_rows(ssc.build_table(sp)).detach()
        skinds = torch.tensor(fused_trace.kind_rows(smeta, scfg),
                              dtype=torch.int32, device=dev)
        smaps = fused_trace.plate_maps(smeta, {})
        sgm = torch.ones(1, 1, 7, device=dev)
        label = f'solid_{name}'
        if ssc.sequential:
            calls[f'{label}_k1'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, m=smaps:
                fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, True),
                'trace_seq_fwd_kernel')
            calls[f'{label}_k2'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, m=smaps, g=sgm:
                fused_trace.trace_seq_bwd_cuda(f, k, r, c, (None,) * 7, g,
                                               maps=m, ext=True),
                'trace_seq_bwd')
        else:
            calls[f'{label}_k5'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, b=ssc.n_bounces,
                m=smaps: fused_nonseq.trace_nonseq_fwd_cuda(f, k, r, c, b, m,
                                                             True),
                'trace_nonseq_fwd_kernel')
            calls[f'{label}_k6'] = (
                lambda f=sflat, k=skinds, r=sr, c=scfg, b=ssc.n_bounces,
                m=smaps, g=sgm: fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, b, (None,) * 7, g, maps=m, ext=True),
                'trace_nonseq_bwd_kernel')
    lpsc = cs.lightpipe_scene(rt, grad=True)
    lp_p, lp_rays = lpsc.init_params(dev), cs.lightpipe_rays(torch, n, dev)

    def lp_step():
        p = {k: dict(v) for k, v in lp_p.items()}
        p['pipe']['width'] = lp_p['pipe']['width'].clone().requires_grad_(
            True)
        lpsc.simulate_fused(p, lp_rays)[1].spot_rms(0)[0].backward()
    calls.update({
        'solid_simulate_fused_lightpipe': (lambda: lpsc.simulate_fused(
            lp_p, lp_rays), 'trace_nonseq_fwd_kernel'),
        'solid_grad_step_fused_lightpipe': (lp_step,
                                            'trace_nonseq_bwd_kernel')})
    # the polarized field (section 17)
    for name in ('analyzer', 'ex07_circ'):
        fsc, fp, fr, fe0, _ = cs.field_case(rt, torch, name, n, dev,
                                            cs.FIELD_SEED + 7)
        fmeta, fcfg, fflat, fkinds, fmaps, ffield, fside = cs.field_inputs(
            rt, torch, fsc, fp, fr, fe0, dev)
        fgm = torch.ones(1, 1, 7, device=dev)
        label = f'field_{name}'
        calls[f'{label}_k1'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            sd=fside: fused_trace.trace_seq_fwd_cuda(
                f, k, r, c, m, True, fresnel=True, diff=True, field=e, **sd),
            'trace_seq_fwd_kernel')
        calls[f'{label}_k2'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            sd=fside, g=fgm: fused_trace.trace_seq_bwd_cuda(
                f, k, r, c, (None,) * 7, g, maps=m, ext=True, fresnel=True,
                diff=True, field=e, g_field=[r.px] * 6, **sd),
            'trace_seq_bwd')
    dsc = cs.ex22_scene(rt, 'design')
    d_p, d_rays = dsc.init_params(dev), cs.ref_disk(rt, n, 2.0, -5.0, dev)

    def field_step():
        p = {k: dict(v) for k, v in d_p.items()}
        p['analyzer']['angle'] = d_p['analyzer']['angle'].clone() \
            .requires_grad_(True)
        dsc.simulate_fused(p, d_rays, track_field=True)[2][
            'field_power'].mean().backward()
    calls.update({
        'field_simulate_fused_analyzer': (lambda: dsc.simulate_fused(
            d_p, d_rays, track_field=True), 'trace_seq_fwd_kernel'),
        'field_grad_step_fused_analyzer': (field_step, 'trace_seq_bwd')})
    # the field through coated interfaces and metal mirrors (section 18)
    for name in ('coated_w', 'stack8'):
        fsc, fp, fr, fe0, fu = cs.field_coat_case(rt, torch, name, n, dev,
                                                  cs.FIELD_COAT_SEED + 7)
        fmeta, fcfg, fflat, fkinds, fmaps, ffield, fside = cs.field_inputs(
            rt, torch, fsc, fp, fr, fe0, dev)
        fgm = torch.ones(1, 1, 7, device=dev)
        label = f'field_coat_{name}'
        calls[f'{label}_k1'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            sd=fside: fused_trace.trace_seq_fwd_cuda(
                f, k, r, c, m, True, fresnel=True, diff=True, field=e, **sd),
            'trace_seq_fwd_kernel')
        calls[f'{label}_k2'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            sd=fside, g=fgm: fused_trace.trace_seq_bwd_cuda(
                f, k, r, c, (None,) * 7, g, maps=m, ext=True, fresnel=True,
                diff=True, field=e, g_field=[r.px] * 6, **sd),
            'trace_seq_bwd')
    fcsc = cs.field_coat_scene(rt, 'coated_w')
    fc_p = fcsc.init_params(dev)
    fc_rays = cs.field_coat_ref_rays(rt, 'coated_w', n, dev)
    fc_e0 = cs.FIELD_COAT_E0['circular']

    def coat_field_step():
        p = {k: dict(v) for k, v in fc_p.items()}
        for k in ('c1', 'c2', 'coat_d'):
            p['lens'][k] = fc_p['lens'][k].clone().requires_grad_(True)
        fcsc.simulate_fused(p, fc_rays, track_field=True, E0=fc_e0)[1] \
            .total_weight(0)[0].backward()
    calls.update({
        'field_coat_simulate_fused_coated_w': (
            lambda: fcsc.simulate_fused(fc_p, fc_rays, track_field=True,
                                       E0=fc_e0), 'trace_seq_fwd_kernel'),
        'field_coat_grad_step_fused_coated_w': (coat_field_step,
                                                'trace_seq_bwd')})
    # the field in the non-sequential scene (section 19)
    for name in ('naive', 'fold'):
        fsc, fp, fr, fe0, _ = cs.field_ns_case(rt, torch, name, n, dev,
                                               cs.FIELD_NS_SEED + 7)
        fmeta, fcfg, fflat, fkinds, fmaps, ffield, fside = cs.field_ns_inputs(
            rt, torch, fsc, fp, fr, fe0, dev)
        fgm = torch.ones(1, 1, 7, device=dev)
        label = f'field_ns_{name}'
        calls[f'{label}_k5'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            s=fside, nb=fsc.n_bounces: fused_nonseq.trace_nonseq_fwd_cuda(
                f, k, r, c, nb, m, True, fresnel=True, field=e, **s),
            'trace_nonseq_fwd_kernel')
        calls[f'{label}_k6'] = (
            lambda f=fflat, k=fkinds, r=fr, c=fcfg, m=fmaps, e=ffield,
            s=fside, nb=fsc.n_bounces, g=fgm:
            fused_nonseq.trace_nonseq_bwd_cuda(
                f, k, r, c, nb, (None,) * 7, g, maps=m, ext=True,
                fresnel=True, field=e, g_field=[r.px] * 6, **s),
            'trace_nonseq_bwd_kernel')
    nfsc = cs.field_ns_scene(rt, 'fold')
    nf_p = nfsc.init_params(dev)
    nf_rays = cs.ref_disk(rt, n, 2.0, 1.0, dev)
    nf_e0 = cs.field_ns_source('fold')[4]

    def ns_field_step():
        p = {k: dict(v) for k, v in nf_p.items()}
        p['mirror']['c'] = nf_p['mirror']['c'].clone().requires_grad_(True)
        e0 = torch.tensor(nf_e0, device=dev, requires_grad=True)
        _, s, aux = nfsc.simulate_fused(p, nf_rays, track_field=True, E0=e0)
        cs.field_ns_loss(s, aux).backward()
    calls.update({
        'field_ns_simulate_fused_fold': (
            lambda: nfsc.simulate_fused(nf_p, nf_rays, track_field=True,
                                       E0=nf_e0), 'trace_nonseq_fwd_kernel'),
        'field_ns_grad_step_fused_fold': (ns_field_step,
                                          'trace_nonseq_bwd_kernel')})
    # GRIN rods (section 20)
    for name in ('quarter', 'mixed', 'ns'):
        rsc = cs.grin_scene(rt, name)
        rp = rsc.init_params(dev)
        rr = cs.grin_rays(rt, torch, name, n, dev, cs.GRIN_SEED + 7)
        rmeta, rcfg, rflat, rkinds, rmaps, rext = cs.grin_inputs(rt, torch,
                                                                 rsc, rp)
        rgm = torch.ones(1, 1, 7, device=dev)
        if name == 'ns':
            calls['grin_ns_k5'] = (
                lambda f=rflat, k=rkinds, r=rr, c=rcfg, m=rmaps, e=rext,
                nb=rsc.n_bounces: fused_nonseq.trace_nonseq_fwd_cuda(
                    f, k, r, c, nb, m, e, track_opl=True),
                'trace_nonseq_fwd_kernel')
            calls['grin_ns_k6'] = (
                lambda f=rflat, k=rkinds, r=rr, c=rcfg, m=rmaps, e=rext,
                nb=rsc.n_bounces, g=rgm: fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, nb, (r.px,) + (None,) * 6, g, maps=m, ext=e,
                    opl=True, g_opl=r.px),
                'trace_nonseq_bwd_kernel')
            continue
        calls[f'grin_{name}_k1'] = (
            lambda f=rflat, k=rkinds, r=rr, c=rcfg, m=rmaps, e=rext:
            fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, e, track_opl=True),
            'trace_seq_fwd_kernel')
        calls[f'grin_{name}_k2'] = (
            lambda f=rflat, k=rkinds, r=rr, c=rcfg, m=rmaps, e=rext, g=rgm:
            fused_trace.trace_seq_bwd_cuda(f, k, r, c, (r.px,) + (None,) * 6,
                                           g, maps=m, ext=e, opl=True,
                                           g_opl=r.px),
            'trace_seq_bwd')
    rod_sc = cs.grin_scene(rt, 'design')
    rod_p = rod_sc.init_params(dev)
    rod_rays = rt.CollimatedDisk.make(radius=0.8, translation=[0, 0, -3.0]) \
        .sample(torch.Generator(device=dev).manual_seed(cs.GRIN_SEED), n, dev)

    def rod_step():
        p = {k: dict(v) for k, v in rod_p.items()}
        for k in ('n0', 'grin_A'):
            p['rod'][k] = rod_p['rod'][k].clone().requires_grad_(True)
        (rod_sc.simulate_fused(p, rod_rays)[1].spot_rms(0)[0] ** 2).backward()
    calls.update({
        'grin_simulate_fused_design': (
            lambda: rod_sc.simulate_fused(rod_p, rod_rays),
            'trace_seq_fwd_kernel'),
        'grin_grad_step_fused_design': (rod_step, 'trace_seq_bwd')})
    # the kind mix (section 21)
    for name in cs.MIX_SEQ_CASES + cs.MIX_NS_CASES + cs.MIX_FIELD_CASES:
        xsc = cs.mix_scene(rt, name, torch)
        xp = xsc.init_params(dev)
        xr = cs.mix_rays(rt, torch, name, n, dev)
        xmeta, xcfg, xflat, xkinds, xmaps, xext, xside = cs.mix_inputs(
            rt, torch, xsc, xp, name, dev)
        xgm = torch.ones(max(xcfg.n_sensors, 1), xcfg.n_bundles, 7,
                         device=dev)
        xu = cs.mix_uniforms(torch, xmeta, n, dev)
        xfield = None
        if name in cs.MIX_FIELD_CASES:
            from raytracetorch_tpu_torch.core.field import FieldState
            xfield = FieldState.init(xr, list(cs.MIX_E0)).streams()
        if xsc.sequential:
            calls[f'mix_{name}_k1'] = (
                lambda f=xflat, k=xkinds, r=xr, c=xcfg, m=xmaps, e=xext,
                u=xu, s=xside: fused_trace.trace_seq_fwd_cuda(
                    f, k, r, c, m, e, track_opl=True, uniforms=u, **s),
                'trace_seq_fwd_kernel')
            calls[f'mix_{name}_k2'] = (
                lambda f=xflat, k=xkinds, r=xr, c=xcfg, m=xmaps, e=xext,
                u=xu, s=xside, g=xgm: fused_trace.trace_seq_bwd_cuda(
                    f, k, r, c, (r.px,) + (None,) * 6, g, maps=m, ext=e,
                    opl=True, g_opl=r.px, uniforms=u, **s),
                'trace_seq_bwd')
            continue
        calls[f'mix_{name}_k5'] = (
            lambda f=xflat, k=xkinds, r=xr, c=xcfg, m=xmaps, e=xext,
            nb=xsc.n_bounces, s=xside, fld=xfield:
            fused_nonseq.trace_nonseq_fwd_cuda(
                f, k, r, c, nb, m, e, track_opl=True, field=fld, **s),
            'trace_nonseq_fwd_kernel')
        calls[f'mix_{name}_k6'] = (
            lambda f=xflat, k=xkinds, r=xr, c=xcfg, m=xmaps, e=xext,
            nb=xsc.n_bounces, s=xside, g=xgm, fld=xfield:
            fused_nonseq.trace_nonseq_bwd_cuda(
                f, k, r, c, nb, (r.px,) + (None,) * 6, g, maps=m, ext=e,
                opl=True, g_opl=r.px, field=fld,
                g_field=None if fld is None else [r.px] * 6, **s),
            'trace_nonseq_bwd_kernel')
    # the field through GRIN rods (section 22)
    for name in ('quarter', 'ns'):
        gsc = cs.grin_field_scene(rt, name)
        gr = cs.grin_field_rays(rt, torch, name, n, dev,
                                cs.GRIN_FIELD_SEED + 7)
        gmeta, gcfg, gflat, gkinds, gmaps, gfield, gside = \
            cs.field_ns_inputs(rt, torch, gsc, gsc.init_params(dev), gr,
                               cs.GRIN_FIELD_E0[name], dev)
        ggm = torch.ones(1, 1, 7, device=dev)
        if name == 'ns':
            calls['grin_field_ns_k5'] = (
                lambda f=gflat, k=gkinds, r=gr, c=gcfg, m=gmaps,
                nb=gsc.n_bounces, s=gside, fld=gfield:
                fused_nonseq.trace_nonseq_fwd_cuda(f, k, r, c, nb, m, True,
                                                   field=fld, **s),
                'trace_nonseq_fwd_kernel')
            calls['grin_field_ns_k6'] = (
                lambda f=gflat, k=gkinds, r=gr, c=gcfg, m=gmaps,
                nb=gsc.n_bounces, s=gside, g=ggm, fld=gfield:
                fused_nonseq.trace_nonseq_bwd_cuda(
                    f, k, r, c, nb, (r.px,) + (None,) * 6, g, maps=m,
                    ext=True, field=fld, g_field=[r.px] * 6, **s),
                'trace_nonseq_bwd_kernel')
            continue
        calls['grin_field_quarter_k1'] = (
            lambda f=gflat, k=gkinds, r=gr, c=gcfg, m=gmaps, s=gside,
            fld=gfield: fused_trace.trace_seq_fwd_cuda(f, k, r, c, m, True,
                                                       field=fld, **s),
            'trace_seq_fwd_kernel')
        calls['grin_field_quarter_k2'] = (
            lambda f=gflat, k=gkinds, r=gr, c=gcfg, m=gmaps, s=gside,
            g=ggm, fld=gfield: fused_trace.trace_seq_bwd_cuda(
                f, k, r, c, (r.px,) + (None,) * 6, g, maps=m, ext=True,
                field=fld, g_field=[r.px] * 6, **s),
            'trace_seq_bwd')
    cam = Camera(position=[25.0, 18.0, -25.0], look_at=[0.0, 0.0, 10.0],
                 fov_deg=45.0, width=cs.RENDER_SIZE[1],
                 height=cs.RENDER_SIZE[0])
    renderer = Renderer(nscene)
    calls['render_1024x1024'] = (lambda: renderer.render_3d(nparams, cam),
                                 None)
    if len(sys.argv) > 1:   # only the calls whose names start so
        calls = {k: v for k, v in calls.items()
                 if k.startswith(tuple(sys.argv[1:]))}
    out = {'n': n, 'reps': REPS}
    for name, (fn, key) in calls.items():
        out[name] = profile(torch, fn, key)
    print(json.dumps({'phase': 'profile', **out}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == '__main__':
    sys.exit(main())
