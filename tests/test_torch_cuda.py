"""The kernels K1 (csrc/trace_seq_fwd.cu), K2 (csrc/trace_seq_bwd.cu), K3
(csrc/grid_bin.cu), K4 (csrc/grid_corners.cu), K5
(csrc/trace_nonseq_fwd.cu) and K6 (csrc/trace_nonseq_bwd.cu) against their
plain PyTorch versions, on the card, and the paths that run them, pixelated
phase plates included.

Every test here needs a CUDA card and is marked ``cuda``; without a card
each skips.  The file imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: final intensity exact; positions and directions atol/rtol 1e-5
(f32 rounding of a chain of a few surfaces: the kernel contracts
multiply-adds, eager torch does not); moments rtol 1e-5 atol 1e-3 (another
summation order).  At N = 2,999 no ray sits close enough to a rim for its
hit to flip.  K2's cotangents are held to chip_smoke.py's bounds (BWD_TOL,
TAB_RTOL; reasons there); so are grids (GRID_RAND_RTOL, GRID_SHARE and the
grid totals), K5 (the NS_* bounds), K6 (``chip_smoke.compare_k6``) and the
phase plates' map cotangents (``chip_smoke.compare_maps``), with the reasons
there.  K2's and K6's table cotangents are also held bit for bit across two
launches, and their instantiations without plate code to zero register
spills and at least two resident blocks per SM; K5's main-path
instantiation to no spill, no stack frame and at least the parent design's
blocks per SM.  K3 is held to its plain version with the whole grid, a
band of it and no band in shared memory, on one hot cell, on ragged and
small batches and on hits placed at its bin edges, unit weights exactly.
K4's scatter is held to its plain version on both of its paths (a map in
shared memory, vector atomics), at the launcher's cap and one row over
it, on odd and even widths, on row pairs that straddle 16-byte groups,
clamped rims, one hot cell, zero or missing cotangents and ragged batches.
K1 is held to its plain version at the edges of its blocks and waves, its
moments bit for bit across two launches, and its two instantiations
without the extended kinds to no spill, no stack frame and their launch
bounds' blocks per SM.  The instantiations of K1, K2, K5 and K6 with the
extended kinds (the mixed-surface and asphere scenes, and the dispersive
achromat and Cooke triplet, K2's and K6's wavelength cotangent and
dispersion columns included, the latter with chip_smoke.DISP_BWD_TOL) are
held to their plain versions with the same bounds, and the paths that
should take them (and the main paths, which should not) are counted.  So
are the instantiations with the deterministic streams (the optical path
length, path and hit recording; chip_smoke.py section 10's
``stream_kernels_vs_plain`` with its bounds, OPL_RTOL for the path length),
the paths that launch them, the recording run's eager backward
(``RECORD_RECOMPUTES``), their blocks per SM, and ``footprints`` on the
card against the CPU.  So are the instantiations with the Fresnel kinds
(chip_smoke.py section 11's ``fresnel_kernels_vs_plain`` with its bounds:
the bench singlet with ``fresnel=True`` and ``'weighted'``, the window's
and a Cooke triplet's ghost, the naive scene), the paths that launch them,
their blocks per SM, the device generator's Philox known-answer vectors
and the window ghost's closed-form flux.  So are the instantiations with
the coatings (chip_smoke.py section 12's ``coating_kernels_vs_plain`` with
its bounds: the coated bench singlet in FRESNEL_W and FRESNEL, example
11's telescope, the stress rows), the paths that launch them and their
blocks per SM.  So are the instantiations with the diffractive and ideal
elements (chip_smoke.py section 13's ``diffractive_kernels_vs_plain``:
example 25's hybrid achromat, example 05's nine-channel spectrometer, the
Scene of every new kind), the paths that launch them, their blocks per SM
and K1 with 18 bundles.  So are the instantiations with fuzzy programs
(chip_smoke.py section 14's ``fuzzy_kernels_vs_plain``: the obscured pupil
and the Gaussian apodizer, the Lorentzian and the pupil as Scenes), the
paths that launch them, their blocks per SM and the refusal of a legacy
callable on CUDA tensors.
"""

import math

import pytest
import torch

import chip_smoke
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.core.sensor import bin_indices
from raytracetorch_tpu_torch.ops import (fused_nonseq, fused_trace, grid,
                                         phase_grid)

torch.set_num_threads(2)

N = 2999          # not a multiple of the 256-ray block: the ragged edge


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')
    return torch.device('cuda')


def _bench_case(dev):
    scene = chip_smoke.bench_scene(trt)
    gen = torch.Generator(device=dev).manual_seed(0)
    rays = trt.CollimatedDisk.make(radius=4.0,
                                   translation=[0, 0, -10.0]).sample(
        gen, N, dev)
    return (scene.build_table(scene.init_params(dev)), rays,
            scene.sensor_config(), scene.static_meta())


def _two_bundle_case(dev):
    """chip_smoke.py's 6-row table (REFLECT, BLOCK, two sensors, a SNELL
    face with HEMI and APER_R2 bounds, an inverted stop), two bundles."""
    table, meta, cfg = chip_smoke.two_bundle_table(trt, torch, dev)
    return table, chip_smoke.two_bundle_rays(trt, torch, N, dev, 1), cfg, meta


CASES = {'bench': _bench_case, 'two_bundle': _two_bundle_case}


def _assert_kernel_matches_plain(out_k, sens_k, out_p, sens_p):
    torch.testing.assert_close(out_k.intensity, out_p.intensity, rtol=0,
                               atol=0)
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz'):
        torch.testing.assert_close(getattr(out_k, c), getattr(out_p, c),
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sens_k.moments, sens_p.moments, rtol=1e-5,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernel_matches_plain(case, dev):
    table, rays, cfg, meta = CASES[case](dev)
    flat = trt.flatten_table_rows(table)
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    before = fused_trace.LAUNCHES
    out_k, sens_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    assert fused_trace.LAUNCHES == before + 1
    out_p, sens_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                             meta)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, sens_k, out_p, sens_p)
    if case == 'two_bundle':
        # every row kind did work: reflections, absorptions, both sensors
        # saw both bundles
        assert int((out_k.dz < 0).sum()) > 0
        assert int((out_k.intensity == 0).sum()) > 0
        assert bool((sens_k.moments[:, :, 0] > 0).all())


@pytest.mark.cuda
def test_dispatcher_and_simulate_fused_launch_the_kernel(dev):
    """CUDA tensors go to the kernel: the dispatcher and simulate_fused each
    launch it once and give the kernel's own result."""
    table, rays, cfg, meta = _bench_case(dev)
    flat = trt.flatten_table_rows(table)
    kinds = torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                         device=dev)
    out_k, sens_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    before = fused_trace.LAUNCHES
    out_d, sens_d = trt.trace_sequential_fused(table, rays, cfg, meta)
    assert fused_trace.LAUNCHES == before + 1
    torch.testing.assert_close(out_d.px, out_k.px, rtol=0, atol=0)
    torch.testing.assert_close(sens_d.moments, sens_k.moments, rtol=0,
                               atol=0)
    scene = chip_smoke.bench_scene(trt)
    out_s, sens_s, _ = scene.simulate_fused(scene.init_params(dev), rays)
    assert fused_trace.LAUNCHES == before + 2
    torch.testing.assert_close(out_s.pz, out_k.pz, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_takes_empty_batch(dev):
    """N = 0 launches nothing and gives zero moments."""
    table, rays, cfg, meta = _bench_case(dev)
    empty = trt.Rays(**{f: getattr(rays, f)[:0].contiguous()
                        for f in rays.__dataclass_fields__})
    before = fused_trace.LAUNCHES
    out, sens = trt.trace_sequential_fused(table, empty, cfg, meta)
    assert fused_trace.LAUNCHES == before
    assert out.px.shape == (0,)
    assert bool((sens.moments == 0).all())


@pytest.mark.cuda
def test_kernel_refuses_strided_rays(dev):
    table, rays, cfg, meta = _bench_case(dev)
    strided = rays.replace(px=torch.stack([rays.px, rays.py], 1)[:, 0])
    with pytest.raises(ValueError, match='contiguous'):
        trt.trace_sequential_fused(table, strided, cfg, meta)


def _kinds(meta, cfg, dev):
    return torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32,
                        device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CASES))
def test_k2_matches_plain(case, dev):
    table, rays, cfg, meta = CASES[case](dev)
    flat = trt.flatten_table_rows(table)
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, rays.n, cfg, dev,
                                                    5)
    before = fused_trace.BWD_LAUNCHES
    gt_k, gr_k = fused_trace.trace_seq_bwd_cuda(flat, _kinds(meta, cfg, dev),
                                                rays, cfg, g_rays, g_mom)
    assert fused_trace.BWD_LAUNCHES == before + 1
    gt_p, gr_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta,
                                                 g_rays, g_mom)
    torch.cuda.synchronize()
    res = chip_smoke.compare_ray_cotangents(torch, gr_k, gr_p)
    assert res['rays_differ'] == 0
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p)


@pytest.mark.cuda
def test_simulate_fused_backward_launches_k2_once(dev):
    """A spot-loss gradient through simulate_fused launches K1 and K2 once
    each and equals the eager path's."""
    scene = chip_smoke.bench_scene(trt)
    _, rays, _, _ = _bench_case(dev)
    grads = []
    for sim in (scene.simulate_fused, scene.simulate):
        p = scene.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        fwd, bwd = fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES
        _, sens, _ = sim(p, rays)
        trt.spot_size_loss(sens).backward()
        grads.append(p['lens']['c1'].grad)
        launched = (fused_trace.LAUNCHES - fwd, fused_trace.BWD_LAUNCHES - bwd)
        assert launched == ((1, 1) if sim == scene.simulate_fused
                            else (0, 0))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_ray_gradients_through_the_kernels(dev):
    """Rays that require grad get gradients through simulate_fused on the
    card: a loss on output pz and px plus the spot RMS, with rays.px and
    rays.dx requiring grad, equals the eager path's."""
    scene = chip_smoke.bench_scene(trt)
    _, base, _, _ = _bench_case(dev)
    grads = []
    for sim in (scene.simulate_fused, scene.simulate):
        rays = base.replace(px=base.px.clone().requires_grad_(True),
                            dx=base.dx.clone().requires_grad_(True))
        out, sens, _ = sim(scene.init_params(dev), rays)
        loss = (out.pz.mean() + out.px.square().mean()
                + trt.spot_size_loss(sens))
        loss.backward()
        grads.append((rays.px.grad, rays.dx.grad))
    zeros = torch.zeros_like(base.px)
    res = chip_smoke.compare_ray_cotangents(
        torch, (grads[0][0], zeros, zeros, grads[0][1], zeros, zeros, zeros),
        (grads[1][0], zeros, zeros, grads[1][1], zeros, zeros, zeros))
    assert res['rays_differ'] == 0
    assert float(grads[0][0].abs().max()) > 0
    assert float(grads[0][1].abs().max()) > 0


@pytest.mark.cuda
def test_k2_takes_empty_batch(dev):
    """N = 0 launches nothing and gives a zero table cotangent."""
    table, rays, cfg, meta = _bench_case(dev)
    empty = trt.Rays(**{f: getattr(rays, f)[:0].contiguous()
                        for f in rays.__dataclass_fields__})
    before = fused_trace.BWD_LAUNCHES
    g_flat, g_in = fused_trace.trace_seq_bwd_cuda(
        trt.flatten_table_rows(table), _kinds(meta, cfg, dev), empty, cfg,
        (None,) * 7, torch.ones(1, 1, 7, device=dev))
    assert fused_trace.BWD_LAUNCHES == before
    assert bool((g_flat == 0).all()) and g_in[0].shape == (0,)


def _hits(dev, seed=3):
    """N hits on two slots, some outside the grid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, generator=gen, device=dev) * 0.6
    y = torch.randn(N, generator=gen, device=dev) * 0.6
    slot = torch.randint(0, 2, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    w = torch.rand(N, generator=gen, device=dev)
    cfg = trt.SensorConfig(n_sensors=2, grid_shape=chip_smoke.GRID,
                           grid_half_extent=chip_smoke.GRID_E)
    return x, y, slot, w, cfg


@pytest.mark.cuda
@pytest.mark.parametrize('weights', ['unit', 'random'])
def test_grid_bin_matches_plain(weights, dev):
    """K3 alone: unit weights bit for bit, random weights to GRID_RAND_RTOL
    of the largest bin (atomics add in a run-dependent order)."""
    x, y, slot, w, cfg = _hits(dev)
    if weights == 'unit':
        w = torch.ones_like(w)
    before = grid.GRID_LAUNCHES
    g_k = grid.bin_grid_cuda(x, y, w, slot, cfg)
    assert grid.GRID_LAUNCHES == before + 1
    g_p = grid.bin_grid_slots_plain(x, y, w, slot, cfg)
    torch.cuda.synchronize()
    if weights == 'unit':
        assert torch.equal(g_k, g_p)
    else:
        err = float((g_k - g_p).abs().max())
        assert err <= chip_smoke.GRID_RAND_RTOL * float(g_p.abs().max())


@pytest.mark.cuda
def test_grid_gradient_is_the_gather(dev):
    """bin_grid on CUDA tensors runs K3 and, backward, its gather:
    d sum(grid * W) / d w = W[slot, iy, ix], exactly."""
    x, y, slot, w, cfg = _hits(dev)
    w = w.requires_grad_(True)
    W = torch.randn(2, *chip_smoke.GRID, device=dev)
    before = grid.GATHER_LAUNCHES
    (grid.bin_grid(x, y, w, slot, cfg) * W).sum().backward()
    assert grid.GATHER_LAUNCHES == before + 1
    ix, iy = bin_indices(chip_smoke.GRID, chip_smoke.GRID_E, x, y)
    assert torch.equal(w.grad, W[slot.long(), iy, ix])


@pytest.mark.cuda
def test_k1_grid_matches_plain(dev):
    scene = chip_smoke.grid_scene(trt)
    table, rays, _, meta = _bench_case(dev)
    cfg = scene.sensor_config()
    flat = trt.flatten_table_rows(table)
    out_k, sens_k = fused_trace.trace_seq_fwd_cuda(flat, _kinds(meta, cfg,
                                                                dev),
                                                   rays, cfg)
    out_p, sens_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                             meta)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, sens_k, out_p, sens_p)
    chip_smoke.compare_grid(torch, sens_k.grid, sens_p.grid,
                            chip_smoke.GRID_TOTAL_RTOL)
    assert float(sens_k.grid.sum()) > 0.9 * N


@pytest.mark.cuda
def test_k2_grid_cotangent_matches_plain(dev):
    """K2 with the grid's cotangent and a spot-RMS moment cotangent."""
    scene = chip_smoke.grid_scene(trt)
    table, rays, _, meta = _bench_case(dev)
    cfg = scene.sensor_config()
    flat = trt.flatten_table_rows(table)
    W = torch.randn(1, *chip_smoke.GRID, device=dev)
    g_mom = torch.zeros(1, 1, 7, device=dev)
    g_mom[0, 0, 3:5] = 1.0
    gt_k, gr_k = fused_trace.trace_seq_bwd_cuda(
        flat, _kinds(meta, cfg, dev), rays, cfg, (None,) * 7, g_mom,
        g_grid=W)
    gt_p, gr_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta,
                                                 (None,) * 7, g_mom,
                                                 g_grid=W)
    torch.cuda.synchronize()
    res = chip_smoke.compare_ray_cotangents(
        torch, gr_k, gr_p, intensity_allowed=int(chip_smoke.GRID_SHARE * N))
    assert res['position_direction_differ'] == 0
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p)
    assert float(gr_k[6].abs().sum()) > 0


NS_CASES = {'naive': (chip_smoke.naive_scene, chip_smoke.sample_rays),
            'mirror_fold': (chip_smoke.mirror_fold_scene,
                            chip_smoke.mirror_fold_rays)}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(NS_CASES))
def test_k5_matches_plain(case, dev):
    make_scene, make_rays = NS_CASES[case]
    scene = make_scene(trt)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    rays = make_rays(trt, torch, N, dev, 2)
    before = fused_nonseq.NONSEQ_LAUNCHES
    out_k, sens_k = fused_nonseq.trace_nonseq_fwd_cuda(
        flat, _kinds(meta, cfg, dev), rays, cfg, scene.n_bounces)
    assert fused_nonseq.NONSEQ_LAUNCHES == before + 1
    out_p, sens_p = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays, cfg, meta, scene.n_bounces)
    torch.cuda.synchronize()
    res = chip_smoke.compare_nonseq(torch, out_k, sens_k, out_p, sens_p)
    assert res['mismatched'] == 0
    assert res['grid_total'] > 0.5 * N


@pytest.mark.cuda
def test_scene_simulate_fused_launches_k5_once(dev):
    """Scene.simulate_fused launches K5 once and nothing else; a budget of
    100 bounces gives the 8-bounce result bit for bit; under grad its
    backward launches K6 once and nothing else."""
    scene = chip_smoke.naive_scene(trt)
    params = scene.init_params(dev)
    _, rays, _, _ = _bench_case(dev)
    fwd, k5, k3 = (fused_trace.LAUNCHES, fused_nonseq.NONSEQ_LAUNCHES,
                   grid.GRID_LAUNCHES)
    out, sens, _ = scene.simulate_fused(params, rays)
    assert (fused_trace.LAUNCHES - fwd, fused_nonseq.NONSEQ_LAUNCHES - k5,
            grid.GRID_LAUNCHES - k3) == (0, 1, 0)
    out_b, sens_b, _ = chip_smoke.naive_scene(
        trt, n_bounces=100).simulate_fused(params, rays)
    assert torch.equal(out_b.px, out.px) and torch.equal(out_b.dz, out.dz)
    assert torch.equal(sens_b.moments, sens.moments)
    assert torch.equal(sens_b.grid, sens.grid)
    params['lens']['c1'].requires_grad_(True)
    _, sens_g, _ = scene.simulate_fused(params, rays)
    before = dict(k5=fused_nonseq.NONSEQ_LAUNCHES,
                  k6=fused_nonseq.NONSEQ_BWD_LAUNCHES,
                  k1=fused_trace.LAUNCHES, k2=fused_trace.BWD_LAUNCHES,
                  k3=grid.GRID_LAUNCHES, gather=grid.GATHER_LAUNCHES)
    trt.spot_size_loss(sens_g).backward()
    after = dict(k5=fused_nonseq.NONSEQ_LAUNCHES,
                 k6=fused_nonseq.NONSEQ_BWD_LAUNCHES,
                 k1=fused_trace.LAUNCHES, k2=fused_trace.BWD_LAUNCHES,
                 k3=grid.GRID_LAUNCHES, gather=grid.GATHER_LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == dict(
        k5=0, k6=1, k1=0, k2=0, k3=0, gather=0)
    assert bool(torch.isfinite(params['lens']['c1'].grad))


@pytest.mark.cuda
def test_eager_scene_bins_with_k3(dev):
    """The eager bounce loop on the card bins its grid with K3 and agrees
    with K5."""
    scene = chip_smoke.naive_scene(trt)
    params = scene.init_params(dev)
    _, rays, _, _ = _bench_case(dev)
    before = grid.GRID_LAUNCHES
    out_e, sens_e, _ = scene.simulate(params, rays)
    assert grid.GRID_LAUNCHES > before
    out_f, sens_f, _ = scene.simulate_fused(params, rays)
    torch.cuda.synchronize()
    res = chip_smoke.compare_nonseq(torch, out_e, sens_e, out_f, sens_f)
    assert res['mismatched'] == 0


K6_CASES = {'naive': (chip_smoke.naive_scene, chip_smoke.sample_rays),
            'mirror_fold': (chip_smoke.mirror_fold_scene,
                            chip_smoke.mirror_fold_rays),
            'cavity': (chip_smoke.cavity_scene, chip_smoke.mirror_fold_rays)}


def _k6_inputs(case, dev, n=N):
    make_scene, make_rays = K6_CASES[case]
    scene = make_scene(trt)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    return scene, flat, _kinds(meta, cfg, dev), make_rays(trt, torch, n, dev,
                                                          3)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(K6_CASES))
def test_k6_matches_plain(case, dev):
    """K6 against autograd of the plain bounce loop, with random cotangents
    of the rays, the moments and the grid, on the rays whose forward K5 and
    the plain loop trace alike (all but a few, except in the
    rounding-chaotic cavity)."""
    scene, _, _, rays = _k6_inputs(case, dev)
    before = fused_nonseq.NONSEQ_BWD_LAUNCHES
    res = chip_smoke.compare_k6(trt, torch, scene, rays, 4,
                                chaotic=case == 'cavity')
    assert fused_nonseq.NONSEQ_BWD_LAUNCHES == before + 1
    if case != 'naive':
        assert res['row0_curvature_cotangent'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(K6_CASES))
def test_k6_replay_equals_k5(case, dev):
    """The state K6's forward replay ends at is K5's output, bit for bit."""
    scene, flat, kinds, rays = _k6_inputs(case, dev)
    cfg = scene.sensor_config()
    out_k, _ = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg,
                                                  scene.n_bounces)
    g_flat, g_in, ends = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, cfg, scene.n_bounces, (None,) * 7, None,
        need_table=False, need_rays=False, replay=True)
    assert g_flat is None and g_in is None
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(ends, c), getattr(out_k, c)), c


@pytest.mark.cuda
def test_k6_takes_empty_batch(dev):
    """N = 0 launches nothing and gives a zero table cotangent."""
    scene, flat, kinds, rays = _k6_inputs('naive', dev)
    empty = trt.Rays(**{f: getattr(rays, f)[:0].contiguous()
                        for f in rays.__dataclass_fields__})
    before = fused_nonseq.NONSEQ_BWD_LAUNCHES
    g_flat, g_in = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, empty, scene.sensor_config(), scene.n_bounces,
        (None,) * 7, torch.ones(1, 1, 7, device=dev))
    assert fused_nonseq.NONSEQ_BWD_LAUNCHES == before
    assert bool((g_flat == 0).all()) and g_in[0].shape == (0,)


@pytest.mark.cuda
def test_k6_takes_strided_cotangents(dev):
    """Expanded (stride-0) and strided cotangents, as autograd may hand
    them, give the result of their contiguous copies, bit for bit."""
    scene, flat, kinds, rays = _k6_inputs('mirror_fold', dev)
    cfg = scene.sensor_config()
    g_mom = torch.randn(1, 1, 7, device=dev)
    h, w = cfg.grid_shape
    g_grid = torch.randn(1, h, 2 * w, device=dev)[:, :, ::2]
    g_strided = (torch.ones(1, device=dev).expand(rays.n),
                 torch.randn(2 * rays.n, device=dev)[::2]) + (None,) * 5
    res = [fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, cfg, scene.n_bounces, g, g_mom, g_grid=gg)
        for g, gg in ((g_strided, g_grid),
                      (tuple(None if x is None else x.contiguous()
                             for x in g_strided), g_grid.contiguous()))]
    assert torch.equal(res[0][0], res[1][0])
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)
    assert float(res[0][1][0].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(16, 16), (40, 40), (256, 256)])
def test_k4_matches_plain(shape, dev):
    """K4's gather bit for bit and its scatter per chip_smoke.compare_maps,
    on cells partly outside the map (clamped)."""
    gen = torch.Generator(device=dev).manual_seed(shape[0])
    cmap = torch.randn(*shape, generator=gen, device=dev)
    iv, iu = (torch.randint(-3, shape[0] + 3, (N,), generator=gen,
                            device=dev, dtype=torch.int32) for _ in range(2))
    before = phase_grid.CORNER_LAUNCHES, phase_grid.CORNER_BWD_LAUNCHES
    c_k = phase_grid.grid_corners_cuda(cmap, iv, iu)
    g_c = tuple(torch.randn(N, generator=gen, device=dev) for _ in range(4))
    s_k = phase_grid.grid_corners_bwd_cuda(g_c, iv, iu, shape)
    assert (phase_grid.CORNER_LAUNCHES, phase_grid.CORNER_BWD_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    c_p = phase_grid.grid_corners_plain(cmap, iv, iu)
    s_p = phase_grid.grid_corners_bwd_plain(g_c, iv, iu, shape)
    torch.cuda.synchronize()
    for a, b in zip(c_k, c_p):
        assert torch.equal(a, b)
    chip_smoke.compare_maps(torch, (s_k,), (s_p,))


def _plate_case(kind, dev):
    """The ring former with a 40 x 40 closed-form map, lit beyond its rims
    (chip_smoke.rim_rays), as a SequentialScene or a 3-bounce Scene with a
    256 x 256 irradiance grid."""
    scene = chip_smoke.ring_scene(
        trt, shape=(40, 40), bounces=None if kind == 'sequential' else 3,
        grid=kind == 'scene')
    params = chip_smoke.ring_params(scene, dev)
    return scene, params, chip_smoke.rim_rays(trt, torch, N, dev, 5)


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_plate_kernels_match_plain(kind, dev):
    """K1 (or K5) with a plate against its plain version, with this file's
    forward bounds (the NS_* bounds for K5), and K2 (or K6) per
    chip_smoke.compare_plate_bwd."""
    scene, params, rays = _plate_case(kind, dev)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(params))
    kinds = _kinds(meta, cfg, dev)
    maps = fused_trace.plate_maps(meta, scene.side_grids(params))
    if kind == 'sequential':
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg,
                                                    maps)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps)
        torch.cuda.synchronize()
        _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
    else:
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, scene.n_bounces, maps)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, scene.n_bounces, maps)
        torch.cuda.synchronize()
        chip_smoke.compare_nonseq(torch, out_k, s_k, out_p, s_p)
    assert int((out_k.intensity > 0).sum()) > N // 2
    chip_smoke.compare_plate_bwd(trt, torch, scene, params, rays, 7,
                                 nonseq=kind == 'scene')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_map_only_gradient_on_the_card(kind, dev):
    """Only the map requires grad: simulate_fused still runs its autograd
    Function (the forward and backward kernels once each) and gives the
    map the eager trace's gradient (each cell within GRAD_RTOL of the
    largest); the eager trace launches K4's gather and scatter once each
    per bounce that meets the plate."""
    scene, _, rays = _plate_case(kind, dev)
    fwd = (lambda: fused_trace.LAUNCHES) if kind == 'sequential' else \
        (lambda: fused_nonseq.NONSEQ_LAUNCHES)
    bwd = (lambda: fused_trace.BWD_LAUNCHES) if kind == 'sequential' else \
        (lambda: fused_nonseq.NONSEQ_BWD_LAUNCHES)
    grads = []
    for sim in (scene.simulate_fused, scene.simulate):
        p = chip_smoke.ring_params(scene, dev, grad=True)
        before = (fwd(), bwd(), phase_grid.CORNER_LAUNCHES,
                  phase_grid.CORNER_BWD_LAUNCHES)
        out, _, _ = sim(p, rays)
        chip_smoke.ring_loss(torch, out).backward()
        torch.cuda.synchronize()
        after = (fwd(), bwd(), phase_grid.CORNER_LAUNCHES,
                 phase_grid.CORNER_BWD_LAUNCHES)
        moved = tuple(a - b for a, b in zip(after, before))
        if sim == scene.simulate_fused:
            assert moved == (1, 1, 0, 0)
        else:
            assert moved[:2] == (0, 0) and moved[2] >= 1 and moved[3] >= 1
        grads.append(p['plate']['grid'].grad)
    assert float(grads[0].abs().max()) > 0
    chip_smoke.compare_maps(torch, grads[:1], grads[1:], chip_smoke.GRAD_RTOL)


@pytest.mark.cuda
def test_v1_runs_k1_with_every_stream_off(dev):
    """trace_sequential_v1 launches K1's kernel (counted in V1_LAUNCHES, not
    LAUNCHES) and equals K1 without a grid bit for bit."""
    table, rays, cfg, meta = _bench_case(dev)
    flat = trt.flatten_table_rows(table)
    before = fused_trace.V1_LAUNCHES, fused_trace.LAUNCHES
    out_v, sens_v, aux = trt.trace_sequential_v1(table, rays, cfg, meta)
    assert (fused_trace.V1_LAUNCHES, fused_trace.LAUNCHES) == \
        (before[0] + 1, before[1]) and aux == {}
    out_k, sens_k = fused_trace.trace_seq_fwd_cuda(
        flat, _kinds(meta, cfg, dev), rays, cfg)
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(out_v, c), getattr(out_k, c))
    assert torch.equal(sens_v.moments, sens_k.moments)


def _rect_stop_case(dev):
    """The two-bundle table with its inverted stop bounded by a 2 x 1
    rectangle (RECT) instead of a disk, and a 16 x 16 irradiance grid: a
    RECT bound without a plate, which the kernels test only in their
    instantiation with plate code."""
    from raytracetorch_tpu_torch.constants import PhysKind, SBKind, VBKind
    from raytracetorch_tpu_torch.core.table import ROW_OFFSETS
    table, rays, cfg, meta = _two_bundle_case(dev)
    cfg = trt.SensorConfig(n_sensors=cfg.n_sensors, n_bundles=cfg.n_bundles,
                           grid_shape=(16, 16), grid_half_extent=20.0)
    flat = trt.flatten_table_rows(table).clone()
    sb = ROW_OFFSETS['sb']
    flat[4, sb:sb + 3] = torch.tensor([2.0, 1.0, 0.0])
    meta = list(meta)
    meta[4] = trt.StaticRowMeta(PhysKind.APERTURE, SBKind.RECT, VBKind.NONE,
                                invert=True, plane=True)
    return flat, rays, cfg, meta


@pytest.mark.cuda
def test_rect_bound_without_a_plate_runs_plate_code(dev):
    """plate_maps gives () for a RECT bound without a plate, so K1, K2, K5
    and K6 run their instantiation with plate code (no map) and match
    their plain versions with this file's bounds."""
    flat, rays, cfg, meta = _rect_stop_case(dev)
    maps = fused_trace.plate_maps(meta, None)
    assert maps == ()
    kinds = _kinds(meta, cfg, dev)
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta, maps)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
    chip_smoke.compare_grid(torch, s_k.grid, s_p.grid,
                            chip_smoke.GRID_TOTAL_RTOL)
    g_rays, g_mom, g_grid = chip_smoke.random_cotangents(torch, rays.n, cfg,
                                                         dev, 5)
    gt_k, gr_k, gm_k = fused_trace.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, g_rays, g_mom, g_grid=g_grid, maps=maps)
    gt_p, gr_p, gm_p = fused_trace.trace_seq_bwd_plain(
        flat, rays, cfg, meta, g_rays, g_mom, g_grid=g_grid, maps=maps)
    torch.cuda.synchronize()
    assert gm_k == gm_p == ()
    chip_smoke.compare_ray_cotangents(
        torch, gr_k, gr_p, intensity_allowed=math.ceil(chip_smoke.GRID_SHARE
                                                       * rays.n))
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        plates=True)
    out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, cfg, 4,
                                                    maps)
    out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(flat, rays, cfg, meta,
                                                       4, maps)
    torch.cuda.synchronize()
    chip_smoke.compare_nonseq(torch, out_k, s_k, out_p, s_p)
    gt_k, gr_k, _ = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, cfg, 4, g_rays, g_mom, g_grid=g_grid, maps=maps)
    gt_p, gr_p, _ = fused_nonseq.trace_nonseq_bwd_plain(
        flat, rays, cfg, meta, 4, g_rays, g_mom, g_grid=g_grid, maps=maps)
    torch.cuda.synchronize()
    chip_smoke.compare_ray_cotangents(
        torch, gr_k, gr_p, allowed=3,
        intensity_allowed=math.ceil(chip_smoke.GRID_SHARE * rays.n))
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        plates=True)


N_BLOCKS = 100_000   # rays for the tests that need many blocks


def _bwd_case(lib, dev, n=N):
    """K2 on the bench scene or K6 on the naive scene: (wrapper, its
    positional inputs, cfg)."""
    if lib == 'trace_seq_bwd':
        table, rays, cfg, meta = _bench_case(dev)
        rays = chip_smoke.sample_rays(trt, torch, n, dev, 9)
        flat = trt.flatten_table_rows(table)
        return (fused_trace.trace_seq_bwd_cuda,
                (flat, _kinds(meta, cfg, dev), rays, cfg), cfg)
    scene, flat, kinds, rays = _k6_inputs('naive', dev, n)
    cfg = scene.sensor_config()
    return (fused_nonseq.trace_nonseq_bwd_cuda,
            (flat, kinds, rays, cfg, scene.n_bounces), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize('lib', ['trace_seq_bwd', 'trace_nonseq_bwd'])
def test_bwd_table_cotangent_is_deterministic(lib, dev):
    """Two launches of K2 (or K6) on the same inputs give the same table
    cotangent and ray cotangents, bit for bit: lanes, warps and blocks are
    summed in a fixed order, with no atomics."""
    wrapper, args, cfg = _bwd_case(lib, dev, N_BLOCKS)
    g_rays, g_mom, g_grid = chip_smoke.random_cotangents(
        torch, N_BLOCKS, cfg, dev, 11)
    runs = [wrapper(*args, g_rays, g_mom, g_grid=g_grid) for _ in range(2)]
    torch.cuda.synchronize()
    assert float(runs[0][0].abs().max()) > 0
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def _flags(name):
    """The bool and int template arguments of a mangled kernel name, as
    ints (a family set, uint32_t, left out): the last is kExt, the one
    before kPlates."""
    import re
    m = re.search(r'_kernelI((?:L[bij]\d+E)+)E', name)
    return [int(v) for v in re.findall(r'L[bi](\d+)E', m.group(1))]


def _no_plate(name):
    """Whether a mangled kernel name is an instantiation without plate code
    (its template argument kPlates, the last but one, false)."""
    return _flags(name)[-2] == 0


def _ext(name):
    """Whether a mangled kernel name is the instantiation with the extended
    kinds (its last template argument, kExt, true); the overloads with the
    streams share its template arguments (``_streams``)."""
    return _flags(name)[-1] == 1


def _streams(name):
    """Whether a mangled kernel name is an overload with the deterministic
    streams (a StreamOut or OplIn argument) and without the families' side
    data (a FamSide argument: ``_family``, the field's), which take those
    arguments too."""
    return ('StreamOut' in name or 'OplIn' in name) and 'FamSide' not in name


def _family(name, fams=63):
    """Whether a mangled kernel name is an instantiation with a FamSide
    argument of the family set ``fams`` (csrc/trace_seq_common.cuh::
    fam_link: 63, the family instantiation, every family together; 1, 3, 7,
    15 and 32, the chain's links that a table of one family runs: the
    Fresnel kinds, the coatings, the diffractive kinds, the fuzzy programs,
    GRIN rods), not the field's (a FieldIO or FieldIn argument too)."""
    return ('FamSide' in name and 'Field' not in name
            and f'Lj{fams}E' in name)


@pytest.mark.cuda
@pytest.mark.parametrize('lib', ['trace_seq_bwd', 'trace_nonseq_bwd'])
def test_bwd_kernels_run_two_blocks_per_sm_without_spills(lib, dev):
    """K2's and K6's instantiations without plate code spill no register
    (ptxas), and the main path's launch (the bench scene's 5 rows, the naive
    scene's) keeps at least 2 blocks resident on an SM at its shared
    memory."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    usage = nvcc_build.ptxas_usage(fused_trace.build()[lib][0])
    kernels = {k: v for k, v in usage.items() if f'{lib}_kernel' in k}
    assert len(kernels) >= 2
    no_plate = {k: v for k, v in kernels.items() if _no_plate(k)}
    assert no_plate
    for name, u in no_plate.items():
        assert u['spill_stores'] == 0 and u['spill_loads'] == 0, (name, u)
    _, args, cfg = _bwd_case(lib, dev)
    bounces = args[4] if len(args) > 4 else 0
    assert fused_trace.blocks_per_sm(lib, args[0].shape[0], cfg, False,
                                     bounces) >= 2
    assert fused_trace.blocks_per_sm(lib, args[0].shape[0], cfg, True,
                                     bounces) >= 1


def _many_rows_scene(kind):
    """Three singlets, a stop and a sensor: 11 rows, beyond the 8 whose
    saved states K2 keeps in shared memory (the 64-row instantiation), as a
    SequentialScene or a 12-bounce Scene."""
    els = [trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           ior_media=1.0, translation=[0.0, 0.0, z],
                           name=f'lens{j}')
           for j, z in enumerate((0.0, 12.0, 24.0))]
    els += [trt.CircularAperture(radius=5.0, translation=[0.0, 0.0, 30.0],
                                 name='stop'),
            trt.SensorElement(radius=20.0, translation=[0.0, 0.0, 45.0],
                              name='sensor')]
    return (trt.SequentialScene(els) if kind == 'sequential'
            else trt.Scene(els, n_bounces=12))


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_bwd_kernels_match_plain_beyond_eight_rows(kind, dev):
    """K2 (or K6) on an 11-row table against its plain version, with
    chip_smoke.py's bounds."""
    scene = _many_rows_scene(kind)
    rays = chip_smoke.sample_rays(trt, torch, N, dev, 13)
    if kind == 'scene':
        chip_smoke.compare_k6(trt, torch, scene, rays, 14)
        return
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    assert flat.shape[0] > 8
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, N, cfg, dev, 15)
    gt_k, gr_k = fused_trace.trace_seq_bwd_cuda(
        flat, _kinds(meta, cfg, dev), rays, cfg, g_rays, g_mom)
    gt_p, gr_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta,
                                                 g_rays, g_mom)
    torch.cuda.synchronize()
    assert chip_smoke.compare_ray_cotangents(torch, gr_k, gr_p)[
        'rays_differ'] == 0
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p)


# K3's scatter with the whole grid in a block's shared memory (32^2), with
# a band of 50 rows of a 256^2 slot, and without a window (two and eight
# 256^2 slots, where a band would hold less than an eighth of the rows:
# csrc/grid_bin.cu::band_rows), as (slots, H, W).
K3_GRIDS = ((1, 32, 32), (1, 256, 256), (2, 256, 256), (8, 256, 256))


def _k3_hits(shape, n, seed):
    """n hits spread over the grid's slots, some outside [-1, 1]^2."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randn(n, generator=gen, device='cuda') * 0.6
    y = torch.randn(n, generator=gen, device='cuda') * 0.6
    slot = torch.randint(0, shape[0], (n,), generator=gen, device='cuda',
                         dtype=torch.int32)
    w = torch.rand(n, generator=gen, device='cuda')
    cfg = trt.SensorConfig(n_sensors=shape[0], grid_shape=shape[1:],
                           grid_half_extent=chip_smoke.GRID_E)
    return x, y, slot, w, cfg


@pytest.mark.cuda
@pytest.mark.parametrize('weights', ['unit', 'random'])
@pytest.mark.parametrize('shape', sorted(K3_GRIDS))
def test_k3_paths_match_plain(shape, weights, dev):
    """K3 with each of its windows: unit weights bit for bit, random weights
    to GRID_RAND_RTOL of the largest bin (atomics add in a run-dependent
    order)."""
    x, y, slot, w, cfg = _k3_hits(shape, N_BLOCKS, 21)
    if weights == 'unit':
        w = torch.ones_like(w)
    g_k = grid.bin_grid_cuda(x, y, w, slot, cfg)
    g_p = grid.bin_grid_slots_plain(x, y, w, slot, cfg)
    torch.cuda.synchronize()
    if weights == 'unit':
        assert torch.equal(g_k, g_p)
        assert float(g_k.sum()) == N_BLOCKS
    else:
        err = float((g_k - g_p).abs().max())
        assert err <= chip_smoke.GRID_RAND_RTOL * float(g_p.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize('shape', sorted(K3_GRIDS))
def test_k3_counts_one_cell_exactly(shape, dev):
    """The worst case of contention: a million unit hits in one cell of the
    last slot count exactly, and nothing lands elsewhere."""
    n = 1_000_000
    x = torch.full((n,), 0.1, device=dev)
    y = torch.full((n,), -0.3, device=dev)
    _, _, _, _, cfg = _k3_hits(shape, 1, 0)
    g_k = grid.bin_grid_cuda(x, y, torch.ones(n, device=dev), shape[0] - 1,
                             cfg)
    torch.cuda.synchronize()
    ix, iy = bin_indices(shape[1:], chip_smoke.GRID_E, x[:1], y[:1])
    assert float(g_k[shape[0] - 1, iy[0], ix[0]]) == n
    assert float(g_k.sum()) == n


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 37, N, N_BLOCKS + 3])
@pytest.mark.parametrize('shape', [(1, 256, 256), (8, 256, 256)])
def test_k3_takes_ragged_and_small_batches(n, shape, dev):
    """A batch below one block, ragged edges, and zero weights (skipped)
    bin as the plain version bins them."""
    x, y, slot, w, cfg = _k3_hits(shape, n, 23)
    w = torch.where(w < 0.2, 0.0, 1.0)
    g_k = grid.bin_grid_cuda(x, y, w, slot, cfg)
    g_p = grid.bin_grid_slots_plain(x, y, w, slot, cfg)
    torch.cuda.synchronize()
    assert torch.equal(g_k, g_p)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 256, 256), (8, 256, 256)])
def test_k3_unit_weights_are_deterministic(shape, dev):
    """Two launches of unit weights on the bench spot give the same grid bit
    for bit (sums of integers are exact in any order); a launch into a given
    grid adds to it."""
    table, rays, cfg, meta = _bench_case(dev)
    rays = chip_smoke.sample_rays(trt, torch, N_BLOCKS, dev, 25)
    flat = trt.flatten_table_rows(table)
    out, _ = fused_trace.trace_seq_fwd_cuda(flat, _kinds(meta, cfg, dev),
                                            rays, cfg)
    _, _, _, _, gcfg = _k3_hits(shape, 1, 0)
    ones = torch.ones_like(out.px)
    runs = [grid.bin_grid_cuda(out.px, out.py, ones, shape[0] - 1, gcfg)
            for _ in range(2)]
    twice = grid.bin_grid_cuda(out.px, out.py, ones, shape[0] - 1, gcfg,
                               grid=runs[0].clone())
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(twice, 2 * runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize('n', [37, N_BLOCKS])
@pytest.mark.parametrize('shape', sorted(K3_GRIDS))
def test_k3_zero_weights_leave_the_grid(shape, n, dev):
    """A launch whose weights are all zero (the eager loop's bounces that
    end off the sensor) leaves the grid it is given as it was, and a launch
    whose only weights fall in one block of a cluster bins them as the plain
    version does."""
    x, y, slot, w, cfg = _k3_hits(shape, n, 29)
    before = torch.rand((shape[0],) + shape[1:], device=dev)
    after = grid.bin_grid_cuda(x, y, torch.zeros_like(w), slot, cfg,
                               grid=before.clone())
    lone = torch.zeros_like(w)
    lone[n // 3] = 1.0
    g_k = grid.bin_grid_cuda(x, y, lone, slot, cfg)
    g_p = grid.bin_grid_slots_plain(x, y, lone, slot, cfg)
    torch.cuda.synchronize()
    assert torch.equal(after, before)
    assert torch.equal(g_k, g_p) and float(g_k.sum()) == 1.0


# K5's resident blocks per SM on the naive scene's launch before this
# design: 61 registers, 4 blocks of 256 threads (PERF.md, NVIDIA H100 80GB
# HBM3).
K5_PARENT_BLOCKS_PER_SM = 4


@pytest.mark.cuda
def test_k5_runs_without_spills_at_the_parents_occupancy(dev):
    """K5's instantiations of one moment bucket without the extended kinds
    (the main path's, and the same with plate code) spill no register and have no stack frame
    (ptxas), and the naive scene's launch keeps at least the parent's
    blocks resident on an SM."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    usage = nvcc_build.ptxas_usage(fused_trace.build()['trace_nonseq_fwd'][0])
    main = {k: v for k, v in usage.items()
            if 'trace_nonseq_fwd_kernelILi1ELb' in k and not _ext(k)}
    assert len(main) == 2
    for name, u in main.items():
        assert u['spill_stores'] == 0 and u['spill_loads'] == 0, (name, u)
        assert u['stack'] == 0, (name, u)
    scene = chip_smoke.naive_scene(trt)
    assert fused_trace.blocks_per_sm(
        'trace_nonseq_fwd', len(scene.static_meta()), scene.sensor_config(),
        False) >= K5_PARENT_BLOCKS_PER_SM


@pytest.mark.cuda
def test_k5_grid_equals_k3_binning_of_its_hits(dev):
    """On the naive scene every ray that keeps its intensity (1) ends on
    the sensor (a plane at z = 19, not rotated, so its local x, y are the
    world's), and the stop zeroes the others: K5's grid equals K3's binning
    of the rays' end points with their intensities as weights, exactly."""
    scene = chip_smoke.naive_scene(trt)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    rays = chip_smoke.sample_rays(trt, torch, N_BLOCKS, dev, 27)
    out, sens = fused_nonseq.trace_nonseq_fwd_cuda(
        flat, _kinds(meta, cfg, dev), rays, cfg, scene.n_bounces)
    torch.cuda.synchronize()
    lit = out.intensity > 0
    assert int(lit.sum()) > N_BLOCKS // 2
    assert bool((out.intensity[lit] == 1.0).all())
    assert float((out.pz[lit] - 19.0).abs().max()) < 1e-4
    g3 = grid.bin_grid_cuda(out.px, out.py, out.intensity, 0, cfg)
    torch.cuda.synchronize()
    assert torch.equal(sens.grid, g3)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(1, 32, 32), (1, 256, 256), (8, 256, 256)])
def test_k3_bins_hits_at_bin_edges_as_the_plain_version(shape, dev):
    """Hits on every bin edge of both axes and up to 4 float steps to either
    side of it land in the plain version's bins, with and without a window:
    grid_axis rounds the add, the division and the product each on its own,
    as the plain version does, so no fused multiply-add moves an edge."""
    import numpy as np
    n_slots, h, w = shape
    e = np.float32(chip_smoke.GRID_E)
    edges = (-e + np.arange(w + 1, dtype=np.float32) * (2 * e / w)).astype(
        np.float32)
    pts = [edges]
    for direction in (np.float32(-np.inf), np.float32(np.inf)):
        p = edges
        for _ in range(4):
            p = np.nextafter(p, direction).astype(np.float32)
            pts.append(p)
    vals = np.concatenate(pts)
    xx, yy = np.meshgrid(vals, vals[::7])
    x = torch.tensor(xx.ravel(), device=dev)
    y = torch.tensor(yy.ravel(), device=dev)
    cfg = trt.SensorConfig(n_sensors=n_slots, grid_shape=(h, w),
                           grid_half_extent=chip_smoke.GRID_E)
    ones = torch.ones_like(x)
    g_k = grid.bin_grid_cuda(x, y, ones, n_slots - 1, cfg)
    g_p = grid.bin_grid_slots_plain(x, y, ones, n_slots - 1, cfg)
    torch.cuda.synchronize()
    assert torch.equal(g_k, g_p)


# ---- K4's scatter: the shared-map path (maps of at most the launcher's
# kMaxSharedCells) and the vector path (larger maps) ----

K4_CAP = chip_smoke.k4_shared_cap()
# (rows, columns): 32 x 32 and an odd width in shared memory; an even and an
# odd width at the cap or just under it and one row over it; 256 x 256
K4_MAPS = {'32x32': (32, 32), 'odd_33x47': (33, 47),
           'cap_even': (K4_CAP // 100, 100),
           'over_cap_even': (K4_CAP // 100 + 1, 100),
           'cap_odd': (K4_CAP // 101, 101),
           'over_cap_odd': (K4_CAP // 101 + 1, 101), '256x256': (256, 256)}


def _k4_cells(shape, pattern, n, dev, seed=0):
    """Cells (iv, iu) of an [H, W] map and their four cotangents (some None
    for the 'zeros' pattern).  'random': cells partly outside the map
    (clamped) with flat offsets at every residue mod 4; 'residue3': every
    cell's flat offset c00 = 3 mod 4 (its row pair straddles two 16-byte
    groups); 'rim': cells on and beyond the far rims and below row and
    column 0, where corners coincide; 'hot': every cell the same, with
    integer cotangents;
    'zeros': one zero tensor and one None among the cotangents."""
    h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed + h * 1000 + w)
    rand = lambda lo, hi: torch.randint(lo, hi, (n,), generator=gen,  # noqa
                                        device=dev, dtype=torch.int32)
    if pattern == 'residue3':
        iv, base = rand(0, h - 1), rand(0, w - 4)
        iu = base + (3 - (iv * w + base)) % 4
    elif pattern == 'rim':
        iv = torch.where(rand(0, 2) == 0, rand(h - 2, h + 3), rand(-3, 1))
        iu = torch.where(rand(0, 2) == 0, rand(w - 2, w + 3), rand(-3, 1))
    elif pattern == 'hot':
        iv = torch.full((n,), h // 2, dtype=torch.int32, device=dev)
        iu = torch.full((n,), w // 3, dtype=torch.int32, device=dev)
    else:
        iv, iu = rand(-2, h + 2), rand(-2, w + 2)
    g = [torch.randn(n, generator=gen, device=dev) for _ in range(4)]
    if pattern == 'hot':
        # small integers: their sum in one cell is exact in any order, so
        # the comparison holds the combine, not the summation order
        g = [torch.randint(-4, 5, (n,), generator=gen, device=dev).float()
             for _ in range(4)]
    if pattern == 'zeros':
        g[1] = torch.zeros(n, device=dev)
        g[2] = None
    return iv, iu, tuple(g)


@pytest.mark.cuda
@pytest.mark.parametrize('pattern', ['random', 'residue3', 'rim', 'hot',
                                     'zeros'])
@pytest.mark.parametrize('map_name', sorted(K4_MAPS))
def test_k4_scatter_paths_match_plain(map_name, pattern, dev):
    """K4's scatter on both of its paths, at the launcher's cap and one row
    over it, with odd and even widths, against its plain version
    (chip_smoke.compare_maps): the sum of the cells' cotangents in each
    cell, wherever the row pairs fall in the 16-byte groups, where clamped
    corners coincide, on one hot cell and with zero or missing cotangents;
    one launch a call."""
    shape = K4_MAPS[map_name]
    iv, iu, g = _k4_cells(shape, pattern, 100_003, dev)
    if pattern == 'residue3':
        assert bool(((iv.long() * shape[1] + iu) % 4 == 3).all())
    before = phase_grid.CORNER_BWD_LAUNCHES
    s_k = phase_grid.grid_corners_bwd_cuda(g, iv, iu, shape)
    assert phase_grid.CORNER_BWD_LAUNCHES == before + 1
    s_p = phase_grid.grid_corners_bwd_plain(g, iv, iu, shape)
    torch.cuda.synchronize()
    chip_smoke.compare_maps(torch, (s_k,), (s_p,))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 37, N, 2048 * 3 + 5])
@pytest.mark.parametrize('map_name', ['32x32', 'over_cap_even'])
def test_k4_scatter_takes_ragged_batches(map_name, n, dev):
    """Batches that are not a multiple of a block, or of a cluster's batch of
    cells, and a batch of one cell, on both paths; all-zero cotangents leave
    the map zero."""
    shape = K4_MAPS[map_name]
    iv, iu, g = _k4_cells(shape, 'random', n, dev, seed=n)
    s_k = phase_grid.grid_corners_bwd_cuda(g, iv, iu, shape)
    s_p = phase_grid.grid_corners_bwd_plain(g, iv, iu, shape)
    zero = phase_grid.grid_corners_bwd_cuda(
        tuple(torch.zeros(n, device=dev) for _ in range(4)), iv, iu, shape)
    torch.cuda.synchronize()
    chip_smoke.compare_maps(torch, (s_k,), (s_p,))
    assert not bool(zero.any())


# ---- K1 ----

def _k1_bench(dev, n, seed=5):
    scene = chip_smoke.bench_scene(trt)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(scene.init_params(dev)))
    rays = chip_smoke.sample_rays(trt, torch, n, dev, seed)
    return flat, _kinds(meta, cfg, dev), rays, cfg, meta


@pytest.mark.cuda
@pytest.mark.parametrize('n', ['1', '255', '257', 'ragged_waves'])
def test_k1_block_edges(n, dev):
    """K1 against its plain version on one ray, one ray short of a block,
    one over it, and a count of more blocks than are resident at once whose
    last block is ragged, per chip_smoke.compare (its tolerances and
    reasons)."""
    flat, _, _, cfg, _ = _k1_bench(dev, 1)
    if n == 'ragged_waves':
        per_sm = fused_trace.blocks_per_sm('trace_seq_fwd', flat.shape[0],
                                           cfg, False)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n = (2 * per_sm * sms + 7) * fused_trace.THREADS - 19
    n = int(n)
    flat, kinds, rays, cfg, meta = _k1_bench(dev, n)
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta)
    torch.cuda.synchronize()
    res = chip_smoke.compare(torch, out_k, s_k, out_p, s_p)
    assert res['n'] == n and float(s_k.moments[0, 0, 0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('grid_on', [False, True])
def test_k1_moments_are_deterministic(grid_on, dev):
    """Two launches of K1 on the same rays give the same moments and ray
    streams, bit for bit: lanes, warps and blocks are summed in a fixed
    order, with no atomics."""
    flat, kinds, rays, cfg, _ = _k1_bench(dev, N_BLOCKS * 3 + 11)
    if grid_on:
        cfg = chip_smoke.grid_scene(trt).sensor_config()
    runs = [fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert float(runs[0][1].moments[0, 0, 0]) > 0
    assert torch.equal(runs[0][1].moments, runs[1][1].moments)
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(runs[0][0], c), getattr(runs[1][0], c))


@pytest.mark.cuda
def test_k1_runs_without_spills_at_its_occupancy(dev):
    """K1's two instantiations without the extended kinds spill no
    register and have no stack frame (ptxas), and the bench scene's launch
    keeps the blocks their launch
    bounds ask for (kSeqFwdMinBlocks, kSeqFwdPlateMinBlocks with plate
    code) resident on an SM (the occupancy query K1 exports)."""
    import pathlib
    import re
    from raytracetorch_tpu_torch.ops import nvcc_build
    usage = nvcc_build.ptxas_usage(fused_trace.build()['trace_seq_fwd'][0])
    kernels = {k: v for k, v in usage.items()
               if 'trace_seq_fwd_kernel' in k and not _ext(k)}
    assert len(kernels) == 2
    for name, u in kernels.items():
        assert u['spill_stores'] == 0 and u['spill_loads'] == 0, (name, u)
        assert u['stack'] == 0, (name, u)
    src = (pathlib.Path(fused_trace.__file__).resolve().parents[1] / 'csrc'
           / 'trace_seq_fwd.cu').read_text()
    scene = chip_smoke.bench_scene(trt)
    rows, cfg = len(scene.static_meta()), scene.sensor_config()
    for plates, name in ((False, 'kSeqFwdMinBlocks'),
                         (True, 'kSeqFwdPlateMinBlocks')):
        want = int(re.search(rf'constexpr int {name} = (\d+);',
                             src).group(1))
        assert fused_trace.blocks_per_sm('trace_seq_fwd', rows, cfg,
                                         plates) >= want


EXT_CASES = ('mixed', 'asphere')


def _ext_case(case, dev, n=N):
    """A benchmarks/suite.py scene with the extended kinds, sequential, and
    its 12-bounce Scene -> (scene, Scene, flat table, kinds, maps, rays)."""
    make = (chip_smoke.mixed_scene if case == 'mixed'
            else chip_smoke.asphere_scene)
    seq, ns = make(trt), make(trt, chip_smoke.EXT_BOUNCES)
    meta, cfg = seq.static_meta(), seq.sensor_config()
    flat = trt.flatten_table_rows(seq.build_table(seq.init_params(dev)))
    return (seq, ns, flat, _kinds(meta, cfg, dev),
            fused_trace.plate_maps(meta, None),
            chip_smoke.sample_rays(trt, torch, n, dev, 21))


@pytest.mark.cuda
@pytest.mark.parametrize('case', EXT_CASES)
def test_ext_kernels_match_plain(case, dev):
    """K1, K2, K5 and K6 in their instantiation with the extended kinds, on
    the mixed-surface scene (cylindrical faces, CYL_EDGE side planes, VB
    RECT, an inverted RECT stop) and the asphere scene, against their plain
    versions with this file's bounds; K6's replay ends at K5's output bit
    for bit."""
    seq, ns, flat, kinds, maps, rays = _ext_case(case, dev)
    meta, cfg = seq.static_meta(), seq.sensor_config()
    assert fused_trace.ext_kinds(meta) and maps == ()
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps,
                                                ext=True)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta, maps)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, rays.n, cfg, dev,
                                                    22)
    gt_k, gr_k, _ = fused_trace.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=True)
    gt_p, gr_p, _ = fused_trace.trace_seq_bwd_plain(
        flat, rays, cfg, meta, g_rays, g_mom, maps=maps)
    torch.cuda.synchronize()
    chip_smoke.compare_ray_cotangents(torch, gr_k, gr_p)
    res = chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                              plates=True, ext=True)
    assert res['rows_with_grad'] >= 3
    nmeta, ncfg, nb = ns.static_meta(), ns.sensor_config(), ns.n_bounces
    out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, ncfg,
                                                    nb, maps, ext=True)
    out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(flat, rays, ncfg,
                                                       nmeta, nb, maps)
    torch.cuda.synchronize()
    chip_smoke.compare_nonseq(torch, out_k, s_k, out_p, s_p)
    *_, ends = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, ncfg, nb, (None,) * 7, None, need_table=False,
        need_rays=False, replay=True, maps=maps, ext=True)
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(ends, c), getattr(out_k, c)), c
    chip_smoke.compare_k6(trt, torch, ns, rays, 23)


@pytest.mark.cuda
@pytest.mark.parametrize('case', EXT_CASES)
def test_ext_scenes_launch_their_instantiation(case, dev):
    """``simulate_fused`` on the mixed-surface and asphere scenes launches
    K1 (and K2 under grad) once each, their Scenes K5 (and K6), every launch
    in the instantiation with the extended kinds (``EXT_LAUNCHES``); the
    gradients in the leaves of chip_smoke.EXT_TRAINED match the eager
    trace's to chip_smoke.GRAD_RTOL."""
    seq, ns, _, _, _, rays = _ext_case(case, dev)
    for sc, fwd, bwd in ((seq, 'LAUNCHES', 'BWD_LAUNCHES'),
                         (ns, 'NONSEQ_LAUNCHES', 'NONSEQ_BWD_LAUNCHES')):
        mod = fused_trace if sc is seq else fused_nonseq

        def grads(simulate):
            p = sc.init_params(dev)
            for el, k in chip_smoke.EXT_TRAINED[case]:
                p[el][k].requires_grad_(True)
            _, s, _ = simulate(p, rays)
            trt.spot_size_loss(s).backward()
            return [p[el][k].grad for el, k in chip_smoke.EXT_TRAINED[case]]

        setattr(mod, fwd, 0)
        setattr(mod, bwd, 0)
        fused_trace.EXT_LAUNCHES = 0
        g_f = grads(sc.simulate_fused)
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd),
                fused_trace.EXT_LAUNCHES) == (1, 1, 2)
        for a, b in zip(g_f, grads(sc.simulate)):
            assert bool(torch.isfinite(a).all())
            assert float(((a - b).abs() / b.abs()).max()) < \
                chip_smoke.GRAD_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize('case', EXT_CASES)
def test_v1_takes_the_extended_kinds(case, dev):
    """``trace_sequential_v1`` on a scene with the extended kinds launches
    K1's kernel in its instantiation with them, equal bit for bit to K1."""
    seq, _, flat, kinds, maps, rays = _ext_case(case, dev)
    meta, cfg = seq.static_meta(), seq.sensor_config()
    fused_trace.V1_LAUNCHES = fused_trace.EXT_LAUNCHES = 0
    out_v, sens_v, _ = trt.trace_sequential_v1(
        seq.build_table(seq.init_params(dev)), rays, cfg, meta)
    torch.cuda.synchronize()
    assert (fused_trace.V1_LAUNCHES, fused_trace.EXT_LAUNCHES) == (1, 1)
    out_k, sens_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg,
                                                   maps, ext=True)
    torch.cuda.synchronize()
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(out_v, c), getattr(out_k, c)), c
    assert torch.equal(sens_v.moments, sens_k.moments)


@pytest.mark.cuda
def test_main_path_runs_no_extended_kinds(dev):
    """The bench scene's forward and gradient step (K1, K2), and the naive
    scene's (K5, K6), launch their instantiations without the extended
    kinds."""
    rays = chip_smoke.sample_rays(trt, torch, N, dev, 24)
    for sc in (chip_smoke.bench_scene(trt), chip_smoke.naive_scene(trt)):
        p = sc.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        fused_trace.EXT_LAUNCHES = 0
        _, s, _ = sc.simulate_fused(p, rays)
        trt.spot_size_loss(s).backward()
        torch.cuda.synchronize()
        assert fused_trace.EXT_LAUNCHES == 0
        assert float(p['lens']['c1'].grad.abs()) > 0


@pytest.mark.cuda
def test_ext_instantiations_are_built(dev):
    """Each of K1, K2, K5 and K6 builds its instantiations with the extended
    kinds (K2's for both homes of its saved states, K5's for both moment
    buckets; K2 and K6 also the overloads that take dispersion and the
    wavelength's cotangent), and their occupancy queries answer."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 4, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 2}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        ext = [k for k in usage
               if f'{lib}_kernel' in k and _ext(k) and not _streams(k)
               and 'FamSide' not in k]
        assert len(ext) == count, (lib, ext)
        assert all(usage[k]['registers'] for k in ext)
    for case in EXT_CASES:
        seq, ns, *_ = _ext_case(case, dev, 1)
        for lib, sc in (('trace_seq_fwd', seq), ('trace_seq_bwd', seq),
                        ('trace_nonseq_fwd', ns), ('trace_nonseq_bwd', ns)):
            assert fused_trace.blocks_per_sm(
                lib, len(sc.static_meta()), sc.sensor_config(), True,
                sc.n_bounces, ext=True) >= 1


def _plate_asphere_scene(bounces=None):
    """A 40 x 40 phase plate ahead of an even-asphere singlet and a sensor
    with a 32 x 32 grid: plate code, the extended kinds and a grid in one
    launch."""
    els = [trt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(40, 40),
                              name='plate'),
           trt.AsphericLens(c1=0.05, k1=-0.6, a1=[2.5e-4, 1e-6], c2=-0.02,
                            d=10.0, t=3.0, ior_glass=1.5,
                            translation=[0.0, 0.0, 10.0], name='asph'),
           trt.SensorElement(radius=10.0, translation=[0.0, 0.0, 30.0],
                             name='det')]
    scene = (trt.SequentialScene(els) if bounces is None
             else trt.Scene(els, n_bounces=bounces))
    scene.grid_shape, scene.grid_half_extent = (32, 32), 4.0
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_ext_with_a_plate_and_a_grid_matches_plain(kind, dev):
    """A scene with a phase plate, an asphere and a grid runs the
    instantiation with the extended kinds (which holds plate code), reading
    the plate's map: K1/K5 and K2/K6 against their plain versions with
    chip_smoke.py's plate bounds (``compare_plate_bwd``)."""
    scene = _plate_asphere_scene(None if kind == 'sequential' else 4)
    meta, cfg = scene.static_meta(), scene.sensor_config()
    assert fused_trace.ext_kinds(meta)
    params = chip_smoke.ring_params(scene, dev)
    maps = tuple(m.detach() for m in fused_trace.plate_maps(
        meta, scene.side_grids(params)))
    flat = trt.flatten_table_rows(scene.build_table(params))
    kinds = _kinds(meta, cfg, dev)
    rays = chip_smoke.ring_rays(trt, torch, N, dev, 25)
    fused_trace.EXT_LAUNCHES = 0
    if kind == 'sequential':
        out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg,
                                                    maps, ext=True)
        out_p, s_p = fused_trace.trace_sequential_fused_plain(
            flat, rays, cfg, meta, maps)
        torch.cuda.synchronize()
        _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
        chip_smoke.compare_grid(torch, s_k.grid, s_p.grid,
                                chip_smoke.GRID_TOTAL_RTOL)
    else:
        out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(
            flat, kinds, rays, cfg, scene.n_bounces, maps, ext=True)
        out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, cfg, meta, scene.n_bounces, maps)
        torch.cuda.synchronize()
        chip_smoke.compare_nonseq(torch, out_k, s_k, out_p, s_p)
    chip_smoke.compare_plate_bwd(trt, torch, scene, params, rays, 26,
                                 nonseq=kind == 'scene')
    assert fused_trace.EXT_LAUNCHES == 2


DISP_CASES = chip_smoke.DISP_CASES


def _disp_case(case, dev, n=N):
    """A dispersive scene of chip_smoke.py section 9 (the achromat with Abbe
    or Sellmeier glasses, the Cooke triplet), sequential, and its 12-bounce
    Scene -> (scene, Scene, bundles, flat table, kinds, maps, rays)."""
    seq, _, nb = chip_smoke.disp_case(trt, case)
    ns = chip_smoke.disp_case(trt, case, chip_smoke.DISP_BOUNCES)[0]
    meta, cfg = seq.static_meta(), seq.sensor_config(nb)
    flat = trt.flatten_table_rows(seq.build_table(seq.init_params(dev)))
    return (seq, ns, nb, flat, _kinds(meta, cfg, dev),
            fused_trace.plate_maps(meta, None),
            chip_smoke.disp_rays(trt, torch, case, n, dev, 31))


@pytest.mark.cuda
@pytest.mark.parametrize('case', DISP_CASES)
def test_disp_kernels_match_plain(case, dev):
    """K1, K2, K5 and K6 in their instantiation with the extended kinds on
    the dispersive scenes, against their plain versions: K2 with the disp
    columns and the wavelength's cotangent, K6 (chip_smoke.compare_k6) with
    both; K6's replay ends at K5's output bit for bit."""
    seq, ns, nb, flat, kinds, maps, rays = _disp_case(case, dev)
    meta, cfg = seq.static_meta(), seq.sensor_config(nb)
    assert fused_trace.dispersive(meta) and maps == ()
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps,
                                                ext=True)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta, maps)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, rays.n, cfg, dev,
                                                    32)
    gt_k, gr_k, _, gw_k = fused_trace.trace_seq_bwd_cuda(
        flat, kinds, rays, cfg, g_rays, g_mom, maps=maps, ext=True,
        disp=True, need_wavelength=True)
    gt_p, gr_p, _, gw_p = fused_trace.trace_seq_bwd_plain(
        flat, rays, cfg, meta, g_rays, g_mom, maps=maps,
        need_wavelength=True)
    torch.cuda.synchronize()
    chip_smoke.compare_ray_cotangents(torch, gr_k, gr_p,
                                      tol=chip_smoke.DISP_BWD_TOL)
    chip_smoke.compare_table_cotangents(torch, fused_trace, gt_k, gt_p,
                                        plates=True, ext=True, disp=True)
    chip_smoke.compare_wavelength_cotangents(torch, gw_k, gw_p)
    dcols = list(fused_trace.DISP_GRAD_COLS)
    assert float(gt_k[:, dcols].abs().max()) > 0
    nmeta, ncfg = ns.static_meta(), ns.sensor_config(nb)
    nbounce = ns.n_bounces
    out_k, s_k = fused_nonseq.trace_nonseq_fwd_cuda(flat, kinds, rays, ncfg,
                                                    nbounce, maps, ext=True)
    out_p, s_p = fused_nonseq.trace_nonseq_fused_plain(flat, rays, ncfg,
                                                       nmeta, nbounce, maps)
    torch.cuda.synchronize()
    chip_smoke.compare_nonseq(torch, out_k, s_k, out_p, s_p)
    *_, ends = fused_nonseq.trace_nonseq_bwd_cuda(
        flat, kinds, rays, ncfg, nbounce, (None,) * 7, None,
        need_table=False, need_rays=False, replay=True, maps=maps, ext=True)
    for c in fused_trace.COMPS:
        assert torch.equal(getattr(ends, c), getattr(out_k, c)), c
    res = chip_smoke.compare_k6(trt, torch, ns, rays, 33)
    assert res['wavelength']['scale'] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('case', DISP_CASES)
def test_disp_scenes_launch_their_instantiation(case, dev):
    """``simulate_fused`` on a dispersive scene launches K1 (and K2 under
    grad) once each, its Scene K5 (and K6), every launch in the
    instantiation with the extended kinds; the gradients in chip_smoke.
    DISP_TRAINED and the rays' wavelength match the eager trace's."""
    seq, ns, nb, _, _, _, rays = _disp_case(case, dev)
    for sc, fwd, bwd in ((seq, 'LAUNCHES', 'BWD_LAUNCHES'),
                         (ns, 'NONSEQ_LAUNCHES', 'NONSEQ_BWD_LAUNCHES')):
        mod = fused_trace if sc is seq else fused_nonseq

        def grads(simulate):
            p = sc.init_params(dev)
            for el, k in chip_smoke.DISP_TRAINED[case]:
                p[el][k].requires_grad_(True)
            wl = rays.wavelength.clone().requires_grad_(True)
            _, s, _ = simulate(p, rays.replace(wavelength=wl), nb)
            trt.spot_size_loss(s).backward()
            return ([p[el][k].grad for el, k in chip_smoke.DISP_TRAINED[case]],
                    wl.grad)

        setattr(mod, fwd, 0)
        setattr(mod, bwd, 0)
        fused_trace.EXT_LAUNCHES = 0
        g_f, w_f = grads(sc.simulate_fused)
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd),
                fused_trace.EXT_LAUNCHES) == (1, 1, 2)
        g_e, w_e = grads(sc.simulate)
        for a, b in zip(g_f, g_e):
            assert bool(torch.isfinite(a).all())
            assert float(((a - b).abs() / b.abs()).max()) < \
                chip_smoke.GRAD_RTOL
        chip_smoke.compare_wavelength_cotangents(torch, w_f, w_e, 3)


@pytest.mark.cuda
def test_plate_wavelength_cotangent_takes_the_extended_instantiation(dev):
    """With the wavelength under grad, a phase-plate scene's backward runs
    K2 (and K6) in the instantiation with the extended kinds, whose
    wavelength cotangent (the kick reads it) matches the plain version's;
    without, it runs the plate instantiation as before."""
    for sc, mod, bwd in (
            (chip_smoke.ring_scene(trt), fused_trace, 'BWD_LAUNCHES'),
            (chip_smoke.ring_scene(trt, bounces=chip_smoke.DO_BOUNCES),
             fused_nonseq, 'NONSEQ_BWD_LAUNCHES')):
        rays = chip_smoke.ring_rays(trt, torch, N, dev, 34)
        rays = rays.replace(wavelength=torch.linspace(
            0.45, 0.65, N, device=dev))
        p = chip_smoke.ring_params(sc, dev)
        wl = rays.wavelength.clone().requires_grad_(True)
        fused_trace.EXT_LAUNCHES = 0
        setattr(mod, bwd, 0)
        out, _, _ = sc.simulate_fused(p, rays.replace(wavelength=wl))
        (out.px * out.dx).mean().backward()
        torch.cuda.synchronize()
        assert fused_trace.EXT_LAUNCHES == 1 and getattr(mod, bwd) == 1
        # the plain versions on the CPU, the same rays and map
        p_cpu = chip_smoke.ring_params(sc, 'cpu')
        r_cpu = rays.to('cpu')
        w_cpu = r_cpu.wavelength.clone().requires_grad_(True)
        o_c, _, _ = sc.simulate_fused(p_cpu, r_cpu.replace(wavelength=w_cpu))
        (o_c.px * o_c.dx).mean().backward()
        chip_smoke.compare_wavelength_cotangents(torch, wl.grad.cpu(),
                                                 w_cpu.grad, 3)


@pytest.mark.cuda
def test_disp_instantiations_build_and_fit(dev):
    """The dispersive launches' occupancy (code 3: 12 more table columns a
    row in K2's and K6's shared memory) keeps at least one block an SM on
    every section 9 scene, and the mixed-surface Scene's K6 (no dispersive
    row, no extra columns) keeps its 2."""
    for case in DISP_CASES:
        seq, ns, nb, *_ = _disp_case(case, dev, 1)
        for lib, sc in (('trace_seq_fwd', seq), ('trace_seq_bwd', seq),
                        ('trace_nonseq_fwd', ns), ('trace_nonseq_bwd', ns)):
            assert fused_trace.blocks_per_sm(
                lib, len(sc.static_meta()), sc.sensor_config(nb), True,
                sc.n_bounces, ext=True, disp=True) >= 1
    mixed = chip_smoke.mixed_scene(trt, chip_smoke.EXT_BOUNCES)
    assert fused_trace.blocks_per_sm(
        'trace_nonseq_bwd', len(mixed.static_meta()), mixed.sensor_config(),
        True, mixed.n_bounces, ext=True) >= 2


# ---- the deterministic streams (chip_smoke.py section 10) ----

STREAM_CASES = [('bench', False, False), ('ring', False, False),
                ('achromat_sellmeier', False, False), ('bench', True, False),
                ('cooke', True, False), ('bench', False, True),
                ('fold', False, True), ('bench', True, True),
                ('fold', True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize('name,records,nonseq', STREAM_CASES,
                         ids=[f'{n}-{"rec" if r else "opl"}-'
                              f'{"k5k6" if s else "k1k2"}'
                              for n, r, s in STREAM_CASES])
def test_stream_kernels_match_plain(name, records, nonseq, dev):
    """K1 and K2 (K5 and K6) with the streams against their plain versions:
    rays, moments, opl, n_final and the records, and with the path length
    alone the ray, table and map cotangents under seeded cotangents of opl
    and n_final too."""
    res = chip_smoke.stream_kernels_vs_plain(trt, torch, name, N, dev, 41,
                                             records=records, nonseq=nonseq)
    assert res['stream_flipped'] <= res['stream_flips_allowed']


@pytest.mark.cuda
def test_stream_paths_launch_their_instantiation(dev):
    """``simulate_fused`` with ``track_opl`` launches K1 (K5) once in the
    instantiation with the streams and, under grad, K2 (K6) in theirs; a
    recording run's backward recomputes the eager trace and launches no K2;
    a run without streams takes no stream instantiation."""
    seq = chip_smoke.bench_scene(trt)
    rays = chip_smoke.sample_rays(trt, torch, N, dev, 42)
    for sc, mod, fwd, bwd in (
            (seq, fused_trace, 'LAUNCHES', 'BWD_LAUNCHES'),
            (chip_smoke.naive_scene(trt), fused_nonseq, 'NONSEQ_LAUNCHES',
             'NONSEQ_BWD_LAUNCHES')):
        p = sc.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        for k in (fwd, bwd):
            setattr(mod, k, 0)
        fused_trace.STREAM_LAUNCHES = fused_trace.EXT_LAUNCHES = 0
        out, _, aux = sc.simulate_fused(p, rays, track_opl=True)
        trt.wavefront_rms(out, aux['opl']).backward()
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd)) == (1, 1)
        assert fused_trace.STREAM_LAUNCHES == 2
        assert fused_trace.EXT_LAUNCHES == 0
        assert bool(torch.isfinite(p['lens']['c1'].grad))
    p = seq.init_params(dev)
    p['lens']['c1'].requires_grad_(True)
    fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
    fused_trace.STREAM_LAUNCHES = fused_trace.RECORD_RECOMPUTES = 0
    _, _, aux = seq.simulate_fused(p, rays, record_hits=True)
    aux['hits'][-1].square().mean().backward()
    torch.cuda.synchronize()
    assert (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES) == (1, 0)
    assert fused_trace.RECORD_RECOMPUTES == 1
    fused_trace.STREAM_LAUNCHES = 0
    seq.simulate_fused(seq.init_params(dev), rays)
    assert fused_trace.STREAM_LAUNCHES == 0


@pytest.mark.cuda
def test_stream_instantiations_are_built(dev):
    """K1 and K5 build one overload with the streams (K5 for both moment
    buckets), K2 one with the path length for both homes of its saved
    states, K6 one; each has its registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k and _streams(k)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_stream_instantiations_fit(dev):
    """The stream instantiations keep at least 2 blocks an SM on the bench
    and naive scenes (3 for K1), as measured when they were written."""
    seq, ns = chip_smoke.bench_scene(trt), chip_smoke.naive_scene(trt)
    want = {'trace_seq_fwd': (seq, 3), 'trace_seq_bwd': (seq, 2),
            'trace_nonseq_fwd': (ns, 2), 'trace_nonseq_bwd': (ns, 2)}
    for lib, (sc, blocks) in want.items():
        assert fused_trace.blocks_per_sm(
            lib, len(sc.static_meta()), sc.sensor_config(), True,
            sc.n_bounces, ext=True, streams=True) >= blocks


@pytest.mark.cuda
def test_footprints_on_the_card_match_cpu(dev):
    """``footprints`` of the Cooke triplet through K1 on the card against
    the eager trace on the CPU, the same rays: labels, counts and r_max
    (POS_TOL relative)."""
    sc = chip_smoke.cooke_scene(trt)
    gen = torch.Generator(device=dev).manual_seed(43)
    rays = trt.sample_bundles(gen, chip_smoke.cooke_bundles(trt, N), dev)
    fused_trace.LAUNCHES = 0
    rep_k = trt.footprints(sc, sc.init_params(dev), rays)
    assert fused_trace.LAUNCHES == 1
    rep_c = trt.footprints(sc, sc.init_params('cpu'), rays.to('cpu'))
    for a, b in zip(rep_k, rep_c):
        assert a['label'] == b['label'] and a['n'] == b['n']
        assert math.isclose(a['r_max'], b['r_max'],
                            rel_tol=chip_smoke.POS_TOL, abs_tol=1e-6)


# ---- the Fresnel kinds (chip_smoke.py section 11) ----

@pytest.mark.cuda
def test_philox_on_the_card_matches_known_answers(dev):
    """The kernels' Philox4x32-10 (csrc/trace_seq_common.cuh, through K5's
    library's check entry point) gives the generator's published
    known-answer vectors, and the plain version's words on random
    counters and keys."""
    from raytracetorch_tpu_torch.rays import draws
    m = 0xFFFFFFFF
    ctr = [[0, 0, 0, 0], [m, m, m, m],
           [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344]]
    key = [[0, 0], [m, m], [0xa4093822, 0x299f31d0]]
    want = [[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
            [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd],
            [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]]
    gen = torch.Generator().manual_seed(5)
    rand = torch.randint(0, 2 ** 32, (64, 6), generator=gen,
                         dtype=torch.int64)
    ctr += rand[:, :4].tolist()
    key += rand[:, 4:].tolist()

    def words(rows):
        return torch.tensor(rows, dtype=torch.int64).to(torch.int32).to(dev)
    c, k = words(ctr), words(key)
    out = torch.empty_like(c)
    rc = fused_trace.kernel('rtt_philox4x32')(
        c.data_ptr(), k.data_ptr(), out.data_ptr(), len(ctr),
        fused_trace.stream(dev))
    torch.cuda.synchronize()
    assert rc == 0
    got = out.cpu().to(torch.int64) & m
    assert got[:3].tolist() == want
    for j in range(3, len(ctr)):
        w = draws.philox4x32(*(torch.tensor([ctr[j][i]]) for i in range(4)),
                             key[j])
        assert [int(v) for v in w] == got[j].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize('name,nonseq', [(c, False)
                                         for c in chip_smoke.FRESNEL_SEQ_CASES]
                         + [(c, True) for c in chip_smoke.FRESNEL_NS_CASES],
                         ids=[f'{c}-k1k2' for c in chip_smoke.FRESNEL_SEQ_CASES]
                         + [f'{c}-k5k6' for c in chip_smoke.FRESNEL_NS_CASES])
def test_fresnel_kernels_match_plain(name, nonseq, dev):
    """K1 and K2 (K5 and K6) with the Fresnel kinds against their plain
    versions on the same draws: rays, moments and the ray and table
    cotangents (chip_smoke.py's bounds); K6's replay against K5."""
    res = chip_smoke.fresnel_kernels_vs_plain(trt, torch, name, N, dev, 51,
                                              nonseq=nonseq)
    assert res['flipped' if not nonseq else 'mismatched'] <= res[
        'flips_allowed' if not nonseq else 'mismatch_allowed']
    if name == 'window_ghost':
        assert abs(res['mean_intensity'] - chip_smoke.WINDOW_GHOST) <= \
            1e-5 * chip_smoke.WINDOW_GHOST


@pytest.mark.cuda
def test_fresnel_paths_launch_their_instantiation(dev):
    """``simulate_fused`` of a Fresnel scene launches K1 (K5) once in the
    instantiation with the Fresnel kinds and, under grad, K2 (K6) in
    theirs; the eager and fused traces draw alike from one generator
    state; the main path takes no Fresnel instantiation."""
    rays = chip_smoke.sample_rays(trt, torch, N, dev, 52)
    for nb, mod, fwd, bwd in (
            (None, fused_trace, 'LAUNCHES', 'BWD_LAUNCHES'),
            (8, fused_nonseq, 'NONSEQ_LAUNCHES', 'NONSEQ_BWD_LAUNCHES')):
        sc = chip_smoke.fresnel_scene(trt, True, nb)
        p = sc.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        setattr(mod, fwd, 0)
        setattr(mod, bwd, 0)
        fused_trace.FRESNEL_LAUNCHES = 0
        out, sens, _ = sc.simulate_fused(
            p, rays, generator=torch.Generator(device=dev).manual_seed(3))
        sens.moments[0, 0, 0].backward()
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd)) == (1, 1)
        assert fused_trace.FRESNEL_LAUNCHES == 2
        out_e, _, _ = sc.simulate(
            p, rays, generator=torch.Generator(device=dev).manual_seed(3))
        assert int((out.dz.sign() != out_e.dz.sign()).sum()) <= 1
    fused_trace.FRESNEL_LAUNCHES = 0
    seq = chip_smoke.bench_scene(trt)
    seq.simulate_fused(seq.init_params(dev), rays)
    assert fused_trace.FRESNEL_LAUNCHES == 0


@pytest.mark.cuda
def test_fresnel_instantiations_are_built(dev):
    """K1 and K6 build one overload with the Fresnel kinds, K2 one for each
    home of its saved states and K5 one for each moment bucket; each has
    its registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, 1)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_fresnel_instantiations_fit(dev):
    """The Fresnel instantiations keep at least 2 blocks an SM on the bench
    and naive scenes (3 for K1), as measured when they were written."""
    seq = chip_smoke.fresnel_scene(trt, True)
    ns = chip_smoke.fresnel_scene(trt, True, 8)
    want = {'trace_seq_fwd': (seq, 3), 'trace_seq_bwd': (seq, 2),
            'trace_nonseq_fwd': (ns, 2), 'trace_nonseq_bwd': (ns, 2)}
    for lib, (sc, blocks) in want.items():
        assert fused_trace.blocks_per_sm(
            lib, len(sc.static_meta()), sc.sensor_config(), True,
            sc.n_bounces, ext=True, fresnel=True) >= blocks


@pytest.mark.cuda
@pytest.mark.parametrize('name,nonseq', [(c, False)
                                         for c in chip_smoke.COAT_SEQ_CASES]
                         + [(c, True) for c in chip_smoke.COAT_NS_CASES],
                         ids=[f'{c}-k1k2' for c in chip_smoke.COAT_SEQ_CASES]
                         + [f'{c}-k5k6' for c in chip_smoke.COAT_NS_CASES])
def test_coat_kernels_match_plain(name, nonseq, dev):
    """K1 and K2 (K5 and K6) with the coatings against their plain versions
    on the same draws: rays, moments and the ray, table (the coat
    thicknesses' included) and wavelength cotangents (chip_smoke.py's
    bounds); K6's replay against K5 (not on the rounding-chaotic
    telescope)."""
    res = chip_smoke.coating_kernels_vs_plain(trt, torch, name, N, dev, 61,
                                              nonseq=nonseq)
    assert res['bwd']['rays_differ'] <= res['bwd']['allowed']


@pytest.mark.cuda
def test_coat_paths_launch_their_instantiation(dev):
    """``simulate_fused`` of a coated scene launches K1 (K5) once in the
    family instantiation with the coatings (and the Fresnel kinds of its
    faces) and, under grad, K2 (K6) in theirs; a scene whose stack sits on
    SNELL faces takes the main path's."""
    rays = chip_smoke.sample_rays(trt, torch, N, dev, 62)
    for nb, mod, fwd, bwd in (
            (None, fused_trace, 'LAUNCHES', 'BWD_LAUNCHES'),
            (8, fused_nonseq, 'NONSEQ_LAUNCHES', 'NONSEQ_BWD_LAUNCHES')):
        sc = chip_smoke.coated_scene(trt, 'weighted', nb)
        p = sc.init_params(dev)
        p['lens']['coat_d'].requires_grad_(True)
        setattr(mod, fwd, 0)
        setattr(mod, bwd, 0)
        fused_trace.COAT_LAUNCHES = fused_trace.FRESNEL_LAUNCHES = 0
        _, sens, _ = sc.simulate_fused(p, rays)
        sens.moments[0, 0, 0].backward()
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd)) == (1, 1)
        # the family instantiation counts in each family it ran with: the
        # coated faces are FRESNEL_W rows
        assert fused_trace.COAT_LAUNCHES == 2
        assert fused_trace.FRESNEL_LAUNCHES == 2
        assert float(p['lens']['coat_d'].grad.abs().max()) > 0
    fused_trace.COAT_LAUNCHES = 0
    snell = chip_smoke.coated_scene(trt, False)
    snell.simulate_fused(snell.init_params(dev), rays)
    assert fused_trace.COAT_LAUNCHES == 0


@pytest.mark.cuda
def test_coat_instantiations_are_built(dev):
    """K1 and K6 build one overload with the coatings, K2 one for each home
    of its saved states and K5 one for each moment bucket; each has its
    registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, 3)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_coat_instantiations_fit(dev):
    """The coated instantiations keep at least one block resident on an SM
    on the coated singlet and example 11's telescope, at their shared
    memory."""
    seq = chip_smoke.coated_scene(trt, 'weighted')
    tel = chip_smoke.telescope_scene(trt, trt, trt.glass,
                                     list(chip_smoke.TELESCOPE_PAIR))
    want = {'trace_seq_fwd': seq, 'trace_seq_bwd': seq,
            'trace_nonseq_fwd': tel, 'trace_nonseq_bwd': tel}
    for lib, sc in want.items():
        assert fused_trace.blocks_per_sm(
            lib, len(sc.static_meta()), sc.sensor_config(), True,
            sc.n_bounces, ext=True, disp=fused_trace.dispersive(
                sc.static_meta()), coat=True) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.DIFF_CASES)
def test_diff_kernels_match_plain(name, dev):
    """K1 and K2 (the Scene: K5 and K6) with the diffractive kinds against
    their plain versions: rays, moments slot by slot and the ray, table (a
    DOE's coefficients included) and wavelength cotangents (chip_smoke.py's
    bounds); K6's replay against K5."""
    res = chip_smoke.diffractive_kernels_vs_plain(trt, torch, name, N, dev,
                                                  71)
    assert res['bwd']['rays_differ'] <= res['bwd']['allowed']


@pytest.mark.cuda
def test_diff_paths_launch_their_instantiation(dev):
    """``simulate_fused`` of the hybrid achromat (as a SequentialScene and as
    a Scene) launches K1 (K5) once in the instantiation with the diffractive
    kinds and, under grad, K2 (K6) in theirs; the DOE's phase gets a
    gradient."""
    gen = torch.Generator(device=dev).manual_seed(72)
    for nb, mod, fwd, bwd in (
            (None, fused_trace, 'LAUNCHES', 'BWD_LAUNCHES'),
            (4, fused_nonseq, 'NONSEQ_LAUNCHES', 'NONSEQ_BWD_LAUNCHES')):
        sc = chip_smoke.hybrid_scene(trt, n_bounces=nb)
        rays = trt.sample_bundles(gen, chip_smoke.hybrid_bundles(trt, 999),
                                  dev)
        p = sc.init_params(dev)
        p['doe']['phase'].requires_grad_(True)
        setattr(mod, fwd, 0)
        setattr(mod, bwd, 0)
        fused_trace.DIFF_LAUNCHES = fused_trace.COAT_LAUNCHES = 0
        _, sens, _ = sc.simulate_fused(p, rays, 3)
        trt.spot_size_loss(sens).backward()
        torch.cuda.synchronize()
        assert (getattr(mod, fwd), getattr(mod, bwd)) == (1, 1)
        assert fused_trace.DIFF_LAUNCHES == 2
        assert fused_trace.COAT_LAUNCHES == 0
        assert float(p['doe']['phase'].grad.abs().max()) > 0


@pytest.mark.cuda
def test_diff_instantiations_are_built(dev):
    """K1 and K6 build one overload with the diffractive kinds, K2 one for
    each home of its saved states and K5 one for each moment bucket; each
    has its registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, 7)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_diff_instantiations_fit(dev):
    """The diffractive instantiations keep at least one block resident on an
    SM on the hybrid achromat, the spectrometer and the Scene of every new
    kind, at their shared memory."""
    for lib, make in (('trace_seq_fwd', chip_smoke.hybrid_scene),
                      ('trace_seq_bwd', chip_smoke.spectrometer_scene),
                      ('trace_nonseq_fwd', chip_smoke.diffractive_ns_scene),
                      ('trace_nonseq_bwd', chip_smoke.diffractive_ns_scene)):
        sc = make(trt)
        meta = sc.static_meta()
        assert fused_trace.blocks_per_sm(
            lib, len(meta), sc.sensor_config(9), True, sc.n_bounces,
            ext=True, disp=fused_trace.dispersive(meta), diff=True) >= 1


@pytest.mark.cuda
def test_k1_k2_take_eighteen_bundles(dev):
    """K1 and K2 on the spectrometer with 18 bundles (the limit) against
    their plain versions: the moments slot by slot, the ray cotangents."""
    sc = chip_smoke.spectrometer_scene(trt)
    meta = sc.static_meta()
    bundles = [(trt.CollimatedDisk.make(radius=4.0, ray_id=j,
                                        wavelength=0.45 + 0.012 * j,
                                        translation=[0, 0, -5.0]), 167)
               for j in range(18)]
    rays = trt.sample_bundles(torch.Generator(device=dev).manual_seed(73),
                              bundles, dev)
    cfg = sc.sensor_config(18)
    flat = trt.flatten_table_rows(sc.build_table(sc.init_params(dev)))
    kinds = _kinds(meta, cfg, dev)
    maps = fused_trace.plate_maps(meta, {})
    coat = fused_trace.coat_side(meta, dev)
    out_k, s_k = fused_trace.trace_seq_fwd_cuda(flat, kinds, rays, cfg, maps,
                                                True, coat=coat, diff=True)
    out_p, s_p = fused_trace.trace_sequential_fused_plain(flat, rays, cfg,
                                                          meta, maps)
    torch.cuda.synchronize()
    _assert_kernel_matches_plain(out_k, s_k, out_p, s_p)
    assert s_k.moments.shape == (1, 18, 7)
    assert float(s_k.moments[0, :, 0].min()) > 0
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, rays.n, cfg, dev,
                                                    74)
    g_k = fused_trace.trace_seq_bwd_cuda(flat, kinds, rays, cfg, g_rays,
                                         g_mom, maps=maps, ext=True,
                                         disp=True, coat=coat, diff=True)
    g_p = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta, g_rays,
                                          g_mom, maps=maps)
    chip_smoke.compare_ray_cotangents(torch, g_k[1], g_p[1],
                                      tol=chip_smoke.DISP_BWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.FUZZY_CASES)
def test_fuzzy_kernels_match_plain(name, dev):
    """K1 and K2 (the Scenes: K5 and K6) with fuzzy programs against their
    plain versions, which call the callables: rays, moments and the ray and
    table cotangents (chip_smoke.py's bounds); K6's replay against K5."""
    res = chip_smoke.fuzzy_kernels_vs_plain(trt, torch, name, N, dev, 81)
    assert res['bwd']['rays_differ'] <= res['bwd']['allowed']
    assert res['bwd']['fuzzy_row_grad'] > 0


@pytest.mark.cuda
def test_fuzzy_paths_launch_their_instantiation(dev):
    """``simulate_fused`` of the obscured pupil launches K1 (as a Scene K5)
    once in the family instantiation with fuzzy programs (and the
    diffractive kinds of its ideal lens); a grad step of the
    Gaussian apodizer K1 and K2 in theirs, and its curvatures get the eager
    trace's gradients."""
    for name, mod, fwd in (('pupil', fused_trace, 'LAUNCHES'),
                           ('pupil_scene', fused_nonseq, 'NONSEQ_LAUNCHES')):
        sc, p, rays, _, _ = chip_smoke.fuzzy_case(trt, torch, name, 999, dev,
                                                  82)
        setattr(mod, fwd, 0)
        fused_trace.FUZZY_LAUNCHES = fused_trace.DIFF_LAUNCHES = 0
        with torch.no_grad():
            out, _, _ = sc.simulate_fused(p, rays)
        torch.cuda.synchronize()
        assert getattr(mod, fwd) == 1 and fused_trace.FUZZY_LAUNCHES == 1
        # the family instantiation counts in each family it ran with: the
        # pupil's IdealThinLens is of the diffractive family
        assert fused_trace.DIFF_LAUNCHES == 1
        ref, _, _ = sc.simulate(p, rays)
        torch.testing.assert_close(out.intensity, ref.intensity, rtol=0,
                                   atol=0)
    sc, _, rays, _, _ = chip_smoke.fuzzy_case(trt, torch, 'gauss', 999, dev,
                                              83)
    grads = []
    for simulate in ('simulate_fused', 'simulate'):
        p = sc.init_params(dev)
        p['lens']['c1'].requires_grad_(True)
        fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
        fused_trace.FUZZY_LAUNCHES = 0
        _, sens, _ = getattr(sc, simulate)(p, rays)
        sens.spot_rms(0)[0].backward()
        torch.cuda.synchronize()
        grads.append(p['lens']['c1'].grad)
        if simulate == 'simulate_fused':
            assert (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES,
                    fused_trace.FUZZY_LAUNCHES) == (1, 1, 2)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_fuzzy_instantiations_are_built(dev):
    """K1 and K6 build one overload with fuzzy programs, K2 one for each
    home of its saved states and K5 one for each moment bucket; each has
    its registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, 15)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_fuzzy_instantiations_fit(dev):
    """The instantiations with fuzzy programs keep at least one block
    resident on an SM on the section 14 scenes, at their shared memory (the
    programs' words included), and at the largest buffer."""
    from raytracetorch_tpu_torch.ops import fuzzy_program
    for name, libs in (('gauss', ('trace_seq_fwd', 'trace_seq_bwd')),
                       ('lorentz_scene', ('trace_nonseq_fwd',
                                          'trace_nonseq_bwd'))):
        sc, _, _, cfg, _ = chip_smoke.fuzzy_case(trt, torch, name, 8, dev, 84)
        meta = fused_trace.TraceMeta(sc.static_meta(), sc.fuzzy_fns())
        for lib in libs:
            for words in (len(meta.words), fuzzy_program.MAX_WORDS):
                assert fused_trace.blocks_per_sm(
                    lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                    diff=True, fuzzy_words=words) >= 1, (lib, words)


@pytest.mark.cuda
def test_fuzzy_refusals_on_the_card(dev):
    """A legacy [N, 3] callable and an op outside the set raise on CUDA
    tensors as on the CPU, before anything launches."""
    for fn, components, match in (
            (lambda h: torch.exp(-h[:, 0] ** 2), False, 'component-style'),
            (lambda x, y, z: torch.sin(x), True, 'op sin')):
        sc = trt.SequentialScene([
            trt.FuzzyAperture(fn, components=components, name='apod'),
            trt.SensorElement(radius=6.0, translation=[0, 0, 10.0],
                              name='s')])
        rays = trt.CollimatedDisk.make(radius=2.0, translation=[
            0, 0, -5.0]).sample(torch.Generator(device=dev).manual_seed(85),
                                64, dev)
        fused_trace.LAUNCHES = 0
        with pytest.raises(NotImplementedError, match=match):
            sc.simulate_fused(sc.init_params(dev), rays)
        assert fused_trace.LAUNCHES == 0


_EX20_TERMS = []


@pytest.fixture
def ex20_terms(dev):
    """Example 20's prescription, measured through K1 with track_opl (once
    a test run)."""
    if not _EX20_TERMS:
        _EX20_TERMS.append(chip_smoke.ex20_prescription(trt, torch, dev)[0])
    return _EX20_TERMS[0]


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.FREEFORM_CASES)
def test_freeform_kernels_match_plain(name, dev, ex20_terms):
    """K1 and K2 (the Scene: K5 and K6) with freeform surfaces against their
    plain versions on examples 19, 20 (with the path length) and 26: rays,
    moments and the ray and table cotangents (chip_smoke.py's bounds); K6's
    replay against K5; the freeform rows' ff columns carry cotangents."""
    res = chip_smoke.freeform_kernels_vs_plain(trt, torch, name, N, dev, 91,
                                               ex20_terms)
    assert res['bwd']['rays_differ'] <= res['bwd']['allowed']
    assert res['bwd']['ff_columns_used'] >= 2


@pytest.mark.cuda
def test_freeform_paths_launch_their_instantiation(dev):
    """``simulate_fused`` of example 19's corrector launches K1 (as a Scene
    K5) once in the instantiation with freeform surfaces, and
    ``trace_sequential_v1`` K1's kernel there; a grad step in the freeform
    coefficients K1 and K2 in theirs, with the eager trace's gradients."""
    for name, mod, fwd in (('ex19', fused_trace, 'LAUNCHES'),
                           ('ex19_scene', fused_nonseq, 'NONSEQ_LAUNCHES')):
        sc, p, rays, _, _ = chip_smoke.freeform_case(trt, torch, name, 999,
                                                     dev, 92)
        setattr(mod, fwd, 0)
        fused_trace.FREEFORM_LAUNCHES = fused_trace.FUZZY_LAUNCHES = 0
        with torch.no_grad():
            out, _, _ = sc.simulate_fused(p, rays)
        torch.cuda.synchronize()
        assert getattr(mod, fwd) == 1 and fused_trace.FREEFORM_LAUNCHES == 1
        assert fused_trace.FUZZY_LAUNCHES == 0
        ref, _, _ = sc.simulate(p, rays)
        torch.testing.assert_close(out.px, ref.px, rtol=1e-5, atol=1e-4)
    sc, p, rays, cfg, _ = chip_smoke.freeform_case(trt, torch, 'ex19', 999,
                                                   dev, 93)
    fused_trace.V1_LAUNCHES = fused_trace.FREEFORM_LAUNCHES = 0
    trt.trace_sequential_v1(sc.build_table(p), rays, cfg, sc.static_meta())
    assert (fused_trace.V1_LAUNCHES, fused_trace.FREEFORM_LAUNCHES) == (1, 1)
    grads = []
    for simulate in ('simulate_fused', 'simulate'):
        p = sc.init_params(dev)
        p['corrector']['xy1'].requires_grad_(True)
        fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
        fused_trace.FREEFORM_LAUNCHES = 0
        _, sens, _ = getattr(sc, simulate)(p, rays)
        sens.spot_rms(0)[0].backward()
        torch.cuda.synchronize()
        grads.append(p['corrector']['xy1'].grad)
        if simulate == 'simulate_fused':
            assert (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES,
                    fused_trace.FREEFORM_LAUNCHES) == (1, 1, 2)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_freeform_instantiations_are_built(dev):
    """K1 and K6 build one overload with freeform surfaces, K2 one for each
    home of its saved states and K5 one for each moment bucket; each has
    its registers."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': 1, 'trace_seq_bwd': 2, 'trace_nonseq_fwd': 2,
            'trace_nonseq_bwd': 1}
    for lib, count in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, 63)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)


@pytest.mark.cuda
def test_freeform_instantiations_fit(dev):
    """The instantiations with freeform surfaces keep at least one block
    resident on an SM on the section 15 scenes, at their shared memory (the
    exponent pairs and the 32 ff columns' warp slots included)."""
    for name, libs in (('ex19', ('trace_seq_fwd', 'trace_seq_bwd')),
                       ('ex19_scene', ('trace_nonseq_fwd',
                                       'trace_nonseq_bwd')),
                       ('ex26', ('trace_seq_fwd', 'trace_seq_bwd'))):
        sc, _, _, cfg, _ = chip_smoke.freeform_case(trt, torch, name, 8, dev,
                                                    94)
        meta = sc.static_meta()
        for lib in libs:
            assert fused_trace.blocks_per_sm(
                lib, len(meta), cfg, True, sc.n_bounces, ext=True,
                diff=True, fuzzy_words=len(meta), freeform=True) >= 1, lib


def _freeform_smem_scenes():
    """Section 15's freeform Scene, alone, with a dispersive singlet and
    with a fuzzy apodizer (whose programs fill the buffer) -> [Scene]."""
    base = chip_smoke.ex19_scene(trt, chip_smoke.EX19_COEFFS,
                                 chip_smoke.FF_NS_BOUNCES).elements
    disp = trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           abbe_vd=60.0, translation=[0, 0, 5.0],
                           name='disp')
    apod = trt.FuzzyAperture(lambda x, y, z: torch.exp(-(x * x + y * y) / 8.0),
                             components=True, name='apod',
                             translation=[0, 0, 10.0])
    return [trt.Scene(base + extra, n_bounces=chip_smoke.FF_NS_BOUNCES)
            for extra in ([], [disp], [apod])]


def _k6_smem(meta, cfg, bounces, field, dev):
    """The shared memory K6's family (or, with ``field``, field)
    instantiation takes for a launch of this table (``rtt_trace_nonseq_bwd_
    smem``)."""
    import ctypes
    query = fused_trace.kernel('rtt_trace_nonseq_bwd_smem')
    prog = fused_trace.fuzzy_buffer(meta, dev)
    out = ctypes.c_longlong(0)
    assert query(len(meta), max(cfg.n_sensors, 1), cfg.n_bundles, bounces,
                 int(fused_trace.dispersive(meta)),
                 0 if prog is None else int(prog.numel()),
                 fused_trace.families(meta), int(field),
                 ctypes.byref(out)) == 0
    return out.value


@pytest.mark.cuda
def test_freeform_shared_limit_is_the_kernels(dev):
    """``fused_nonseq.freeform_k6_shared_bytes``, the host's limit of K6's
    family instantiation, equals the shared memory K6's launch takes
    (``rtt_trace_nonseq_bwd_smem``) on the freeform Scene, with a
    dispersive row and with fuzzy programs, at bounce budgets below, at and
    above the checkpoints and at 1 and 3 bundles."""
    for sc in _freeform_smem_scenes():
        meta = fused_trace.TraceMeta(sc.static_meta(), sc.fuzzy_fns())
        for bundles in (1, 3):
            cfg = sc.sensor_config(bundles)
            for bounces in (1, 8, fused_nonseq.K6_CHECKPOINTS, 25):
                assert _k6_smem(meta, cfg, bounces, False, dev) == \
                    fused_nonseq.freeform_k6_shared_bytes(
                        meta, cfg, bounces), (len(meta), bundles, bounces)


@pytest.mark.cuda
def test_field_shared_limit_is_the_kernels(dev):
    """``fused_nonseq.field_k6_shared_bytes``, the host's limit of K6 with
    the field, equals the shared memory K6's launch takes
    (``rtt_trace_nonseq_bwd_smem``) on section 19's naive scene and
    coated singlet, the coated singlet with a dispersive row, and section
    21's freeform corrector under the field, at bounce budgets below, at
    and above its checkpoints and at 1 and 3 bundles."""
    disp = trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           abbe_vd=60.0, translation=[0, 0, 30.0],
                           name='disp')
    coated = chip_smoke.field_ns_scene(trt, 'coated')
    for sc in (chip_smoke.field_ns_scene(trt, 'naive'), coated,
               trt.Scene(coated.elements + [disp], n_bounces=6),
               chip_smoke.ex19_scene(trt, n_bounces=4)):
        meta = fused_trace.TraceMeta(sc.static_meta(), None, field=True)
        for bundles in (1, 3):
            cfg = sc.sensor_config(bundles)
            for bounces in (1, 4, fused_nonseq.K6_FIELD_CHECKPOINTS, 25):
                assert _k6_smem(meta, cfg, bounces, True, dev) == \
                    fused_nonseq.field_k6_shared_bytes(
                        meta, cfg, bounces), (len(meta), bundles, bounces)


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.FIELD_NS_CASES
                         + chip_smoke.FIELD_NS_SEGMENT_CASES)
def test_field_nonseq_kernels_match_plain(name, dev):
    """K5 and K6 with the field against their plain versions on section
    19's cases (chip_smoke.py's bounds), the light guide's rays living
    beyond two segments of K6's checkpoints: the rays, moments, field and
    cotangents, and K6's replay equal to K5 bit for bit, its field too."""
    res = chip_smoke.field_ns_kernels_vs_plain(trt, torch, name, N, dev, 93)
    assert res['replay_equal'] and res['replay_field_equal']
    assert res['bwd']['field']['rays_differ'] <= res['bwd']['field'][
        'allowed']


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.GRIN_SEQ_CASES
                         + chip_smoke.GRIN_NS_CASES)
def test_grin_kernels_match_plain(name, dev):
    """K1 and K2 (the quarter-pitch rod, the relay, the mixed table) and K5
    and K6 (the rod as a Scene, with barrel kills; the rod whose axial term
    takes rays to their turning points) in their instantiation with GRIN
    rods against their plain versions, with the path length
    (chip_smoke.py section 20's bounds): rays, moments, path lengths, the
    rays a rod kills, cotangents and K6's replay equal to K5 bit for
    bit."""
    res = chip_smoke.grin_kernels_vs_plain(trt, torch, name, N, dev, 95)
    assert res['killed_differ'] <= res['apart']
    if name in chip_smoke.GRIN_NS_CASES:
        assert res['replay_equal'] and res['killed'] > 0


@pytest.mark.cuda
def test_grin_paths_launch_their_instantiation(dev):
    """simulate_fused of a rod launches K1 (a Scene: K5) in the
    instantiation with GRIN rods, its grad step K1 + K2 (K5 + K6), and the
    fused gradients in n0 and grin_A equal the eager ones; K0's counterpart
    refuses the rod."""
    for name in ('quarter', 'ns'):
        sc = chip_smoke.grin_scene(trt, name)
        rays = chip_smoke.grin_rays(trt, torch, name, N, dev, 96)
        grads = []
        for simulate in ('simulate_fused', 'simulate'):
            p = sc.init_params(dev)
            leaves = [p['rod'][k].requires_grad_(True)
                      for k in ('n0', 'grin_A')]
            fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
            fused_nonseq.NONSEQ_LAUNCHES = fused_nonseq.NONSEQ_BWD_LAUNCHES = 0
            fused_trace.GRIN_LAUNCHES = fused_trace.STREAM_LAUNCHES = 0
            loss = getattr(sc, simulate)(p, rays)[1].spot_rms(0)[0]
            grads.append(torch.stack(torch.autograd.grad(loss, leaves)))
            torch.cuda.synchronize()
            if simulate == 'simulate_fused':
                pair = ((fused_nonseq.NONSEQ_LAUNCHES,
                         fused_nonseq.NONSEQ_BWD_LAUNCHES) if name == 'ns'
                        else (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES))
                assert pair == (1, 1)
                assert (fused_trace.GRIN_LAUNCHES,
                        fused_trace.STREAM_LAUNCHES) == (2, 0)
        torch.testing.assert_close(grads[0], grads[1],
                                   rtol=chip_smoke.GRIN_GRAD_RTOL, atol=0)
    sc = chip_smoke.grin_scene(trt, 'quarter')
    with pytest.raises(ValueError, match='GRIN'):
        fused_trace.trace_sequential_v1(sc.build_table(sc.init_params(dev)),
                                        rays, sc.sensor_config(),
                                        sc.static_meta())


@pytest.mark.cuda
def test_grin_instantiations_are_built(dev):
    """K1 builds one instantiation for GRIN rods alone and K2 one for each
    home of its saved states; K5 and K6 run such tables in their family
    instantiation (K5 one for each moment bucket); each has its registers,
    and each keeps a block resident on an SM on the section 20 scenes."""
    from raytracetorch_tpu_torch.ops import nvcc_build
    logs = fused_trace.build()
    want = {'trace_seq_fwd': (1, 32), 'trace_seq_bwd': (2, 32),
            'trace_nonseq_fwd': (2, 63), 'trace_nonseq_bwd': (1, 63)}
    for lib, (count, fams) in want.items():
        usage = nvcc_build.ptxas_usage(logs[lib][0])
        found = [k for k in usage if f'{lib}_kernel' in k
                 and _family(k, fams)]
        assert len(found) == count, (lib, found)
        assert all(usage[k]['registers'] for k in found)
    for name, libs in (('mixed', ('trace_seq_fwd', 'trace_seq_bwd')),
                       ('ns', ('trace_nonseq_fwd', 'trace_nonseq_bwd'))):
        sc = chip_smoke.grin_scene(trt, name)
        for lib in libs:
            assert fused_trace.blocks_per_sm(
                lib, len(sc.static_meta()), sc.sensor_config(), True,
                getattr(sc, 'n_bounces', 0), ext=True, grin=True) >= 1, lib


# ---- the kind mix: the family instantiation on tables that mix families
# (chip_smoke.py section 21) ----

MIX_CASES = (chip_smoke.MIX_SEQ_CASES + chip_smoke.MIX_NS_CASES
             + chip_smoke.MIX_FIELD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize('name', MIX_CASES)
def test_kind_mix_kernels_match_plain(name, dev):
    """K1 and K2, K5 and K6 in their family instantiation (the field's on
    the field cases) against their plain versions on a section 21 case:
    chip_smoke.mix_kernels_vs_plain's rules at 20,000 rays (K6's replay
    against K5 bit for bit)."""
    res = chip_smoke.mix_kernels_vs_plain(trt, torch, name, 20_000, dev)
    assert res['apart'] <= max(3, 20_000 * 1e-3), res


@pytest.mark.cuda
@pytest.mark.parametrize('name', MIX_CASES)
def test_kind_mix_launches_the_family_instantiation(name, dev):
    """``simulate_fused`` of a section 21 case launches K1 (K5) once, counted
    in each family its table has (the field's cases in FIELD_LAUNCHES
    alone), and its grad step K2 (K6) once more."""
    sc = chip_smoke.mix_scene(trt, name, torch)
    field = name in chip_smoke.MIX_FIELD_CASES
    meta = fused_trace.TraceMeta(sc.static_meta(), sc.fuzzy_fns(), field)
    rays = chip_smoke.mix_rays(trt, torch, name, 4096, dev)
    kw = dict(track_field=True, E0=list(chip_smoke.MIX_E0)) if field else {}
    u = chip_smoke.mix_uniforms(torch, meta, rays.n, dev)
    if u is not None:
        kw['uniforms'] = u
    names = ('FRESNEL', 'COAT', 'DIFF', 'FUZZY', 'FREEFORM', 'GRIN',
             'FIELD')
    for k in names:
        setattr(fused_trace, f'{k}_LAUNCHES', 0)
    p = sc.init_params(dev)
    el, leaf = chip_smoke.MIX_LEAVES[name][0]
    p[el][leaf].requires_grad_(True)
    chip_smoke.mix_loss(sc.simulate_fused(p, rays, **kw)[1]).backward()
    torch.cuda.synchronize()
    got = {k: getattr(fused_trace, f'{k}_LAUNCHES') for k in names}
    want = dict.fromkeys(names, 0)
    if field:
        want['FIELD'] = 2
    else:
        want.update({k.upper(): v for k, v in
                     chip_smoke.mix_family_counts(meta, 2).items()})
    assert got == want, (name, got, want)
    assert bool(torch.isfinite(p[el][leaf].grad).all())
