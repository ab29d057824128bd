"""The kernels K1 (csrc/trace_seq_fwd.cu), K2 (csrc/trace_seq_bwd.cu), K3
(csrc/grid_bin.cu), K5 (csrc/trace_nonseq_fwd.cu) and K6
(csrc/trace_nonseq_bwd.cu) against their plain PyTorch versions, on the
card, and the paths that run them.

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
grid totals), K5 (the NS_* bounds) and K6 (``chip_smoke.compare_k6``),
with the reasons there.
"""

import pytest
import torch

import chip_smoke
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.core.sensor import bin_indices
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace, grid

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
