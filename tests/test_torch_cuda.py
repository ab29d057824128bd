"""The fused kernels K1 (csrc/trace_seq_fwd.cu) and K2 (csrc/trace_seq_bwd.cu)
against their plain PyTorch versions, on the card, and the gradient paths
that run them.

Every test here needs a CUDA card and is marked ``cuda``; without a card
each skips.  The file imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: final intensity exact; positions and directions atol/rtol 1e-5
(f32 rounding of a chain of a few surfaces: the kernel contracts
multiply-adds, eager torch does not); moments rtol 1e-5 atol 1e-3 (another
summation order).  At N = 2,999 no ray sits close enough to a rim for its
hit to flip.  K2's cotangents are held to chip_smoke.py's bounds (BWD_TOL,
TAB_RTOL; reasons there).
"""

import pytest
import torch

import chip_smoke
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.ops import fused_trace

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
    g_rays, g_mom = chip_smoke.random_cotangents(torch, rays.n, cfg, dev, 5)
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
