"""The fused forward kernel K1 (csrc/trace_seq_fwd.cu) against its plain
PyTorch version, on the card.

Every test here needs a CUDA card and is marked ``cuda``; without a card
each skips.  The file imports neither jax nor the JAX package, so on a
machine with a card and no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: final intensity exact; positions and directions atol/rtol 1e-5
(f32 rounding of a chain of a few surfaces: the kernel contracts
multiply-adds, eager torch does not); moments rtol 1e-5 atol 1e-3 (another
summation order).  At N = 2,999 no ray sits close enough to a rim for its
hit to flip.
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
