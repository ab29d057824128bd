"""The solids' and cones' bounds (HALFSPACES, CONE_NAPPE) in K1, K2, K5 and
K6 against their plain PyTorch versions, on the card: chip_smoke.py
section 16's ``solid_kernels_vs_plain`` with its bounds (the bounds table
for K1 and K2; example 27's lightpipe, the wedge, the wedge with
fresnel=True and the axicon for K5 and K6, whose replay must equal K5 bit
for bit), and the paths that should launch the instantiation with the
extended kinds.

Every test here needs a CUDA card and is marked ``cuda``; without a card
each skips.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_solid_cuda.py
"""

import pytest
import torch

import chip_smoke
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

N = 2999          # not a multiple of the 256-ray block: the ragged edge


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernel has no CPU mode)')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('name', chip_smoke.SOLID_CASES)
def test_solid_kernels_match_plain(name, dev):
    """K1 and K2 (the Scenes: K5 and K6) with the new bounds against their
    plain versions: rays, moments, the exit grid and the ray and table
    cotangents under chip_smoke.py's bounds."""
    res = chip_smoke.solid_kernels_vs_plain(trt, torch, name, N, dev, 71)
    assert res['bwd']['rays_differ'] <= res['bwd']['allowed']
    if name != 'bounds':
        assert res['replay_equal']


@pytest.mark.cuda
def test_solid_paths_launch_the_extended_instantiation(dev):
    """``Scene.simulate_fused`` of the lightpipe launches K5 once in the
    instantiation with the extended kinds, and a step in its width K5 and
    K6 there; ``simulate_fused`` of the bounds table launches K1 there."""
    sc = chip_smoke.lightpipe_scene(trt, grad=True)
    rays = chip_smoke.lightpipe_rays(torch, N, dev)
    p = sc.init_params(dev)
    before = (fused_nonseq.NONSEQ_LAUNCHES, fused_nonseq.NONSEQ_BWD_LAUNCHES,
              fused_trace.EXT_LAUNCHES)
    p['pipe']['width'].requires_grad_(True)
    sc.simulate_fused(p, rays)[1].spot_rms(0)[0].backward()
    torch.cuda.synchronize()
    assert (fused_nonseq.NONSEQ_LAUNCHES, fused_nonseq.NONSEQ_BWD_LAUNCHES,
            fused_trace.EXT_LAUNCHES) == tuple(
        b + d for b, d in zip(before, (1, 1, 2)))
    assert torch.isfinite(p['pipe']['width'].grad)
    sc = chip_smoke.bounds_scene(trt)
    before = (fused_trace.LAUNCHES, fused_trace.EXT_LAUNCHES)
    with torch.no_grad():
        out = sc.simulate_fused(sc.init_params(dev), chip_smoke.sample_rays(
            trt, torch, N, dev, 3))[0]
    assert (fused_trace.LAUNCHES, fused_trace.EXT_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    assert 0 < int((out.intensity == 0).sum()) < N
