"""Host code around the adjoint kernels K2 (csrc/trace_seq_bwd.cu) and K6
(csrc/trace_nonseq_bwd.cu), on the CPU:

- ``table_and_map_cotangents`` folds a partials buffer of any number of
  blocks (the kernels write one row of partial sums per block) into the
  [K, 160] table cotangent, held to the plain backward's table cotangent
  (rtol 1e-5 of each field's scale: the fold sums the blocks in float32);
- ``nvcc_build.ptxas_usage`` reads each kernel's registers and spills from
  an nvcc log, which the card tests hold to zero spills;
- chip_smoke.py counts K6's segment replays with the kernel's own number
  of checkpoints.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py."""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.ops import fused_trace, nvcc_build

torch.set_num_threads(2)

CSRC = pathlib.Path(fused_trace.__file__).resolve().parents[1] / 'csrc'


def _bench_plain(n, plates):
    """The plain backward's table cotangent (and map cotangents) on the
    bench scene, or on the ring former with a 16 x 16 plate."""
    dev = torch.device('cpu')
    if plates:
        scene = chip_smoke.ring_scene(trt, shape=(16, 16))
        params = chip_smoke.ring_params(scene, dev)
        rays = chip_smoke.ring_rays(trt, torch, n, dev, 3)
    else:
        scene = chip_smoke.bench_scene(trt)
        params = scene.init_params(dev)
        rays = chip_smoke.sample_rays(trt, torch, n, dev, 3)
    cfg, meta = scene.sensor_config(), scene.static_meta()
    flat = trt.flatten_table_rows(scene.build_table(params))
    maps = fused_trace.plate_maps(meta, scene.side_grids(params))
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, n, cfg, dev, 4)
    res = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta, g_rays,
                                          g_mom, maps=maps)
    return res, rays, maps


@pytest.mark.parametrize('plates', [False, True])
@pytest.mark.parametrize('n_blocks', [1, 3, 17])
def test_fold_takes_any_block_count(n_blocks, plates):
    """Partial sums over any number of blocks fold into the plain
    backward's table cotangent; columns outside the kernels' stay zero, and
    the maps' cotangent is split into its [H, W] maps."""
    res, rays, maps = _bench_plain(300, plates)
    g_p = res[0]
    cols = list(fused_trace.PLATE_GRAD_COLS if plates
                else fused_trace.GRAD_COLS)
    rng = np.random.default_rng(n_blocks)
    k = g_p.shape[0]
    parts = torch.tensor(rng.standard_normal((n_blocks, k, len(cols))),
                         dtype=torch.float32)
    parts[-1] = g_p[:, cols] - parts[:-1].sum(dim=0)
    plate_bufs = (fused_trace.PlateBuffers(maps, rays, torch.device('cpu'))
                  if plates else None)
    g_maps = (torch.cat([m.reshape(-1) for m in res[2]]) if plates
              else None)
    out = fused_trace.table_and_map_cotangents(
        k, cols, parts, None, plate_bufs, g_maps, torch.device('cpu'))
    g_flat = out[0]
    assert out[1] is None
    outside = [c for c in range(g_flat.shape[1]) if c not in cols]
    assert float(g_flat[:, outside].abs().max()) == 0.0
    scale = float(g_p[:, cols].abs().max())
    assert scale > 0
    torch.testing.assert_close(g_flat[:, cols], g_p[:, cols], rtol=0,
                               atol=1e-5 * scale)
    if plates:
        assert len(out[2]) == 1 and torch.equal(out[2][0], res[2][0])


LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb1ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for __internal_0_$__cuda_sm3x_div_rn_noftz_f32_slowpath
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb1ELb0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb0ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb0ELb1EEEvPKf
    2048 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 560 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_kernel():
    """Registers, stack and spills per kernel; a called function's
    properties do not count as the kernel's."""
    usage = nvcc_build.ptxas_usage(LOG)
    assert usage == {
        '_ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb1ELb0EEEvPKf': dict(
            registers=128, stack=0, spill_stores=0, spill_loads=0),
        '_ZN12_GLOBAL__N_120trace_seq_bwd_kernelILb0ELb1EEEvPKf': dict(
            registers=255, stack=2048, spill_stores=8, spill_loads=12)}
    assert nvcc_build.ptxas_usage('') == {}


def test_smoke_counts_replays_with_the_kernels_checkpoints():
    """chip_smoke.segment_replays, with which the bound counts K6's segment
    replays, takes by default the kernel's kCkpt (fused_nonseq's copy); the
    widest table cotangent fits the lanes of one warp (reduce_row's
    transpose reduce-scatter)."""
    from raytracetorch_tpu_torch.ops import fused_nonseq
    src = (CSRC / 'trace_nonseq_bwd.cu').read_text()
    m = re.search(r'constexpr int kCkpt = (\d+);', src)
    assert m and int(m.group(1)) == fused_nonseq.K6_CHECKPOINTS
    k = int(m.group(1))
    lives = torch.tensor([0, 1, k, k + 1, 2 * k, 2 * k + 1, 3 * k + 2])
    # earlier segments m = (lives - 1) // k: 0, 0, 0, 1, 1, 2, 3
    assert chip_smoke.segment_replays(lives) == k * (1 + 1 + 3 + 6)
    assert len(fused_trace.PLATE_GRAD_COLS) <= 32

