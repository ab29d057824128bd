"""The float64 diagnosis of four card tests of tests/test_torch_cuda.py
(ROADMAP Queue 3): each kernel's distance from the plain version's float64
run beside the float32 plain version's, on the tests' own inputs.

- ``test_field_nonseq_kernels_match_plain[coated]`` and ``[naive]``: K6
  with the field, its table cotangent (``table_f64``: the kernel's and the
  float32 plain version's distance from float64 over each column group's
  scale) and its ray and launch-field cotangents (``rays_off_f64``,
  ``field_off_f64``);
- ``test_grin_kernels_match_plain[ns_turn]``: K6 through the
  turning-point rod, the rays whose cotangents break BWD_TOL's rule
  against the float64 run (``rays_off_f64``: kernel, float32 plain);
- ``test_grin_paths_launch_their_instantiation``: the gradients of
  spot_rms in n0 and grin_A, fused (K1 + K2 or K5 + K6), eager in float32
  and eager in float64, at the quarter-pitch rod's focus, 2 mm beyond it,
  and through the rod as a Scene.

Every check of chip_smoke.py that these functions make is recorded, not
raised.  Run it on a machine with a CUDA card, from the repository's root:
``python3 tests/card_f64.py`` (one JSON line a case).  It imports no JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import raytracetorch_tpu_torch as trt  # noqa: E402

N = 2999  # tests/test_torch_cuda.py's rays


def main():
    if not torch.cuda.is_available():
        print('card_f64: no CUDA card', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    failed = []
    chip_smoke.check = lambda cond, what: cond or failed.append(what)
    print(json.dumps(dict(card=chip_smoke.nvidia_smi_line())), flush=True)
    for name in ('coated', 'naive'):
        del failed[:]
        res = chip_smoke.field_ns_kernels_vs_plain(trt, torch, name, N, dev,
                                                   93)
        print(json.dumps(dict(case=f'field_ns_{name}', checks_failed=failed,
                              res=res), default=str), flush=True)
    del failed[:]
    res = chip_smoke.grin_kernels_vs_plain(trt, torch, 'ns_turn', N, dev, 95)
    print(json.dumps(dict(case='grin_ns_turn', checks_failed=failed,
                          res=res), default=str), flush=True)
    lq = chip_smoke.GRIN_LQ
    for name, z in (('quarter', lq + 1e-3), ('quarter', lq + 2.0),
                    ('ns', None)):
        sc = chip_smoke.grin_scene(trt, name)
        if z is not None:
            sc = trt.SequentialScene([
                chip_smoke.grin_rod(trt, lq, 0.0),
                trt.SensorElement(radius=2.0, translation=[0.0, 0.0, z],
                                  name='s')])
        rays = chip_smoke.grin_rays(trt, torch, name, N, dev, 96)
        g = {sim: chip_smoke.grin_spot_grads(trt, torch, sc, rays, sim)
             for sim in ('simulate_fused', 'simulate')}
        g64 = chip_smoke.grin_spot_grads(trt, torch, sc, rays, 'simulate',
                                         dtype=torch.float64)
        print(json.dumps(dict(
            case=f'grin_grads_{name}', sensor_z=z,
            fused=g['simulate_fused'].tolist(), eager=g['simulate'].tolist(),
            eager64=g64.tolist(),
            fused_vs_eager=((g['simulate_fused'] - g['simulate']).abs()
                            / g['simulate'].abs()).tolist(),
            fused_vs_64=((g['simulate_fused'].double() - g64).abs()
                         / g64.abs()).tolist(),
            eager_vs_64=((g['simulate'].double() - g64).abs()
                         / g64.abs()).tolist())), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
