"""Anchors of chip_smoke.py section 16 (convex solids, custom shapes and
the point source), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/solid_anchors.py

prints, for chip_smoke.py's constants:

- ``LP_REF``: example 27's lightpipe (``chip_smoke.lightpipe_scene``,
  examples/27_lightpipe_homogenizer.py as published) with and without the
  pipe, at LP_RAYS and N_MAIN rays of PointSource(na=0.35) drawn from
  PRNGKey(0): the flux, the central relative std of the exit grid and the
  exit moments;
- ``WEDGE_MOMENTS_REF``: the moments of tests/test_pallas.py:225-254's wedge
  scene (``chip_smoke.wedge_scene``) on N_MAIN rays of the reference's
  CollimatedDisk(radius 2) at z = -5, key 0;

and the same runs by the port's eager bounce loop on the CPU, on the same
rays (rays/reference_prng.py: the directions an ulp apart, numpy's float32
transcendentals against XLA's), with their differences from the JAX
package's: the rays whose exit differs by more than 1e-4, which set
chip_smoke's LP_FLIPS_PER_MILLION and LP_STD_ATOL.  Takes ~10 minutes.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402
import raytracetorch_tpu_torch as trt  # noqa: E402


def run_jax(sc, rays, key):
    out, sens, _ = sc.simulate(sc.init_params(), rays, key)
    return out, np.asarray(sens.grid[0], np.float64), \
        np.asarray(sens.moments[0], np.float64)


def run_port(sc, rays):
    with torch.no_grad():
        out, sens, _ = sc.simulate(sc.init_params('cpu'), rays)
    return out, sens.grid[0].double().numpy(), sens.moments[0].double() \
        .numpy()


def apart(out_t, out_j):
    d = np.stack([np.abs(getattr(out_t, c).numpy()
                         - np.asarray(getattr(out_j, c)))
                  for c in ('px', 'py', 'pz')]).max(0)
    di = np.abs(out_t.intensity.numpy() - np.asarray(out_j.intensity))
    return int(((d > 1e-4) | (di > 1e-5)).sum())


def main():
    jax.config.update('jax_platforms', 'cpu')
    key = jax.random.PRNGKey(0)
    lp_ref, port = {}, {}
    for n in (chip_smoke.LP_RAYS, chip_smoke.N_MAIN):
        rays_j = jrt.PointSource.make(
            na=jnp.float32(chip_smoke.LP_NA),
            translation=list(chip_smoke.LP_SOURCE)).sample(key, n)
        rays_t = chip_smoke.lightpipe_rays(torch, n, 'cpu')
        for label in ('pipe', 'bare'):
            t0 = time.time()
            out_j, grid, mom = run_jax(chip_smoke.lightpipe_scene(
                jrt, label == 'pipe'), rays_j, key)
            flux, std = chip_smoke.lightpipe_stats(grid, mom)
            lp_ref[f'{label}_{n}'] = dict(flux=flux, rel_std=std,
                                          moments=mom[0].tolist())
            out_t, grid_t, mom_t = run_port(chip_smoke.lightpipe_scene(
                trt, label == 'pipe'), rays_t)
            flux_t, std_t = chip_smoke.lightpipe_stats(grid_t, mom_t)
            port[f'{label}_{n}'] = dict(
                flux_err=flux_t - flux, rel_std_err=std_t - std,
                moment_errs=(mom_t[0] - mom[0]).tolist(),
                rays_apart=apart(out_t, out_j),
                grid_l1=float(np.abs(grid_t - grid).sum()),
                seconds=time.time() - t0)
            print(label, n, lp_ref[f'{label}_{n}'], port[f'{label}_{n}'],
                  flush=True)
    n = chip_smoke.N_MAIN
    sc = chip_smoke.wedge_scene(jrt)
    rays_j = jrt.CollimatedDisk.make(radius=jnp.float32(2.0),
                                     translation=[0, 0, -5.0]).sample(key, n)
    out_j, _, mom = run_jax(sc, rays_j, key)
    rays_t = chip_smoke.wedge_rays(torch, n, 'cpu')
    same_rays = all(np.array_equal(getattr(rays_t, c).numpy(),
                                   np.asarray(getattr(rays_j, c)))
                    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz'))
    out_t, _, mom_t = run_port(chip_smoke.wedge_scene(trt), rays_t)
    wedge = dict(moments=mom[0].tolist(), same_rays=same_rays,
                 port_moment_errs=(mom_t[0] - mom[0]).tolist(),
                 rays_apart=apart(out_t, out_j))
    print(json.dumps(dict(LP_REF=lp_ref, port_vs_jax=port,
                          WEDGE_MOMENTS_REF=wedge)))


if __name__ == '__main__':
    main()
