"""Anchors of chip_smoke.py section 9 (chromatic dispersion), computed with
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/dispersion_anchors.py

prints, for chip_smoke.py's constants:

- ``COOKE_RMS_REF`` / ``COOKE_RMS_TOL``: the spot RMS of each of the Cooke
  triplet's six bundles (chip_smoke.cooke_scene, cooke_bundles) at 1M rays,
  the mean over PRNG keys 0-3 and 6 standard deviations over those keys;
- ``ACHROMAT_CROSS_REF``: the axis crossing of a paraxial ray (height 0.1,
  +z) at the F, d and C lines through the achromat (chip_smoke.
  achromat_scene), Abbe and Sellmeier glasses.

The rays of each key are drawn and traced in chunks, and the moments
summed, so the 1M rays never sit in memory at once.  tests/
test_torch_dispersion.py runs ``cooke_spot_rms`` and ``axis_crossings`` at
a small size.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402

KEYS = (0, 1, 2, 3)
CHUNKS = 8


def cooke_spot_rms(n, key, chunks=CHUNKS):
    """[6] spot RMS of the Cooke triplet's bundles, n rays in all, drawn
    with PRNG key ``key`` in ``chunks`` parts."""
    scene = chip_smoke.cooke_scene(jrt)
    params = scene.init_params()
    trace = jax.jit(lambda p, r: scene.simulate(p, r, jax.random.PRNGKey(0),
                                                n_bundles=6)[1].moments)
    moments = 0.0
    for c in range(chunks):
        bundles = chip_smoke.cooke_bundles(jrt, n // chunks)
        rays = scene.sample_rays(jax.random.fold_in(jax.random.PRNGKey(key),
                                                    c), bundles)
        moments = moments + np.asarray(trace(params, rays), np.float64)
    m = moments[0]
    w = m[:, 0]
    var = (m[:, 3] / w - (m[:, 1] / w) ** 2) + (m[:, 4] / w - (m[:, 2] / w) ** 2)
    return np.sqrt(var)


def axis_crossings(model):
    """The z at which a ray at height 0.1 parallel to the axis crosses it
    behind the achromat, at the F, d and C lines."""
    scene = chip_smoke.achromat_scene(jrt, model)
    params = scene.init_params()
    out = []
    for wl in (chip_smoke.F_LINE, chip_smoke.D_LINE, chip_smoke.C_LINE):
        rays = jrt.Rays.create([[0.0, 0.1, -10.0]], [[0.0, 0.0, 1.0]],
                               wavelength=[wl])
        o, _, _ = scene.simulate(params, rays, jax.random.PRNGKey(0))
        t = -o.pos[0, 1] / o.dir[0, 1]
        out.append(float(o.pos[0, 2] + t * o.dir[0, 2]))
    return out


def main():
    jax.config.update('jax_platforms', 'cpu')
    runs = np.array([cooke_spot_rms(chip_smoke.N_MAIN, k) for k in KEYS])
    print('COOKE_RMS_REF =', tuple(round(float(v), 6)
                                   for v in runs.mean(0)))
    print('COOKE_RMS_TOL =', tuple(round(float(6 * v), 6)
                                   for v in runs.std(0, ddof=1)))
    print('per key:', runs.tolist())
    print('ACHROMAT_CROSS_REF =', {m: tuple(round(v, 5)
                                            for v in axis_crossings(m))
                                   for m in ('abbe', 'sellmeier')})


if __name__ == '__main__':
    main()
