"""Anchors of chip_smoke.py section 14 (fuzzy apodization and the obscured
pupil), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/fuzzy_anchors.py

prints, for chip_smoke.py's constants:

- ``APOD_RMS_REF, APOD_RMS_TOL``: the spot RMS of the Gaussian-apodized
  bench singlet (``chip_smoke.apodizer_scene`` with exp(-(x^2 + y^2) / 8),
  a collimated disk of 4 mm from z = -10) at 1M rays, the mean over
  PRNGKey 0-3 and 6 of its standard deviations over them (the card draws
  its own rays);
- the obscured pupil's transmitted share at 1M rays, beside its open area
  ``chip_smoke.PUPIL_SHARE`` (tests/test_obscuration.py::
  test_energy_fraction).

Takes ~1 minute.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402

N = 1_000_000


def apod(x, y, z):
    return jnp.exp(-(x * x + y * y) / 8.0)


def main():
    jax.config.update('jax_platforms', 'cpu')
    sc = chip_smoke.apodizer_scene(jrt, apod)
    p = sc.init_params()
    sim = jax.jit(lambda r: sc.simulate(p, r, jax.random.PRNGKey(0))[1]
                  .spot_rms(0)[0])
    rms = []
    for k in range(4):
        rays = jrt.CollimatedDisk.make(
            radius=jnp.float32(4.0), translation=[0, 0, -10.0]).sample(
                jax.random.PRNGKey(k), N)
        rms.append(float(sim(rays)))
    pupil = chip_smoke.pupil_scene(jrt)
    pp = pupil.init_params()
    shares = []
    for k in range(4):
        rays = jrt.CollimatedDisk.make(
            radius=jnp.float32(chip_smoke.PUPIL_R),
            translation=[0, 0, -3.0]).sample(jax.random.PRNGKey(k), N)
        out, _, _ = pupil.simulate(pp, rays, jax.random.PRNGKey(0))
        shares.append(float(out.intensity.sum()) / N)
    print(json.dumps({
        'APOD_RMS_REF': float(np.mean(rms)),
        'APOD_RMS_TOL': float(6 * np.std(rms, ddof=1)),
        'apod_rms_per_key': rms,
        'pupil_share_per_key': shares,
        'pupil_open_area': chip_smoke.PUPIL_SHARE}))


if __name__ == '__main__':
    main()
