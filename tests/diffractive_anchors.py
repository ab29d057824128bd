"""Anchors of chip_smoke.py section 13 (the diffractive and ideal
elements), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/diffractive_anchors.py

prints, for chip_smoke.py's constants:

- ``HYBRID_REF``: examples/25_hybrid_achromat.py as published: the bare
  singlet's chromatic focal shift z_F - z_C (mm), the hybrid's
  polychromatic spot RMS before and after the 600-step Adam design on its
  3 x 2,000 rays (PRNGKey(0) for each colour), its shift after it, the
  fitted DOE power -2 lam0_mm c1 and the thin-lens split's;
- ``SPECTROMETER_REF``: examples/05_spectrometer.py as published (nine
  channels of 2,000 rays, ``sample_rays(PRNGKey(0), ...)``, 400 Adam
  steps): the dispersion (um/nm, the slope of the centroids over the
  wavelength) and the mean and worst spot RMS before and after the design.

The port draws the same rays (rays/reference_prng.py::collimated_bundles)
and runs the same designs through its fused kernels.  The script then runs
the port's designs on the CPU (the kernels' plain versions) and prints
them with their differences from JAX's (``PORT_CPU``, ``DIFF``): they set
section 13's tolerances (chip_smoke.py HYB_TOL, SPEC_TOL).  Takes ~2
minutes.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402
from raytracetorch_tpu.optim.fit import fit  # noqa: E402


def chromatic_shift(scene, p):
    """Example 25's marginal-ray axis crossings: median z at F minus C."""
    zs = []
    for lam in (chip_smoke.HYB_LAMS[0], chip_smoke.HYB_LAMS[2]):
        r = jrt.CollimatedDisk.make(radius=jnp.float32(1.0),
                                    translation=[0, 0, -10.0],
                                    wavelength=lam).sample(
                                        jax.random.PRNGKey(1), 64)
        out, _, _ = scene.simulate(p, r, jax.random.PRNGKey(0))
        t = -out.px / out.dx * out.dz
        zs.append(float(jnp.median(out.pz + t)))
    return zs[0] - zs[1]


def hybrid_ref():
    bare = chip_smoke.hybrid_scene(jrt, bare=True)
    shift0 = chromatic_shift(bare, bare.init_params())
    hyb = chip_smoke.hybrid_scene(jrt)
    key = jax.random.PRNGKey(0)
    beams = [jrt.CollimatedDisk.make(radius=jnp.float32(4.0),
                                     translation=[0, 0, -10.0],
                                     wavelength=lam).sample(
                                         key, chip_smoke.HYB_RAYS)
             for lam in chip_smoke.HYB_LAMS]

    def loss(p):
        tot = 0.0
        for r in beams:
            _, sens, _ = hyb.simulate(p, r, key)
            tot = tot + sens.spot_rms(0)[0] ** 2
        return tot / len(beams)

    c0 = chip_smoke.HYB_C0
    p, hist = fit(loss, hyb.init_params(), trainable=hyb.trainable(),
                  steps=chip_smoke.HYB_STEPS, lr=3e-2,
                  scales={'lens': {'c1': c0, 'c2': c0},
                          'doe': {'phase': 0.2}})
    power = 1.0 / chip_smoke.HYB_F
    return dict(
        shift0=shift0, shift1=chromatic_shift(hyb, p),
        rms0=math.sqrt(float(hist[0])), rms1=math.sqrt(float(hist[-1])),
        p_doe=-2.0 * 0.5876e-3 * float(np.asarray(p['doe']['phase'])[0]),
        p_doe_split=power * chip_smoke.HYB_V_D
        / (chip_smoke.HYB_V_D - chip_smoke.HYB_V_R),
        c1=float(p['lens']['c1']), c2=float(p['lens']['c2']))


def spectrometer_stats(scene, p, rays):
    """(dispersion um/nm, mean spot RMS, worst spot RMS) of the nine
    channels."""
    _, sens, _ = scene.simulate(p, rays, jax.random.PRNGKey(0), n_bundles=9)
    cx = np.asarray(sens.centroid(0))[:, 0]
    rms = np.asarray(sens.spot_rms(0))
    lams = np.asarray(chip_smoke.spec_channels()) * 1000.0
    return (float(np.polyfit(lams, cx, 1)[0]) * 1e3, float(rms.mean()),
            float(rms.max()))


def spectrometer_ref():
    scene = chip_smoke.spectrometer_scene(jrt)
    rays = scene.sample_rays(jax.random.PRNGKey(0),
                             chip_smoke.spectrometer_bundles(
                                 jrt, chip_smoke.SPEC_RAYS))
    p0 = scene.init_params()

    def loss(p):
        _, sens, _ = scene.simulate(p, rays, jax.random.PRNGKey(0),
                                    n_bundles=9)
        return jnp.sum(sens.spot_rms(0) ** 2)

    p, losses = fit(loss, p0, trainable=scene.trainable(),
                    steps=chip_smoke.SPEC_STEPS, lr=2e-3)
    d0, m0, w0 = spectrometer_stats(scene, p0, rays)
    d1, m1, w1 = spectrometer_stats(scene, p, rays)
    return dict(dispersion0=d0, rms_mean0=m0, rms_max0=w0, dispersion=d1,
                rms_mean=m1, rms_max=w1, loss0=float(losses[0]),
                loss=float(losses[-1]),
                sensor_z=float(np.asarray(p['sensor']['trans'])[2]),
                c1=float(p['lens']['c1']), c2=float(p['lens']['c2']))


def main():
    import torch

    import raytracetorch_tpu_torch as trt
    refs = {'HYBRID_REF': hybrid_ref(), 'SPECTROMETER_REF': spectrometer_ref()}
    ports = {'HYBRID_REF': chip_smoke.hybrid_design(trt, torch, 'cpu'),
             'SPECTROMETER_REF': chip_smoke.spectrometer_design(trt, torch,
                                                                'cpu')}
    for name, ref in refs.items():
        port = ports[name]
        print(f'{name} =', json.dumps(ref))
        print(f'PORT_CPU {name} =', json.dumps(port))
        print(f'DIFF {name} =', json.dumps(
            {k: abs(port[k] - v) for k, v in ref.items()}))


if __name__ == '__main__':
    main()
