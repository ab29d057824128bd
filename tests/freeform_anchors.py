"""Anchors of chip_smoke.py section 15 (freeform, Zernike and wedge
lenses), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/freeform_anchors.py

prints, for chip_smoke.py's constants, example 19's design as published
(examples/19_freeform_corrector.py: ``chip_smoke.ex19_scene`` with zero
coefficients, its 20,000-ray beam of PRNGKey(0), Adam for 400 steps at lr
2e-4 on the spot RMS^2):

- ``EX19_RMS0_REF``: the uncorrected spot RMS;
- ``EX19_RMS1_REF``: the spot RMS after the design, and the learned
  coefficients (x^2 and y^2 of opposite signs);

and the same design run by the port's eager trace on the CPU (the same
rays: rays/reference_prng.py), with its differences from the JAX package's,
which set the tolerances EX19_RMS0_RTOL and EX19_RMS1_RTOL.  Takes ~3
minutes.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402
import raytracetorch_tpu_torch as trt  # noqa: E402
from raytracetorch_tpu.rays.ray import Rays as JaxRays  # noqa: E402


def jax_beam(n):
    """examples/19_freeform_corrector.py::beam."""
    xy = jax.random.uniform(jax.random.PRNGKey(0), (2, n), minval=-8.0,
                            maxval=8.0)
    ok = (xy[0] ** 2 + xy[1] ** 2 <= 64.0).astype(jnp.float32)
    zero = jnp.zeros((n,))
    return JaxRays.from_components(
        (xy[0], xy[1], zero - 10.0), (zero, zero, jnp.ones((n,))),
        ok, jnp.zeros((n,), jnp.int32), zero)


def main():
    jax.config.update('jax_platforms', 'cpu')
    n = chip_smoke.EX19_DESIGN_RAYS
    sc = chip_smoke.ex19_scene(jrt)
    rays = jax_beam(n)
    key = jax.random.PRNGKey(1)
    p = sc.init_params()

    def rms(pp):
        return sc.simulate(pp, rays, key)[1].spot_rms(0)[0]

    def loss(pp):
        return rms(pp) ** 2
    rms0 = float(rms(p))
    p1, _ = jrt.fit(loss, p, trainable=sc.trainable(),
                    steps=chip_smoke.EX19_DESIGN_STEPS,
                    lr=chip_smoke.EX19_DESIGN_LR)
    rms1 = float(rms(p1))
    coeffs = [float(v) for v in p1['corrector']['xy1']]

    # the port's eager design on the same rays
    ts = chip_smoke.ex19_scene(trt)
    rays_t = chip_smoke.square_beam(trt, torch, n, chip_smoke.EX19_BEAM,
                                    'cpu')
    same_rays = bool(np.array_equal(np.asarray(rays.px),
                                    rays_t.px.numpy())
                     and np.array_equal(np.asarray(rays.intensity),
                                        rays_t.intensity.numpy()))

    def t_loss(pp):
        return ts.simulate(pp, rays_t)[1].spot_rms(0)[0] ** 2
    pt = ts.init_params('cpu')
    t_rms0 = float(t_loss(pt)) ** 0.5
    pt1, _ = trt.fit(t_loss, pt, trainable=ts.trainable(),
                     steps=chip_smoke.EX19_DESIGN_STEPS,
                     lr=chip_smoke.EX19_DESIGN_LR)
    t_rms1 = float(t_loss(pt1)) ** 0.5
    print(json.dumps({
        'EX19_RMS0_REF': rms0, 'EX19_RMS1_REF': rms1,
        'jax_coeffs': coeffs, 'same_rays': same_rays,
        'port_rms0': t_rms0, 'port_rms1': t_rms1,
        'port_coeffs': [float(v) for v in pt1['corrector']['xy1']],
        'rms0_rel_diff': abs(t_rms0 - rms0) / rms0,
        'rms1_rel_diff': abs(t_rms1 - rms1) / rms1}))


if __name__ == '__main__':
    main()
