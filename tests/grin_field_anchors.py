"""Anchors of chip_smoke.py section 22 (the polarized field through GRIN
rods), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/grin_field_anchors.py

prints ``GRIN_FIELD_REF``: for each case of ``chip_smoke.GRIN_FIELD_CASES``
(``chip_smoke.grin_field_scene``), the JAX package's ``simulate`` with the
field (E0 = ``chip_smoke.GRIN_FIELD_E0``) at chip_smoke.N_MAIN rays of its
CollimatedDisk or PointSource under PRNGKey(GRIN_FIELD_SEED): the sensor's
weight, centroid and RMS, the mean intensity and the mean |E|^2
(``chip_smoke.mix_stats``'s numbers).  The card draws the same rays
(rays/reference_prng.py, ``chip_smoke.grin_field_rays``).  Takes a few
minutes.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402
from mix_anchors import stats  # noqa: E402


def rays_of(name, key, n):
    """The JAX package's rays of a section 22 case."""
    if name == 'ns':
        return jrt.PointSource.make(
            na=cs.GRIN_FIELD_NA,
            translation=list(cs.GRIN_FIELD_SRC)).sample(key, n)
    radius, x = ((0.5, 0.0) if name == 'quarter'
                 else (cs.GRIN_FIELD_BEAM, cs.GRIN_FIELD_X))
    return jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                   translation=[x, 0.0, -3.0]).sample(key, n)


def main():
    key = jax.random.PRNGKey(cs.GRIN_FIELD_SEED)
    ref = {}
    for name in cs.GRIN_FIELD_CASES:
        sc = cs.grin_field_scene(jrt, name)
        E0 = jnp.asarray(cs.GRIN_FIELD_E0[name],
                         jnp.complex64 if name == 'ns' else jnp.float32)
        out, sens, aux = jax.jit(
            lambda p, r: sc.simulate(p, r, key, track_field=True, E0=E0))(
                sc.init_params(), rays_of(name, key, cs.N_MAIN))
        ref[name] = stats(out, sens, aux)
        print(name, json.dumps(ref[name]), file=sys.stderr, flush=True)
    print('GRIN_FIELD_REF = ' + json.dumps(ref, indent=1))


if __name__ == '__main__':
    main()
