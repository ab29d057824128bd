"""Anchors of chip_smoke.py section 21 (the kind mix), computed with the
JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/mix_anchors.py

prints ``MIX_REF``: for each case of ``chip_smoke.MIX_SEQ_CASES``,
``MIX_NS_CASES`` and ``MIX_FIELD_CASES`` (``chip_smoke.mix_scene``), the
JAX package's ``simulate`` at chip_smoke.N_MAIN rays of its CollimatedDisk
(``chip_smoke.mix_source``) under PRNGKey(MIX_SEED), the FRESNEL draws
under the same key: the sensor's weight, centroid and RMS, the mean
intensity and, under the field (E0 = MIX_E0), the mean |E|^2
(``chip_smoke.mix_stats``'s numbers).  The card draws the same rays and
uniforms (rays/reference_prng.py).  Takes ~10 minutes.
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

import chip_smoke as cs  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402


def stats(out, sens, aux):
    m = np.asarray(sens.moments[0, 0], np.float64)
    cx, cy = m[1] / m[0], m[2] / m[0]
    var = m[3] / m[0] - cx * cx + m[4] / m[0] - cy * cy
    res = dict(weight=float(m[0]), cx=float(cx), cy=float(cy),
               rms=math.sqrt(max(float(var), 0.0)),
               mean_intensity=float(np.asarray(out.intensity,
                                               np.float64).mean()))
    if aux and 'field_power' in aux:
        res['field_power'] = float(np.asarray(aux['field_power'],
                                              np.float64).mean())
    return res


def main():
    key = jax.random.PRNGKey(cs.MIX_SEED)
    ref = {}
    for name in cs.MIX_SEQ_CASES + cs.MIX_NS_CASES + cs.MIX_FIELD_CASES:
        sc = cs.mix_scene(jrt, name, jnp)
        radius, trans, wl = cs.mix_source(name)
        rays = jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                       translation=list(trans),
                                       wavelength=wl).sample(key, cs.N_MAIN)
        kw = {}
        if name in cs.MIX_FIELD_CASES:
            kw = dict(track_field=True, E0=jnp.asarray(cs.MIX_E0,
                                                       jnp.float32))
        out, sens, aux = sc.simulate(sc.init_params(), rays, key, **kw)
        ref[name] = stats(out, sens, aux)
        print(name, json.dumps(ref[name]), file=sys.stderr, flush=True)
    print('MIX_REF = ' + json.dumps(ref, indent=1))


if __name__ == '__main__':
    main()
