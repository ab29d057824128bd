"""Anchors of chip_smoke.py section 11 (Fresnel physics), computed with the
JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/fresnel_anchors.py

prints, for chip_smoke.py's constants:

- ``FRESNEL_SEQ_REF``: the forward-going share, the mean intensity, the
  sensor's share of rays and the spot RMS of the bench scene with its
  singlet's faces FRESNEL (``fresnel=True``), at N_MAIN rays of the
  reference's threefry draws (``CollimatedDisk.make(radius=4.0,
  translation=[0, 0, -10]).sample(PRNGKey(0), n)``) traced by the JAX
  package's ``trace_sequential`` with the Fresnel key PRNGKey(0), whose
  uniforms the port rebuilds (rays/reference_prng.py::fresnel_uniforms);
- ``FRESNEL_W_REF``: the same statistics with ``fresnel='weighted'``;
- ``FRESNEL_NS_REF``: the sensor's share of rays of the naive scene with a
  FRESNEL singlet (8 bounces), traced by the JAX package's XLA bounce loop
  in CHUNKS parts of the same rays, the part c with the Fresnel key
  fold_in(PRNGKey(0), c) (its draws are not the port's: compared within
  binomial sigmas).

tests/test_torch_fresnel.py runs ``seq_stats`` and ``nonseq_share`` at a
small size against the port.
"""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402

CHUNKS = 8


def jax_rays(n, key=0):
    """The anchors' rays: the reference's collimated disk of radius 4 at
    z = -10, n rays of PRNG key ``key``."""
    return jrt.CollimatedDisk.make(radius=4.0, translation=[0.0, 0.0, -10.0]
                                   ).sample(jax.random.PRNGKey(key), n)


def seq_stats(n, mode, key=0):
    """``chip_smoke.fresnel_stats`` of the bench scene in Fresnel ``mode``
    at n rays of ``jax_rays(n, key)``, traced with the Fresnel key
    PRNGKey(key)."""
    scene = chip_smoke.fresnel_scene(jrt, mode)
    out, sensors, _ = scene.simulate(scene.init_params(), jax_rays(n, key),
                                     jax.random.PRNGKey(key))
    return chip_smoke.fresnel_stats(np.asarray(out.dz),
                                    np.asarray(out.intensity),
                                    np.asarray(sensors.moments))


def nonseq_share(n, key=0, chunks=CHUNKS):
    """The sensor's share of rays of the naive scene with a FRESNEL singlet
    (NS_BOUNCES bounces), n rays of ``jax_rays(n, key)`` traced by
    the XLA bounce loop in ``chunks`` parts."""
    scene = chip_smoke.fresnel_scene(jrt, True, chip_smoke.NS_BOUNCES)
    scene.grid_shape = ()
    params = scene.init_params()
    rays = jax_rays(n, key)
    trace = jax.jit(lambda r, k: scene.simulate(params, r, k)[1].moments)
    hits, size = 0.0, -(-n // chunks)
    for c in range(chunks):
        part = jax.tree_util.tree_map(lambda a: a[c * size:(c + 1) * size],
                                      rays)
        m = trace(part, jax.random.fold_in(jax.random.PRNGKey(key), c))
        hits += float(np.asarray(m, np.float64)[0, 0, 6])
    return hits / n


def main():
    jax.config.update('jax_platforms', 'cpu')
    n = chip_smoke.N_MAIN
    for name, mode in (('FRESNEL_SEQ_REF', True),
                       ('FRESNEL_W_REF', 'weighted')):
        print(name, '=', {k: round(v, 8)
                          for k, v in seq_stats(n, mode).items()})
    print('FRESNEL_NS_REF =', round(nonseq_share(n), 8))


if __name__ == '__main__':
    main()
