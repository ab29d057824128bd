"""Anchors of chip_smoke.py section 12 (thin-film coatings and metal
mirrors), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/coating_anchors.py

prints, for chip_smoke.py's constants:

- ``COAT_W_REF`` and ``COAT_MC_REF``: ``chip_smoke.fresnel_stats`` of the
  bench scene with its singlet under a quarter-wave MgF2 coat on both
  faces (``chip_smoke.coated_scene``), in FRESNEL_W and FRESNEL, at N_MAIN
  rays of the reference's threefry draws (tests/fresnel_anchors.py's
  ``jax_rays``) with the Fresnel key PRNGKey(0), whose uniforms the port
  rebuilds;
- ``COAT_NS_REF``: the sensor's share of rays of the naive scene with the
  coated FRESNEL singlet (the XLA bounce loop in parts, its fold_in draws:
  compared within binomial sigmas);
- ``TELESCOPE_REF``: example 11 as published (100,000 threefry rays of
  PRNGKey(0) over its 50 mm disk, 300 Adam steps on the pair's
  thicknesses from (0.05, 0.08)): the bare, enhanced and optimized
  throughputs and the optimized thicknesses.  Most of its rays stay on the
  primary at a float32 root of the paraboloid ~0.01 mm off the mirror
  (ROADMAP Queue 3), and each package's rounding meets it on other rays:
  ``TELESCOPE_PARTED`` is the share of rays of that disk that the port's
  eager trace and the JAX package's end apart (4,000 rays of PRNGKey(1));
- ``TELESCOPE12_REF``: the same on a 12 mm disk, where no ray meets that
  root.

tests/test_torch_coated_trace.py runs these scenes at a small size against
the port.  Takes ~5 minutes, most of it the 2 x 300 design steps.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
import fresnel_anchors  # noqa: E402
import raytracetorch_tpu as jrt  # noqa: E402
from raytracetorch_tpu.elements import mirror as jmirror  # noqa: E402
from raytracetorch_tpu.utils.glass import glass as jglass  # noqa: E402


def coated_stats(n, mode, key=0):
    """``fresnel_stats`` of the coated bench scene in ``mode``."""
    scene = chip_smoke.coated_scene(jrt, mode)
    out, sensors, _ = scene.simulate(scene.init_params(),
                                     fresnel_anchors.jax_rays(n, key),
                                     jax.random.PRNGKey(key))
    return chip_smoke.fresnel_stats(np.asarray(out.dz),
                                    np.asarray(out.intensity),
                                    np.asarray(sensors.moments))


def coated_ns_share(n, key=0, chunks=fresnel_anchors.CHUNKS):
    """The sensor's share of rays of the naive scene with the coated
    FRESNEL singlet, in ``chunks`` parts of the same rays."""
    scene = chip_smoke.coated_scene(jrt, True, chip_smoke.NS_BOUNCES)
    scene.grid_shape = ()
    params = scene.init_params()
    rays = fresnel_anchors.jax_rays(n, key)
    trace = jax.jit(lambda r, k: scene.simulate(params, r, k)[1].moments)
    hits, size = 0.0, -(-n // chunks)
    for c in range(chunks):
        part = jax.tree_util.tree_map(lambda a: a[c * size:(c + 1) * size],
                                      rays)
        m = trace(part, jax.random.fold_in(jax.random.PRNGKey(key), c))
        hits += float(np.asarray(m, np.float64)[0, 0, 6])
    return hits / n


def telescope_rays(radius, n=chip_smoke.TELESCOPE_RAYS, key=0):
    return jrt.CollimatedDisk.make(
        radius=jnp.float32(radius), translation=[0, 0, 2.0],
        wavelength=chip_smoke.TELESCOPE_WL).sample(jax.random.PRNGKey(key), n)


def telescope(radius, steps=chip_smoke.TELESCOPE_STEPS):
    """Example 11 on a disk of ``radius``: the bare, enhanced and optimized
    throughputs and the optimized thicknesses."""
    import optax
    key = jax.random.PRNGKey(0)
    rays = telescope_rays(radius)
    n = rays.n

    def scene(coating):
        return chip_smoke.telescope_scene(jrt, jmirror, jglass, coating)

    def tput(sc, p):
        _, sens, _ = sc.simulate(p, rays, key)
        return float(sens.total_weight(0)[0]) / n

    bare = scene(None)
    t_bare = tput(bare, bare.init_params())
    enh = scene(list(chip_smoke.TELESCOPE_PAIR))
    p_enh = enh.init_params()
    t_enh = tput(enh, p_enh)
    p = dict(p_enh)
    p['primary'] = {**p_enh['primary'], 'coat_d': jnp.asarray(
        chip_smoke.TELESCOPE_START, jnp.float32)}
    opt = optax.adam(2e-3)

    @jax.jit
    def step(coat_d, state):
        def loss(cd):
            pp = dict(p)
            pp['primary'] = {**p['primary'], 'coat_d': cd}
            _, sens, _ = enh.simulate(pp, rays, key)
            return -sens.total_weight(0)[0] / n
        g = jax.grad(loss)(coat_d)
        up, state = opt.update(g, state)
        return jnp.clip(coat_d + up, 1e-3, 0.4), state

    cd, state = p['primary']['coat_d'], opt.init(p['primary']['coat_d'])
    for _ in range(steps):
        cd, state = step(cd, state)
    p_opt = dict(p)
    p_opt['primary'] = {**p['primary'], 'coat_d': cd}
    return dict(bare=t_bare, enhanced=t_enh, optimized=tput(enh, p_opt),
                coat_d=[float(x) for x in cd])


def telescope_parted(n=4000):
    """The share of rays of example 11's 50 mm disk that the port's eager
    trace and the JAX package's trace end apart (the paraboloid's float32
    root, which each package's rounding meets on other rays): final
    positions more than 1e-3 mm or intensities more than 1e-5 apart."""
    import torch

    import raytracetorch_tpu_torch as trt
    from raytracetorch_tpu_torch import interop
    rays = telescope_rays(50.0, n, key=1)
    js = chip_smoke.telescope_scene(jrt, jmirror, jglass,
                                    list(chip_smoke.TELESCOPE_PAIR))
    ts = chip_smoke.telescope_scene(trt, trt, trt.glass,
                                    list(chip_smoke.TELESCOPE_PAIR))
    pj = js.init_params()
    out_j, _, _ = js.simulate(pj, rays, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, pj)
    with torch.no_grad():
        out_t, _, _ = ts.simulate(interop.params_from_numpy(tree, 'cpu'),
                                  interop.rays_from_numpy(
                                      jax.tree_util.tree_map(np.asarray,
                                                             rays), 'cpu'))
    dpos = np.max([np.abs(np.asarray(getattr(out_j, c))
                          - getattr(out_t, c).numpy())
                   for c in ('px', 'py', 'pz')], axis=0)
    dint = np.abs(np.asarray(out_j.intensity) - out_t.intensity.numpy())
    return float(((dpos > 1e-3) | (dint > 1e-5)).mean())


def main():
    jax.config.update('jax_platforms', 'cpu')
    n = chip_smoke.N_MAIN
    for name, mode in (('COAT_W_REF', 'weighted'), ('COAT_MC_REF', True)):
        print(name, '=', {k: round(v, 8)
                          for k, v in coated_stats(n, mode).items()})
    print('COAT_NS_REF =', round(coated_ns_share(n), 8))
    telescope_only()


def telescope_only():
    jax.config.update('jax_platforms', 'cpu')
    print('TELESCOPE_REF =', telescope(50.0))
    print('TELESCOPE12_REF =', telescope(12.0))
    print('TELESCOPE_PARTED =', round(telescope_parted(), 6))


if __name__ == '__main__':
    telescope_only() if '--telescope' in sys.argv else main()
