"""Anchors of chip_smoke.py section 10 (the deterministic streams and the
wavefront analysis), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/wavefront_anchors.py

prints, for chip_smoke.py's constants:

- ``WF_BENCH_REF``: on the bench singlet (chip_smoke.bench_scene) traced
  with ``track_opl`` on 1M rays of the reference's threefry draws
  (``CollimatedDisk(r=4)`` at z = -10, PRNG key 0; the port draws the same
  rays with rays/reference_prng.py), the refocused RMS wavefront error, the
  defocus and primary spherical Zernike coefficients of the OPD about best
  focus (15 Noll terms over the launch pupil of radius 4) and the set of
  ``n_final`` values;
- ``AXIAL_OPL_REF``: the axial ray's OPL through tests/test_wavefront.py's
  singlet, 8 + 1.5168 * 4;
- ``COOKE_RMAX_REF`` / ``COOKE_RMAX_TOL``: the footprint r_max of the
  Cooke triplet's (chip_smoke.cooke_scene, cooke_bundles) six lens faces,
  its stop and its sensor (``COOKE_FACE_ROWS``) at 1M rays, the mean over
  PRNG keys 0-3 and 6 standard deviations over those keys (at least 1e-4).
  The three edge cylinders are left out: a ray that misses one records the
  quadric's far root (the raw hit), an outlier that depends on the draw;
- ``WF_DESIGN_REF``: ``fit_lbfgs``, 20 steps, on those 1M bench rays with
  c1 and c2 trainable, minimizing ``wavefront_rms(refocus=True)``: the loss
  before and after, and the curvatures after.

``bench_wavefront`` and ``cooke_r_max`` take either package (``rt``) and
run at any size; tests/test_torch_wavefront.py runs them small.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

KEYS = (0, 1, 2, 3)
# the Cooke triplet's rows whose footprint is the beam's: not the lenses'
# edge cylinders (rows 2, 5 and 9)
COOKE_FACE_ROWS = (0, 1, 3, 4, 6, 7, 8, 10)
PUPIL_R = 4.0
DESIGN_STEPS = 20


def _is_jax(rt):
    return rt.__name__ == 'raytracetorch_tpu'


def bench_rays(rt, n, device='cpu'):
    """The bench source's rays from the reference's threefry key 0."""
    if _is_jax(rt):
        import jax
        import jax.numpy as jnp
        return rt.CollimatedDisk.make(
            radius=jnp.float32(PUPIL_R),
            translation=[0.0, 0.0, -10.0]).sample(jax.random.PRNGKey(0), n)
    from raytracetorch_tpu_torch.rays import reference_prng
    return reference_prng.collimated_disk(reference_prng.prng_key(0), n,
                                          PUPIL_R, (0.0, 0.0, -10.0),
                                          device=device)


def bench_wavefront(rt, n, device='cpu'):
    """{'rms', 'zernike': [defocus, spherical], 'n_final': sorted set} of
    the bench singlet on ``n`` threefry rays."""
    scene = chip_smoke.bench_scene(rt)
    rays = bench_rays(rt, n, device)
    if _is_jax(rt):
        import jax
        import jax.numpy as jnp
        from raytracetorch_tpu.utils import wavefront as wf
        out, _, aux = scene.simulate(scene.init_params(), rays,
                                     jax.random.PRNGKey(0), track_opl=True)
        xy = jnp.stack([rays.px, rays.py], axis=1)
        alive = (out.intensity > 0).astype(jnp.float32)
    else:
        from raytracetorch_tpu_torch.utils import wavefront as wf
        import torch
        simulate = (scene.simulate_fused if rays.px.device.type == 'cuda'
                    else scene.simulate)
        with torch.no_grad():
            out, _, aux = simulate(scene.init_params(device), rays,
                                   track_opl=True)
        xy = torch.stack([rays.px, rays.py], dim=1)
        alive = (out.intensity > 0).float()
    rms = float(wf.wavefront_rms(out, aux['opl'], refocus=True))
    tot = wf.opl_to_point(out, aux['opl'], wf.best_focus(out))
    opd = tot - (tot * alive).sum() / alive.sum()
    coef = wf.zernike_fit(xy, opd, PUPIL_R, weights=alive)
    return {'rms': rms, 'zernike': [float(coef[3]), float(coef[10])],
            'n_final': sorted({float(v) for v in np.unique(
                np.asarray(aux['n_final'].tolist()
                           if not _is_jax(rt) else aux['n_final']))})}


def axial_opl(rt):
    """The OPL and final medium of tests/test_wavefront.py's axial ray."""
    scene = rt.SequentialScene([rt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        name='lens')])
    r = rt.Rays.create([[0.0, 0.0, -10.0]], [[0.0, 0.0, 1.0]])
    if _is_jax(rt):
        import jax
        _, _, aux = scene.simulate(scene.init_params(), r,
                                   jax.random.PRNGKey(0), track_opl=True)
    else:
        _, _, aux = scene.simulate(scene.init_params('cpu'), r,
                                   track_opl=True)
    return float(aux['opl'][0]), float(aux['n_final'][0])


def cooke_r_max(rt, n, key=0, device='cpu'):
    """[8] footprint r_max of the Cooke triplet's COOKE_FACE_ROWS on ``n``
    rays of its six bundles (the JAX package draws them with PRNG key
    ``key``, the port with a torch.Generator seeded ``key``)."""
    scene = chip_smoke.cooke_scene(rt)
    bundles = chip_smoke.cooke_bundles(rt, n)
    if _is_jax(rt):
        import jax
        from raytracetorch_tpu.utils.footprint import footprints
        rays = scene.sample_rays(jax.random.PRNGKey(key), bundles)
        reps = footprints(scene, scene.init_params(), rays,
                          jax.random.PRNGKey(0))
    else:
        import torch
        gen = torch.Generator(device=device).manual_seed(key)
        rays = rt.sample_bundles(gen, bundles, device)
        reps = rt.footprints(scene, scene.init_params(device), rays)
    return [reps[k]['r_max'] for k in COOKE_FACE_ROWS]


def design(n, steps=DESIGN_STEPS):
    """The wavefront design on the bench singlet with the JAX package:
    (loss before, loss after, c1, c2)."""
    import jax
    import raytracetorch_tpu as jrt
    from raytracetorch_tpu.optim.fit import fit_lbfgs
    from raytracetorch_tpu.utils.wavefront import wavefront_rms
    scene = chip_smoke.bench_scene(jrt)
    rays = bench_rays(jrt, n)
    key = jax.random.PRNGKey(0)

    def loss(p):
        out, _, aux = scene.simulate(p, rays, key, track_opl=True)
        return wavefront_rms(out, aux['opl'], refocus=True)
    p0 = scene.init_params()
    trainable = jax.tree_util.tree_map(lambda _: False, p0)
    trainable['lens']['c1'] = trainable['lens']['c2'] = True
    p1, _ = fit_lbfgs(loss, p0, trainable=trainable, steps=steps)
    return (float(loss(p0)), float(loss(p1)), float(p1['lens']['c1']),
            float(p1['lens']['c2']))


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import raytracetorch_tpu as jrt
    n = chip_smoke.N_MAIN
    wf = bench_wavefront(jrt, n)
    print('WF_BENCH_REF =', {'rms': round(wf['rms'], 8),
                             'zernike': [round(v, 8) for v in wf['zernike']],
                             'n_final': wf['n_final']})
    print('AXIAL_OPL_REF =', axial_opl(jrt))
    runs = np.array([cooke_r_max(jrt, n, k) for k in KEYS])
    print('COOKE_RMAX_REF =', tuple(round(float(v), 6)
                                    for v in runs.mean(0)))
    print('COOKE_RMAX_TOL =', tuple(round(max(float(6 * v), 1e-4), 6)
                                    for v in runs.std(0, ddof=1)))
    print('per key:', runs.tolist())
    print('WF_DESIGN_REF =', tuple(round(v, 8) for v in design(n)))


if __name__ == '__main__':
    main()
