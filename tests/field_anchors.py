"""Anchors of chip_smoke.py sections 17 (the polarized field), 18 (the
field through coated interfaces and metal mirrors) and 19 (the field in the
non-sequential scene), computed with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/field_anchors.py [--coat | --nonseq]

prints ``FIELD_REF`` (without ``--coat``) and ``FIELD_COAT_REF`` for
chip_smoke.py, or with ``--nonseq`` ``FIELD_NS_REF`` alone.  ``FIELD_REF``: on the reference's own rays
(PRNGKey(0), which rays/reference_prng.py reproduces) at each example's
published size and at N_MAIN rays,

- example 07 (examples/07_polarization.py): the Brewster plane's mean
  transmitted power, mean degree of polarization and <S3/S0> for s, p and
  circular E0;
- example 22 (examples/22_polarimeter.py): the Malus curve's powers at 19
  analyzer angles, the mean normalized Stokes vectors behind no optic, the
  QWP at 45 degrees and the HWP at 22.5 degrees, and the analyzer design's
  final angle and leakage after 60 gradient steps;
- example 33 (examples/33_polarimeter.py): the quartz QWP's ellipticity
  angle chi (degrees) and the analyzer modulation at lam0 - 0.05, lam0 and
  lam0 + 0.05 um;
- example 06(c) (examples/06_analysis.py:79-85): the singlet's polarized
  transmission on its 96^2 pupil grid, mean and edge minimum.

``FIELD_COAT_REF``, on the reference's own rays (and FRESNEL uniforms) at
N_MAIN rays, the metals and the silver films in float64 (``enable_x64``,
where the JAX package's float32 complex square root does not cancel):

- ``paths``: the flux intensity * |E|^2 and |E|^2 (means over the rays) and
  the sensor's weight and first moments (per ray) of the coated bench
  singlet of chip_smoke.py::coated_scene in FRESNEL_W ('coated_w') and
  FRESNEL ('coated_mc') with s, p and circular E0, of the stress rows
  stack8, mangin and gold (at 0.45 and 0.70 um), of the silver-film
  beamsplitter in FRESNEL_W and of the aluminium mirrors (fixed, and
  dispersive at 0.80 um);
- ``design``: the coat thickness after 20 Adam steps (lr 0.004, from 0.08
  um) that maximize the coated FRESNEL_W singlet's x-polarized flux on its
  sensor, on 20,000 rays;
- ``jones``: the diattenuation and retardance maps of ``jones_pupil`` at
  n = 16 (pupil radius 3) on the coated singlet tilted 0.3 rad and on
  stack8.

``FIELD_NS_REF``: for each of chip_smoke.py's FIELD_NS_CASES (its
``field_ns_scene``, ``field_ns_source``) through the JAX package's
``Scene.simulate(track_field=True)`` at N_MAIN rays, on the reference's own
rays of PRNGKey(0) (the Brewster plane: its tilted beam's, sampled by the
JAX package) and the JAX package's draws, the aluminium mirror in float64:
the means of |E|^2 ('power') and of intensity * |E|^2 over the rays that
leave forward ('flux') with its per-ray standard deviation ('flux_std'),
and the sensor's weight and first moments per ray.

The tests do not run it.  Without ``--coat`` it takes a few minutes
(example 22's design at N_MAIN rays leads); ``--coat`` alone about 1.5
minutes; ``--nonseq`` alone about 2 minutes.
"""

import json
import math
import os
import sys
import time

import jax
from jax import enable_x64
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import raytracetorch_tpu as jrt  # noqa: E402
from raytracetorch_tpu.constants import PhysKind  # noqa: E402
from raytracetorch_tpu.elements import mirror, shapes  # noqa: E402
from raytracetorch_tpu.utils.polarization import (  # noqa: E402
    degree_of_polarization, jones_pupil, polarized_sequential_trace,
    stokes_parameters)

N_MAIN = 1_000_000
KEY = jax.random.PRNGKey(0)
LAM0 = 0.5876


def disk(n, radius, z, wavelength=None):
    kw = {} if wavelength is None else {'wavelength': wavelength}
    return jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                   translation=[0, 0, z], **kw).sample(KEY, n)


def ex07(n):
    theta_b = math.atan(1.5)
    sc = jrt.SequentialScene([
        jrt.ElementCustom(shapes.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                          name='brewster', rotation=[theta_b, 0.0, 0.0],
                          translation=[0.0, 0.0, 10.0]),
        jrt.SensorElement(half_x=6.0, half_y=6.0, translation=[0, 0, 30.0],
                          name='sensor')])
    sc.grid_shape, sc.grid_half_extent = (96, 96), 6.0
    rays = disk(n, 4.0, -10.0)
    res = {}
    for label, E0 in (('s', [[1.0, 0.0, 0.0]]), ('p', [[0.0, 1.0, 0.0]]),
                      ('circular', np.array([[1.0, 1.0j, 0.0]])
                       / np.sqrt(2))):
        out, sens, aux = sc.simulate(sc.init_params(), rays, KEY,
                                     track_field=True, E0=E0)
        s0, s1, s2, s3 = stokes_parameters(aux['field'], out.dir_c)
        res[label] = dict(
            T=float(jnp.mean(aux['field_power'])),
            dop=float(jnp.mean(degree_of_polarization(s0, s1, s2, s3))),
            s3=float(jnp.mean(s3 / jnp.maximum(s0, 1e-12))),
            grid=float(jnp.sum(sens.grid)))
    return res


def ex22(n):
    rays = disk(n, 2.0, -5.0)
    sc = jrt.SequentialScene([
        jrt.LinearPolarizer(radius=8.0, angle=0.0, angle_grad=True,
                            name='analyzer'),
        jrt.SensorElement(radius=20.0, translation=[0, 0, 20.0], name='s')])
    p0 = sc.init_params()

    @jax.jit
    def transmitted(theta):
        p = jax.tree.map(lambda x: x, p0)
        p['analyzer']['angle'] = theta
        _, _, aux = sc.simulate(p, rays, KEY, track_field=True)
        return aux['field_power'].mean()

    thetas = jnp.linspace(0.0, jnp.pi, 19)
    malus = [float(transmitted(t)) for t in thetas]
    stokes = {}
    for label, els in (
            ('none', ()),
            ('qwp45', (jrt.QuarterWaveplate(radius=8.0, angle=math.pi / 4,
                                            name='q'),)),
            ('hwp22', (jrt.HalfWaveplate(radius=8.0, angle=math.pi / 8,
                                         name='h'),))):
        s = jrt.SequentialScene(list(els) + [jrt.SensorElement(
            radius=20.0, translation=[0, 0, 30.0], name='s')])
        out, _, aux = s.simulate(s.init_params(), rays, KEY,
                                 track_field=True)
        s0, s1, s2, s3 = stokes_parameters(aux['field'], out.dir_c)
        stokes[label] = [float(jnp.mean(x / jnp.maximum(s0, 1e-12)))
                         for x in (s1, s2, s3)]
    sc3 = jrt.SequentialScene([
        jrt.HalfWaveplate(radius=8.0, angle=0.337, name='rot'),
        jrt.LinearPolarizer(radius=8.0, angle=0.2, angle_grad=True,
                            translation=[0, 0, 5.0], name='analyzer'),
        jrt.SensorElement(radius=20.0, translation=[0, 0, 20.0], name='s')])
    p = sc3.init_params()

    @jax.jit
    def power(p):
        _, _, aux = sc3.simulate(p, rays, KEY, track_field=True)
        return aux['field_power'].mean()

    g = jax.jit(jax.grad(power))
    for _ in range(60):
        p['analyzer']['angle'] = p['analyzer']['angle'] \
            - 0.5 * g(p)['analyzer']['angle']
    return dict(malus=malus, stokes=stokes,
                design_angle=float(p['analyzer']['angle']),
                design_leakage=float(power(p)))


def ex33(n):
    qwp = jrt.Waveplate(radius=10.0, retardance=0.25, angle=math.pi / 4,
                        material='quartz', design_wavelength=LAM0,
                        translation=[0, 0, 5.0], name='qwp')
    sc = jrt.SequentialScene([
        jrt.LinearPolarizer(radius=10.0, angle=0.0, name='pol'), qwp,
        jrt.SensorElement(radius=50.0, translation=[0, 0, 30.0],
                          name='sens')])
    res = {}
    for lam in (LAM0 - 0.05, LAM0, LAM0 + 0.05):
        rays = disk(n, 1.0, -5.0, lam)
        out, _, aux = sc.simulate(sc.init_params(), rays, KEY,
                                  track_field=True)
        s0, s1, s2, s3 = (float(np.mean(np.asarray(s))) for s in
                          stokes_parameters(aux['field'], out.dir_c))
        chi = 0.5 * math.asin(max(-1.0, min(1.0, s3 / s0)))
        res[f'{lam:.4f}'] = dict(chi_deg=math.degrees(chi),
                                 modulation=math.hypot(s1, s2) / s0)
    return res


def ex06():
    sc = jrt.SequentialScene([jrt.SingletLens(
        c1=0.02, c2=-0.02, d=16.0, t=4.0, ior_glass=1.5168, name='lens')])
    n, r = 96, 6.0
    gx, gy = np.meshgrid(np.linspace(-r, r, n), np.linspace(-r, r, n))
    keep = gx ** 2 + gy ** 2 <= r ** 2
    px, py = gx[keep], gy[keep]
    pos = np.stack([px, py, np.full_like(px, -10.0)], axis=1)
    d = np.tile([0.0, 0.0, 1.0], (len(px), 1))
    rays = jrt.Rays.create(pos, d, wavelength=np.full(len(px), 0.5876))
    out, power, _ = polarized_sequential_trace(sc, sc.init_params(), rays,
                                               KEY, E0=[[1.0, 0.0, 0.0]])
    alive = np.asarray(out.intensity) > 0
    power = np.asarray(power)
    return dict(rays=int(len(px)), alive=int(alive.sum()),
                mean=float(power[alive].mean()),
                edge_min=float(power[alive].min()))


# ---- section 18 ----

NC, QW = 1.38, 0.5876 / (4 * 1.38)
STACK8 = [(2.35, 0.5876 / (4 * 2.35)), (1.38, 0.5876 / (4 * 1.38))] * 3 + [
    (2.35, 0.5876 / (4 * 2.35)), ('Ag', 0.01)]


def coat_scene(name):
    """chip_smoke.py::field_coat_scene's scenes, in the JAX package."""
    if name in ('coated_w', 'coated_mc'):
        return jrt.SequentialScene([
            jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                            ior_media=1.0,
                            fresnel='weighted' if name == 'coated_w'
                            else True, coating=[(NC, QW)],
                            coating_grad=True, name='lens'),
            jrt.CircularAperture(radius=5.0, name='stop'),
            jrt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                              name='sensor')])
    if name == 'stack8':
        return jrt.SequentialScene([
            jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                            fresnel='weighted', coating=list(STACK8),
                            coating_grad=True, name='lens'),
            jrt.SensorElement(radius=6.0, translation=[0.0, 0.0, 19.0],
                              name='sensor')])
    if name == 'gold':
        return jrt.SequentialScene([
            mirror.SphericalMirror(c1=-0.01, d=40.0, metal='Au',
                                   metal_dispersion=True,
                                   translation=[0, 0, 50.0], name='mirror'),
            jrt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                              name='sensor')])
    if name == 'mangin':
        return jrt.SequentialScene([
            mirror.ManginMirror(c1=-0.02, c2=-0.025, d=30.0, t=4.0,
                                ior_glass=1.5168, metal='Al',
                                translation=[0, 0, 60.0], name='mirror'),
            jrt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                              name='sensor')])
    if name == 'splitter_w':
        return jrt.SequentialScene([
            jrt.ElementCustom(shapes.plane, 1, PhysKind.FRESNEL_W,
                              ph=(1.5168, 1.0), coating=[('Ag', 0.04)],
                              coating_grad=True,
                              rotation=[math.pi / 4, 0.0, 0.0], name='bs'),
            jrt.SensorElement(radius=100.0, translation=[0, 0, 20.0],
                              name='sensor')])
    if name == 'tilted':
        return jrt.SequentialScene([
            jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                            fresnel='weighted', coating=[(NC, QW)],
                            rotation=[0.3, 0.0, 0.0], name='lens'),
            jrt.SensorElement(radius=20.0, translation=[0, 0, 19.0],
                              name='sensor')])
    return jrt.SequentialScene([
        mirror.ParabolicMirror(c1=-0.001, d=30.0, translation=[0, 0, 50.0],
                               metal='Al', metal_dispersion=name == 'al_disp',
                               name='m'),
        jrt.SensorElement(radius=20.0, translation=[0, 0, 0.5], name='s')])


def x64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def coat_stats(out, sens, aux):
    n = out.px.shape[0]
    m = np.asarray(sens.moments, np.float64)[0].sum(0)
    inten = np.asarray(out.intensity, np.float64)
    power = np.asarray(aux['field_power'], np.float64)
    return dict(flux=float((inten * power).mean()), power=float(power.mean()),
                weight=float(m[0]) / n, mx=float(m[1]) / n,
                my=float(m[2]) / n)


def coat_path(name, radius, z, E0, wl=None, float64=False):
    sc = coat_scene(name)
    rays = disk(N_MAIN, radius, z, wl)
    p = sc.init_params()
    if float64:
        with enable_x64():
            return coat_stats(*sc.simulate(x64(p), x64(rays), KEY,
                                           track_field=True, E0=E0))
    return coat_stats(*sc.simulate(p, rays, KEY, track_field=True, E0=E0))


def coat_paths():
    s2 = math.sqrt(0.5)
    e0 = {'s': [[1.0, 0.0, 0.0]], 'p': [[0.0, 1.0, 0.0]],
          'circular': np.array([[1.0, 1.0j, 0.0]]) / np.sqrt(2)}
    res = {name: {label: coat_path(name, 4.0, -10.0, E0)
                  for label, E0 in e0.items()}
           for name in ('coated_w', 'coated_mc')}
    res['stack8'] = coat_path('stack8', 4.0, -10.0, [[s2, s2, 0.0]],
                              float64=True)
    res['mangin'] = coat_path('mangin', 10.0, -3.0, [[0.0, 1.0, 0.0]],
                              float64=True)
    for wl in (0.45, 0.7):
        res[f'gold_{wl}'] = coat_path('gold', 15.0, -3.0, [[1.0, 0.0, 0.0]],
                                      wl, float64=True)
    res['splitter_w'] = coat_path('splitter_w', 0.5, -5.0, [[1.0, 0.0, 0.0]],
                                  float64=True)
    res['al'] = coat_path('al', 1.0, 1.0, [[1.0, 0.0, 0.0]], float64=True)
    res['al_disp'] = coat_path('al_disp', 1.0, 1.0, [[0.6, 0.8, 0.0]], 0.80,
                               float64=True)
    return res


def coat_design(steps=20, lr=0.004, start=0.08, n=20_000):
    """The coat thickness by Adam (torch.optim.Adam's update, betas 0.9 and
    0.999, eps 1e-8) on the x-polarized flux of the coated FRESNEL_W
    singlet."""
    sc = coat_scene('coated_w')
    rays = disk(n, 4.0, -10.0)
    p0 = sc.init_params()

    @jax.jit
    def grad(d):
        def flux(d):
            p = jax.tree.map(lambda x: x, p0)
            p['lens']['coat_d'] = d
            _, sens, _ = sc.simulate(p, rays, KEY, track_field=True,
                                     E0=[[1.0, 0.0, 0.0]])
            return sens.total_weight(0)[0] / n
        return jax.grad(lambda d: -flux(d))(d)
    d = np.full(np.shape(p0['lens']['coat_d']), start, np.float32)
    m = v = np.zeros_like(d)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, steps + 1):
        g = np.asarray(grad(jnp.asarray(d)), np.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        den = np.sqrt(v) / math.sqrt(1 - b2 ** t) + eps
        d = (d - (lr / (1 - b1 ** t)) * m / den).astype(np.float32)
    return dict(thickness=float(d[0]))


def coat_jones():
    res = {}
    for name in ('tilted', 'stack8'):
        sc = coat_scene(name)
        if name == 'stack8':
            with enable_x64():
                jp = jones_pupil(sc, x64(sc.init_params()), KEY, 3.0, n=16)
        else:
            jp = jones_pupil(sc, sc.init_params(), KEY, 3.0, n=16)
        res[name] = {k: np.round(np.asarray(getattr(jp, k), np.float64),
                                 9).tolist()
                     for k in ('diattenuation', 'retardance')}
    return res


def ns_stats(out, sens, aux):
    """chip_smoke.py::field_ns_stats of a JAX trace."""
    n = out.px.shape[0]
    w = np.asarray(out.intensity, np.float64) * np.asarray(
        aux['field_power'], np.float64)
    fwd = (np.asarray(out.dir)[:, 2] > 0) & (np.asarray(out.intensity) > 0)
    w = np.where(fwd, w, 0.0)
    m = np.asarray(sens.moments, np.float64)[0, 0]
    return dict(power=float(np.asarray(aux['field_power'],
                                       np.float64).mean()),
                flux=float(w.mean()), flux_std=float(w.std(ddof=1)),
                weight=float(m[0]) / n, mx=float(m[1]) / n,
                my=float(m[2]) / n)


def ns_paths():
    import chip_smoke as cs
    res = {}
    for name in cs.FIELD_NS_CASES:
        sc = cs.field_ns_scene(jrt, name)
        radius, z, rot, wl, E0 = cs.field_ns_source(name)
        rays = (cs.field_ns_bundle(jrt, name).sample(KEY, N_MAIN) if rot
                else disk(N_MAIN, radius, z, wl or None))
        p = sc.init_params()
        if name.startswith('al'):
            with enable_x64():
                res[name] = ns_stats(*sc.simulate(x64(p), x64(rays), KEY,
                                                  track_field=True, E0=E0))
        else:
            res[name] = ns_stats(*sc.simulate(p, rays, KEY,
                                              track_field=True, E0=E0))
    return res


def main():
    t0 = time.time()
    if '--nonseq' in sys.argv:
        print('FIELD_NS_REF =', json.dumps(ns_paths(), indent=1))
        print(f'# {time.time() - t0:.0f} s', file=sys.stderr)
        return
    if '--coat' not in sys.argv:
        ref = {'ex07': {n: ex07(n) for n in (200_000, N_MAIN)},
               'ex22': {n: ex22(n) for n in (20_000, N_MAIN)},
               'ex33': {n: ex33(n) for n in (512, N_MAIN)},
               'ex06': ex06()}
        print('FIELD_REF =', json.dumps(ref, indent=1))
    coat = {'paths': coat_paths(), 'design': coat_design(),
            'jones': coat_jones()}
    print('FIELD_COAT_REF =', json.dumps(coat))
    print(f'# {time.time() - t0:.0f} s', file=sys.stderr)


if __name__ == '__main__':
    main()
