"""Anchors of chip_smoke.py section 17 (the polarized field), computed with
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/field_anchors.py

prints ``FIELD_REF`` for chip_smoke.py: on the reference's own rays
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

The tests do not run it.  Takes a few minutes (example 22's design at
N_MAIN rays leads).
"""

import json
import math
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update('jax_platforms', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import raytracetorch_tpu as jrt  # noqa: E402
from raytracetorch_tpu.constants import PhysKind  # noqa: E402
from raytracetorch_tpu.elements import shapes  # noqa: E402
from raytracetorch_tpu.utils.polarization import (  # noqa: E402
    degree_of_polarization, polarized_sequential_trace, stokes_parameters)

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


def main():
    t0 = time.time()
    ref = {'ex07': {n: ex07(n) for n in (200_000, N_MAIN)},
           'ex22': {n: ex22(n) for n in (20_000, N_MAIN)},
           'ex33': {n: ex33(n) for n in (512, N_MAIN)},
           'ex06': ex06()}
    print('FIELD_REF =', json.dumps(ref, indent=1))
    print(f'# {time.time() - t0:.0f} s', file=sys.stderr)


if __name__ == '__main__':
    main()
