"""The polarized field on the sequential path in the PyTorch port against
the JAX package, on the CPU: the s/p basis, the Fresnel amplitudes, the
launch field (real and complex E0 of every shape), the crystals'
birefringence and the polarizers' and waveplates' tables; the sequential
scenes of tests/test_polarization.py:46-290, tests/test_polarization_optics
.py:35-200 and tests/test_birefringence.py traced eagerly and by the fused
trace's plain version against the JAX package's
``simulate(track_field=True)``, on the same rays (and, on FRESNEL rows, the
same draws: rays/reference_prng.py); the gradients in an analyzer's angle,
a waveplate's retardance, a lens curvature and E0 against ``jax.grad``;
and the refusals that remain (a JONES row without the field; the
non-sequential field: tests/test_torch_field_nonseq.py).  The plain
K1 and K2 against the JAX kernels: tests/test_torch_field_kernels.py.

Tolerances, each with its reason: the field's six streams and |E|^2 atol
2e-6 (float32 products of unit vectors, XLA perhaps contracting a
multiply-add); positions rtol 1e-6 + atol 1e-5 and directions atol 2e-6
(as tests/test_torch_solids.py); moments rtol 1e-5 + atol 1e-5 of their
scale (sums in another order); gradients rtol 1e-4 (float32 adjoints), a
cancelling sum's (the lens curvature under the grad loss of
tests/test_pallas.py:628-665) rtol 1e-3 of its scale.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.constants import PhysKind
from raytracetorch_tpu.core import field as jfield
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu.utils import birefringence as jbire
from raytracetorch_tpu.utils import polarization as jpol
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core import field as tfield
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.rays import reference_prng as rp
from raytracetorch_tpu_torch.utils import birefringence as tbire
from raytracetorch_tpu_torch.utils import polarization as tpol

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
N_G = 1.5
N_B = 1.5168
LAM0 = 0.5876
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rays(pos, d, wavelength=None):
    """One ray batch for both packages: (JAX Rays, Rays)."""
    pos, d = np.float32(pos), np.float32(d)
    kw = {} if wavelength is None else {'wavelength': np.float32(wavelength)}
    jr = JaxRays.create(jnp.asarray(pos), jnp.asarray(d), **kw)
    return jr, interop.rays_from_numpy(_np(jr), 'cpu')


def _disk(n, radius, z, seed=0, wavelength=0.0, rotation=None):
    """The JAX package's CollimatedDisk rays of PRNGKey(seed), both ways."""
    jr = jrt.CollimatedDisk.make(
        radius=jnp.float32(radius), translation=[0, 0, z],
        wavelength=wavelength,
        **({} if rotation is None else {'rotation': rotation})).sample(
            jax.random.PRNGKey(seed), n)
    return jr, interop.rays_from_numpy(_np(jr), 'cpu')


def _oblique(theta, back=10.0):
    """One ray at incidence theta in the y-z plane towards the origin."""
    d = [0.0, math.sin(theta), math.cos(theta)]
    return _rays([[0.0, -back * d[1], -back * d[2]]], [d])


def _params(js):
    return interop.params_from_numpy(_np(js.init_params()), 'cpu')


def _check_field(field_t, field_j, power_t=None, power_j=None):
    for f in FIELDS:
        _close(getattr(field_t, f).detach(), getattr(field_j, f), atol=2e-6,
               err_msg=f)
    if power_t is not None:
        _close(power_t.detach(), power_j, atol=2e-6)


def _check_rays(out_t, out_j):
    for c in COMPS:
        ref = np.asarray(getattr(out_j, c))
        tol = (dict(rtol=1e-6, atol=1e-5) if c[0] == 'p'
               else dict(rtol=0, atol=2e-6))
        _close(getattr(out_t, c).detach(), ref, err_msg=c, **tol)


def _check_sensors(s_t, s_j):
    ref = np.asarray(s_j.moments)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(s_t.moments.detach(), ref, rtol=1e-5, atol=1e-5 * scale)
    if s_j.grid is not None and np.asarray(s_j.grid).size:
        g = np.asarray(s_j.grid)
        _close(s_t.grid.detach(), g, rtol=1e-5,
               atol=1e-5 * max(1.0, float(np.abs(g).max())))


def _trace_both(js, ts, rays_j, rays_t, E0=None, fused=True,
                uniforms=False):
    """The JAX package's simulate(track_field=True) against the port's
    eager trace and (``fused``) the fused trace's plain version, on the same
    rays; FRESNEL rows draw the JAX package's uniforms (reference_prng).
    Returns (JAX (out, sensors, aux), the port's eager one)."""
    res_j = js.simulate(js.init_params(), rays_j, KEY, track_field=True,
                        E0=E0)
    kw = {}
    if uniforms:
        kw['uniforms'] = rp.fresnel_uniforms(rp.prng_key(0),
                                             ts.static_meta(), rays_t.n)
    pt = _params(js)
    runs = [ts.simulate(pt, rays_t, track_field=True, E0=E0, **kw)]
    if fused:
        runs.append(ts.simulate_fused(pt, rays_t, track_field=True, E0=E0,
                                      **kw))
    for out_t, s_t, aux_t in runs:
        _check_rays(out_t, res_j[0])
        _check_sensors(s_t, res_j[1])
        _check_field(aux_t['field'], res_j[2]['field'], aux_t['field_power'],
                     res_j[2]['field_power'])
    return res_j, runs[0]


# ---- the pure functions ----

def test_sp_basis_and_amplitudes():
    """sp_basis (oblique and at normal incidence, where the fallback
    basis holds) and fresnel_amplitudes (propagating and under TIR)
    against the JAX package's, on seeded directions and normals."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = rng.normal(size=(64, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:8] = d[:8]                       # normal incidence: degenerate
    d32, n32 = np.float32(d), np.float32(n)
    sj, pj = jfield.sp_basis(tuple(jnp.asarray(d32.T)),
                             tuple(jnp.asarray(n32.T)))
    st, pt = tfield.sp_basis(tuple(_t(d32.T)), tuple(_t(n32.T)))
    for a, b in zip(st + pt, sj + pj):
        _close(a, b, atol=1e-6)
    n1 = np.float32(rng.uniform(1.0, 1.8, 64))
    n2 = np.float32(rng.uniform(1.0, 1.8, 64))
    ci = np.float32(rng.uniform(0.05, 1.0, 64))
    s2 = np.float32((n1 / n2) ** 2 * (1 - ci ** 2))
    assert (s2 > 1).any() and (s2 < 1).any()
    out_j = jfield.fresnel_amplitudes(*map(jnp.asarray, (n1, n2, ci, s2)))
    out_t = tfield.fresnel_amplitudes(*map(_t, (n1, n2, ci, s2)))
    flat = (lambda o: [o[0], o[1], *o[2], *o[3], o[4]])
    for a, b in zip(flat(out_t), flat(out_j)):
        _close(a, b, atol=1e-6)


@pytest.mark.parametrize('E0', [
    None, [[1.0, 0.0, 0.0]], [0.0, 1.0, 0.3],
    np.array([[1.0, 1.0j, 0.0]]) / np.sqrt(2),
    'per_ray_complex'])
def test_field_state_init(E0):
    """FieldState.init: x-linear by default; real or complex E0 of shape
    [N, 3], [1, 3] or [3], projected transverse to the ray and normalized,
    against the JAX package's."""
    rng = np.random.default_rng(1)
    d = rng.normal(size=(16, 3)) + [0, 0, 3.0]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, tr = _rays(np.zeros((16, 3)), d)
    if isinstance(E0, str):
        E0 = rng.normal(size=(16, 3)) + 1j * rng.normal(size=(16, 3))
    fj = jfield.FieldState.init(jr, E0)
    ft = tfield.FieldState.init(tr, E0)
    _check_field(ft, fj, ft.power(), fj.power())
    _close(ft.power(), 1.0, atol=1e-6)


def test_field_state_init_tensor_e0_grad():
    """A complex tensor E0 carries its cotangent through the projection
    and the normalization, as jax.grad carries a real one's."""
    jr, tr = _rays([[0.0, 0.0, 0.0]] * 4, [[0.0, 0.6, 0.8]] * 4)
    e0 = np.float32([[0.3, 0.9, 0.1]])
    g_j = jax.grad(lambda e: jfield.FieldState.init(jr, e).erx.sum()
                   * 3.0 + jfield.FieldState.init(jr, e).erz.sum())(
        jnp.asarray(e0))
    e_t = _t(e0).requires_grad_(True)
    ft = tfield.FieldState.init(tr, e_t)
    (ft.erx.sum() * 3.0 + ft.erz.sum()).backward()
    _close(e_t.grad, g_j, rtol=1e-5, atol=1e-7)
    e_c = torch.tensor([[0.3 + 0.2j, 0.9, 0.1j]], requires_grad=True)
    tfield.FieldState.init(tr, e_c).power().sum().backward()
    assert e_c.grad is not None and torch.isfinite(
        torch.view_as_real(e_c.grad)).all()


@pytest.mark.parametrize('material', ['quartz', 'MgF2', 'calcite'])
def test_birefringence(material):
    """crystal_indices and birefringence on floats and tensors against the
    JAX package's, and the published d-line indices
    (tests/test_birefringence.py)."""
    lams = np.float32([0.45, 0.5376, LAM0, 0.6376, 0.85])
    for fn in ('crystal_indices', 'birefringence'):
        ref = getattr(jbire, fn)(material, jnp.asarray(lams))
        got = getattr(tbire, fn)(material, _t(lams))
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            _close(a, b, rtol=2e-6)
    no_ref, ne_ref = {'quartz': (1.5443, 1.5534), 'MgF2': (1.3777, 1.3895),
                      'calcite': (1.6585, 1.4864)}[material]
    n_o, n_e = tbire.crystal_indices(material, LAM0)
    assert abs(n_o - no_ref) < 3e-4 and abs(n_e - ne_ref) < 3e-4
    assert tbire.WAVEPLATE_MATERIALS == jbire.WAVEPLATE_MATERIALS


@pytest.mark.parametrize('make', [
    lambda rt: rt.LinearPolarizer(radius=8.0, angle=0.3, extinction=1e-2,
                                  rotation=[0.1, 0.2, 0.3], name='p'),
    lambda rt: rt.QuarterWaveplate(radius=5.0, angle=0.7,
                                   translation=[0, 0, 3.0], name='q'),
    lambda rt: rt.HalfWaveplate(radius=5.0, angle=0.2, name='h'),
    lambda rt: rt.Waveplate(radius=5.0, retardance=0.3, angle=0.4,
                            chromatic=True, design_wavelength=0.55,
                            name='w'),
    lambda rt: rt.Waveplate(radius=5.0, retardance=0.25, angle=0.4,
                            material='calcite', retardance_grad=True,
                            angle_grad=True, name='c')])
def test_plate_tables(make):
    """The polarizers' and waveplates' tables, static metadata (JONES, the
    chromatic flag and the crystal), params and trainable flags against
    the JAX package's; interop.jones_plate_from carries a plate across."""
    js = jrt.SequentialScene([make(jrt)])
    for ts in (trt.SequentialScene([make(trt)]),
               trt.SequentialScene([interop.jones_plate_from(make(jrt))])):
        tj = _np(js.build_table(js.init_params()))
        tt = ts.build_table(_params(js))
        for name in ('Rw', 'tw', 'sb', 'ph', 'q'):
            _close(getattr(tt, name), getattr(tj, name), rtol=1e-6,
                   atol=1e-7, err_msg=name)
        assert ts.static_meta() == interop.meta_from_slots(js.static_meta())
        assert ts.elements[0].trainable() == js.elements[0].trainable()
    with pytest.raises(ValueError, match='extinction'):
        trt.LinearPolarizer(radius=1.0, extinction=1.5)
    with pytest.raises(ValueError, match='material'):
        trt.Waveplate(radius=1.0, material='diamond')


def test_stokes_parameters():
    """Stokes analysis of x-linear and circular fields against the JAX
    package's: S1 = S0 for x, |S3| = S0 and degree of polarization 1 for
    circular (tests/test_polarization.py:169-204)."""
    jr, tr = _rays([[0.0, 0.0, 0.0]] * 2, [[0.0, 0.0, 1.0], [0.0, 0.6, 0.8]])
    for E0 in ([[1.0, 0.0, 0.0]],
               np.array([[1.0, 1.0j, 0.0]]) / math.sqrt(2)):
        sj = jpol.stokes_parameters(jfield.FieldState.init(jr, E0),
                                    jr.dir_c)
        st = tpol.stokes_parameters(tfield.FieldState.init(tr, E0),
                                    tr.dir_c)
        for a, b in zip(st, sj):
            _close(a, b, atol=1e-6)
        _close(tpol.degree_of_polarization(*st),
               jpol.degree_of_polarization(*sj), atol=1e-6)


# ---- the JAX package's sequential field scenes, eager and fused ----

def _iface(rt, shapes, ph=(N_G, 1.0), kind=PhysKind.SNELL, sensor=False):
    els = [rt.ElementCustom(shapes.plane, 1, kind, ph=ph, name='iface')]
    if sensor:
        els.append(rt.SensorElement(name='sensor', translation=[0, 0, 40.0]))
    sc = rt.SequentialScene(els)
    if sensor:
        sc.grid_shape, sc.grid_half_extent = (16, 16), 60.0
    return sc


def _plates(rt, *specs):
    """Plates along z (5 mm apart) and example 22's sensor at 30."""
    els = [make(rt, j) for j, make in enumerate(specs)]
    return rt.SequentialScene(els + [rt.SensorElement(
        radius=50.0, translation=[0, 0, 30.0], name='sens')])


def _pol(angle, ext=0.0):
    return lambda rt, j: rt.LinearPolarizer(
        radius=10.0, angle=angle, extinction=ext,
        translation=[0, 0, 5.0 * j], name=f'p{j}')


def _wp(retardance, angle, **kw):
    return lambda rt, j: rt.Waveplate(
        radius=10.0, retardance=retardance, angle=angle,
        translation=[0, 0, 5.0 * j], name=f'w{j}', **kw)


def _interface_case(theta, E0, kind=PhysKind.SNELL, ph=(N_G, 1.0),
                    sensor=False):
    def case():
        js = _iface(jrt, jshapes, ph, kind, sensor)
        ts = _iface(trt, tshapes, ph, kind, sensor)
        return js, ts, _oblique(theta), E0, False
    return case


def _ep(theta):
    return [[0.0, math.cos(theta), -math.sin(theta)]]


def _brewster_mc(kind, E0, n=2000):
    th_b = math.atan(N_B)

    def case():
        sc = [rt.SequentialScene([
            rt.ElementCustom(sh.plane, 1, kind, ph=(N_B, 1.0), name='iface'),
            rt.SensorElement(radius=100.0, translation=[0, 0, 25.0],
                             name='sensor')])
            for rt, sh in ((jrt, jshapes), (trt, tshapes))]
        return (*sc, _disk(n, 2.0, -10.0, rotation=[th_b, 0.0, 0.0]), E0,
                kind == PhysKind.FRESNEL)
    return case


def _singlet_case(ray, E0):
    def case():
        sc = [rt.SequentialScene([rt.SingletLens(
            c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=N_G,
            name='lens')]) for rt in (jrt, trt)]
        return (*sc, _rays([ray], [[0.0, 0.0, 1.0]]), E0, False)
    return case


def _plates_case(*specs, wavelength=0.0, n=256, E0=None):
    def case():
        return (_plates(jrt, *specs), _plates(trt, *specs),
                _disk(n, 1.0, -5.0, wavelength=wavelength), E0, False)
    return case


def _ex07_case(E0):
    def case():
        sc = []
        for rt, sh in ((jrt, jshapes), (trt, tshapes)):
            s = rt.SequentialScene([
                rt.ElementCustom(sh.plane, 1, PhysKind.SNELL, ph=(1.5, 1.0),
                                 name='brewster',
                                 rotation=[math.atan(1.5), 0.0, 0.0],
                                 translation=[0.0, 0.0, 10.0]),
                rt.SensorElement(half_x=6.0, half_y=6.0,
                                 translation=[0, 0, 30.0], name='sensor')])
            s.grid_shape, s.grid_half_extent = (24, 24), 6.0
            sc.append(s)
        return (*sc, _disk(3000, 4.0, -10.0), E0, False)
    return case


th_b15 = math.atan(N_G)
s45 = math.sqrt(0.5)
CASES = {
    # tests/test_polarization.py:46-290
    'normal_incidence': _interface_case(0.0, [[1.0, 0.0, 0.0]]),
    's_at_angle': _interface_case(0.8, [[1.0, 0.0, 0.0]]),
    'p_at_angle': _interface_case(0.8, _ep(0.8)),
    'brewster': _interface_case(th_b15, _ep(th_b15)),
    'lens_two_faces': _singlet_case([0.0, 0.5, -10.0], [[1.0, 0.0, 0.0]]),
    'tir_unit_power': _interface_case(0.9, [[1.0, 0.0, 0.0]],
                                      ph=(1.0, N_G)),
    'track_field_aux': _interface_case(0.8, [[1.0, 0.0, 0.0]], sensor=True),
    'mc_brewster_p': _brewster_mc(
        PhysKind.FRESNEL, [[0.0, math.cos(math.atan(N_B)),
                            math.sin(math.atan(N_B))]]),
    'mc_brewster_s': _brewster_mc(PhysKind.FRESNEL, [[1.0, 0.0, 0.0]]),
    'mc_brewster_45': _brewster_mc(
        PhysKind.FRESNEL, [[s45, math.cos(math.atan(N_B)) * s45,
                            math.sin(math.atan(N_B)) * s45]]),
    'weighted_p': _brewster_mc(
        PhysKind.FRESNEL_W, [[0.0, math.cos(math.atan(N_B)),
                              math.sin(math.atan(N_B))]], 64),
    'weighted_s': _brewster_mc(PhysKind.FRESNEL_W, [[1.0, 0.0, 0.0]], 64),
    'reflect_w_s': _brewster_mc(PhysKind.REFLECT_W, [[1.0, 0.0, 0.0]], 64),
    # tests/test_polarization_optics.py:35-200
    'malus_30': _plates_case(_pol(math.pi / 6)),
    'malus_60': _plates_case(_pol(math.pi / 3)),
    'crossed': _plates_case(_pol(0.0), _pol(math.pi / 2)),
    'crossed_mediator': _plates_case(_pol(0.0), _pol(math.pi / 4),
                                     _pol(math.pi / 2)),
    'leaky': _plates_case(_pol(0.0, 1e-2), _pol(math.pi / 2, 1e-2)),
    'qwp_circular': _plates_case(_wp(0.25, math.pi / 4)),
    'hwp_rotates': _plates_case(_wp(0.5, math.pi / 8)),
    'hwp_twice': _plates_case(_wp(0.5, math.pi / 8), _wp(0.5, math.pi / 8)),
    'rotated_element': _plates_case(lambda rt, j: rt.LinearPolarizer(
        radius=10.0, angle=0.0, rotation=[0.0, 0.0, 0.6], name='pol')),
    'tilted_element': _plates_case(lambda rt, j: rt.LinearPolarizer(
        radius=10.0, angle=0.2, rotation=[0.4, 0.3, 0.0], name='pol')),
    'chromatic_design': _plates_case(
        _wp(0.25, math.pi / 4, chromatic=True, design_wavelength=0.55),
        wavelength=0.55),
    'chromatic_double': _plates_case(
        _wp(0.25, math.pi / 4, chromatic=True, design_wavelength=0.55),
        wavelength=1.10),
    'polarizer_qwp': _plates_case(_pol(0.4), _wp(0.25, math.pi / 4)),
    # tests/test_birefringence.py
    'quartz_blue': _plates_case(_wp(0.25, math.pi / 4, material='quartz'),
                                wavelength=LAM0 - 0.05),
    'quartz_red_crossed': _plates_case(
        _pol(0.0), _wp(0.25, math.pi / 4, material='quartz'),
        _pol(math.pi / 2), wavelength=LAM0 + 0.05),
    'mgf2': _plates_case(_wp(0.25, math.pi / 4, material='MgF2'),
                         wavelength=0.5),
    'calcite': _plates_case(_wp(0.25, math.pi / 4, material='calcite'),
                            wavelength=LAM0),
    'unset_wavelength': _plates_case(_wp(0.25, math.pi / 4,
                                         material='quartz')),
    # example 07 (E0 s, p, circular) with its grid
    'ex07_s': _ex07_case([[1.0, 0.0, 0.0]]),
    'ex07_circular': _ex07_case(np.array([[1.0, 1.0j, 0.0]]) / np.sqrt(2)),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_scene_parity(name):
    """A field scene traced eagerly and by the fused trace's plain version
    against the JAX package's simulate(track_field=True): rays, moments,
    grid, the final field and |E|^2."""
    js, ts, (rays_j, rays_t), E0, draws = CASES[name]()
    _trace_both(js, ts, rays_j, rays_t, E0, uniforms=draws)


def test_scene_anchors():
    """The closed forms the JAX tests hold, on the port: Brewster's p
    transmits fully, TIR keeps unit power, Malus's law, a QWP at 45
    degrees makes circular light, the quartz QWP's S3 = -sin(delta(lam)),
    and the polarized draw never reflects p at Brewster."""
    rays = _oblique(th_b15)[1]
    ts = _iface(trt, tshapes)
    pw = ts.simulate(_params(_iface(jrt, jshapes)), rays, track_field=True,
                     E0=_ep(th_b15))[2]['field_power']
    assert abs(float(pw[0]) - 1.0) < 1e-5
    ts = _iface(trt, tshapes, ph=(1.0, N_G))
    out, pw, _ = tpol.polarized_sequential_trace(
        ts, ts.init_params('cpu'), _oblique(0.9, 5.0)[1], [[1.0, 0.0, 0.0]])
    assert abs(float(pw[0]) - 1.0) < 1e-5 and float(out.dz[0]) < 0
    rays = _disk(64, 1.0, -5.0)[1]
    for theta in (0.0, 0.5, 1.2):
        ts = _plates(trt, _pol(theta))
        pw = ts.simulate(ts.init_params('cpu'), rays,
                         track_field=True)[2]['field_power']
        _close(pw, math.cos(theta) ** 2, atol=1e-6)
    for lam, mat in ((LAM0, None), (LAM0 - 0.05, 'quartz')):
        ts = _plates(trt, _wp(0.25, math.pi / 4, material=mat))
        r = _disk(64, 1.0, -5.0, wavelength=lam)[1]
        out, _, aux = ts.simulate(ts.init_params('cpu'), r, track_field=True)
        s0, _, _, s3 = tpol.stokes_parameters(aux['field'], out.dir_c)
        d = (math.pi / 2) * (LAM0 / lam) * (
            tbire.birefringence('quartz', lam)
            / tbire.birefringence('quartz', LAM0) if mat else 1.0)
        _close(s3 / s0, -math.sin(d), atol=1e-5)
    js, ts, (_, rays), E0, _ = CASES['mc_brewster_p']()
    out = ts.simulate(ts.init_params('cpu'), rays, track_field=True, E0=E0,
                      generator=torch.Generator().manual_seed(3))[0]
    assert int((out.dz < 0).sum()) == 0


# ---- gradients against jax.grad ----

def _analyzer(rt):
    return rt.SequentialScene([
        rt.HalfWaveplate(radius=8.0, angle=0.337, name='rot'),
        rt.LinearPolarizer(radius=8.0, angle=0.2, angle_grad=True,
                           translation=[0, 0, 5.0], name='analyzer'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 20.0], name='s')])


def _retarder(rt):
    return rt.SequentialScene([
        rt.LinearPolarizer(radius=10.0, angle=0.1, name='pol'),
        rt.Waveplate(radius=10.0, retardance=0.2, angle=0.5,
                     material='quartz', retardance_grad=True,
                     angle_grad=True, translation=[0, 0, 5.0], name='wp'),
        rt.LinearPolarizer(radius=10.0, angle=1.3, translation=[0, 0, 10.0],
                           name='an'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 20.0], name='s')])


def _singlet(rt):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=N_B,
                       c1_grad=True, name='lens'),
        rt.SensorElement(radius=8.0, translation=[0, 0, 19.0],
                         name='sensor')])


GRAD_CASES = {
    'analyzer_angle': (_analyzer, (('analyzer', 'angle'), ('rot', 'angle'),
                                   ('rot', 'retardance')), 0.0),
    'retardance': (_retarder, (('wp', 'retardance'), ('wp', 'angle'),
                               ('an', 'angle')), LAM0 - 0.04),
    'lens_c1_and_E0': (_singlet, (('lens', 'c1'),), 0.0),
}


@pytest.mark.parametrize('fused', [False, True])
@pytest.mark.parametrize('name', sorted(GRAD_CASES))
def test_gradients(name, fused):
    """Gradients of a field loss (mean |E|^2 plus the polarization-weighted
    total weight and its x moment) in the listed leaves and in E0, the
    port's eager trace (``fused=False``) and the fused trace's plain
    version (``fused=True``, K2's plain version) against jax.grad of the
    JAX package's eager trace."""
    make, leaves, wl = GRAD_CASES[name]
    js, ts = make(jrt), make(trt)
    radius, z = (3.0, -10.0) if name.startswith('lens') else (2.0, -5.0)
    rays_j, rays_t = _disk(1024, radius, z, wavelength=wl)
    e0 = np.float32([[math.sqrt(0.5), math.sqrt(0.5), 0.1]])

    def loss_j(p, e):
        _, s, aux = js.simulate(p, rays_j, KEY, track_field=True, E0=e)
        return (aux['field_power'].mean() + s.total_weight(0)[0] * 1e-3
                + s.moments[0, 0, 1] * 1e-3 + (aux['field_power'] ** 2).sum()
                * 1e-4)
    g_j, ge_j = jax.grad(loss_j, argnums=(0, 1))(js.init_params(),
                                                 jnp.asarray(e0))
    pt = _params(js)
    for el, leaf in leaves:
        pt[el][leaf].requires_grad_(True)
    e_t = _t(e0).requires_grad_(True)
    sim = ts.simulate_fused if fused else ts.simulate
    _, s, aux = sim(pt, rays_t, track_field=True, E0=e_t)
    loss = (aux['field_power'].mean() + s.total_weight(0)[0] * 1e-3
            + s.moments[0, 0, 1] * 1e-3 + (aux['field_power'] ** 2).sum()
            * 1e-4)
    grads = torch.autograd.grad(loss, [pt[el][leaf] for el, leaf in leaves]
                                + [e_t])
    for (el, leaf), g in zip(leaves, grads):
        ref = float(g_j[el][leaf])
        tol = 1e-3 if leaf == 'c1' else 1e-4
        assert abs(float(g) - ref) <= tol * max(abs(ref), 1e-3), (el, leaf)
    _close(grads[-1], ge_j, rtol=1e-4, atol=1e-6)


# ---- the refusals that remain ----

def test_refusals():
    """A JONES row without the field raises NotImplementedError naming the
    missing field, sequential or not; coated and metal rows trace under the
    field (tests/test_torch_field_coat.py holds them to the JAX package),
    and so does a non-sequential Scene, eager and fused (E0 without
    ``track_field`` is ignored, as in the JAX package;
    tests/test_torch_field_nonseq.py holds it to the JAX package)."""
    rays = _disk(16, 1.0, -5.0)[1]
    coated = trt.SequentialScene([trt.SingletLens(
        c1=0.02, c2=-0.02, d=10.0, t=3.0, ior_glass=1.5, fresnel='weighted',
        coating=[(1.38, 0.1)], name='lens')])
    metal = trt.SequentialScene([trt.SphericalMirror(
        c1=-0.02, d=10.0, metal='Al', name='m', translation=[0, 0, 20.0])])
    for sc in (coated, metal):
        for sim in (sc.simulate, sc.simulate_fused):
            aux = sim(sc.init_params('cpu'), rays, track_field=True)[2]
            assert bool(torch.isfinite(aux['field_power']).all())
    ns = trt.Scene([trt.LinearPolarizer(radius=10.0, name='p')])
    for sim in (ns.simulate, ns.simulate_fused):
        aux = sim(ns.init_params('cpu'), rays, track_field=True)[2]
        assert bool(torch.isfinite(aux['field_power']).all())
        with pytest.raises(NotImplementedError, match='track_field'):
            sim(ns.init_params('cpu'), rays, E0=[1.0, 0.0, 0.0])
    sq = _plates(trt, _pol(0.0))
    for sim in (sq.simulate, sq.simulate_fused):
        with pytest.raises(NotImplementedError, match='track_field'):
            sim(sq.init_params('cpu'), rays)
