"""The diffractive and ideal elements in the PyTorch port against the JAX
package, on the CPU: the direction maps (``linear_dir``, ``grating_dir``,
``doe_dir``, ``kinoform_efficiency``, ``mla_dir``) and the ELLIPSE bound,
values and gradients; the elements' tables, static metadata, parameters and
paraxial matrices; the eager traces and the fused traces' plain versions
(K1's and K5's functions) on example 25's hybrid achromat, example 05's
nine-channel spectrometer and tests/test_elements.py's ideal-element
Scenes; the anchors of tests/test_doe.py, tests/test_grating.py and
tests/test_mla.py in the port; the bundle limits; the kinds still
refused.

Tolerances, each with its reason: direction maps rtol 1e-6 / atol 1e-6
(float32 rounding in another order; the maps' inputs are O(1)), their
gradients rtol 1e-4 / atol 1e-5 of the input's scale, and the kinoform
efficiency's wavelength gradient atol 1e-4 near the design wavelength,
where sin(x) / x's derivative cancels in float32 in both packages; ray
positions atol 2e-5 of the scene's scale, directions atol 2e-6,
intensities rtol 1e-5; moments rtol 1e-4 / atol 1e-3 (sums in another
order); tables rtol 1e-6 (each package builds its rows in its own float32
arithmetic).  A hit within a few ulps of a lenslet's cell edge or of the
ellipse's rim can take the other cell or side in the other package: such
rays are found by moving the hits by 1e-5 mm (``_stable``) and left out;
at most 1 in 500 may be.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core import physics as jphys
from raytracetorch_tpu.core.static_dispatch import sb_check_one as jsb
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core import physics as tphys
from raytracetorch_tpu_torch.core.static_dispatch import sb_check_one
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
N = 300


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


# ---- the direction maps ----

def _dirs(n, seed, edges=True):
    """Unit directions, mostly forward, with |d_z| < 1e-12 edges."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.2
    v[: n // 2, 2] *= -1.0
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if edges:
        v[:4, 2] = 0.0
        v[4:6, 2] = 1e-13
    return v.astype(np.float32)


def _rot(seed):
    """A proper rotation matrix (row-major, float32)."""
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


MAPS = ('linear', 'grating', 'grating_reflective', 'mla', 'doe', 'doe_n1')


def _map_inputs(name, seed=1, n=64):
    """Numpy inputs of a map: direction, Rw, hit and parameters; the
    wavelengths cover unset (0), the design wavelength and evanescent
    orders."""
    rng = np.random.default_rng(seed)
    d = _dirs(n, seed)
    rw = _rot(seed)
    hit = rng.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    wl = rng.uniform(0.4, 0.8, n).astype(np.float32)
    wl[::5] = 0.0
    wl[1::7] = 0.5876
    if name == 'linear':
        par = np.float32([0.05, -0.02, 1.1, 0.9])
    elif name.startswith('grating'):
        # period 0.9 um: the high wavelengths' first order is evanescent
        par = np.float32([0.9, 1.0, 1.0 if 'reflective' in name else 0.0])
    elif name == 'mla':
        par = np.float32([0.7, 25.0])
    else:
        # c1..c3, the order m, lam0: m = 1 meets a = 0 at the design
        # wavelength, m = 2 (and n1 > n2) the evanescent orders
        par = np.float32([-6.0, 0.05, -1e-3, 1.0 if name == 'doe' else 2.0,
                          0.5876])
    return d, rw, hit, wl, par


def _run_map(lib, name, d, rw, hit, wl, par):
    """(outputs..., ok or None) of the map in package ``lib`` (jnp or
    torch inputs)."""
    dd = (d[:, 0], d[:, 1], d[:, 2])
    hl = (hit[:, 0], hit[:, 1], hit[:, 0] * 0)
    if name == 'linear':
        return lib.linear_dir(dd, hl, rw, *par), None
    if name.startswith('grating'):
        return lib.grating_dir(dd, None, rw, par[0], par[1], par[2], wl) \
            if lib is jphys else lib.grating_dir(dd, rw, par[0], par[1],
                                                 par[2], wl)
    if name == 'mla':
        return lib.mla_dir(dd, hl, rw, par[0], par[1]), None
    n1, n2 = (1.0, 1.5) if name == 'doe' else (1.5, 1.0)
    coeffs = [par[0], par[1], par[2]]
    out, ok = lib.doe_dir(dd, rw, hl, coeffs, par[3], par[4], wl, n1, n2)
    eff = lib.kinoform_efficiency(par[3], par[4], wl)
    return out, (ok, eff)


@pytest.mark.parametrize('name', MAPS)
def test_direction_maps_match_jax(name):
    """Values of each map (and the DOE's ok mask and efficiency) on random
    directions, frames, hits and wavelengths, with the |d_z| < 1e-12,
    evanescent and design-wavelength edges."""
    d, rw, hit, wl, par = _map_inputs(name)
    out_j, ok_j = _run_map(jphys, name, jnp.asarray(d), jnp.asarray(rw),
                           jnp.asarray(hit), jnp.asarray(wl),
                           [jnp.float32(p) for p in par])
    out_t, ok_t = _run_map(tphys, name, _t(d), _t(rw), _t(hit), _t(wl),
                           [_t(p) for p in par])
    for a, b in zip(out_t, out_j):
        _close(a.numpy(), b, rtol=1e-6, atol=1e-6)
    if name.startswith('grating'):
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert not ok_t.all() and ok_t.any()
    if name.startswith('doe'):
        np.testing.assert_array_equal(ok_t[0].numpy(), np.asarray(ok_j[0]))
        _close(ok_t[1].numpy(), ok_j[1], rtol=1e-6, atol=1e-6)
        assert float(ok_t[1].min()) < 0.99
        if name == 'doe':
            assert float(ok_t[1].max()) == 1.0
        else:
            assert not ok_t[0].all()


@pytest.mark.parametrize('name', MAPS)
def test_direction_map_gradients_match_jax(name):
    """Gradients of a seeded projection of each map's output (plus the
    DOE's efficiency) in the direction, the frame, the hit, the wavelength
    and the parameters (the pitch through pitch * floor(.), the DOE's
    coefficients) against ``jax.grad``."""
    d, rw, hit, wl, par = _map_inputs(name, seed=3)
    g = np.random.default_rng(9).standard_normal((3, d.shape[0]))
    g = g.astype(np.float32)

    def proj(outs, extra, gg):
        s = sum((gi * oi).sum() for gi, oi in zip(gg, outs))
        if extra is not None:
            s = s + (extra[1] * gg[0]).sum()
        return s

    def jax_loss(args):
        out, ex = _run_map(jphys, name, *args[:4], list(args[4]))
        return proj(out, ex, jnp.asarray(g))
    args_j = (jnp.asarray(d), jnp.asarray(rw), jnp.asarray(hit),
              jnp.asarray(wl), tuple(jnp.float32(p) for p in par))
    ref = jax.grad(jax_loss)(args_j)
    args_t = [_t(d, True), _t(rw, True), _t(hit, True), _t(wl, True)]
    par_t = [_t(p, True) for p in par]
    out, ex = _run_map(tphys, name, *args_t, par_t)
    proj(out, ex, torch.from_numpy(g)).backward()
    got = [a.grad for a in args_t] + [p.grad for p in par_t]
    ref = list(ref[:4]) + list(ref[4])
    for k, (a, b) in enumerate(zip(got, ref)):
        b = np.asarray(b)
        a = np.zeros_like(b) if a is None else a.numpy()
        scale = max(1.0, float(np.abs(b).max()))
        # the wavelength's gradient near lam0 (the efficiency's sinc
        # derivative cancels in float32 in both packages)
        atol = 1e-4 * scale if k == 3 and name.startswith('doe') \
            else 1e-5 * scale
        _close(a, b, rtol=1e-4, atol=atol, err_msg=f'{name} input {k}')
    if name == 'mla':
        assert float(par_t[0].grad) != 0.0       # through pitch * floor(.)
    if name.startswith('doe'):
        assert all(float(p.grad) != 0.0 for p in par_t[:3])


def test_ellipse_bound_matches_jax():
    """The ELLIPSE surface bound on 20,000 hits for five rotations: the
    same decision as the JAX package's on every hit."""
    rng = np.random.default_rng(4)
    xy = rng.uniform(-3.0, 3.0, (20000, 2)).astype(np.float32)
    z = np.zeros(20000, np.float32)
    for rot in (0.0, 0.3, math.pi / 2, 2.0, -1.1):
        sb = np.float32([2.0, 1.0, rot, 0.0])
        ref = np.asarray(jsb(3, jnp.asarray(sb), (jnp.asarray(xy[:, 0]),
                                                  jnp.asarray(xy[:, 1]),
                                                  jnp.asarray(z))))
        got = sb_check_one(3, _t(sb), (_t(xy[:, 0]), _t(xy[:, 1]), _t(z)))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < ref.size


# ---- the elements ----

def _elements(rt):
    return {
        'linear': rt.LinearElement(diameter=8.0, translation=[0, 0, 3.0],
                                   name='e'),
        'ideal_lens': rt.IdealThinLens(focal=50.0, focal_grad=True,
                                       rotation=[0.01, 0.02, 0.0], name='e'),
        'ideal_cyl': rt.IdealCylThinLens(focal_x=1e9, focal_y=50.0,
                                         name='e'),
        'ideal_mirror': rt.IdealMirror(radius_x=100.0, radius_y=80.0,
                                       name='e'),
        'grating': rt.DiffractionGrating(period_um=1.5, order=-2,
                                         reflective=True, diameter=20.0,
                                         period_grad=True, name='e'),
        'doe_f': rt.DiffractiveLens(radius=8.0, f=5000.0, phase_grad=True,
                                    translation=[0, 0, 2.0], name='e'),
        'doe_coeffs': rt.DiffractiveLens(radius=6.0, coeffs=[-8.0, 0.02,
                                                             1e-4],
                                         order=2, design_wavelength=0.55,
                                         ior_in=1.0, ior_out=1.5,
                                         efficiency=True, name='e'),
        'mla': rt.MicrolensArray(half_x=5.0, half_y=4.0, pitch=1.0, f=20.0,
                                 pitch_grad=True, f_grad=True, name='e'),
        'ellipse': rt.EllipticAperture(r_major=2.0, r_minor=1.0, rot=0.4,
                                       invert=True, r_major_grad=True,
                                       name='e'),
    }


@pytest.mark.parametrize('name', sorted(_elements(trt)))
def test_element_tables_match_jax(name):
    """Every column of the element's row (a DOE's coefficients in the ff
    columns), its static metadata (a DOE's (terms, efficiency)), its
    parameters and trainable flags, and its paraxial matrices."""
    ej, et = _elements(jrt)[name], _elements(trt)[name]
    pj = ej.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    for k, v in et.init_params('cpu').items():
        _close(v.numpy(), pt[k].numpy(), rtol=0, atol=0, err_msg=k)
    assert et.trainable() == {k: bool(v) if isinstance(v, bool) else v
                              for k, v in ej.trainable().items()}
    sj, st = jrt.SequentialScene([ej]), trt.SequentialScene([et])
    tj, tt = sj.build_table({'e': pj}), st.build_table({'e': pt})
    for f in dataclasses.fields(tt):
        a = np.asarray(getattr(tj, f.name))
        b = getattr(tt, f.name).detach().numpy()
        assert a.shape == b.shape, f.name
        if np.issubdtype(a.dtype, np.floating):
            _close(b, a, rtol=1e-6, atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert [interop.meta_from_slots([m])[0] for m in sj.static_meta()] \
        == st.static_meta()
    if name not in ('ellipse', 'grating', 'mla'):
        zj, mj = ej.paraxial(pj)
        zt, mt = et.paraxial(pt)
        for a, b in zip(mt, mj):
            _close(a.numpy(), b, rtol=1e-6, atol=1e-7)
    if name == 'ideal_lens':
        assert float(et.f(pt)) == pytest.approx(50.0, rel=1e-6)
    if name.startswith('doe'):
        assert et.focal_length(0.5) == pytest.approx(ej.focal_length(0.5))
        assert fused_trace.doe_bits(st.static_meta()[0]) == (
            (len(pj['phase']) | (16 if 'coeffs' in name else 0)) << 20)


def test_element_guards_match_jax():
    """The constructors' errors, as the JAX package raises them."""
    for bad in (dict(radius=5.0), dict(radius=5.0, f=10.0, coeffs=[1.0]),
                dict(radius=5.0, f=10.0, order=0),
                dict(radius=0.0, f=10.0), dict(radius=5.0, f=0.0),
                dict(radius=5.0, coeffs=[1.0] * 9)):
        for rt in (jrt, trt):
            with pytest.raises(ValueError):
                rt.DiffractiveLens(**bad)
    for bad in (dict(pitch=0.0, f=10.0), dict(pitch=1.0, f=0.0)):
        for rt in (jrt, trt):
            with pytest.raises(ValueError):
                rt.MicrolensArray(half_x=5.0, half_y=5.0, **bad)


def test_params_from_numpy_carries_the_designs():
    """``interop.params_from_numpy`` of the JAX package's init_params of
    the hybrid achromat, the spectrometer and the diffractive Scene equals
    the port's init_params leaf for leaf (phase, period_um, pitch, f,
    r_major, ap_rot, P, ...), and the trainable trees agree."""
    names = set()
    for make in (chip_smoke.hybrid_scene, chip_smoke.spectrometer_scene,
                 chip_smoke.diffractive_ns_scene):
        js, ts = make(jrt), make(trt)
        pj = interop.params_from_numpy(_np(js.init_params()), 'cpu')
        pt = ts.init_params('cpu')
        assert pj.keys() == pt.keys()
        for el in pt:
            assert pj[el].keys() == pt[el].keys(), el
            for k in pt[el]:
                assert pj[el][k].dtype == pt[el][k].dtype, (el, k)
                torch.testing.assert_close(pj[el][k], pt[el][k], rtol=0,
                                           atol=0)
        tj, tt = js.trainable(), ts.trainable()
        for el in tt:
            for k, v in tt[el].items():
                np.testing.assert_array_equal(np.asarray(v, np.float32),
                                              np.asarray(tj[el][k],
                                                         np.float32))
        names |= {k for el in pt.values() for k in el}
    assert {'phase', 'period_um', 'pitch', 'f', 'r_major', 'ap_rot',
            'P'} <= names


# ---- the traces ----

def _case(make, bundles, nb, n, seed):
    """(JAX scene, port scene, JAX rays, bundles): the rays drawn by the
    port's sources from a seeded generator, carried to the JAX package
    through numpy (its own draws would compile its sampler first)."""
    ts = make(trt)
    rays_t = trt.sample_bundles(torch.Generator().manual_seed(seed),
                                bundles(trt, n), 'cpu')
    rays = jrt.Rays(**{f.name: jnp.asarray(getattr(rays_t, f.name).numpy())
                       for f in dataclasses.fields(trt.Rays)})
    return make(jrt), ts, rays, nb


def _hybrid_case(n=N, seed=2):
    return _case(chip_smoke.hybrid_scene,
                 lambda rt, n_: chip_smoke.hybrid_bundles(rt, n_ // 3), 3, n,
                 seed)


def _spectrometer_case(n=N, seed=3):
    return _case(chip_smoke.spectrometer_scene,
                 lambda rt, n_: chip_smoke.spectrometer_bundles(rt, n_ // 9),
                 9, n, seed)


def _scene_case(n=N, seed=4):
    return _case(chip_smoke.diffractive_ns_scene,
                 chip_smoke.diffractive_ns_bundles, 2, n, seed)


CASES = {'hybrid': _hybrid_case, 'spectrometer': _spectrometer_case,
         'scene': _scene_case}


def _port(js, rays):
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    return pt, interop.rays_from_numpy(_np(rays), 'cpu')


def _assert_rays_close(out_t, out_j, keep=None, scale=40.0):
    keep = np.ones(out_t.n, bool) if keep is None else keep
    for c in ('px', 'py', 'pz'):
        _close(getattr(out_t, c).detach().numpy()[keep],
               np.asarray(getattr(out_j, c))[keep], atol=2e-5 * scale,
               err_msg=c)
    for c in ('dx', 'dy', 'dz'):
        _close(getattr(out_t, c).detach().numpy()[keep],
               np.asarray(getattr(out_j, c))[keep], atol=2e-6, err_msg=c)
    _close(out_t.intensity.detach().numpy()[keep],
           np.asarray(out_j.intensity)[keep], rtol=1e-5, atol=1e-7)


def _stable(sim, rays, shift=1e-5):
    """Rays whose outcome does not move when the launch positions move by
    +-``shift`` mm in x and y (away from a cell edge or a rim)."""
    outs = []
    for s in (-shift, shift):
        out = sim(rays.replace(px=rays.px + s, py=rays.py + s))[0]
        outs.append(torch.stack([out.px, out.py, out.dx, out.dy,
                                 out.intensity]))
    return torch.isclose(outs[0], outs[1], rtol=1e-2, atol=1e-2).all(0) \
        .numpy()


@pytest.mark.parametrize('case', sorted(CASES))
def test_traces_match_jax(case):
    """The eager ``simulate`` and ``simulate_fused`` (K1's or K5's plain
    version here) against the JAX package's ``simulate``: rays and
    moments, bundle by bundle (nine on the spectrometer)."""
    js, ts, rays, nb = CASES[case]()
    pt, rays_t = _port(js, rays)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays, KEY, n_bundles=nb)
    keep = _stable(lambda r: ts.simulate(pt, r, nb), rays_t)
    assert (~keep).sum() <= max(1, keep.size // 500)
    for sim in (ts.simulate, ts.simulate_fused):
        fused_trace.LAUNCHES = fused_nonseq.NONSEQ_LAUNCHES = 0
        out_t, sens_t, _ = sim(pt, rays_t, nb)
        assert fused_trace.LAUNCHES == fused_nonseq.NONSEQ_LAUNCHES == 0
        _assert_rays_close(out_t, out_j, keep)
        if keep.all():
            _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4,
                   atol=1e-3)
    assert sens_t.moments.shape[1] == nb
    assert float(sens_t.moments[0, :, 0].min()) > 0     # every bundle lands


def test_ideal_lens_scene_matches_jax():
    """tests/test_elements.py's 2f-2f imaging Scene (an IdealThinLens, two
    bounces) through the eager and the fused loops, against the JAX
    package's; the point source's rays refocus at +2f."""
    f = 50.0
    js = jrt.Scene([jrt.IdealThinLens(focal=f, name='lens')], n_bounces=2)
    ts = trt.Scene([trt.IdealThinLens(focal=f, name='lens')], n_bounces=2)
    src = jrt.PointSource.make(na=jnp.float32(0.05),
                               translation=[0.0, 1.0, -2 * f])
    rays = src.sample(jax.random.PRNGKey(1), 256)
    out_j, _, _ = js.simulate(js.init_params(), rays, KEY)
    pt, rays_t = _port(js, rays)
    for sim in (ts.simulate, ts.simulate_fused):
        out_t, _, _ = sim(pt, rays_t)
        _assert_rays_close(out_t, out_j, scale=100.0)
        t = (2 * f - out_t.pz) / out_t.dz
        y = out_t.py + t * out_t.dy
        assert float((y + 1.0).abs().max()) < 1e-3
