"""The wavefront and footprint analysis of the PyTorch port against the JAX
package, on the CPU: ``noll_nm``, ``best_focus``, ``opl_to_point``,
``wavefront_rms`` (with and without ``refocus``), the Zernike basis and
fit, ``interferogram``, ``footprints`` and ``footprint_report``, on the same
traced rays; the anchors of tests/test_wavefront.py (the axial OPL, the
best focus near the axis crossing, the RMS wavefront error's growth with
the aperture, refocus absorbing a reference tilt, a finite gradient); part
(a) of examples/06_analysis.py (the Zernike spectrum of a singlet over its
96 x 96 pupil grid); and the bench singlet's wavefront anchors of
chip_smoke.py section 10 at a small size (tests/wavefront_anchors.py).

Inputs are made by the JAX package from a seed and carried over through
numpy.  Tolerances, each with its reason:

- ``noll_nm``, the Zernike names and the report: exact;
- ``best_focus``: atol 1e-4 (a 3 x 3 solve of float32 sums over the rays,
  summed in another order);
- ``opl_to_point``: atol 1e-5 of the OPL (float32 rounding);
- ``wavefront_rms``: rtol 2e-3 and atol 5e-6 (a spread of ~1e-3 to ~1e-5
  about an OPL of ~30-110: differences of float32 numbers whose own
  rounding, ~1e-5 relative of the OPL at most, is the floor that
  tests/test_wavefront.py:52-58 names);
- the Zernike basis: rtol 1e-5, atol 5e-6 (polynomials up to rho^6 with
  coefficients up to 20 whose terms cancel: ~20 float32 ulps of 1); the
  fit: atol 1e-3 of the largest coefficient, and at least 5e-6, the float32
  floor of an OPD taken from OPLs of ~30 (the port solves the normal
  equations in float64, the JAX package ``lstsq`` in float32);
- footprints: r_max rtol 1e-5 (float32 hits), hit counts exactly;
- interferogram: atol 1e-5 (a cosine of float32 phases)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.geom.zernike import noll_nm as jax_noll_nm
from raytracetorch_tpu.utils import footprint as jfp
from raytracetorch_tpu.utils import wavefront as jwf
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.utils import wavefront as twf

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _lens_scene(rt, **kw):
    """tests/test_wavefront.py's f/6 singlet."""
    return rt.SequentialScene([rt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        name='lens', **kw)])


def _traced(scene_fn, radius, n, z=-10.0, seed=0):
    """Both packages' traces of the same JAX-drawn collimated disk with
    ``track_opl``: (JAX rays out, JAX aux, port rays out, port aux, JAX
    rays in)."""
    js, ts = scene_fn(jrt), scene_fn(trt)
    rays = jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                   translation=[0, 0, z]).sample(
        jax.random.PRNGKey(seed), n)
    out_j, _, aux_j = js.simulate(js.init_params(), rays, KEY,
                                  track_opl=True)
    out_t, _, aux_t = ts.simulate(ts.init_params('cpu'),
                                  interop.rays_from_numpy(_np(rays), 'cpu'),
                                  track_opl=True)
    return out_j, aux_j, out_t, aux_t, rays


def test_noll_nm_matches_jax():
    for j in range(1, 60):
        assert trt.noll_nm(j) == jax_noll_nm(j)
    with pytest.raises(ValueError):
        trt.noll_nm(0)
    for j in (1, 4, 11, 22, 25):
        assert twf.zernike_name(j) == jwf.zernike_name(j)
    assert twf.ZERNIKE_NAMES == jwf.ZERNIKE_NAMES


@pytest.mark.parametrize('radius', [1.0, 8.0])
def test_wavefront_functions_match_jax(radius):
    """best_focus, opl_to_point and wavefront_rms (both modes, about best
    focus and about a displaced point) on the same traced rays."""
    out_j, aux_j, out_t, aux_t, _ = _traced(_lens_scene, radius, 3000)
    F_j = jwf.best_focus(out_j)
    F_t = twf.best_focus(out_t)
    _close(F_t.numpy(), F_j, atol=1e-4)
    tot_j = jwf.opl_to_point(out_j, aux_j['opl'], F_j)
    tot_t = twf.opl_to_point(out_t, aux_t['opl'], torch.from_numpy(
        np.asarray(F_j)))
    _close(tot_t.numpy(), tot_j, atol=1e-5 * float(np.abs(tot_j).max()))
    off = np.asarray(F_j) + np.array([0.05, 0.0, 0.0], np.float32)
    for point in (None, off):
        for refocus in (False, True):
            ref = float(jwf.wavefront_rms(
                out_j, aux_j['opl'], None if point is None
                else jnp.asarray(point), refocus=refocus))
            got = float(twf.wavefront_rms(
                out_t, aux_t['opl'], None if point is None
                else torch.from_numpy(point), refocus=refocus))
            _close(got, ref, rtol=2e-3, atol=5e-6)


def test_wavefront_anchors():
    """tests/test_wavefront.py's anchors in the port: best focus near the
    paraxial axis crossing, the RMS wavefront error at the float32 floor for
    a paraxial pencil and growing ~r^4 (spherical aberration) at r = 8, and
    refocus absorbing a laterally displaced reference point's tilt."""
    _, _, out, aux, _ = _traced(_lens_scene, 1.0, 500)
    F = twf.best_focus(out).numpy()
    _close(F[2], 99.3, atol=0.3)
    _close(F[:2], 0.0, atol=1e-3)
    _, _, out1, aux1, _ = _traced(_lens_scene, 1.0, 4000)
    small = float(twf.wavefront_rms(out1, aux1['opl']))
    _, _, out8, aux8, _ = _traced(_lens_scene, 8.0, 4000)
    large = float(twf.wavefront_rms(out8, aux8['opl']))
    assert small < 5e-5
    assert 5e-5 < large < 1e-3
    assert large > small * 5
    _, _, out4, aux4, _ = _traced(_lens_scene, 4.0, 4000)
    F = twf.best_focus(out4)
    at_f = float(twf.wavefront_rms(out4, aux4['opl'], point=F))
    off = F + torch.tensor([0.1, 0.0, 0.0])
    plain = float(twf.wavefront_rms(out4, aux4['opl'], point=off))
    refoc = float(twf.wavefront_rms(out4, aux4['opl'], point=off,
                                    refocus=True))
    assert plain > 20 * at_f
    assert refoc < at_f + 2e-5
    both = float(twf.wavefront_rms(out4, aux4['opl'], point=F,
                                   refocus=True))
    assert both <= at_f + 1e-7


@pytest.mark.parametrize('fused', [False, True])
def test_wavefront_differentiable(fused):
    """tests/test_wavefront.py::test_wavefront_differentiable: the RMS
    wavefront error's gradient in c1 is finite and nonzero, through the
    eager trace and the fused trace's plain versions, and equals
    ``jax.grad`` of the JAX package's to rtol 2e-2: the RMS here (~4e-5)
    sits near the float32 floor of the OPL, and its float32 gradient itself
    lies ~10% from the float64 one (the port traced in float64 gives 0.00597
    against 0.00542), so the two packages' float32 roundings agree only to
    about a percent."""
    js = _lens_scene(jrt, c1_grad=True, c2_grad=True)
    ts = _lens_scene(trt, c1_grad=True, c2_grad=True)
    rays = jrt.CollimatedDisk.make(radius=jnp.float32(6.0),
                                   translation=[0, 0, -10.0]).sample(KEY, 512)

    def loss_j(p):
        out, _, aux = js.simulate(p, rays, KEY, track_opl=True)
        return jwf.wavefront_rms(out, aux['opl'])
    g_j = jax.grad(loss_j)(js.init_params())['lens']['c1']
    p = ts.init_params('cpu')
    p['lens']['c1'].requires_grad_(True)
    sim = ts.simulate_fused if fused else ts.simulate
    out, _, aux = sim(p, interop.rays_from_numpy(_np(rays), 'cpu'),
                      track_opl=True)
    twf.wavefront_rms(out, aux['opl']).backward()
    g = float(p['lens']['c1'].grad)
    assert np.isfinite(g) and g != 0.0
    _close(g, float(g_j), rtol=2e-2)


def _ex06_pupil(n=96, pupil_r=6.0):
    gx, gy = np.meshgrid(np.linspace(-pupil_r, pupil_r, n),
                         np.linspace(-pupil_r, pupil_r, n))
    keep = gx ** 2 + gy ** 2 <= pupil_r ** 2
    px, py = gx[keep], gy[keep]
    pos = np.stack([px, py, np.full_like(px, -10.0)], axis=1)
    d = np.tile([0.0, 0.0, 1.0], (len(px), 1))
    return px, py, pos, d


def test_example_06_zernike_spectrum():
    """Part (a) of examples/06_analysis.py: the singlet traced over its
    96 x 96 pupil grid, the OPD about best focus fitted with 15 Zernike
    terms, in both packages: the spectrum agrees, led by defocus and
    spherical."""
    px, py, pos, d = _ex06_pupil()
    wl = np.full(len(px), 0.5876)

    def make(rt):
        return rt.SequentialScene([rt.SingletLens(
            c1=0.02, c2=-0.02, d=16.0, t=4.0, ior_glass=1.5168,
            name='lens')])
    js, ts = make(jrt), make(trt)
    rays_j = jrt.Rays.create(pos, d, wavelength=wl)
    out_j, _, aux_j = js.simulate(js.init_params(), rays_j, KEY,
                                  track_opl=True)
    alive_j = np.asarray(out_j.intensity) > 0
    focus_j = jwf.best_focus(out_j)
    tot_j = np.asarray(jwf.opl_to_point(out_j, aux_j['opl'], focus_j))
    opd_j = tot_j - tot_j[alive_j].mean()
    c_j = np.asarray(jwf.zernike_fit(
        jnp.asarray(np.stack([px, py], 1), jnp.float32),
        jnp.asarray(opd_j), 6.0, weights=jnp.asarray(alive_j, jnp.float32)))

    rays_t = trt.Rays.create(pos, d, wavelength=wl)
    out_t, _, aux_t = ts.simulate(ts.init_params('cpu'), rays_t,
                                  track_opl=True)
    alive_t = out_t.intensity > 0
    focus_t = twf.best_focus(out_t)
    tot_t = twf.opl_to_point(out_t, aux_t['opl'], focus_t)
    opd_t = tot_t - tot_t[alive_t].mean()
    c_t = twf.zernike_fit(torch.tensor(np.stack([px, py], 1),
                                       dtype=torch.float32), opd_t, 6.0,
                          weights=alive_t.float()).numpy()
    scale = float(np.abs(c_j).max())
    _close(c_t, c_j, atol=max(1e-3 * scale, 5e-6))
    lead = set(np.argsort(-np.abs(c_t))[:2])
    assert lead == {3, 10}                  # defocus, spherical
    assert abs(c_t[10]) / 0.5876e-3 > 0.02  # printed by the example


def test_zernike_basis_and_fit_match_jax():
    """The basis at random pupil points and a weighted fit of a known
    combination plus noise."""
    rng = np.random.default_rng(3)
    xy = rng.uniform(-1.0, 1.0, (2000, 2)).astype(np.float32)
    xy = xy[(xy ** 2).sum(1) <= 1.0]
    Z_j = np.asarray(jwf.zernike_basis(jnp.asarray(xy[:, 0]),
                                       jnp.asarray(xy[:, 1]), 1.0, 22))
    Z_t = twf.zernike_basis(torch.from_numpy(xy[:, 0]),
                            torch.from_numpy(xy[:, 1]), 1.0, 22).numpy()
    _close(Z_t, Z_j, rtol=1e-5, atol=5e-6)
    coef = rng.standard_normal(15).astype(np.float32)
    opd = Z_j[:, :15] @ coef + 1e-3 * rng.standard_normal(len(xy)).astype(
        np.float32)
    w = rng.uniform(0.5, 1.0, len(xy)).astype(np.float32)
    c_j = np.asarray(jwf.zernike_fit(jnp.asarray(xy), jnp.asarray(opd), 1.0,
                                     weights=jnp.asarray(w)))
    c_t = twf.zernike_fit(torch.from_numpy(xy), torch.from_numpy(opd), 1.0,
                          weights=torch.from_numpy(w)).numpy()
    _close(c_t, c_j, atol=1e-3 * float(np.abs(c_j).max()))
    _close(c_t, coef, atol=5e-3)


def test_interferogram_matches_jax():
    rng = np.random.default_rng(4)
    opd = (rng.standard_normal((32, 32)) * 1e-3).astype(np.float32)
    amp = rng.uniform(0.5, 1.0, (32, 32)).astype(np.float32)
    for tilt, axis in ((0.0, 'x'), (3.0, 'x'), (2.5, 'y')):
        ref = jwf.interferogram(jnp.asarray(opd), jnp.asarray(amp), 5.876e-4,
                                tilt_fringes=tilt, axis=axis)
        got = twf.interferogram(torch.from_numpy(opd), torch.from_numpy(amp),
                                5.876e-4, tilt_fringes=tilt, axis=axis)
        _close(got.numpy(), ref, atol=1e-5)


def test_footprints_match_jax():
    """``footprints`` on the Sellmeier Cooke triplet (chip_smoke.
    cooke_scene and its six bundles): every row's label, hit count, r_max,
    semi-diameter and fill, and the clearance table's text."""
    js, ts = chip_smoke.cooke_scene(jrt), chip_smoke.cooke_scene(trt)
    rays = js.sample_rays(jax.random.PRNGKey(2),
                          chip_smoke.cooke_bundles(jrt, 1200))
    rep_j = jfp.footprints(js, js.init_params(), rays, KEY)
    rep_t = trt.footprints(ts, ts.init_params('cpu'),
                           interop.rays_from_numpy(_np(rays), 'cpu'))
    assert len(rep_t) == len(rep_j) == 11
    for a, b in zip(rep_t, rep_j):
        assert a['label'] == b['label'] and a['n'] == b['n'] > 0
        assert a['semi_dia'] == b['semi_dia']
        _close(a['r_max'], b['r_max'], rtol=1e-5)
        _close(a['x'].numpy(), b['x'], atol=2e-5 * 20)
        if b['fill'] is not None:
            _close(a['fill'], b['fill'], rtol=1e-5)
    assert trt.footprint_report(rep_t) == jfp.footprint_report(rep_j)
    with pytest.raises(ValueError, match='SequentialScene'):
        trt.footprints(chip_smoke.cooke_scene(trt, 4),
                       ts.init_params('cpu'),
                       interop.rays_from_numpy(_np(rays), 'cpu'))


def test_bench_wavefront_anchor_functions():
    """tests/wavefront_anchors.py's functions at a small size: the bench
    singlet's refocused RMS wavefront error, its defocus and spherical
    Zernike terms on the same threefry rays in both packages, and the
    footprint r_max of the Cooke triplet's faces, stop and sensor, on each
    package's own draws of 1,200 rays: the largest radius of 200 rays a
    bundle varies with the draw by about a percent (6.15 against 6.08 on
    the front face), so rtol 3e-2.  chip_smoke.py holds the 1M-ray values
    to the spread over four keys."""
    import wavefront_anchors as wa
    ref = wa.bench_wavefront(jrt, 4096)
    got = wa.bench_wavefront(trt, 4096)
    _close(got['rms'], ref['rms'], rtol=2e-3, atol=5e-6)
    _close(got['zernike'], ref['zernike'], atol=2e-3 * max(
        abs(v) for v in ref['zernike']))
    assert got['n_final'] == ref['n_final'] == [1.0]
    _close(wa.cooke_r_max(trt, 1200), wa.cooke_r_max(jrt, 1200), rtol=3e-2)
