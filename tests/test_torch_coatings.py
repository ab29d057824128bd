"""The thin-film functions of the PyTorch port (utils/coatings.py) against
the JAX package's, on the CPU: ``coating_rt`` in s and p on a bare
interface, a quarter-wave coat, a V-coat and an 8-layer stack, dielectric
and absorbing, from either side and up to grazing and total internal
reflection; ``metal_reflectance`` bare, enhanced, protected and under an
absorbing layer; ``metal_nk_at`` at its knots, midpoints and clamps;
``parse_coating_entries``; the unpolarized means; and their gradients in
the thicknesses, the cosine of incidence, the media and the wavelength
against ``jax.grad``, at exactly normal incidence too.

The same numpy inputs go to both packages.  Dielectric stacks are held
to the JAX package in float32: values rtol 1e-5 (atol 1e-7), gradients
rtol 1e-4 of the largest component (float32 adjoints in another order).
Metal substrates and absorbing stacks go through the complex square root,
whose smaller half the JAX package takes with a float32 cancellation that
the port avoids (utils/coatings.py::_c_sqrt; ROADMAP Queue 3): they are
held to the JAX package in float64 (``jax.enable_x64``), values atol 2e-6
on metals and 2e-5 on absorbing stacks (tests/test_coatings.py's atol
against its complex oracle), gradients rtol 1e-4 of the largest
component; at exactly normal incidence, where the two square roots agree,
to the JAX package in float32.  ``test_jax_float32_noise_is_avoided``
shows the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from raytracetorch_tpu.utils import coatings as jc
from raytracetorch_tpu_torch.utils import coatings as tc

torch.set_num_threads(2)

NS, NC, NH = 1.5168, 1.38, 2.35
WL = 0.5876
QW = WL / (4 * NC)
STACKS = {
    'bare': ([], [], None),
    'quarter_wave': ([NC], [QW], None),
    'v_coat': ([NC, NH], [0.1065, 0.0157], None),
    'eight_layer': ([NH, NC] * 4, [WL / (4 * NH), WL / (4 * NC)] * 4, None),
    'thin_silver': ([0.144], [0.04], [3.6]),
    'absorbing_3': ([NC, 0.144, NH], [0.1, 0.02, 0.06], [0.0, 3.6, 0.0]),
}
COS = np.array([1.0, 0.99999, 0.9, 0.6, 0.3, 0.05], np.float32)
LAMS = (0.45, WL, 0.7)
SIDES = {'air': (1.0, NS), 'glass': (NS, 1.0)}


def _close(a, b, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _absorbing(ks):
    return ks is not None and any(k != 0 for k in ks)


def _jax64(fn, *arrays):
    """``fn(*arrays)`` in the JAX package in float64 -> numpy."""
    with enable_x64():
        out = fn(*[jnp.asarray(np.asarray(a, np.float64)) for a in arrays])
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('side', sorted(SIDES))
@pytest.mark.parametrize('stack', sorted(STACKS))
def test_coating_rt_matches_jax(stack, side, pol):
    """R and T of each stack, from the air and the glass side, at six
    angles (normal incidence to beyond the glass's critical angle) and
    three wavelengths."""
    ns, ds, ks = STACKS[stack]
    n_in, n_out = SIDES[side]
    absorbing = _absorbing(ks)
    atol = 2e-5 if absorbing else 1e-7
    for lam in LAMS:
        if absorbing:
            rj, tj = _jax64(lambda c, lm: jc.coating_rt(
                ns, ds, n_in, n_out, c, lm, pol=pol, k_stack=ks), COS, lam)
        else:
            rj, tj = jc.coating_rt(ns, ds, n_in, n_out, jnp.asarray(COS),
                                   jnp.float32(lam), pol=pol, k_stack=ks)
        rt_, tt = tc.coating_rt(ns, ds, n_in, n_out, torch.from_numpy(COS),
                                torch.tensor(lam), pol=pol, k_stack=ks)
        _close(rt_.numpy(), rj, atol=atol)
        _close(tt.numpy(), tj, atol=atol)
        assert np.all(np.isfinite(rt_.numpy())) and np.all(rt_.numpy() >= 0)


METAL_STACKS = {
    'bare': ([], [], None),
    'enhanced': ([NH, NC], [WL / (4 * NH), WL / (4 * NC)], None),
    'protected': ([NC], [WL / (2 * NC)], None),
    'absorbing_overlayer': ([NC, 0.144], [0.1, 0.01], [0.0, 3.6]),
}


@pytest.mark.parametrize('pol', ['s', 'p'])
@pytest.mark.parametrize('metal', ['AL', 'AG', 'AU', 'CU'])
@pytest.mark.parametrize('stack', sorted(METAL_STACKS))
def test_metal_reflectance_matches_jax(stack, metal, pol):
    """A metal's reflectance under each stack, in air and in glass (a
    Mangin's back face), at six angles and three wavelengths."""
    ns, ds, ks = METAL_STACKS[stack]
    n_m, k_m = tc.METALS[metal]
    atol = 2e-5 if _absorbing(ks) else 2e-6
    for n_amb in (1.0, NS):
        for lam in LAMS:
            rj = _jax64(lambda c, lm: jc.metal_reflectance(
                ns, ds, n_amb, n_m, k_m, c, lm, pol=pol, k_stack=ks),
                COS, lam)
            rt_ = tc.metal_reflectance(ns, ds, n_amb, n_m, k_m,
                                       torch.from_numpy(COS),
                                       torch.tensor(lam), pol=pol,
                                       k_stack=ks)
            _close(rt_.numpy(), rj, atol=atol)


def test_metal_tables_match_jax():
    assert tc.METALS == jc.METALS
    assert tc.METAL_NK == jc.METAL_NK
    assert tc.METAL_GRID_UM == jc.METAL_GRID_UM


@pytest.mark.parametrize('metal', ['AL', 'AG', 'AU', 'CU'])
def test_metal_nk_at_knots_midpoints_clamps(metal):
    """(n, k) and their wavelength derivatives at the six knots, the five
    midpoints and outside the grid (clamped: no derivative), against
    ``jax.grad``; the knots return the table's values."""
    n_tab, k_tab = tc.METAL_NK[metal]
    g = tc.METAL_GRID_UM
    mids = [0.5 * (a + b) for a, b in zip(g[:-1], g[1:])]
    lams = np.array(list(g) + mids + [0.3, 0.39, 1.01, 1.3], np.float32)
    nj, kj = jc.metal_nk_at(n_tab, k_tab, jnp.asarray(lams))
    lam_t = torch.from_numpy(lams).requires_grad_(True)
    nt, kt = tc.metal_nk_at(n_tab, k_tab, lam_t)
    _close(nt.detach().numpy(), nj)
    _close(kt.detach().numpy(), kj)
    _close(nt.detach().numpy()[:6], np.float32(n_tab))
    for which, ref in ((0, nj), (1, kj)):
        gj = jax.grad(lambda lam: jnp.sum(
            jc.metal_nk_at(n_tab, k_tab, lam)[which]))(jnp.asarray(lams))
        gt, = torch.autograd.grad((nt, kt)[which].sum(), lam_t,
                                  retain_graph=True)
        _close(gt.numpy(), gj, rtol=1e-5, atol=1e-5)
    assert float(gt[-4:].abs().max()) == 0.0


def test_parse_coating_entries_matches_jax():
    entries = [(1.38, 0.1), (2.1, 0.05, 0.02), ('Ag', 0.03), ('au', 0.01),
               (np.float32(1.46), 0.2)]
    assert tc.parse_coating_entries(entries) == \
        jc.parse_coating_entries(entries)
    with pytest.raises(ValueError):
        tc.parse_coating_entries([(1.38,)])
    with pytest.raises(KeyError):
        tc.parse_coating_entries([('Pt', 0.1)])


@pytest.mark.parametrize('stack', sorted(STACKS))
def test_unpolarized_reflectance_matches_jax(stack):
    ns, ds, ks = STACKS[stack]
    if _absorbing(ks):
        atol = 2e-5
        rj = _jax64(lambda c, lm: jc.unpolarized_reflectance(
            ns, ds, 1.0, NS, c, lm, k_stack=ks), COS, WL)
    else:
        atol = 1e-7
        rj = jc.unpolarized_reflectance(ns, ds, 1.0, NS, jnp.asarray(COS),
                                        jnp.float32(WL), k_stack=ks)
    rt_ = tc.unpolarized_reflectance(ns, ds, 1.0, NS, torch.from_numpy(COS),
                                     torch.tensor(WL), k_stack=ks)
    _close(rt_.numpy(), rj, atol=atol)


def _grads(fj, ft, args, x64=False):
    """``jax.grad`` of fj (in float64 with ``x64``) and
    ``torch.autograd.grad`` of ft at the float32 scalars ``args`` (a list
    of floats) -> (jax grads, torch grads)."""
    if x64:
        with enable_x64():
            gj = jax.grad(lambda *a: fj(*a), argnums=tuple(
                range(len(args))))(*[jnp.float64(a) for a in args])
            gj = [float(g) for g in gj]
    else:
        gj = jax.grad(lambda *a: fj(*a), argnums=tuple(range(len(args))))(
            *[jnp.float32(a) for a in args])
    at = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
          for a in args]
    gt = torch.autograd.grad(ft(*at), at, allow_unused=True)
    return ([float(g) for g in gj],
            [0.0 if g is None else float(g) for g in gt])


def _assert_grads(gj, gt, which=None):
    which = range(len(gj)) if which is None else which
    scale = max(abs(gj[i]) for i in which)
    assert scale > 0
    for i in which:
        np.testing.assert_allclose(gt[i], gj[i], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=f'arg {i}')


@pytest.mark.parametrize('cos_i', [1.0, 0.8, 0.05],
                         ids=['normal', 'oblique', 'grazing'])
@pytest.mark.parametrize('stack', [s for s in sorted(STACKS) if s != 'bare'])
def test_coating_gradients_match_jax(stack, cos_i):
    """The gradient of 0.7 R - 0.3 T (both polarizations) in each layer's
    thickness, the cosine, both indices and the wavelength, against
    ``jax.grad`` (an absorbing stack's in float64, module note); at exactly
    normal incidence the clamp of 1 - cos_i^2 sits on its bound, where both
    packages split the derivative."""
    ns, _, ks = STACKS[stack]
    ds = list(STACKS[stack][1])
    n = len(ns)

    def make(lib, math):
        def f(*a):
            d, ci, n_in, n_out, lam = list(a[:n]), a[n], a[n + 1], \
                a[n + 2], a[n + 3]
            rs, ts = lib.coating_rt(ns, d, n_in, n_out, ci, lam, 's',
                                    k_stack=ks)
            rp, tp = lib.coating_rt(ns, d, n_in, n_out, ci, lam, 'p',
                                    k_stack=ks)
            return 0.7 * (rs + rp) - 0.3 * (ts + tp)
        return f
    args = ds + [cos_i, 1.0, NS, WL]
    gj, gt = _grads(make(jc, jnp), make(tc, torch), args,
                    x64=_absorbing(ks))
    assert np.all(np.isfinite(gt))
    _assert_grads(gj, gt)


@pytest.mark.parametrize('cos_i', [1.0, 0.7], ids=['normal', 'oblique'])
@pytest.mark.parametrize('stack', sorted(METAL_STACKS))
def test_metal_gradients_match_jax(stack, cos_i):
    """The unpolarized metal reflectance's gradient in the thicknesses,
    the cosine, the ambient index, the metal's n and k and the wavelength
    against ``jax.grad`` in float64 (module note); at exactly normal
    incidence, where the substrate's complex cosine sits on ``_c_sqrt``'s
    floor, finite and equal to the JAX package's float32 gradient."""
    ns, ds, ks = METAL_STACKS[stack]
    n = len(ns)
    n_m, k_m = tc.METALS['AL']

    def make(lib):
        def f(*a):
            return lib.unpolarized_metal_reflectance(
                ns, list(a[:n]), a[n + 1], a[n + 2], a[n + 3], a[n],
                a[n + 4], k_stack=ks)
        return f
    args = list(ds) + [cos_i, 1.0, n_m, k_m, WL]
    # an absorbing overlayer's own cosine is complex at every incidence
    x64 = cos_i != 1.0 or _absorbing(ks)
    gj, gt = _grads(make(jc), make(tc), args, x64=x64)
    assert np.all(np.isfinite(gt))
    # a bare metal does not read the wavelength
    _assert_grads(gj, gt, list(range(n + 4)) if n == 0 else None)


def test_gradients_finite_through_tir_clamp():
    """tests/test_coatings.py's TIR case: steep incidence beyond the
    layer's critical angle keeps R in [0, 1] and the gradient finite and
    equal to JAX's."""
    gj, gt = _grads(
        lambda d: jc.unpolarized_reflectance([NC], [d], 1.0, NS,
                                             jnp.float32(0.05),
                                             jnp.float32(WL)),
        lambda d: tc.unpolarized_reflectance([NC], [d], 1.0, NS,
                                             torch.tensor(0.05),
                                             torch.tensor(WL)), [0.1])
    assert np.isfinite(gt[0])
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-4)


def test_thin_silver_beamsplitter():
    """tests/test_coatings.py's 40 nm silver film: R ~ 0.89, T ~ 0.07,
    R + T < 0.99, as in the JAX package."""
    n_ag, k_ag = tc.METALS['AG']
    r, t = tc.coating_rt([n_ag], [0.04], 1.0, NS, torch.tensor(1.0),
                         torch.tensor(WL), k_stack=[k_ag])
    r, t = float(r), float(t)
    assert 0.8 < r < 0.95 and 0.03 < t < 0.15 and r + t < 0.99


def test_jax_float32_noise_is_avoided():
    """Near normal incidence on bare aluminium the JAX package's float32
    dR/dcos_i is rounding noise (9109 where float64 gives 0.0022: its
    complex square root cancels); the port's float32 value and gradient
    stay within 1e-6 and 1e-4 of the float64 ones."""
    n_m, k_m = tc.METALS['AL']

    def r_of(lib, ci, lam):
        return lib.unpolarized_metal_reflectance([], [], 1.0, n_m, k_m, ci,
                                                 lam)
    with enable_x64():
        g64 = float(jax.grad(lambda c: r_of(jc, c, jnp.float64(WL)))(
            jnp.float64(0.97)))
        r64 = float(r_of(jc, jnp.float64(0.97), jnp.float64(WL)))
    g32 = float(jax.grad(lambda c: r_of(jc, c, jnp.float32(WL)))(
        jnp.float32(0.97)))
    assert abs(g32 - g64) > 100 * abs(g64)
    ci = torch.tensor(0.97, requires_grad=True)
    r = r_of(tc, ci, torch.tensor(WL))
    g, = torch.autograd.grad(r, ci)
    np.testing.assert_allclose(float(r.detach()), r64, atol=1e-6)
    np.testing.assert_allclose(float(g), g64, atol=1e-4)
