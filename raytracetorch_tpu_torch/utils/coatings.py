"""Differentiable thin-film multilayer coatings and metal reflectance
(characteristic-matrix method).

Counterpart of ``raytracetorch_tpu/utils/coatings.py``: the intensity
reflectances and transmittances the trace reads (``coating_rt``,
``metal_reflectance``, their unpolarized means), the complex amplitudes the
polarized field takes through a coated interface or a metal mirror
(``coating_amplitudes``, ``metal_reflection_amplitudes``; core/field.py),
the entry parser and the metal tables.

Physics: the 2x2 characteristic matrix of each layer
``M_l = [[cos delta, i sin delta / eta], [i eta sin delta, cos delta]]``
with phase thickness ``delta = 2 pi n d cos(theta) / lambda`` and tilted
admittance ``eta_s = n cos(theta)``, ``eta_p = n / cos(theta)`` (Macleod,
"Thin-Film Optical Filters", ch. 2); the stack vector ``(B, C) = prod(M_l)
(1, eta_sub)`` gives the amplitude r = (eta0 B - C) / (eta0 B + C).

Complex numbers are carried as explicit (re, im) pairs, as in the JAX
package: the fused kernels (csrc/thin_film.cuh) have no complex type, so
the plain versions and the kernels do the same arithmetic.  The complex
square root avoids one float32 cancellation of the JAX package's
(``_c_sqrt``).  Every clamp of the JAX version is kept (``1e-12`` under each layer's cosine, ``1e-30`` and
``1e-24`` in ``_c_sqrt``, ``1e-24`` on every complex division and on the
reflectance's denominator, ``1e-6`` under the p admittance and the
substrate index), and each is a ``torch.maximum``, whose derivative splits
at a tie as ``jnp.maximum``'s does: at exactly normal incidence ``1 -
cos_i^2`` sits on its bound 0, and the gradient there equals the JAX
package's.

Units: wavelength and thicknesses in the same unit (um, as the trace's
wavelengths).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
D_LINE_UM = 0.5876


def _max(x, bound):
    """``jnp.maximum(x, bound)`` with its derivative: at a tie each side
    gets half (torch.maximum; torch.clamp would pass all of it)."""
    if not torch.is_tensor(x):
        x = torch.tensor(float(x), dtype=torch.float32)
    return torch.maximum(x, torch.full_like(x, bound))


def _cos_layers(n_in, n_layers, cos_i):
    """cos(theta) in each layer (and the exit medium) by Snell's law, real
    branch, held at sqrt(1e-12) or more so that gradients stay finite at
    total internal reflection."""
    sin_i2 = _max(1.0 - cos_i * cos_i, 0.0)
    out = []
    for nl in n_layers:
        ratio = n_in / nl
        out.append(torch.sqrt(_max(1.0 - ratio * ratio * sin_i2, 1e-12)))
    return out


# -- complex helpers on (re, im) pairs --

def _c_mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _c_div(a, b):
    den = _max(b[0] * b[0] + b[1] * b[1], 1e-24)
    return ((a[0] * b[0] + a[1] * b[1]) / den,
            (a[1] * b[0] - a[0] * b[1]) / den)


def _c_sqrt(a):
    """Principal square root of (re, im), with the JAX package's floors: |a|
    held at sqrt(1e-30), +1e-24 under each root (the derivative stays finite
    where an operand sits at 0, the imaginary part of a cosine at normal
    incidence).

    One deliberate difference: the JAX package takes the smaller of
    (|a| -+ Re a) / 2 as a difference, which cancels in float32 wherever Im
    a is below ~sqrt(eps) Re a (near-normal incidence on a metal, every
    incidence on an absorbing stack's dielectric parts): its value is then
    ~6e-6 (metal) to ~1e-4 (absorbing stack) off the float64 value in R,
    and its derivative is rounding noise (bare aluminium at cos_i = 0.97:
    dR/dcos_i = 9109 in float32, 0.0022 in float64).  Here it is Im(a)^2 /
    (2 (|a| + |Re a|)), the same number without the cancellation (ROADMAP
    Queue 3): R within 3e-7 of float64, and at Im a = 0 exactly the JAX
    package's value and derivative (normal incidence)."""
    r = torch.sqrt(_max(a[0] * a[0] + a[1] * a[1], 1e-30))
    s = r + torch.abs(a[0])
    big, small = 0.5 * s, 0.5 * (a[1] * a[1]) / s
    pos = a[0] >= 0
    re = torch.sqrt(_max(torch.where(pos, big, small), 0.0) + 1e-24)
    im_mag = torch.sqrt(_max(torch.where(pos, small, big), 0.0) + 1e-24)
    sign = torch.where(a[1] < 0, -1.0, 1.0)
    return re, sign * im_mag


def _c_trig(delta):
    """(cos, sin) of a complex phase (a, b): cos(a + ib) = cos a cosh b - i
    sin a sinh b, sin(a + ib) = sin a cosh b + i cos a sinh b, the cosh and
    sinh spelled as exp sums, as in the JAX package."""
    a, b = delta
    ca, sa = torch.cos(a), torch.sin(a)
    eb, enb = torch.exp(b), torch.exp(-b)
    chb, shb = 0.5 * (eb + enb), 0.5 * (eb - enb)
    return (ca * chb, -sa * shb), (sa * chb, ca * shb)


def _metal_eta(n_in, n_metal, k_metal, cos_i, pol):
    """Tilted admittance of an absorbing substrate n_c = n - ik: complex
    Snell cos_t = sqrt(1 - (n_in sin_i / n_c)^2), eta_s = n_c cos_t, eta_p =
    n_c / cos_t, as an (re, im) pair."""
    sin_i2 = _max(1.0 - cos_i * cos_i, 0.0)
    nc = (n_metal, -k_metal)
    ratio2 = _c_div((n_in * n_in * sin_i2, torch.zeros_like(cos_i)),
                    _c_mul(nc, nc))
    cos_t = _c_sqrt((1.0 - ratio2[0], -ratio2[1]))
    if pol == 's':
        return _c_mul(nc, cos_t)
    return _c_div(nc, cos_t)


def _layer_is_absorbing(k_stack):
    """Static: does any layer carry a nonzero extinction coefficient?"""
    return k_stack is not None and any(float(k) != 0.0 for k in k_stack)


def _stack_bc(n_stack, d_stack, n_in, n_out, cos_i, wavelength, pol,
              k_out=None, k_stack=None):
    """Characteristic-matrix accumulation -> ``(eta0, eta_sub, (B_re, B_im),
    (C_re, C_im))``.  ``k_out`` makes the substrate absorbing (n_c = n_out
    - i k_out, a metal mirror; eta_sub is then the real part of its complex
    admittance); ``k_stack`` (per-layer extinction, static) switches to the
    full complex path of ``_stack_bc_absorbing``."""
    n_all = list(n_stack)
    if _layer_is_absorbing(k_stack):
        return _stack_bc_absorbing(n_all, list(k_stack), list(d_stack),
                                   n_in, n_out, cos_i, wavelength, pol,
                                   k_out=k_out)
    cos_l = _cos_layers(n_in, n_all + [_max(n_out, 1e-6)], cos_i)
    cos_layers, cos_t = cos_l[:-1], cos_l[-1]

    def eta(n, c):
        return n * c if pol == 's' else n / _max(c, 1e-6)

    eta0 = eta(n_in, cos_i)
    if k_out is not None:
        eta_sub_c = _metal_eta(n_in, n_out, k_out, cos_i, pol)
    else:
        eta_sub_c = (eta(n_out, cos_t), torch.zeros_like(cos_t))
    eta_sub = eta_sub_c[0]

    one = torch.ones_like(cos_i + wavelength)
    b_re, b_im = one, torch.zeros_like(one)
    c_re, c_im = eta_sub_c[0] * one, eta_sub_c[1] * one
    for nl, dl, cl in zip(reversed(n_all), reversed(list(d_stack)),
                          reversed(cos_layers)):
        delta = TWO_PI * nl * dl * cl / wavelength
        cd, sd = torch.cos(delta), torch.sin(delta)
        el = eta(nl, cl)
        # [[cd, i sd / el], [i el sd, cd]] @ (B, C)
        nb_re = cd * b_re - (sd / el) * c_im
        nb_im = cd * b_im + (sd / el) * c_re
        nc_re = cd * c_re - el * sd * b_im
        nc_im = cd * c_im + el * sd * b_re
        b_re, b_im, c_re, c_im = nb_re, nb_im, nc_re, nc_im
    return eta0, eta_sub, (b_re, b_im), (c_re, c_im)


def _stack_bc_absorbing(n_all, k_all, d_all, n_in, n_out, cos_i, wavelength,
                        pol, k_out=None):
    """Full complex characteristic matrices (absorbing layers, n_l - i k_l):
    complex Snell cosines, complex phase thicknesses (``_c_trig``).  Same
    return contract as ``_stack_bc``; eta_sub is Re(eta_substrate)."""
    sin_i2 = _max(1.0 - cos_i * cos_i, 0.0)
    kin2 = n_in * n_in * sin_i2          # (n_in sin_i)^2, Snell's invariant

    def c_cos(nc):
        ratio2 = _c_div((kin2, torch.zeros_like(cos_i)), _c_mul(nc, nc))
        return _c_sqrt((1.0 - ratio2[0], -ratio2[1]))

    def c_eta(nc, cl):
        return _c_mul(nc, cl) if pol == 's' else _c_div(nc, cl)

    eta0 = n_in * cos_i if pol == 's' else n_in / _max(cos_i, 1e-6)
    nc_sub = (n_out, -(k_out if k_out is not None else 0.0 * n_out))
    cos_sub = c_cos(nc_sub)
    eta_sub_c = c_eta(nc_sub, cos_sub)

    one = torch.ones_like(cos_i + wavelength)
    b = (one, torch.zeros_like(one))
    c = (eta_sub_c[0] * one, eta_sub_c[1] * one)
    for nl, kl, dl in zip(reversed(n_all), reversed(k_all),
                          reversed(d_all)):
        nc = (nl * one, -kl * one)
        cl = c_cos(nc)
        el = c_eta(nc, cl)
        phase = TWO_PI * dl / wavelength
        delta = _c_mul(nc, cl)
        delta = (phase * delta[0], phase * delta[1])
        cd, sd = _c_trig(delta)
        i_sd = (-sd[1], sd[0])           # i sin(delta)
        nb = tuple(x + y for x, y in zip(_c_mul(cd, b),
                                         _c_mul(_c_div(i_sd, el), c)))
        ncv = tuple(x + y for x, y in zip(_c_mul(_c_mul(i_sd, el), b),
                                          _c_mul(cd, c)))
        b, c = nb, ncv
    return eta0, eta_sub_c[0], b, c


def coating_rt(n_stack, d_stack, n_in, n_out, cos_i, wavelength, pol='s',
               k_stack=None):
    """Intensity reflectance and transmittance ``(R, T)`` of a multilayer:
    ``n_stack``/``d_stack`` the layers' indices and thicknesses from the
    incidence side (empty: a bare interface), ``n_in``/``n_out`` the
    incidence and substrate indices, ``cos_i`` the cosine of incidence,
    ``pol`` 's' or 'p', ``k_stack`` optional per-layer extinction (absorbing
    films: R + T < 1)."""
    eta0, eta_sub, (b_re, b_im), (c_re, c_im) = _stack_bc(
        n_stack, d_stack, n_in, n_out, cos_i, wavelength, pol,
        k_stack=k_stack)
    num_re, num_im = eta0 * b_re - c_re, eta0 * b_im - c_im
    den_re, den_im = eta0 * b_re + c_re, eta0 * b_im + c_im
    den2 = _max(den_re * den_re + den_im * den_im, 1e-24)
    r = (num_re * num_re + num_im * num_im) / den2
    # T = 4 eta0 Re(eta_sub) / |eta0 B + C|^2
    t = 4.0 * eta0 * eta_sub / den2
    return r, t


def coating_amplitudes(n_stack, d_stack, n_in, n_out, cos_i, wavelength,
                       pol='s', k_stack=None):
    """Complex amplitudes ``(t, r)`` of a multilayer as (re, im) pairs: ``r
    = (eta0 B - C) / (eta0 B + C)`` and the flux-normalized transmission ``t
    = 2 sqrt(max(eta0 eta_sub, 0)) / (eta0 B + C)``, so that |t|^2 = T, the
    convention of core/field.py::fresnel_amplitudes.  The admittance form's
    r_p has the opposite sign to that convention's, so it is flipped: an
    empty stack gives the bare interface's Fresnel amplitudes.  With an
    absorbing stack (``k_stack``) |r|^2 + |t|^2 < 1."""
    eta0, eta_sub, (b_re, b_im), (c_re, c_im) = _stack_bc(
        n_stack, d_stack, n_in, n_out, cos_i, wavelength, pol,
        k_stack=k_stack)
    den_re, den_im = eta0 * b_re + c_re, eta0 * b_im + c_im
    den2 = _max(den_re * den_re + den_im * den_im, 1e-24)
    num_re, num_im = eta0 * b_re - c_re, eta0 * b_im - c_im
    r_re = (num_re * den_re + num_im * den_im) / den2
    r_im = (num_im * den_re - num_re * den_im) / den2
    if pol == 'p':
        r_re, r_im = -r_re, -r_im
    amp = 2.0 * torch.sqrt(_max(eta0 * eta_sub, 0.0))
    return (amp * den_re / den2, -amp * den_im / den2), (r_re, r_im)


# Fixed complex indices (n, k) near the d line (550-590 nm), handbook
# values (Rakic / Johnson-Christy), as in the JAX package.
METALS = {
    'AL': (1.015, 6.63),
    'AG': (0.144, 3.60),
    'AU': (0.277, 2.92),
    'CU': (0.606, 2.58),
}

# Tabulated (n, k) of the same metals at the six METAL_GRID_UM knots
# (Palik for Al, Johnson & Christy for the noble metals), interpolated
# piecewise-linearly by metal_nk_at; a mirror with metal_dispersion=True
# carries its metal's knots as static row metadata.
METAL_GRID_UM = (0.40, 0.50, 0.60, 0.70, 0.80, 1.00)
METAL_NK = {
    'AL': ((0.49, 0.77, 1.20, 1.83, 2.80, 1.35),
           (4.86, 6.08, 7.26, 8.31, 8.45, 9.58)),
    'AG': ((0.05, 0.05, 0.06, 0.14, 0.14, 0.21),
           (2.07, 2.87, 3.75, 4.52, 5.29, 6.76)),
    'AU': ((1.47, 0.97, 0.25, 0.16, 0.17, 0.26),
           (1.95, 1.87, 2.99, 3.80, 4.86, 6.82)),
    'CU': ((1.18, 1.12, 0.45, 0.21, 0.26, 0.33),
           (2.21, 2.60, 3.30, 4.10, 5.26, 6.70)),
}


def parse_coating_entries(entries):
    """User coating entries (incidence side first) -> static lists ``(ns,
    ks, ds)``: ``(n, d_um)`` a dielectric layer (k = 0), ``(n, k, d_um)`` an
    absorbing one, ``('Ag', d_um)`` a named metal film at its METALS index.
    The thicknesses are the trainable 'coat_d' initializer."""
    ns, ks, ds = [], [], []
    for e in entries:
        e = tuple(e)
        if len(e) == 2:
            a, dd = e
            if isinstance(a, str):
                n, k = METALS[a.upper()]
            else:
                n, k = float(a), 0.0
        elif len(e) == 3:
            n, k, dd = e
        else:
            raise ValueError(
                f"coating entry {e!r}: expected (n, d), (n, k, d) or "
                "('Ag', d)")
        ns.append(float(n))
        ks.append(float(k))
        ds.append(float(dd))
    return ns, ks, ds


def metal_nk_at(n_tab, k_tab, wavelength_um):
    """Piecewise-linear (n, k) of a metal at ``wavelength_um`` from its knot
    values on METAL_GRID_UM, clamped outside [0.40, 1.00] um (the clamp's
    derivative splits at its bounds, as ``jnp.clip``'s)."""
    g = METAL_GRID_UM
    lam = torch.minimum(_max(wavelength_um, g[0]),
                        torch.full_like(wavelength_um, g[-1]))
    n = torch.zeros_like(lam) + n_tab[0]
    k = torch.zeros_like(lam) + k_tab[0]
    for i in range(len(g) - 1):
        t = (lam - g[i]) / (g[i + 1] - g[i])
        # the last segment with lam >= g[i] wins: the one holding lam
        n = torch.where(lam >= g[i],
                        n_tab[i] + t * (n_tab[i + 1] - n_tab[i]), n)
        k = torch.where(lam >= g[i],
                        k_tab[i] + t * (k_tab[i + 1] - k_tab[i]), k)
    return n, k


def metal_reflectance(n_stack, d_stack, n_in, n_metal, k_metal, cos_i,
                      wavelength, pol='s', k_stack=None):
    """Intensity reflectance of a multilayer on an absorbing (metal)
    substrate n_c = n_metal - i k_metal; an empty stack gives the bare
    metal's."""
    eta0, _, (b_re, b_im), (c_re, c_im) = _stack_bc(
        n_stack, d_stack, n_in, n_metal, cos_i, wavelength, pol,
        k_out=k_metal, k_stack=k_stack)
    num = (eta0 * b_re - c_re, eta0 * b_im - c_im)
    den = (eta0 * b_re + c_re, eta0 * b_im + c_im)
    den2 = _max(den[0] * den[0] + den[1] * den[1], 1e-24)
    return (num[0] * num[0] + num[1] * num[1]) / den2


def metal_reflection_amplitudes(n_stack, d_stack, n_in, n_metal, k_metal,
                                cos_i, wavelength, pol='s', k_stack=None):
    """Complex reflection amplitude ``r = (eta0 B - C) / (eta0 B + C)`` of a
    (coated) metal mirror as an (re, im) pair, p flipped as in
    ``coating_amplitudes``."""
    eta0, _, (b_re, b_im), (c_re, c_im) = _stack_bc(
        n_stack, d_stack, n_in, n_metal, cos_i, wavelength, pol,
        k_out=k_metal, k_stack=k_stack)
    r = _c_div((eta0 * b_re - c_re, eta0 * b_im - c_im),
               (eta0 * b_re + c_re, eta0 * b_im + c_im))
    return (-r[0], -r[1]) if pol == 'p' else r


def unpolarized_metal_reflectance(n_stack, d_stack, n_in, n_metal, k_metal,
                                  cos_i, wavelength, k_stack=None):
    """Mean of the s and p reflectances of a (coated) metal."""
    rs = metal_reflectance(n_stack, d_stack, n_in, n_metal, k_metal, cos_i,
                           wavelength, pol='s', k_stack=k_stack)
    rp = metal_reflectance(n_stack, d_stack, n_in, n_metal, k_metal, cos_i,
                           wavelength, pol='p', k_stack=k_stack)
    return 0.5 * (rs + rp)


def unpolarized_reflectance(n_stack, d_stack, n_in, n_out, cos_i,
                            wavelength, k_stack=None):
    """Mean of the s and p reflectances (the bare interface's Fresnel R
    when the stack is empty)."""
    rs, _ = coating_rt(n_stack, d_stack, n_in, n_out, cos_i, wavelength,
                       pol='s', k_stack=k_stack)
    rp, _ = coating_rt(n_stack, d_stack, n_in, n_out, cos_i, wavelength,
                       pol='p', k_stack=k_stack)
    return 0.5 * (rs + rp)
