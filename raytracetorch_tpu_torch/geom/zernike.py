"""Zernike polynomials: Noll ordering and the exact monomial expansion.

Counterpart of ``raytracetorch_tpu/geom/zernike.py``: ``noll_nm`` (which
``utils/wavefront.py::zernike_basis`` needs), ``zernike_xy_poly`` and
``zernike_monomial_map``, the static basis change that lets a Zernike-sag
surface (``elements/lens.py::ZernikeLens``) ride the freeform path: every
Noll term Z_j(rho, theta) expands exactly into monomials x^i y^k of total
degree n, in exact rational arithmetic on the host, so the basis change
adds no rounding beyond the final float cast.  Conventions as the JAX
package's: Noll ordering, m >= 0 -> cos(m theta), m < 0 -> sin(|m| theta),
no normalization factor (a coefficient is the peak sag of its term at the
rim of the normalization radius).
"""

from __future__ import annotations

from fractions import Fraction
from math import comb, factorial


def noll_nm(j):
    """Radial/azimuthal orders (n, m) of Noll index ``j`` (j >= 1).

    Noll's rule: terms sorted by n, then |m| ascending; the sign of m is
    chosen so even j carries cos (m > 0) and odd j carries sin (m < 0).
    """
    if j < 1:
        raise ValueError(f"Noll index starts at 1, got {j}")
    jj = 0
    n = 0
    while True:
        for m_abs in range(n % 2, n + 1, 2):
            reps = 1 if m_abs == 0 else 2
            for _ in range(reps):
                jj += 1
                if jj == j:
                    if m_abs == 0:
                        return n, 0
                    return n, (m_abs if jj % 2 == 0 else -m_abs)
        n += 1


def zernike_xy_poly(n, m):
    """{(i, k): Fraction} monomial coefficients of Z_n^m on the unit disk.

    Z_n^m(u, v) = R_n^|m|(rho) {cos, sin}(|m| theta), expanded through
    rho^|m| cos(|m| theta) = Re[(u + i v)^|m|] (Im for sin) and the binomial
    theorem, in exact rational arithmetic."""
    ma = abs(m)
    if (n - ma) % 2 or ma > n:
        raise ValueError(f"invalid Zernike orders (n={n}, m={m})")
    # the angular factor: Re or Im of (u + i v)^|m|
    ang = {}
    if m >= 0:
        if ma == 0:
            ang[(0, 0)] = Fraction(1)
        else:
            for t in range(0, ma + 1, 2):
                ang[(ma - t, t)] = Fraction((-1) ** (t // 2) * comb(ma, t))
    else:
        for t in range(1, ma + 1, 2):
            ang[(ma - t, t)] = Fraction((-1) ** ((t - 1) // 2) * comb(ma, t))
    poly = {}
    for s in range((n - ma) // 2 + 1):
        c = Fraction(
            (-1) ** s * factorial(n - s),
            factorial(s) * factorial((n + ma) // 2 - s)
            * factorial((n - ma) // 2 - s))
        p = (n - 2 * s - ma) // 2          # the radial rest (u^2 + v^2)^p
        for a in range(p + 1):
            rad = Fraction(comb(p, a))
            for (ai, aj), ac in ang.items():
                key = (ai + 2 * a, aj + 2 * (p - a))
                poly[key] = poly.get(key, Fraction(0)) + c * rad * ac
    return {k: v for k, v in poly.items() if v != 0}


def zernike_monomial_map(indices, norm_radius):
    """The static basis change of a Zernike-sag surface.

    ``indices``: the Noll j's of the terms; ``norm_radius``: the radius the
    polynomials are normalized over (lens units).  Returns ``(powers, M)``:
    ``powers`` the sorted tuple of (i, k) monomial exponent pairs (the
    row's static ``ff_powers``) and ``M[r][c]`` the float weight of Zernike
    coefficient c on monomial r, scaled by norm_radius^-(i + k), so the
    monomial coefficients are ``M @ z`` for Zernike coefficients ``z``."""
    polys = [zernike_xy_poly(*noll_nm(int(j))) for j in indices]
    powers = sorted({k for p in polys for k in p})
    R = float(norm_radius)
    if R <= 0.0:
        raise ValueError(f"norm_radius must be positive, got {R}")
    M = [[float(p.get(mn, Fraction(0))) / R ** (mn[0] + mn[1])
          for p in polys] for mn in powers]
    return tuple(powers), M
