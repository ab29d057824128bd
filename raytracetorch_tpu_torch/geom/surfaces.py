"""Quadric surface coefficients and the branchless intersection solver.

Counterpart of ``raytracetorch_tpu/geom/surfaces.py`` (the quadric
families, the even asphere and the XY-polynomial freeform).  Every family is
a diagonal implicit quadric

    F(p) = qx*x^2 + qy*y^2 + qz*z^2 + lz*z + q0 = 0

with the encodings PLANE (0, 0, 0, -2, 0) n_sign -1, CYLINDER(R)
(1, 1, 0, 0, -R^2) n_sign +1, QUADRIC(c, k) (c, c, c(1+k), -2, 0) n_sign -1,
QUADRIC_ZY(c, k) (0, c, c(1+k), -2, 0) n_sign -1 (curvature in y only: a
cylindrical lens face).  An even asphere starts from its base conic's roots
and refines each onto the sag ``asph_sag`` (``asph_refine``); a freeform
surface, conic + even asphere + sum_m c_m x^i y^j, onto its sag by 8 Newton
steps (``ff_refine``), its normal from the sag's gradient (``ff_normal``).

Misses carry finite ``(t, valid)`` sentinels, never inf, and every sqrt is
double-where'd with ``+1e-24`` inside, so forward and backward stay NaN-free.
"""

from __future__ import annotations

import torch

from ..constants import BIG, INTERSECT_EPS, NORMAL_EPS, SOLVER_EPS


def q_plane(dtype=torch.float32, device=None):
    return torch.tensor([0.0, 0.0, 0.0, -2.0, 0.0], dtype=dtype,
                        device=device), -1.0


def q_cylinder(radius):
    r2 = radius * radius
    one = torch.ones_like(r2)
    zero = torch.zeros_like(r2)
    return torch.stack([one, one, zero, zero, -r2]), 1.0


def q_quadric(c, k):
    k = torch.as_tensor(k, dtype=c.dtype, device=c.device)
    return torch.stack([c, c, c * (1.0 + k), torch.full_like(c, -2.0),
                        torch.zeros_like(c)]), -1.0


def q_quadric_zy(c, k):
    k = torch.as_tensor(k, dtype=c.dtype, device=c.device)
    return torch.stack([torch.zeros_like(c), c, c * (1.0 + k),
                        torch.full_like(c, -2.0), torch.zeros_like(c)]), -1.0


def ray_coeffs(q, o, d):
    """A t^2 + B t + C = 0 of F(o + t d) = 0; ``o``/``d`` component tuples."""
    qx, qy, qz, lz, q0 = (q[..., i] for i in range(5))
    ox, oy, oz = o
    dx, dy, dz = d
    A = qx * dx * dx + qy * dy * dy + qz * dz * dz
    B = 2.0 * (qx * ox * dx + qy * oy * dy + qz * oz * dz) + lz * dz
    C = qx * ox * ox + qy * oy * oy + qz * oz * oz + lz * oz + q0
    return A, B, C


def solve_roots(q, o, d):
    """Both candidate ray parameters as ((t1, v1), (t2, v2)); invalid roots
    carry ``valid=False`` and a finite ``t``."""
    A, B, C = ray_coeffs(q, o, d)
    disc = B * B - 4.0 * A * C
    hit = disc >= 0.0
    sqrt_delta = torch.sqrt(torch.where(hit, disc, 1.0) + 1e-24)

    linear = torch.abs(A) < SOLVER_EPS
    A_safe = torch.where(linear, 1.0, A)
    B_safe = torch.where(torch.abs(B) < SOLVER_EPS, SOLVER_EPS, B)

    t1 = (-B - sqrt_delta) / (2.0 * A_safe)
    t2 = (-B + sqrt_delta) / (2.0 * A_safe)
    t_lin = -C / B_safe

    t1 = torch.where(linear, t_lin, t1)
    t2 = torch.where(linear, t_lin, t2)
    # A ~ 0 and B ~ 0: no real solution, a clean miss
    lin_ok = linear & (torch.abs(B) >= SOLVER_EPS)
    v1 = lin_ok | (~linear & hit)
    return (t1, v1), (t2, v1)


REL_EPS = 1e-5   # float32 self-intersection headroom per unit world scale


def min_positive(roots, scale=None):
    """Smallest root with t > eps among ``roots`` [(t, valid), ...]; returns
    ``(t, valid)`` with t sanitized to 0 where none survives.

    ``scale`` (magnitude of the ray origin, world and surface frame) grows
    the threshold to ``INTERSECT_EPS + REL_EPS*scale``: a float32 hit point
    recomputed at coordinates ~|o| lies O(ulp*|o|) off the surface, and a
    purely absolute epsilon would let the next surface step re-hit it."""
    eps = INTERSECT_EPS if scale is None else INTERSECT_EPS + REL_EPS * scale
    t_best = None
    for t, v in roots:
        keep = v & (t > eps)
        t_masked = torch.where(keep, t, BIG)
        t_best = (t_masked if t_best is None
                  else torch.minimum(t_best, t_masked))
    valid = t_best < BIG * 0.5
    return torch.where(valid, t_best, 0.0), valid


def surface_normal(q, n_sign, p_local):
    """Unit normal (component tuple) from the implicit gradient with the
    family's orientation sign; a degenerate gradient defaults to +z."""
    qx, qy, qz, lz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    gx = 2.0 * qx * p_local[0]
    gy = 2.0 * qy * p_local[1]
    gz = 2.0 * qz * p_local[2] + lz
    g2 = gx * gx + gy * gy + gz * gz
    degen = g2 < NORMAL_EPS * NORMAL_EPS
    sign = torch.where(torch.as_tensor(n_sign) < 0, -1.0, 1.0)
    inv = sign / (torch.sqrt(torch.where(degen, 1.0, g2)) + NORMAL_EPS)
    nx = torch.where(degen, 0.0, gx * inv)
    ny = torch.where(degen, 0.0, gy * inv)
    nz = torch.where(degen, torch.ones_like(gz), gz * inv)
    return nx, ny, nz


def sag_z(c, r):
    """Sag of a curvature-c surface at radius r (the relu clamp keeps the
    sqrt differentiable past the hemisphere rim)."""
    r2 = r * r
    term = torch.clamp(1.0 - c * c * r2, min=0.0)
    return (c * r2) / (1.0 + torch.sqrt(term + 1e-24))


def asph_sag(c, kc2, coeffs, r2):
    """Even-asphere sag at r^2: the conic term plus a4 r^4 .. a10 r^10,
    with ``kc2 = (1 + k) c^2``."""
    term = torch.clamp(1.0 - kc2 * r2, min=0.0)
    z = c * r2 / (1.0 + torch.sqrt(term + 1e-24))
    rp = r2 * r2
    for a in coeffs:
        z = z + a * rp
        rp = rp * r2
    return z


def _asph_g(c, kc2, coeffs, o, d, t):
    """G(t) = z(t) - sag(r(t)^2) along the ray and its first two
    derivatives in t (the closed forms of the JAX package's asph_refine)."""
    x = o[0] + t * d[0]
    y = o[1] + t * d[1]
    z = o[2] + t * d[2]
    r2 = x * x + y * y
    g = z - asph_sag(c, kc2, coeffs, r2)
    term = torch.clamp(1.0 - kc2 * r2, min=0.0)
    sq = torch.sqrt(term + 1e-24)
    inv = 1.0 / (2.0 * sq * (1.0 + sq) ** 2)
    dsag = c / (1.0 + sq) + c * r2 * kc2 * inv
    rp, i = r2, 2.0
    for a in coeffs:
        dsag = dsag + i * a * rp
        rp = rp * r2
        i = i + 1.0
    dsq = -kc2 * (0.5 / sq)
    dinv = -(1.0 / sq + 2.0 / (1.0 + sq)) * inv * dsq
    d2sag = 2.0 * c * kc2 * inv + c * r2 * kc2 * dinv
    rp, i = torch.ones_like(r2), 2.0
    for a in coeffs:
        d2sag = d2sag + i * (i - 1.0) * a * rp
        rp = rp * r2
        i = i + 1.0
    dr2 = 2.0 * (x * d[0] + y * d[1])
    d2r2 = 2.0 * (d[0] * d[0] + d[1] * d[1])
    dg = d[2] - dsag * dr2
    d2g = -(d2sag * dr2 * dr2 + dsag * d2r2)
    return g, dg, d2g


def asph_refine(c, kc2, coeffs, o, d, t0, valid, n_iter=4):
    """Refine a base-conic root ``t0`` onto the even asphere: ``n_iter``
    Halley steps ``t -= 2 G G' / (2 G'^2 - G G'')`` (the denominator held
    off zero at 1e-12), differentiable through every step.  Returns ``(t,
    valid)``: a root stays valid where |G| < 1e-4 after the steps and
    t > INTERSECT_EPS."""
    t = t0
    for _ in range(n_iter):
        g, dg, d2g = _asph_g(c, kc2, coeffs, o, d, t)
        denom = 2.0 * dg * dg - g * d2g
        denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        t = t - 2.0 * g * dg / denom
    g, _, _ = _asph_g(c, kc2, coeffs, o, d, t)
    return t, valid & (torch.abs(g) < 1e-4) & (t > INTERSECT_EPS)


def asph_normal(c, kc2, coeffs, p_local):
    """Unit normal of the even asphere at a surface-frame point: the
    normalized gradient (-2 S' x, -2 S' y, 1) of z - S(r^2), +z at the
    vertex (no orientation sign)."""
    x, y, z = p_local
    r2 = x * x + y * y
    term = torch.clamp(1.0 - kc2 * r2, min=0.0)
    sq = torch.sqrt(term + 1e-24)
    dsag = c / (1.0 + sq) + c * r2 * kc2 / (2.0 * sq * (1.0 + sq) ** 2)
    rp, i = r2, 2.0
    for a in coeffs:
        dsag = dsag + i * a * rp
        rp = rp * r2
        i = i + 1.0
    gx = -2.0 * dsag * x
    gy = -2.0 * dsag * y
    gz = torch.ones_like(z)
    inv = 1.0 / torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-24)
    return gx * inv, gy * inv, gz * inv


# ---------------------------------------------------------------------------
# Freeform (XY-polynomial) surfaces
# ---------------------------------------------------------------------------

FF_STEPS = 8          # Newton steps of ff_refine


def _ipow(v, n):
    """v**n for a small static integer n, as the multiply chain ``out = out
    * v`` from the left (the kernels keep the same chain: csrc/freeform.cuh);
    ones for n = 0."""
    out = None
    for _ in range(int(n)):
        out = v if out is None else out * v
    return out if out is not None else torch.ones_like(v)


def ff_sag_grad(c, kc2, asph_coeffs, powers, ff_coeffs, x, y):
    """Freeform sag and its partials ``(S, dS/dx, dS/dy)``.

    S(x, y) = conic(r^2) + even asphere(r^2) + sum_m c_m x^i_m y^j_m, with
    ``powers`` the static (i, j) exponent pairs and ``ff_coeffs`` their
    coefficients, summed in ``powers`` order after the radial part (another
    order is another float32 result)."""
    r2 = x * x + y * y
    term = torch.clamp(1.0 - kc2 * r2, min=0.0)
    sq = torch.sqrt(term + 1e-24)
    den1 = 1.0 + sq
    sag = c * r2 / den1
    dsag = c / den1 + c * r2 * kc2 / (2.0 * sq * (den1 * den1))
    rp, i = r2 * r2, 2.0
    drp = r2
    for a in asph_coeffs:
        sag = sag + a * rp
        dsag = dsag + i * a * drp
        rp = rp * r2
        drp = drp * r2
        i = i + 1.0
    gx = 2.0 * x * dsag
    gy = 2.0 * y * dsag
    for (pi, pj), cm in zip(powers, ff_coeffs):
        xi = _ipow(x, pi)
        yj = _ipow(y, pj)
        sag = sag + cm * xi * yj
        if pi > 0:
            gx = gx + cm * float(pi) * _ipow(x, pi - 1) * yj
        if pj > 0:
            gy = gy + cm * float(pj) * xi * _ipow(y, pj - 1)
    return sag, gx, gy


def ff_refine(c, kc2, asph_coeffs, powers, ff_coeffs, o, d, t0, valid,
              n_iter=FF_STEPS):
    """Refine a base-conic root ``t0`` onto the freeform surface:
    ``n_iter`` Newton steps ``t -= G / G'`` with G = z - S(x, y) and G' =
    d_z - S_x d_x - S_y d_y (held off zero at 1e-12, keeping its sign),
    differentiable through every step.  Returns ``(t, valid)``: a root
    stays valid where |G| < 1e-4 after the steps and t > INTERSECT_EPS."""
    def g_dg(t):
        x = o[0] + t * d[0]
        y = o[1] + t * d[1]
        z = o[2] + t * d[2]
        sag, gx, gy = ff_sag_grad(c, kc2, asph_coeffs, powers, ff_coeffs,
                                  x, y)
        return z - sag, d[2] - gx * d[0] - gy * d[1]

    t = t0
    for _ in range(n_iter):
        g, dg = g_dg(t)
        dg = torch.where(torch.abs(dg) < 1e-12,
                         torch.where(dg < 0, -1e-12, 1e-12), dg)
        t = t - g / dg
    g, _ = g_dg(t)
    return t, valid & (torch.abs(g) < 1e-4) & (t > INTERSECT_EPS)


def ff_normal(c, kc2, asph_coeffs, powers, ff_coeffs, p_local):
    """Unit normal of the freeform surface at a surface-frame point, +z at
    the vertex: (-S_x, -S_y, 1) / |.|."""
    x, y, _ = p_local
    _, gx, gy = ff_sag_grad(c, kc2, asph_coeffs, powers, ff_coeffs, x, y)
    inv = 1.0 / torch.sqrt(gx * gx + gy * gy + 1.0 + 1e-24)
    return -gx * inv, -gy * inv, torch.ones_like(x) * inv
