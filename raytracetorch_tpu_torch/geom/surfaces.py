"""Quadric surface coefficients and the branchless intersection solver.

Counterpart of ``raytracetorch_tpu/geom/surfaces.py`` (quadric families
only; the asphere and freeform refinements are ROADMAP Queue 1 item 12).
Every family is a diagonal implicit quadric

    F(p) = qx*x^2 + qy*y^2 + qz*z^2 + lz*z + q0 = 0

with the encodings PLANE (0, 0, 0, -2, 0) n_sign -1, CYLINDER(R)
(1, 1, 0, 0, -R^2) n_sign +1, QUADRIC(c, k) (c, c, c(1+k), -2, 0) n_sign -1.

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
