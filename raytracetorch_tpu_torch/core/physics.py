"""Surface interaction physics on component-planar vectors.

Counterpart of ``raytracetorch_tpu/core/physics.py`` (reflection, Snell
refraction and the pixelated phase plate; the Fresnel, grating, scatter and
radial-phase models are ROADMAP Queue 1 item 12).  ``ph[0]`` is the index on
the side the geometric normal points toward, ``ph[1]`` the far side.  Snell
is the physical one: n1 = medium of incidence, mu = n1 / n2.
"""

from __future__ import annotations

import torch

from ..geom import vec3 as v3


def reflect_dir(d, n):
    """Specular reflection R = I - 2 (I.N) N."""
    return v3.fma(d, -2.0 * v3.dot(d, n), n)


def refract_components(d, n, ior_in, ior_out):
    """Shared Snell geometry: (dot, cos_i, n1, n2, mu, tir, cos_t,
    eff_sign); the normal flipped against the incident ray is
    ``eff_sign * n``."""
    dot = v3.dot(d, n)
    from_in = dot < 0
    eff_sign = torch.where(from_in, 1.0, -1.0)
    cos_i = torch.abs(dot)
    n1 = torch.where(from_in, ior_in, ior_out)
    n2 = torch.where(from_in, ior_out, ior_in)
    mu = n1 / torch.where(torch.abs(n2) < 1e-12, 1e-12, n2)
    sin2_t = mu * mu * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.where(tir, 1.0,
                                   torch.clamp(1.0 - sin2_t, min=0.0)))
    cos_t = torch.where(tir, 0.0, cos_t)
    return dot, cos_i, n1, n2, mu, tir, cos_t, eff_sign


def snell_dir(d, n, ior_in, ior_out):
    """Vector Snell; total internal reflection reflects."""
    dot, cos_i, _, _, mu, tir, cos_t, eff_sign = refract_components(
        d, n, ior_in, ior_out)
    coef = (mu * cos_i - cos_t) * eff_sign
    v_refract = v3.fma(v3.scale(d, mu), coef, n)
    v_reflect = v3.fma(d, -2.0 * dot, n)
    return v3.where(tir, v_reflect, v_refract)


def corner_clip(n):
    """The largest cell coordinate of an axis of ``n`` pixels, ``n - 1 -
    1e-6`` taken in double and rounded once to float32, as the reference's
    ``jnp.clip`` bound is.  From ``n = 34`` on it rounds to ``n - 1``
    itself (the float32 spacing there is 3.8e-6), so ``i + 1 == n`` at the
    far rim: the corner reads clamp."""
    return float(torch.tensor(n - 1 - 1e-6, dtype=torch.float32))


def phase_grid_dir(d, Rw, hit_local, grid, order, lam0_um, wavelength_um,
                   n1, n2, hx, hy, corners_fn):
    """Pixelated phase plate: a ``[H, W]`` phase map in cycles over the
    rectangle ``[-hx, hx] x [-hy, hy]`` of the surface frame, bilinearly
    interpolated; the ray takes the momentum-form kick

        n2 d_out_t = n1 d_in_t + m lam_mm grad(phi),

    with grad(phi) the gradient of the bilinear patch at the hit.  Rays
    kicked evanescent return ok = False (and keep their local z
    direction).

    ``corners_fn(grid, iv, iu) -> (g00, g01, g10, g11)`` reads the four
    corners at the CLAMPED cells (kernel K4 or its plain version,
    ops/phase_grid.py): at the far rim ``iu + 1 == W`` (see
    ``corner_clip``), where the clamped read gives ``g01 = g00``, as XLA's
    gather does in the reference's eager trace.  Differentiable in the
    direction, the frame, the hit, the map and the row's parameters.
    Returns ``(new direction tuple, ok mask)``."""
    dl = v3.rot(d, Rw)
    wl = torch.where(wavelength_um > 0, wavelength_um, lam0_um)
    lam_mm = wl * 1e-3
    h, w = grid.shape
    x, y = hit_local[0], hit_local[1]
    u = (x + hx) / (2.0 * hx) * (w - 1)
    v = (y + hy) / (2.0 * hy) * (h - 1)
    u = torch.clamp(u, min=0.0, max=corner_clip(w))
    v = torch.clamp(v, min=0.0, max=corner_clip(h))
    iu = u.detach().to(torch.int32)
    iv = v.detach().to(torch.int32)
    fu, fv = u - iu, v - iv
    g00, g01, g10, g11 = corners_fn(grid, iv, iu)
    # bilinear gradient, rescaled from cell to length units
    su = (w - 1) / (2.0 * hx)
    sv = (h - 1) / (2.0 * hy)
    gx = ((1 - fv) * (g01 - g00) + fv * (g11 - g10)) * su
    gy = ((1 - fu) * (g10 - g00) + fu * (g11 - g01)) * sv
    kick = order * lam_mm
    tx = n1 * dl[0] + kick * gx
    ty = n1 * dl[1] + kick * gy
    t2 = tx * tx + ty * ty
    n2sq = n2 * n2
    ok = t2 < n2sq
    tz = torch.sqrt(torch.where(ok, torch.clamp(n2sq - t2, min=0.0), 1.0))
    sign = torch.sign(torch.where(torch.abs(dl[2]) < 1e-12, 1.0, dl[2]))
    inv = 1.0 / n2
    out_local = (tx * inv, ty * inv, torch.where(ok, tz * sign * inv, dl[2]))
    return v3.rot_t(out_local, Rw), ok
