"""Surface interaction physics on component-planar vectors.

Counterpart of ``raytracetorch_tpu/core/physics.py`` (reflection, Snell
refraction, the unpolarized Fresnel reflectance and its Monte-Carlo branch
draw, the pixelated phase plate, and the diffractive and ideal elements: the
linear grating, the radial-phase kinoform and its efficiency, the
microlens array and the ideal ABCD map; the scatter lobes are ROADMAP Queue
1 item 14).  ``ph[0]`` is the index on the side the geometric normal points
toward, ``ph[1]`` the far side.  Snell is the physical one: n1 = medium of
incidence, mu = n1 / n2.

The diffractive and ideal maps keep every clamp of the JAX package's: 1e-12
on a grating's period and on |d_z|, 1e-9 on a lenslet pitch, the
``where(ok, ..., 1)`` inside each square root, ``sign(where(|d_z| < 1e-12,
1, d_z))`` and the efficiency's ``safe`` select.  An evanescent order
(``ok`` false) keeps the incoming local d_z, so its direction is not of
unit length; the trace zeroes its intensity.
"""

from __future__ import annotations

import math

import torch

from ..geom import vec3 as v3


def reflect_dir(d, n):
    """Specular reflection R = I - 2 (I.N) N."""
    return v3.fma(d, -2.0 * v3.dot(d, n), n)


def refract_components(d, n, ior_in, ior_out):
    """Shared Snell geometry: (dot, cos_i, n1, n2, mu, tir, cos_t,
    eff_sign); the normal flipped against the incident ray is
    ``eff_sign * n``.

    cos_t's square root is taken away from 0 only: at the critical angle
    itself (sin2_t == 1 in float32) its derivative is infinite, and a ray
    that the row's mask leaves out (a row it misses) would turn autograd's
    zero cotangent into 0 / 0 = NaN, which poisons every sum over the rays
    (the JAX package's ``refract_components`` does so, ROADMAP Queue 3).
    The values are the same; the derivative there is 0, where the kernels,
    which skip a ray's missed rows, take none."""
    dot = v3.dot(d, n)
    from_in = dot < 0
    eff_sign = torch.where(from_in, 1.0, -1.0)
    cos_i = torch.abs(dot)
    n1 = torch.where(from_in, ior_in, ior_out)
    n2 = torch.where(from_in, ior_out, ior_in)
    mu = n1 / torch.where(torch.abs(n2) < 1e-12, 1e-12, n2)
    sin2_t = mu * mu * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    x = torch.where(tir, 1.0, torch.clamp(1.0 - sin2_t, min=0.0))
    cos_t = torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)
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


def fresnel_rs_rp(cos_i, cos_t, n1, n2):
    """Per-polarization Fresnel intensity reflectances (Rs, Rp); the 1e-8
    in each denominator is the JAX package's."""
    rs = ((n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t + 1e-8)) ** 2
    rp = ((n1 * cos_t - n2 * cos_i) / (n1 * cos_t + n2 * cos_i + 1e-8)) ** 2
    return rs, rp


def fresnel_reflectance(cos_i, cos_t, n1, n2):
    """Unpolarized Fresnel R = (Rs + Rp) / 2."""
    rs, rp = fresnel_rs_rp(cos_i, cos_t, n1, n2)
    return 0.5 * (rs + rp)


def fresnel_dir(d, n, ior_in, ior_out, u, R_override=None):
    """Monte-Carlo Fresnel: reflect where the per-ray uniform draw ``u`` <
    R (R = 1 under total internal reflection, so those always reflect),
    else refract.  ``R_override`` replaces the bare interface's reflectance
    (a coated row's, core/static_dispatch.py::coated_rt_sp).  The choice
    carries no derivative; each branch is differentiable as reflect_dir and
    snell_dir are."""
    dot, cos_i, n1, n2, mu, tir, cos_t, eff_sign = refract_components(
        d, n, ior_in, ior_out)
    R = torch.where(tir, 1.0, fresnel_reflectance(cos_i, cos_t, n1, n2)
                    if R_override is None else R_override)
    reflect = u < R
    v_reflect = v3.fma(d, -2.0 * dot, n)
    coef = (mu * cos_i - cos_t) * eff_sign
    v_refract = v3.fma(v3.scale(d, mu), coef, n)
    return v3.where(reflect, v_reflect, v_refract)


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


def _sign_z(dz):
    """sign(d_z) with |d_z| < 1e-12 taken as +1 (no derivative)."""
    return torch.sign(torch.where(torch.abs(dz) < 1e-12, 1.0, dz))


def grating_dir(d, Rw, period_um, order, reflective, wavelength_um):
    """Linear diffraction grating: grooves along the surface-local y axis,
    grating vector along local x with period ``period_um``.  The tangential
    direction component picks up m lambda / period; the normal component
    restores unit length (its sign kept, flipped for a reflective grating).
    Unset wavelengths (0) diffract at the d line (0.5876 um).  Returns
    ``(new direction tuple, ok mask)``; ``ok`` is false for an evanescent
    order."""
    dl = v3.rot(d, Rw)
    wl = torch.where(wavelength_um > 0, wavelength_um, 0.5876)
    shift = order * wl / torch.clamp(period_um, min=1e-12)
    tx = dl[0] + shift
    ty = dl[1]
    t2 = tx * tx + ty * ty
    ok = t2 < 1.0
    tz2 = torch.clamp(1.0 - t2, min=0.0)
    tz = torch.sqrt(torch.where(ok, tz2, 1.0))
    tz = tz * _sign_z(dl[2]) * torch.where(reflective > 0.5, -1.0, 1.0)
    out_local = (tx, ty, torch.where(ok, tz, dl[2]))
    return v3.rot_t(out_local, Rw), ok


def doe_dir(d, Rw, hit_local, coeffs, order, lam0_um, wavelength_um, n1, n2):
    """Radial-phase diffractive surface (kinoform): phi(r) = sum_k c_k
    r^(2k) in cycles, ``coeffs`` c_k in cycles/mm^(2k).  The vector grating
    equation in optical-momentum form in the surface frame,

        n2 d_out_t = n1 d_in_t + m lam_mm grad(phi),

    with the normal component restored from |p| = n2.  Unset wavelengths
    (0) diffract at the design wavelength ``lam0_um``.  Returns ``(new
    direction tuple, ok mask)``."""
    dl = v3.rot(d, Rw)
    wl = torch.where(wavelength_um > 0, wavelength_um, lam0_um)
    lam_mm = wl * 1e-3
    x, y = hit_local[0], hit_local[1]
    r2 = x * x + y * y
    gscale = torch.zeros_like(r2)
    rpow = torch.ones_like(r2)           # r^(2(k-1))
    for k_i, c in enumerate(coeffs, start=1):
        gscale = gscale + (2.0 * k_i) * c * rpow
        rpow = rpow * r2
    kick = order * lam_mm * gscale
    tx = n1 * dl[0] + kick * x
    ty = n1 * dl[1] + kick * y
    t2 = tx * tx + ty * ty
    n2sq = n2 * n2
    ok = t2 < n2sq
    tz = torch.sqrt(torch.where(ok, torch.clamp(n2sq - t2, min=0.0), 1.0))
    inv = 1.0 / n2
    out_local = (tx * inv, ty * inv,
                 torch.where(ok, tz * _sign_z(dl[2]) * inv, dl[2]))
    return v3.rot_t(out_local, Rw), ok


def kinoform_efficiency(order, lam0_um, wavelength_um):
    """Scalar diffraction efficiency of a kinoform blazed for order m at
    lam0: sinc^2(alpha - m), alpha = lam0 / lam (1 at the design wavelength,
    where ``safe`` selects the constant 1 and its zero derivative)."""
    wl = torch.where(wavelength_um > 0, wavelength_um, lam0_um)
    a = lam0_um / wl - order
    safe = torch.abs(a) > 1e-9
    x = torch.where(safe, a, 1.0) * math.pi
    return torch.where(safe, (torch.sin(x) / x) ** 2, 1.0)


def mla_dir(d, hit_local, Rw, pitch, f_lens):
    """Microlens array: a square grid of ideal thin lenslets of ``pitch``
    and focal length ``f_lens`` in the surface frame.  The hit's cell
    center is pitch * floor(x / pitch + 0.5) (a choice without derivative);
    within the cell the thin-lens slope map sx' = sx - (x - x_cell) / f
    applies (the same in y)."""
    dl = v3.rot(d, Rw)
    dz = dl[2]
    dz_safe = torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    x, y = hit_local[0], hit_local[1]
    inv_p = 1.0 / torch.clamp(pitch, min=1e-9)
    xc = pitch * torch.floor(x * inv_p + 0.5)
    yc = pitch * torch.floor(y * inv_p + 0.5)
    inv_f = 1.0 / f_lens
    nx = dl[0] / dz_safe - (x - xc) * inv_f
    ny = dl[1] / dz_safe - (y - yc) * inv_f
    inv = 1.0 / torch.sqrt(nx * nx + ny * ny + 1.0)
    sign = _sign_z(dz)
    new_local = (nx * inv * sign, ny * inv * sign, inv * sign)
    return v3.rot_t(new_local, Rw)


def linear_dir(d, hit_local, Rw, Cx, Cy, Dx, Dy):
    """Ideal ABCD optic: the direction in the surface frame, normalized to
    d_z = 1, takes the per-axis linear map on (position, slope) and is
    renormalized; the ray always leaves towards +z of the surface frame."""
    dl = v3.rot(d, Rw)
    dz = dl[2]
    dz_safe = torch.where(torch.abs(dz) < 1e-12, 1e-12, dz)
    nx = Cx * hit_local[0] + Dx * dl[0] / dz_safe
    ny = Cy * hit_local[1] + Dy * dl[1] / dz_safe
    inv = 1.0 / torch.sqrt(torch.clamp(nx * nx + ny * ny + 1.0, min=1e-12))
    return v3.rot_t((nx * inv, ny * inv, inv), Rw)
