"""Wavefront analysis from accumulated optical path lengths.

Counterpart of ``raytracetorch_tpu/utils/wavefront.py``.  Uses the
``track_opl=True`` output of a trace (``aux['opl']``): the OPL of each ray
from its launch plane to its final position, with the per-ray medium
updated through every refraction (dispersion and TIR included).  For an
aberration-free system imaging a collimated bundle to a point F, Fermat's
principle makes ``opl_i + n * d_i(F)`` identical across the pupil, where
``d_i(F)`` is the remaining distance from the ray's final position to its
closest approach to F.  The spread of that quantity is the wavefront error.

Plain torch on the rays' device.  The 3 x 3 systems go to
``torch.linalg.solve``; the Zernike fit solves its weighted normal
equations in float64 (``torch.linalg.lstsq`` on a CUDA tensor has only the
``gels`` solver, which assumes full rank; float64 keeps the squared
condition number of the normal equations harmless at these orders).  The
package keeps TF32 off, so no product here loses precision on the card.
"""

from __future__ import annotations

import math

import torch

from ..geom.zernike import noll_nm


def best_focus(rays):
    """Least-squares point of closest approach of a ray bundle, in closed
    form: minimizes sum_i |(F - p_i) - ((F - p_i).d_i) d_i|^2 over F, i.e.
    solves (sum_i (I - d_i d_i^T)) F = sum_i (I - d_i d_i^T) p_i."""
    p = torch.stack(rays.pos_c, dim=-1)
    d = torch.stack(rays.dir_c, dim=-1)
    proj = (torch.eye(3, dtype=d.dtype, device=d.device)[None]
            - d[:, :, None] * d[:, None, :])                    # [N, 3, 3]
    A = torch.sum(proj, dim=0)
    b = torch.sum(torch.einsum('nij,nj->ni', proj, p), dim=0)
    return torch.linalg.solve(A, b)


def opl_to_point(rays, opl, point, n_medium=1.0):
    """Total OPL of each ray continued to its closest approach to ``point``.
    Constant across rays for perfect imaging at ``point``."""
    px = (rays.px - point[0], rays.py - point[1], rays.pz - point[2])
    t_close = -(px[0] * rays.dx + px[1] * rays.dy + px[2] * rays.dz)
    return opl + n_medium * t_close


def wavefront_rms(rays, opl, point=None, weights=None, n_medium=1.0,
                  refocus=False):
    """Intensity-weighted RMS optical-path-difference about ``point``
    (default: the bundle's best focus), in the trace's length units.
    Divide by the wavelength for waves.

    ``refocus=True`` re-solves the reference point itself for minimum OPD
    variance: moving the reference by dF changes each ray's
    ``opl_to_point`` by exactly ``n (d_i . dF)``, so projecting out the
    span of [1, dx, dy, dz] removes piston and the tilt and defocus a better
    reference sphere would absorb: the RMS wavefront error a designer
    reports."""
    if point is None:
        point = best_focus(rays)
    total = opl_to_point(rays, opl, point, n_medium)
    w = rays.intensity if weights is None else weights
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mean = torch.sum(total * w) / wsum
    tc = total - mean
    if refocus:
        # weighted LS of the centred total onto the centred, normalized
        # (dx, dy, dz) by the 3 x 3 normal equations
        def cnorm(a):
            ac = a - torch.sum(w * a) / wsum
            return ac / torch.sqrt(torch.sum(w * ac * ac) + 1e-20)
        cols = (cnorm(rays.dx), cnorm(rays.dy), cnorm(rays.dz))
        G = torch.stack([torch.stack([torch.sum(w * a * b) for b in cols])
                         for a in cols])
        b = torch.stack([torch.sum(w * a * tc) for a in cols])
        k = torch.linalg.solve(
            G + 1e-6 * torch.eye(3, dtype=G.dtype, device=G.device), b)
        tc = tc - (k[0] * cols[0] + k[1] * cols[1] + k[2] * cols[2])
    var = torch.sum(w * tc ** 2) / wsum
    return torch.sqrt(torch.clamp(var, min=0.0))


# ---------------------------------------------------------------------------
# Zernike decomposition
# ---------------------------------------------------------------------------

ZERNIKE_NAMES = ['piston', 'tilt x', 'tilt y', 'defocus', 'astig 45',
                 'astig 0', 'coma y', 'coma x', 'trefoil y', 'trefoil x',
                 'spherical', 'astig2 0', 'astig2 45', 'quadrafoil 0',
                 'quadrafoil 45', 'coma2 x', 'coma2 y', 'trefoil2 x',
                 'trefoil2 y', 'pentafoil x', 'pentafoil y', 'spherical2']


def zernike_name(j):
    """Human name of Noll term ``j`` (1-based); 'z<j>' beyond the table."""
    return ZERNIKE_NAMES[j - 1] if j <= len(ZERNIKE_NAMES) else f'z{j}'


def _zernike_radial(n, m, rho):
    m = abs(m)
    out = torch.zeros_like(rho)
    for s in range((n - m) // 2 + 1):
        c = ((-1) ** s * math.factorial(n - s)
             / (math.factorial(s) * math.factorial((n + m) // 2 - s)
                * math.factorial((n - m) // 2 - s)))
        out = out + c * rho ** (n - 2 * s)
    return out


def zernike_basis(x, y, radius, n_terms=15):
    """[N, n_terms] Zernike values (Noll order, no normalization factor:
    coefficients are in the OPD's length units) over the pupil coordinates
    (x, y) normalized by ``radius``."""
    rho = torch.sqrt(x * x + y * y) / radius
    theta = torch.atan2(y, x)
    cols = []
    for n, m in (noll_nm(j) for j in range(1, n_terms + 1)):
        r = _zernike_radial(n, m, rho)
        if m == 0:
            cols.append(r)
        elif m > 0:
            cols.append(r * torch.cos(m * theta))
        else:
            cols.append(r * torch.sin(-m * theta))
    return torch.stack(cols, dim=-1)


def zernike_fit(pupil_xy, opd, radius, weights=None, n_terms=15):
    """Weighted least-squares Zernike coefficients of an OPD map sampled at
    pupil coordinates ``pupil_xy [N, 2]``.

    Returns coefficients [n_terms] in ``opd``'s units and dtype; see
    ZERNIKE_NAMES for the Noll ordering (defocus = index 3, primary
    spherical = index 10).  Solved by the weighted normal equations in
    float64 (the module's note); a basis of less than full rank over the
    samples raises."""
    Z = zernike_basis(pupil_xy[:, 0], pupil_xy[:, 1], radius,
                      n_terms).double()
    w = (torch.ones_like(opd) if weights is None else weights).double()
    sw = torch.clamp(w, min=0.0)[:, None]
    G = Z.T @ (Z * sw)
    b = Z.T @ (opd.double() * sw[:, 0])
    return torch.linalg.solve(G, b).to(opd.dtype)


def interferogram(opd, amp, wavelength, tilt_fringes=0.0, axis='x',
                  reference_amp=1.0):
    """Two-beam interferogram of a pupil OPD map.

    ``opd``/``amp`` are [n, n] pupil maps in the same length units as
    ``wavelength``; ``tilt_fringes`` adds a linear reference tilt of that
    many fringes across the pupil along ``axis`` ('x'|'y').  Intensity

        I = A_r^2 + A_t^2 + 2 A_r A_t cos(2 pi (OPD + tilt)/lambda),

    normalized so that a perfect null (flat OPD, no tilt, matched
    amplitudes) peaks at 1."""
    n = opd.shape[0]
    u = (torch.arange(n, dtype=opd.dtype, device=opd.device) + 0.5) / n
    tilt = tilt_fringes * wavelength * (u[None, :] if axis == 'x'
                                        else u[:, None])
    phase = 2.0 * math.pi * (opd + tilt) / wavelength
    a_r = torch.as_tensor(reference_amp, dtype=opd.dtype, device=opd.device)
    inten = a_r * a_r + amp * amp + 2.0 * a_r * amp * torch.cos(phase)
    return inten / ((a_r + 1.0) ** 2)
