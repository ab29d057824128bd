"""Gradient-index (GRIN) media: fixed-step ray integration through an
inhomogeneous rod.

Counterpart of ``raytracetorch_tpu/core/grin.py``.  A ``GrinRod`` element
(elements/grin.py) carries a squared-index profile

    n^2(x, y, z) = c0 + c2 r^2 + c4 r^4 + cz z,     r^2 = x^2 + y^2

in its entry-plane surface frame (z in [0, L]).  The ray equation is
parametrized by z: the optical momentum p = n dr/ds satisfies

    dx/dz = px / pz          dpx/dz = (1/pz) d(n^2)/dx / 2
    dy/dz = py / pz          dpy/dz = (1/pz) d(n^2)/dy / 2
    dOPL/dz = n^2 / pz       pz = sqrt(n^2 - px^2 - py^2)

and a fixed count of RK4 steps integrates exactly from the entry plane to
the exit plane, differentiable through every step (profile coefficients,
thickness and pose all receive gradients).  Entry and exit refraction at
the flat faces conserve the tangential momentum (px, py) and re-solve pz
from |p| = n.  Rays die (intensity 0) when they leave the rod radius, turn
around (pz^2 <= 1e-10) or are totally reflected at the exit face; a dead
lane freezes its state at the step it died.

These are plain tensor functions (a Python loop over the steps).  The
fused kernels run the same arithmetic in csrc/grin.cuh.
"""

from __future__ import annotations

import torch

from ..geom import vec3 as v3
from .intersect import intersect


def _half_grad_n2(c2, c4, x, y):
    """(1/2) d(n^2)/d(x, y) of the radial polynomial profile."""
    r2 = x * x + y * y
    g = c2 + 2.0 * c4 * r2
    return g * x, g * y


def _n2_at(c0, c2, c4, cz, x, y, z):
    r2 = x * x + y * y
    return c0 + (c2 + c4 * r2) * r2 + cz * z


def _derivs(c0, c2, c4, cz, x, y, px, py, z):
    """The z-parametrized ray ODE's right-hand side and the OPL rate: five
    rates and an ``ok`` mask (pz^2 > 1e-10, not at a turning point).  The
    double ``where`` keeps dead lanes' gradients at zero, not NaN."""
    n2 = _n2_at(c0, c2, c4, cz, x, y, z)
    pz2 = n2 - px * px - py * py
    ok = pz2 > 1e-10
    inv_pz = 1.0 / torch.sqrt(torch.where(ok, pz2, 1.0))
    inv_pz = torch.where(ok, inv_pz, 0.0)
    gx, gy = _half_grad_n2(c2, c4, x, y)
    return (px * inv_pz, py * inv_pz, gx * inv_pz, gy * inv_pz,
            n2 * inv_pz, ok)


def _p_dir(c0, c2, c4, cz, x, y, px, py, z):
    """Unit ray direction from the transverse momentum at height z (pz
    re-solved from |p| = n, clamped for frozen or dead lanes)."""
    n2 = _n2_at(c0, c2, c4, cz, x, y, z)
    pz = torch.sqrt(torch.clamp(n2 - px * px - py * py, min=1e-12))
    inv_n = 1.0 / torch.sqrt(torch.clamp(n2, min=1e-12))
    return px * inv_n, py * inv_n, pz * inv_n


def integrate_grin(c0, c2, c4, cz, L, r2_max, x, y, px, py, n_steps,
                   er=None, ei=None):
    """RK4 over z in [0, L] in ``n_steps`` fixed steps.

    The coefficients and ``L`` may be tensors under autograd; ``n_steps``
    is static.  Lanes that die (leave the radius or meet a turning point)
    freeze with ``alive`` False.  The step's height is ``i * h`` with
    ``h = L / n_steps``, as the JAX package carries it.

    With ``er``/``ei`` (component tuples of the complex E-field in the rod
    frame) the field is parallel-transported along the bending ray: each
    step applies the minimal rotation from its entry direction to its exit
    direction (``v3.rotate_between``, the per-step Rytov rotation).

    Returns ``(x, y, px, py, opl, alive[, er, ei])``."""
    h = L / n_steps
    opl = torch.zeros_like(x)
    alive = torch.where((x * x + y * y) <= r2_max, 1.0, 0.0)
    track_e = er is not None
    for i in range(n_steps):
        z = float(i) * h
        k1 = _derivs(c0, c2, c4, cz, x, y, px, py, z)
        k2 = _derivs(c0, c2, c4, cz,
                     x + 0.5 * h * k1[0], y + 0.5 * h * k1[1],
                     px + 0.5 * h * k1[2], py + 0.5 * h * k1[3],
                     z + 0.5 * h)
        k3 = _derivs(c0, c2, c4, cz,
                     x + 0.5 * h * k2[0], y + 0.5 * h * k2[1],
                     px + 0.5 * h * k2[2], py + 0.5 * h * k2[3],
                     z + 0.5 * h)
        k4 = _derivs(c0, c2, c4, cz,
                     x + h * k3[0], y + h * k3[1],
                     px + h * k3[2], py + h * k3[3],
                     z + h)

        def rk(j):
            return (h / 6.0) * (k1[j] + 2.0 * k2[j] + 2.0 * k3[j] + k4[j])

        xn, yn = x + rk(0), y + rk(1)
        pxn, pyn = px + rk(2), py + rk(3)
        opln = opl + rk(4)
        ok = k1[5] & k2[5] & k3[5] & k4[5]
        inside = (xn * xn + yn * yn) <= r2_max
        alive = alive * torch.where(ok & inside, 1.0, 0.0)
        live = alive > 0.0
        # dead lanes freeze (their state stays finite, their grads clean)
        xn = torch.where(live, xn, x)
        yn = torch.where(live, yn, y)
        pxn = torch.where(live, pxn, px)
        pyn = torch.where(live, pyn, py)
        opl = torch.where(live, opln, opl)
        if track_e:
            a = _p_dir(c0, c2, c4, cz, x, y, px, py, z)
            b = _p_dir(c0, c2, c4, cz, xn, yn, pxn, pyn, z + h)
            er = v3.where(live, v3.rotate_between(a, b, er), er)
            ei = v3.where(live, v3.rotate_between(a, b, ei), ei)
        x, y, px, py = xn, yn, pxn, pyn
    out = (x, y, px, py, opl, alive > 0.0)
    return out + (er, ei) if track_e else out


def grin_interaction(row, meta, dir_c, hit_s, Er=None, Ei=None):
    """One GRIN rod's whole interaction from its entry-plane hit: couple in
    (tangential momentum conserved), RK4 through the profile, couple out,
    land at the exit face in world coordinates.  Shared by the sequential
    chain (``grin_surface_step``) and the non-sequential bounce
    (core/trace.py::bounce_step), where the rod's entry face wins a bounce
    and this step is that bounce's interaction.

    ``row.ph`` holds (n_ambient, c0, c2, c4, cz, L) and ``row.sb[0]`` the
    rod radius squared.  With ``Er``/``Ei`` (world-frame field component
    tuples) the field is parallel-transported across the entry coupling,
    along the ray (``integrate_grin``) and across the exit coupling, all
    power-preserving; ``(Er', Ei')`` are then appended.

    Returns ``(new_pos, new_dir, alive, fwd, seg_opl)``: ``fwd`` marks rays
    travelling +z in the rod frame (a backward ray never couples in: its
    hit is a miss), ``alive`` those that reach the exit face (barrel exits,
    turning points and exit-face TIR die with a finite frozen state),
    ``seg_opl`` the in-medium optical path (0 for dead rays)."""
    n_amb = row.ph[..., 0]
    c0, c2 = row.ph[..., 1], row.ph[..., 2]
    c4, cz = row.ph[..., 3], row.ph[..., 4]
    L = row.ph[..., 5]
    r2_max = row.sb[..., 0]          # the DISK bound: radius^2
    track_e = Er is not None

    d_s = v3.rot(dir_c, row.Rw)
    fwd = d_s[2] > 1e-6
    x0, y0 = hit_s[0], hit_s[1]
    px, py = n_amb * d_s[0], n_amb * d_s[1]
    zero = torch.zeros_like(x0)

    # entry face: pz from |p| = n(r, z = 0); evanescent -> dead
    n2_in = _n2_at(c0, c2, c4, cz, x0, y0, zero)
    alive = (n2_in - px * px - py * py) > 1e-10

    er = ei = None
    if track_e:
        er, ei = v3.rot(Er, row.Rw), v3.rot(Ei, row.Rw)
        d0 = _p_dir(c0, c2, c4, cz, x0, y0, px, py, zero)
        er = v3.rotate_between(d_s, d0, er)
        ei = v3.rotate_between(d_s, d0, ei)

    out = integrate_grin(c0, c2, c4, cz, L, r2_max, x0, y0, px, py,
                         meta.grin_steps, er=er, ei=ei)
    x1, y1, px1, py1, seg_opl, live = out[:6]
    alive = alive & live

    # exit face: tangential p conserved, pz back in the ambient medium
    pz2_out = n_amb * n_amb - px1 * px1 - py1 * py1
    ok_out = pz2_out > 1e-10
    alive = alive & ok_out
    pz_out = torch.sqrt(torch.where(ok_out, pz2_out, 1.0))
    inv_n = 1.0 / n_amb
    d_out = (px1 * inv_n, py1 * inv_n, pz_out * inv_n)

    exit_local = (x1, y1, L.expand_as(x1))
    new_pos = v3.add(v3.rot_t(exit_local, row.Rw), v3.from_array(row.tw))
    new_dir = v3.rot_t(d_out, row.Rw)
    base = (new_pos, new_dir, alive, fwd, torch.where(alive, seg_opl, 0.0))
    if not track_e:
        return base
    er, ei = out[6], out[7]
    d1 = _p_dir(c0, c2, c4, cz, x1, y1, px1, py1, L.expand_as(x1))
    er = v3.rotate_between(d1, d_out, er)
    ei = v3.rotate_between(d1, d_out, ei)
    return base + (v3.rot_t(er, row.Rw), v3.rot_t(ei, row.Rw))


def grin_surface_step(row, meta, rays, field=None):
    """One GRIN rod for the sequential chain: intersect the entry plane, run
    ``grin_interaction`` and apply the masked ray update (and the field's,
    when ``field`` is a FieldState).

    Returns ``(rays, active, t_entry, seg_opl, field)``: ``seg_opl`` is the
    in-medium optical path where active (the caller adds the free flight
    n t to the entry plane)."""
    res = intersect(row, rays.pos_c, rays.dir_c, meta)
    out = grin_interaction(
        row, meta, rays.dir_c, res['hit_s'],
        Er=field.r_c if field is not None else None,
        Ei=field.i_c if field is not None else None)
    new_pos, new_dir, alive, fwd, seg_opl = out[:5]
    active = res['valid'] & (rays.intensity > 0) & fwd
    imod = torch.where(active & alive, 1.0, 0.0)
    rays = rays.masked_update(active, new_pos, new_dir, imod)
    if field is not None:
        field = field.masked(active, out[5], out[6])
    return rays, active, res['t'], torch.where(active, seg_opl, 0.0), field
