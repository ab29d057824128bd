"""Ray-surface intersection against one SurfaceTable row (component-planar).

Counterpart of ``raytracetorch_tpu/core/intersect.py`` for the sequential
trace (the row's kinds are static; the dense per-ray kind dispatch of the
non-sequential trace is ROADMAP Queue 1 item 13).  Protocol: the quadric's
roots (an even asphere's or a freeform's refined onto its sag), per-root
surface-local bounds, the minimum positive root with the world-scale
epsilon, then the element-volume bound on the chosen hit.
"""

from __future__ import annotations

import torch

from ..constants import SOLVER_EPS, SBKind, VBKind
from ..geom import vec3 as v3
from ..geom.surfaces import (asph_normal, asph_refine, ff_normal, ff_refine,
                             min_positive, solve_roots, surface_normal)
from .static_dispatch import sb_check_one, vb_check_one


def intersect(row, pos, direction, static_meta):
    """Intersect rays with one table row.

    ``row`` is a SurfaceTable row (or a FlatRow); ``pos``/``direction`` are
    component tuples of [N] world-frame tensors.  Returns a dict with ``t``
    (0 where invalid), ``valid``, the hit in the surface (``hit_s``) and
    element (``hit_e``) frames, and the ray in the surface frame
    (``o_s``, ``d_s``)."""
    o_s = v3.rot(v3.sub(pos, v3.from_array(row.tw)), row.Rw)
    d_s = v3.rot(direction, row.Rw)

    if static_meta.plane:
        # q = (0,0,0,-2,0) always takes solve_roots' linear branch
        # (B = -2 dz, C = -2 oz, t = -C / B_safe): inline exactly that
        B = -2.0 * d_s[2]
        B_safe = torch.where(torch.abs(B) < SOLVER_EPS, SOLVER_EPS, B)
        t1 = (2.0 * o_s[2]) / B_safe
        v1 = torch.abs(B) >= SOLVER_EPS
        t2, v2 = t1, v1
    else:
        (t1, v1), (t2, v2) = solve_roots(row.q, o_s, d_s)

    if static_meta.ff:
        # freeform XY polynomial: Newton-refine both base-conic roots onto
        # S(x, y); the exponent pairs are static, the coefficients the
        # row's ff columns (a freeform row is never a DOE row, whose
        # coefficients share those columns)
        c, kc2, acoef, fcoef = _ff_coeffs(row, static_meta)
        t1, v1 = ff_refine(c, kc2, acoef, static_meta.ff, fcoef, o_s, d_s,
                           t1, v1)
        t2, v2 = ff_refine(c, kc2, acoef, static_meta.ff, fcoef, o_s, d_s,
                           t2, v2)
    elif static_meta.asph:
        # even asphere: refine both base-conic roots onto the sag before
        # the surface bound
        c, kc2, coeffs = _asph_coeffs(row)
        t1, v1 = asph_refine(c, kc2, coeffs, o_s, d_s, t1, v1)
        t2, v2 = asph_refine(c, kc2, coeffs, o_s, d_s, t2, v2)

    if static_meta.sb != SBKind.NONE:
        def sb(hit):
            keep = sb_check_one(static_meta.sb, row.sb, hit)
            return ~keep if static_meta.invert else keep
        v1 = v1 & sb(v3.fma(o_s, t1, d_s))
        v2 = v2 & sb(v3.fma(o_s, t2, d_s))

    # The f32 error of a landed hit point scales with the WORLD coordinate
    # magnitude, so the self-intersection guard includes |pos|
    scale = torch.sqrt(v3.norm2(o_s) + v3.norm2(pos) + 1e-12)
    roots = [(t1, v1)] if static_meta.plane else [(t1, v1), (t2, v2)]
    t, valid = min_positive(roots, scale=scale.detach())

    hit_s = v3.fma(o_s, t, d_s)
    hit_e = v3.add(v3.rot_t(hit_s, row.Rs), v3.from_array(row.ts))
    if static_meta.vb != VBKind.NONE:
        valid = valid & vb_check_one(static_meta.vb, row.vb, hit_e,
                                     (row.hp_n, row.hp_d, row.hp_mask))
    return dict(t=t, valid=valid, hit_s=hit_s, hit_e=hit_e, o_s=o_s,
                d_s=d_s)


def _asph_coeffs(row):
    """(c, (1 + k) c^2, [a4, a6, a8, a10]) of an asphere row."""
    c = row.q[..., 0]
    return c, row.q[..., 2] * c, [row.asph[..., i] for i in range(4)]


def _ff_coeffs(row, static_meta):
    """(c, (1 + k) c^2, [a4..a10], [c_m]) of a freeform row."""
    c, kc2, acoef = _asph_coeffs(row)
    return c, kc2, acoef, [row.ff[..., m] for m in range(len(static_meta.ff))]


def normal_world(row, hit_s, static_meta):
    """World-frame unit normal at a surface-frame hit: n_local @ Rw.T."""
    if static_meta.ff:
        c, kc2, acoef, fcoef = _ff_coeffs(row, static_meta)
        return v3.rot_t(ff_normal(c, kc2, acoef, static_meta.ff, fcoef,
                                  hit_s), row.Rw)
    if static_meta.asph:
        return v3.rot_t(asph_normal(*_asph_coeffs(row), hit_s), row.Rw)
    if static_meta.plane:
        # +z in the surface frame; n @ Rw.T = Rw[:, 2]
        return (row.Rw[..., 0, 2] + 0.0 * hit_s[0],
                row.Rw[..., 1, 2] + 0.0 * hit_s[1],
                row.Rw[..., 2, 2] + 0.0 * hit_s[2])
    n_local = surface_normal(row.q, row.n_sign, hit_s)
    return v3.rot_t(n_local, row.Rw)
