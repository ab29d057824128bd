"""Shape part builders for custom elements.

Counterpart of ``raytracetorch_tpu/elements/shapes.py``.  Each builder
returns geometry-only ``SurfaceRec`` lists for
:class:`~raytracetorch_tpu_torch.elements.base.ElementCustom`, with the
signature ``(params, Re, te) -> list[SurfaceRec]`` of its ``shape_fn``:
planes, disks, rectangles, ellipses, spheres, cylinders, quadrics (with a
conic constant), cylindrical quadrics, hemisphere-clipped conics, cones and
single-nappe cones.
"""

from __future__ import annotations

from ..constants import SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import (q_cone, q_cylinder, q_plane, q_quadric,
                             q_quadric_zy, q_sphere)
from .base import compose_world


def _one(q, sign, Re, te, sb_kind=SBKind.NONE, sb=(), sb_invert=False,
         Rs=None, ts=None, is_plane=False):
    Rw, tw, Rs, ts = compose_world(Re, te, Rs, ts)
    return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                       sb_kind=sb_kind, sb=sb, sb_invert=sb_invert,
                       is_plane=is_plane)]


def _plane(te):
    return q_plane(te.dtype, te.device)


def plane(p, Re, te):
    q, s = _plane(te)
    return _one(q, s, Re, te, is_plane=True)


def disk(p, Re, te):
    """Bounded plane; params: radius, optional invert."""
    q, s = _plane(te)
    return _one(q, s, Re, te, SBKind.DISK, (p['radius'] ** 2,),
                bool(p.get('invert', False)), is_plane=True)


def rectangle(p, Re, te):
    """params: half_x, half_y, optional invert."""
    q, s = _plane(te)
    return _one(q, s, Re, te, SBKind.RECT, (p['half_x'], p['half_y']),
                bool(p.get('invert', False)), is_plane=True)


def ellipse(p, Re, te):
    """params: r_major, r_minor, rot, optional invert."""
    q, s = _plane(te)
    return _one(q, s, Re, te, SBKind.ELLIPSE,
                (p['r_major'], p['r_minor'], p.get('rot', 0.0)),
                bool(p.get('invert', False)), is_plane=True)


def sphere(p, Re, te):
    """Full sphere centered at the local origin; params: radius."""
    q, s = q_sphere(p['radius'])
    return _one(q, s, Re, te)


def cylinder(p, Re, te):
    """Infinite tube along local z; params: radius."""
    q, s = q_cylinder(p['radius'])
    return _one(q, s, Re, te)


def quadric(p, Re, te):
    """Conic of revolution; params: c, k."""
    q, s = q_quadric(p['c'], p.get('k', 0.0))
    return _one(q, s, Re, te)


def half_sphere(p, Re, te):
    """Hemisphere-clipped conic; params: c."""
    q, s = q_quadric(p['c'], 0.0)
    return _one(q, s, Re, te, SBKind.HEMI, (p['c'],))


def quadric_zy(p, Re, te):
    """Cylindrical conic, curvature in y; params: c, k."""
    q, s = q_quadric_zy(p['c'], p.get('k', 0.0))
    return _one(q, s, Re, te)


def half_cyl(p, Re, te):
    """Hemisphere-clipped cylindrical conic; params: c."""
    q, s = q_quadric_zy(p['c'], 0.0)
    return _one(q, s, Re, te, SBKind.HEMI, (p['c'],))


def cone(p, Re, te):
    """Double cone z^2 = slope^2 (x^2 + y^2); params: slope."""
    q, s = q_cone(p['slope'])
    return _one(q, s, Re, te)


def single_cone(p, Re, te):
    """One nappe, z * slope >= -eps; params: slope."""
    q, s = q_cone(p['slope'])
    return _one(q, s, Re, te, SBKind.CONE_NAPPE, (p['slope'],))
