"""Thick spherical lenses.

Counterpart of ``raytracetorch_tpu/elements/lens.py`` (``_SphericLens`` and
``SingletLens``; doublets, triplets, cylindrical and aspheric lenses are
ROADMAP Queue 1 item 14).  Optical faces are hemisphere-clipped quadrics
bounded by the lens aperture; the edge is a cylinder bounded between the
faces' sag heights.  Each surface's physics carries
``(ior_normal_side, ior_far_side)``: faces have +z normals, the edge an
outward radial normal.
"""

from __future__ import annotations

import math

from ..constants import PhysKind, SBKind, VBKind
from ..core.static_dispatch import TODO_FEATURES
from ..core.table import SurfaceRec
from ..geom.surfaces import q_cylinder, q_quadric, sag_z
from ..geom.transform import mm
from .base import Element, compose_world, frame_params, zvec
from .ideal import paraxial_refract_mat


def _sag_float(c, r):
    term = max(1.0 - c * c * r * r, 0.0)
    return (c * r * r) / (1.0 + math.sqrt(term))


def _validate_faces(curvatures, thicknesses, aperture_r, z_list):
    """Constructor-time physicality checks."""
    for i, c in enumerate(curvatures):
        if abs(0.5 * c) > 1.0 / (2.0 * aperture_r):
            raise ValueError(f"|R{i+1}| must be larger than D/2")
    for i, t in enumerate(thicknesses):
        if t <= 1e-6:
            raise ValueError(f"Thickness T{i+1} must be positive")
    sags = [_sag_float(c, aperture_r) + z for c, z in zip(curvatures, z_list)]
    for i in range(len(sags) - 1):
        if sags[i] > sags[i + 1]:
            raise ValueError(f"Optical surfaces {i+1} and {i+2} intersect")


class _SphericLens(Element):
    """Shared machinery for spherical lens stacks.  Subclasses define
    ``_curv_names`` / ``_thick_names`` / ``_ior_chain``."""

    _curv_names: tuple = ()
    _thick_names: tuple = ()

    def _vertex_zs(self, p):
        """Cumulative vertex z's centred on the element."""
        ts = [p[n] for n in self._thick_names]
        z = -sum(ts) / 2.0
        zs = [z]
        for t in ts:
            z = z + t
            zs.append(z)
        return zs

    def _ior_chain(self, p):
        raise NotImplementedError

    @property
    def n_optical(self):
        return len(self._curv_names)

    @property
    def n_surfaces(self):
        return 2 * self.n_optical - 1   # faces + edges

    def _refract_kind(self):
        return PhysKind.SNELL

    def _edge_phys(self, p):
        iors = self._ior_chain(p)
        return PhysKind.BLOCK, (iors[0], iors[1])

    def build(self, p):
        Re, te = frame_params(p)
        r = p['radius']
        zs = self._vertex_zs(p)
        cs = [p[n] for n in self._curv_names]
        iors = self._ior_chain(p)
        kind = self._refract_kind()
        recs = []
        for i, (c, zv) in enumerate(zip(cs, zs)):
            q, sign = q_quadric(c, 0.0)
            Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(zv))
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                sb_kind=SBKind.HEMI, sb=(c,),
                vb_kind=VBKind.APER_R2, vb=(r * r,),
                ph_kind=kind, ph=(iors[i + 1], iors[i])))
        edge_kind, edge_ph = self._edge_phys(p)
        for i in range(self.n_optical - 1):
            q, sign = q_cylinder(r)
            Rw, tw, Rs, ts = compose_world(Re, te)
            z_lo = sag_z(cs[i], r) + zs[i]
            z_hi = sag_z(cs[i + 1], r) + zs[i + 1]
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                vb_kind=VBKind.Z_BETWEEN, vb=(z_lo, z_hi),
                ph_kind=edge_kind, ph=edge_ph))
        return recs

    def paraxial(self, p):
        """Per-face refraction matrices at the vertex z's, wrapped in the
        element decenter shifts."""
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        zs = self._vertex_zs(p)
        cs = [p[n] for n in self._curv_names]
        iors = self._ior_chain(p)
        z0 = p['trans'][2]
        Zs = [z0 + zv for zv in zs]
        mats = [mm(t_inv, mm(paraxial_refract_mat(c, c, iors[i],
                                                  iors[i + 1]), t))
                for i, c in enumerate(cs)]
        return Zs, mats


class SingletLens(_SphericLens):
    """Biconvex/meniscus singlet: 2 refracting faces + edge cylinder.

    ``d`` is the diameter and ``t`` the centre thickness.  Dispersion
    (``abbe_vd``/``sellmeier``), coatings and Fresnel physics are ROADMAP
    Queue 1 item 12 and raise NotImplementedError."""

    _curv_names = ('c1', 'c2')
    _thick_names = ('t',)

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 c1_grad=False, c2_grad=False, t_grad=False, d_grad=False,
                 ior_glass_grad=False, ior_media_grad=False,
                 abbe_vd=None, sellmeier=None, coating=None,
                 fresnel=False, inked=False, name='singlet', **kw):
        super().__init__(name=name, **kw)
        if abbe_vd is not None or sellmeier is not None:
            raise NotImplementedError(f'dispersion is {TODO_FEATURES}')
        if coating:
            raise NotImplementedError(f'coatings are {TODO_FEATURES}')
        if fresnel:
            raise NotImplementedError(f'Fresnel physics is {TODO_FEATURES}')
        _validate_faces([c1, c2], [t], d / 2.0, [-t / 2.0, t / 2.0])
        self._init = dict(c1=c1, c2=c2, t=t, radius=d / 2.0,
                          ior_glass=ior_glass, ior_media=ior_media)
        self._grads = dict(c1=c1_grad, c2=c2_grad, t=t_grad, radius=d_grad,
                           ior_glass=ior_glass_grad,
                           ior_media=ior_media_grad)
        self.inked = inked

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _ior_chain(self, p):
        return [p['ior_media'], p['ior_glass'], p['ior_media']]

    def _edge_phys(self, p):
        """The edge refracts unless inked; its normal points outward."""
        if self.inked:
            return PhysKind.BLOCK, ()
        return self._refract_kind(), (p['ior_media'], p['ior_glass'])
