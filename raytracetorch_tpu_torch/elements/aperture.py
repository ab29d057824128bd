"""Circular aperture.

Counterpart of ``CircularAperture`` in ``raytracetorch_tpu/elements/
aperture.py`` (the other apertures and fuzzy apodization are ROADMAP Queue 1
items 12 and 14).  The bounded plane only exists where its (possibly
inverted) bound holds, so rays that miss fly by unchanged; rays that hit are
re-checked against the RAW bound by the APERTURE physics.  ``invert=False``
transmits in-bounds hits; ``invert=True`` is a blocking iris.
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind, VBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane, q_quadric
from .base import Element, compose_world, frame_params


class CircularAperture(Element):
    """Disk-bounded plane (or spherical cap, ``curvature != 0``) with the
    aperture filter physics."""

    def __init__(self, radius, invert=False, curvature=0.0,
                 name='circ_aperture', **kw):
        super().__init__(name=name, **kw)
        self._r_init = float(radius)
        self._c_init = float(curvature)
        if self._c_init and abs(1.0 / self._c_init) < self._r_init:
            raise ValueError('|1/curvature| must exceed the radius')
        self.invert = invert

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        p = {'radius': self._r_init}
        if self._c_init:
            p['c'] = self._c_init
        return p

    def extra_trainable(self):
        return {k: False for k in self.extra_params()}

    def build(self, p):
        Re, te = frame_params(p)
        Rw, tw, Rs, ts = compose_world(Re, te)
        sb = (p['radius'] ** 2,)
        if not self._c_init:
            q, sign = q_plane(te.dtype, te.device)
            return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                               sb_kind=SBKind.DISK, sb=sb,
                               sb_invert=self.invert, is_plane=True,
                               ph_kind=PhysKind.APERTURE)]
        # curved stop: the invertible opening test is the DISK alone; the
        # far side of the sphere is clipped by a never-inverted volume bound
        q, sign = q_quadric(p['c'], 0.0)
        r_cap = 1.0 / p['c'].abs()
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK, sb=sb, sb_invert=self.invert,
                           vb_kind=VBKind.Z_BETWEEN, vb=(-r_cap, r_cap),
                           ph_kind=PhysKind.APERTURE)]
