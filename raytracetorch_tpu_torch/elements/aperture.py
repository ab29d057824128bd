"""Aperture elements: circular, rectangular and elliptic.

Counterpart of ``_ApertureBase``, ``CircularAperture``,
``RectangularAperture`` and ``EllipticAperture`` in
``raytracetorch_tpu/elements/aperture.py`` (fuzzy apodization and the
obscured pupil are ROADMAP Queue 2 G).  The bounded plane only exists where its (possibly inverted) bound
holds, so rays that miss fly by unchanged; rays that hit are re-checked
against the RAW bound by the APERTURE physics.  ``invert=False`` transmits
in-bounds hits; ``invert=True`` is a blocking iris.
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind, VBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane, q_quadric
from .base import Element, compose_world, frame_params


class _ApertureBase(Element):
    """A bounded plane with the aperture filter physics; subclasses set the
    surface bound (``sb_kind``, ``_sb_params``)."""

    sb_kind = SBKind.NONE

    @property
    def n_surfaces(self):
        return 1

    @property
    def is_aperture(self):
        return True

    def _sb_params(self, p):
        return ()

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=self.sb_kind, sb=self._sb_params(p),
                           sb_invert=self.invert, is_plane=True,
                           ph_kind=PhysKind.APERTURE)]


class CircularAperture(_ApertureBase):
    """Disk-bounded plane (or spherical cap, ``curvature != 0``) with the
    aperture filter physics."""

    sb_kind = SBKind.DISK

    def __init__(self, radius, invert=False, curvature=0.0,
                 name='circ_aperture', **kw):
        super().__init__(name=name, **kw)
        self._r_init = float(radius)
        self._c_init = float(curvature)
        if self._c_init and abs(1.0 / self._c_init) < self._r_init:
            raise ValueError('|1/curvature| must exceed the radius')
        self.invert = invert

    def extra_params(self):
        p = {'radius': self._r_init}
        if self._c_init:
            p['c'] = self._c_init
        return p

    def extra_trainable(self):
        return {k: False for k in self.extra_params()}

    def _sb_params(self, p):
        return (p['radius'] ** 2,)

    def build(self, p):
        if not self._c_init:
            return super().build(p)
        # curved stop: the invertible opening test is the DISK alone; the
        # far side of the sphere is clipped by a never-inverted volume bound
        Re, te = frame_params(p)
        Rw, tw, Rs, ts = compose_world(Re, te)
        q, sign = q_quadric(p['c'], 0.0)
        r_cap = 1.0 / p['c'].abs()
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK, sb=self._sb_params(p),
                           sb_invert=self.invert,
                           vb_kind=VBKind.Z_BETWEEN, vb=(-r_cap, r_cap),
                           ph_kind=PhysKind.APERTURE)]


class RectangularAperture(_ApertureBase):
    """Rectangle-bounded plane, half extents ``half_x`` and ``half_y``."""

    sb_kind = SBKind.RECT

    def __init__(self, half_x, half_y, invert=False, name='rect_aperture',
                 **kw):
        super().__init__(name=name, **kw)
        self._hx, self._hy = float(half_x), float(half_y)
        self.invert = invert

    def extra_params(self):
        return {'half_x': self._hx, 'half_y': self._hy}

    def extra_trainable(self):
        return {'half_x': False, 'half_y': False}

    def _sb_params(self, p):
        return (p['half_x'], p['half_y'])


class EllipticAperture(_ApertureBase):
    """Rotated-ellipse-bounded plane: semi-axes ``r_major`` (along local x
    before the rotation) and ``r_minor``, rotated by ``rot`` (radians; the
    parameter ``ap_rot``)."""

    sb_kind = SBKind.ELLIPSE

    def __init__(self, r_major, r_minor, rot=0.0, invert=False,
                 r_major_grad=False, r_minor_grad=False, rot_grad=False,
                 name='ellipse_aperture', **kw):
        super().__init__(name=name, **kw)
        self._init = dict(r_major=float(r_major), r_minor=float(r_minor),
                          ap_rot=float(rot))
        self._grads = dict(r_major=r_major_grad, r_minor=r_minor_grad,
                           ap_rot=rot_grad)
        self.invert = invert

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _sb_params(self, p):
        return (p['r_major'], p['r_minor'], p['ap_rot'])
