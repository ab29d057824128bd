"""Aperture elements: circular, rectangular and elliptic stops, fuzzy
apodization and the obscured telescope pupil.

Counterpart of ``raytracetorch_tpu/elements/aperture.py``.  The bounded
plane of a stop only exists where its (possibly inverted) bound holds, so
rays that miss fly by unchanged; rays that hit are re-checked against the
RAW bound by the APERTURE physics.  ``invert=False`` transmits in-bounds
hits; ``invert=True`` is a blocking iris.

A ``FuzzyAperture`` is an unbounded TRANSMIT plane whose callable
multiplies the intensity of each ray by a factor of its surface-local hit
(the trace loops apply it after the row's physics: ``call_fuzzy``).  The
eager traces run any callable; the fused kernels run a component-style one
(``fn(x, y, z)``, ``ComponentFuzzy``) traced into a program that they
interpret (ops/fuzzy_program.py), and refuse a legacy ``[N, 3]`` one.  The
``ObscuredAperture`` is such a plane with the telescope pupil's mask, a
component-style callable built from its constructor's scalars.
"""

from __future__ import annotations

import math

import torch

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


class ComponentFuzzy:
    """Marks an apodization callable as component-style: it is called as
    ``fn(x, y, z)`` on the three planar ``[N]`` components of the
    surface-local hit, instead of on one stacked ``[N, 3]`` tensor.  Only
    such callables run in the fused kernels, and only when their body is
    elementwise arithmetic within ops/fuzzy_program.py's op set."""

    components = True

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x, y, z):
        return self.fn(x, y, z)


def call_fuzzy(fn, hit_c):
    """A fuzzy callable's factor at the component-tuple hit ``hit_c``:
    component-style callables (``fn.components``) take the components, a
    legacy one the stacked ``[N, 3]`` tensor."""
    if getattr(fn, 'components', False):
        return fn(*hit_c)
    return fn(torch.stack(hit_c, dim=-1))


class FuzzyAperture(Element):
    """Arbitrary-apodization plane: transmits, and multiplies each ray's
    intensity by ``intensity_fn`` of its surface-local hit.

    - ``intensity_fn(hit [N, 3]) -> [N]`` (the default) runs in the eager
      traces (``simulate``) only;
    - ``components=True``: ``intensity_fn(x, y, z) -> [N]`` on the planar
      components, which the fused traces (``simulate_fused``) also run when
      the callable stays within the fused kernels' op set
      (ops/fuzzy_program.py)."""

    def __init__(self, intensity_fn, components=False, name='fuzzy', **kw):
        super().__init__(name=name, **kw)
        self.intensity_fn = (ComponentFuzzy(intensity_fn) if components
                             else intensity_fn)

    @property
    def n_surfaces(self):
        return 1

    @property
    def is_aperture(self):
        return True

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           is_plane=True, ph_kind=PhysKind.TRANSMIT)]


class ObscuredAperture(FuzzyAperture):
    """Telescope pupil mask: an outer disk of ``radius``, minus a central
    obscuration and ``n_vanes`` radial spider vanes.

    ``obscuration`` is the LINEAR fraction (0.3 = 30% of the diameter);
    ``vane_width`` is the full width of a vane in lens units, and the first
    vane points along +x rotated by ``vane_angle`` (radians).  The mask is a
    component-style callable built from these scalars (0 or 1 per ray), so
    the fused kernels run it."""

    def __init__(self, radius, obscuration=0.3, n_vanes=4, vane_width=0.0,
                 vane_angle=0.0, name='obscured', **kw):
        if not 0.0 <= float(obscuration) < 1.0:
            raise ValueError(
                f'obscuration is a linear fraction in [0, 1), got '
                f'{obscuration}')
        if float(vane_width) < 0 or int(n_vanes) < 0:
            raise ValueError('vane_width and n_vanes must be >= 0')
        r_out = float(radius)
        r_in = float(obscuration) * r_out
        nv, w2 = int(n_vanes), 0.5 * float(vane_width)
        a0 = float(vane_angle)
        angles = [(math.cos(a0 + 2 * math.pi * k / nv),
                   math.sin(a0 + 2 * math.pi * k / nv))
                  for k in range(nv)] if nv and w2 > 0 else []

        def mask(x, y, z):
            r2 = x * x + y * y
            ok = (r2 <= r_out * r_out) & (r2 >= r_in * r_in)
            for c, s in angles:
                along = x * c + y * s
                across = -x * s + y * c
                ok = ok & ~((along > 0.0) & (torch.abs(across) <= w2))
            return ok.to(x.dtype)

        super().__init__(mask, components=True, name=name, **kw)
        self.radius = r_out
        self.obscuration = float(obscuration)
