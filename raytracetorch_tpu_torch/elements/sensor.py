"""Sensor element: a transmitting plane whose hits stream into the trace's
moment accumulators.

Counterpart of ``raytracetorch_tpu/elements/sensor.py``: bounded by a disk
or a rectangle, or unbounded.
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from .base import Element, compose_world, frame_params


class SensorElement(Element):
    """Planar sensor bounded by a disk of ``radius``, or by the rectangle of
    half extents ``half_x`` and ``half_y``, or unbounded; rays outside the
    bound miss it and continue."""

    def __init__(self, radius=None, half_x=None, half_y=None,
                 name='sensor', **kw):
        super().__init__(name=name, **kw)
        if radius is not None:
            self._bound = ('disk', float(radius))
        elif half_x is not None:
            self._bound = ('rect', float(half_x), float(half_y))
        else:
            self._bound = ('none',)

    @property
    def n_surfaces(self):
        return 1

    @property
    def is_sensor(self):
        return True

    def extra_params(self):
        if self._bound[0] == 'disk':
            return {'radius': self._bound[1]}
        if self._bound[0] == 'rect':
            return {'half_x': self._bound[1], 'half_y': self._bound[2]}
        return {}

    def extra_trainable(self):
        return {k: False for k in self.extra_params()}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        if self._bound[0] == 'disk':
            sb_kind, sb = SBKind.DISK, (p['radius'] ** 2,)
        elif self._bound[0] == 'rect':
            sb_kind, sb = SBKind.RECT, (p['half_x'], p['half_y'])
        else:
            sb_kind, sb = SBKind.NONE, ()
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=sb_kind, sb=sb, is_plane=True,
                           ph_kind=PhysKind.TRANSMIT, is_sensor=True)]
