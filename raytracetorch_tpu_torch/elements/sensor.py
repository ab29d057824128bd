"""Sensor element: a transmitting plane whose hits stream into the trace's
moment accumulators.

Counterpart of ``raytracetorch_tpu/elements/sensor.py`` (disk-bounded or
unbounded; the rectangular bound is ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind
from ..core.static_dispatch import TODO_ELEMENTS
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from .base import Element, compose_world, frame_params


class SensorElement(Element):
    """Planar sensor bounded by a disk of ``radius`` (or unbounded); rays
    outside the bound miss it and continue."""

    def __init__(self, radius=None, half_x=None, half_y=None,
                 name='sensor', **kw):
        super().__init__(name=name, **kw)
        if half_x is not None or half_y is not None:
            raise NotImplementedError(
                f'rectangular sensors are {TODO_ELEMENTS}')
        self._radius = None if radius is None else float(radius)

    @property
    def n_surfaces(self):
        return 1

    @property
    def is_sensor(self):
        return True

    def extra_params(self):
        return {} if self._radius is None else {'radius': self._radius}

    def extra_trainable(self):
        return {k: False for k in self.extra_params()}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        if self._radius is None:
            sb_kind, sb = SBKind.NONE, ()
        else:
            sb_kind, sb = SBKind.DISK, (p['radius'] ** 2,)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=sb_kind, sb=sb, is_plane=True,
                           ph_kind=PhysKind.TRANSMIT, is_sensor=True)]
