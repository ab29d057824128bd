"""Microlens array: the Shack-Hartmann building block.

Counterpart of ``raytracetorch_tpu/elements/mla.py``: a rectangular plate
of ideal thin lenslets on a square grid (core/physics.py::mla_dir; the
lenslet a ray meets is a choice without derivative, everything else is
differentiable).  ``pitch`` and ``f`` are parameters, so a Shack-Hartmann
model is differentiable end to end.
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from .base import Element, compose_world, frame_params


class MicrolensArray(Element):
    """Square-grid lenslet plate of half-widths ``half_x`` x ``half_y``,
    lenslet ``pitch`` and focal length ``f``.  A collimated beam forms one
    spot per lenslet at distance f; a wavefront of local slope s moves each
    cell's spot by f s."""

    def __init__(self, half_x, half_y, pitch, f, pitch_grad=False,
                 f_grad=False, name='mla', **kw):
        super().__init__(name=name, **kw)
        if float(pitch) <= 0:
            raise ValueError(f'pitch must be positive, got {pitch}')
        if float(f) == 0.0:
            raise ValueError('f must be nonzero')
        self._hx, self._hy = float(half_x), float(half_y)
        self._pitch_init = float(pitch)
        self._f_init = float(f)
        self._pitch_grad = bool(pitch_grad)
        self._f_grad = bool(f_grad)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'half_x': self._hx, 'half_y': self._hy,
                'pitch': self._pitch_init, 'f': self._f_init}

    def extra_trainable(self):
        return {'half_x': False, 'half_y': False,
                'pitch': self._pitch_grad, 'f': self._f_grad}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.RECT,
                           sb=(p['half_x'], p['half_y']),
                           is_plane=True, ph_kind=PhysKind.MLA,
                           ph=(p['pitch'], p['f'], 1.0, 1.0))]
