"""Pixelated phase plate.

Counterpart of ``PhaseGridPlate`` in ``raytracetorch_tpu/elements/
diffractive.py`` (``DiffractiveLens`` is ROADMAP Queue 1 item 14).  The
plate's ``[H, W]`` phase map (cycles) is a parameter like any other, so
every pixel is trainable; it does not fit the fixed-width table row and
rides a side channel instead (``Scene.side_grids``), which the eager trace
loops and the fused kernels K1, K2, K5 and K6 read (core/physics.py::
phase_grid_dir; kernel K4 reads the corners).
"""

from __future__ import annotations

import numpy as np

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from .base import Element, compose_world, frame_params


class PhaseGridPlate(Element):
    """A traced ``[H, W]`` phase map (cycles) over the rectangular aperture
    ``[-half_x, half_x] x [-half_y, half_y]``, bilinearly interpolated: the
    'deep optics' design surface.  Every pixel is an optimizable parameter
    (``grid_grad=True`` by default).

    ``init`` seeds the map (a scalar or an ``[H, W]`` array, cycles);
    ``shape=(H, W)`` sets the resolution.  The ray takes the momentum-form
    grating kick of the map's gradient at its hit (core/physics.py::
    phase_grid_dir) at the order ``order`` and its own wavelength, or
    ``design_wavelength`` where that is unset."""

    def __init__(self, half_x, half_y, shape=(32, 32), init=0.0,
                 order=1, design_wavelength=0.5876, ior_in=1.0,
                 ior_out=1.0, grid_grad=True, name='phase_plate', **kw):
        super().__init__(name=name, **kw)
        if float(half_x) <= 0 or float(half_y) <= 0:
            raise ValueError('half_x/half_y must be positive')
        h, w = int(shape[0]), int(shape[1])
        if h < 2 or w < 2:
            raise ValueError(f'grid needs at least 2x2 pixels, got {shape}')
        if int(order) == 0:
            raise ValueError('order 0 is undiffracted — use a window')
        g0 = np.asarray(init, np.float32)
        if g0.ndim == 0:
            g0 = np.full((h, w), float(g0), np.float32)
        if g0.shape != (h, w):
            raise ValueError(f'init shape {g0.shape} != {shape}')
        self._hx, self._hy = float(half_x), float(half_y)
        self._g0 = g0
        self._order = int(order)
        self._lam0 = float(design_wavelength)
        self._n_in, self._n_out = float(ior_in), float(ior_out)
        self._grid_grad = bool(grid_grad)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'half_x': self._hx, 'half_y': self._hy,
                'grid': self._g0.copy(),
                'ior_in': self._n_in, 'ior_out': self._n_out}

    def extra_trainable(self):
        return {'half_x': False, 'half_y': False,
                'grid': self._grid_grad, 'ior_in': False,
                'ior_out': False}

    def phase_grid(self, p):
        """Side-channel hook (``Scene.side_grids``): the phase map."""
        return p['grid']

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.RECT,
                           sb=(p['half_x'], p['half_y']),
                           is_plane=True, ph_kind=PhysKind.PHASE_GRID,
                           ph=(p['ior_in'], p['ior_out'],
                               float(self._order), self._lam0,
                               p['half_x'], p['half_y']))]
