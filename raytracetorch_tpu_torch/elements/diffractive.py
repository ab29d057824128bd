"""Diffractive optical elements: the radial-phase kinoform and the
pixelated phase plate.

Counterpart of ``raytracetorch_tpu/elements/diffractive.py``:

- ``DiffractiveLens``, a flat disk whose radial phase profile phi(r) = c1
  r^2 + c2 r^4 + ... (cycles; c_k in cycles/mm^(2k)) bends rays by the
  vector grating equation in optical-momentum form (core/physics.py::
  doe_dir).  Its power scales as lam / lam0 (Abbe number lam_d / (lam_F -
  lam_C) = -3.452), so a weak DOE of the same sign cancels a refractive
  singlet's chromatic focal shift: the hybrid achromat.  The coefficient
  vector ``phase`` rides the table row's ``ff`` columns (its term count is
  static metadata), so the fused kernels K1, K2, K5 and K6 take it, and
  ``phase_grad=True`` makes the profile designable.
- ``PhaseGridPlate``, whose ``[H, W]`` phase map (cycles) is a parameter
  like any other, so every pixel is trainable; it does not fit the
  fixed-width table row and rides a side channel instead
  (``Scene.side_grids``), which the eager trace loops and the fused kernels
  read (core/physics.py::phase_grid_dir; kernel K4 reads the corners).
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_FF_TERMS, PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from ..geom.transform import mm
from .base import Element, compose_world, frame_params


class DiffractiveLens(Element):
    """Radial-phase kinoform on a flat disk of ``radius``.

    Construct EITHER from a focal length ``f`` (at the design wavelength,
    order ``order``), which sets the single r^2 coefficient c1 = -1 / (2 m
    lam0_mm f), or from an explicit coefficient list ``coeffs=[c1, c2,
    ...]`` (cycles/mm^(2k), 1 to 8 terms).  ``efficiency=True`` multiplies
    the intensity by the scalar kinoform efficiency sinc^2(lam0/lam - m)."""

    def __init__(self, radius, f=None, coeffs=None, order=1,
                 design_wavelength=0.5876, ior_in=1.0, ior_out=1.0,
                 efficiency=False, phase_grad=False, name='doe', **kw):
        super().__init__(name=name, **kw)
        if (f is None) == (coeffs is None):
            raise ValueError('give exactly one of f= or coeffs=')
        if float(radius) <= 0:
            raise ValueError('radius must be positive')
        if int(order) == 0:
            raise ValueError('order 0 is undiffracted — use a window')
        lam0 = float(design_wavelength)
        if coeffs is None:
            if float(f) == 0.0:
                raise ValueError('f must be nonzero')
            coeffs = [-1.0 / (2.0 * int(order) * lam0 * 1e-3 * float(f))]
        coeffs = [float(c) for c in coeffs]
        if not 1 <= len(coeffs) <= min(8, MAX_FF_TERMS):
            raise ValueError(f'1..8 radial terms, got {len(coeffs)}')
        self._r_init = float(radius)
        self._coeffs_init = coeffs
        self._order = int(order)
        self._lam0 = lam0
        self._n_in = float(ior_in)
        self._n_out = float(ior_out)
        self.efficiency = bool(efficiency)
        self._phase_grad = bool(phase_grad)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'radius': self._r_init,
                'phase': np.asarray(self._coeffs_init, np.float32),
                'ior_in': self._n_in, 'ior_out': self._n_out}

    def extra_trainable(self):
        return {'radius': False, 'phase': self._phase_grad,
                'ior_in': False, 'ior_out': False}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        n_terms = len(self._coeffs_init)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK, sb=(p['radius'] ** 2,),
                           is_plane=True, ph_kind=PhysKind.DOE,
                           ph=(p['ior_in'], p['ior_out'],
                               float(self._order), self._lam0, 0.0, 0.0),
                           ff=tuple(p['phase'][i] for i in range(n_terms)),
                           doe=(n_terms, self.efficiency))]

    def paraxial(self, p):
        """Thin-lens matrix of the design-wavelength power P = -2 m lam0_mm
        c1 (the higher radial terms are beyond paraxial)."""
        from .ideal import paraxial_lens_mat
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        power = -2.0 * self._order * self._lam0 * 1e-3 * p['phase'][0]
        return ([p['trans'][2]],
                [mm(t_inv, mm(paraxial_lens_mat(power, power), t))])

    def focal_length(self, wavelength_um=None):
        """Nominal first-order focal length at ``wavelength_um`` (the
        design wavelength by default): f(lam) = f0 lam0 / lam."""
        lam = self._lam0 if wavelength_um is None else float(wavelength_um)
        f0 = -1.0 / (2.0 * self._order * self._lam0 * 1e-3
                     * self._coeffs_init[0])
        return f0 * self._lam0 / lam


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
