"""Polarization optics elements: linear polarizers and waveplates.

Counterpart of ``raytracetorch_tpu/elements/polarization.py``.  They act on
the E-field that ``track_field=True`` traces carry (core/field.py) through
the JONES physics kind: direction and intensity pass through, the
transverse field is multiplied by a Jones matrix whose eigen-axes lie at
``angle`` (radians from the element-local x axis, so rotating the element
rotates the optic).  Sensors weigh their flux by ``intensity * |E|^2``, so
Malus's law, crossed-polarizer extinction and waveplate conversion follow
from the ordinary trace.  ``angle`` and ``retardance`` are ordinary
parameters (``angle_grad``, ``retardance_grad``).

Tracing one of them without ``track_field=True`` raises
NotImplementedError: a polarizer has no per-ray intensity model for an
unpolarized ensemble.
"""

from __future__ import annotations

import math

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from ..utils.birefringence import WAVEPLATE_MATERIALS
from .base import Element, compose_world, frame_params


class _JonesPlate(Element):
    """A disk-bounded plane with JONES physics.  Its ``ph`` row: (angle
    rad, a1, a2, retardance rad, lam0 um): amplitude eigenvalues a1 and a2
    along the rotated axes, fast-axis phase -retardance / 2
    (core/field.py::transport_field)."""

    chromatic = False
    material = None

    def __init__(self, radius, angle=0.0, retardance_waves=0.0,
                 amp1=1.0, amp2=1.0, design_wavelength=0.5876,
                 angle_grad=False, retardance_grad=False,
                 name='jones', **kw):
        super().__init__(name=name, **kw)
        self._r_init = float(radius)
        self._angle_init = float(angle)
        self._ret_init = float(retardance_waves)
        self._amp1_init = float(amp1)
        self._amp2_init = float(amp2)
        self._lam0 = float(design_wavelength)
        self._angle_grad = bool(angle_grad)
        self._ret_grad = bool(retardance_grad)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'radius': self._r_init, 'angle': self._angle_init,
                'retardance': self._ret_init,
                'amp1': self._amp1_init, 'amp2': self._amp2_init}

    def extra_trainable(self):
        return {'radius': False, 'angle': self._angle_grad,
                'retardance': self._ret_grad,
                'amp1': False, 'amp2': False}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        delta = (2.0 * math.pi) * p['retardance']
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK, sb=(p['radius'] ** 2,),
                           is_plane=True, ph_kind=PhysKind.JONES,
                           ph=(p['angle'], p['amp1'], p['amp2'], delta,
                               self._lam0),
                           jones_chrom=self.chromatic,
                           jones_bire=self.material)]


class LinearPolarizer(_JonesPlate):
    """Ideal (or leaky) linear polarizer: transmission axis at ``angle``
    radians from the element-local x axis.  ``extinction`` is the intensity
    transmittance of the blocked axis (0: perfect); the blocked axis's
    amplitude is its square root."""

    def __init__(self, radius, angle=0.0, extinction=0.0,
                 angle_grad=False, name='polarizer', **kw):
        if not 0.0 <= float(extinction) <= 1.0:
            raise ValueError(
                f'extinction must be in [0, 1], got {extinction}')
        super().__init__(radius, angle=angle,
                         amp2=math.sqrt(float(extinction)),
                         angle_grad=angle_grad, name=name, **kw)


class Waveplate(_JonesPlate):
    """Linear retarder: fast axis at ``angle``, ``retardance`` in waves at
    the design wavelength (0.25 quarter-wave, 0.5 half-wave).

    ``chromatic=True`` models a true zero-order plate of a non-dispersive
    crystal: the retardance scales as design_wavelength / lam per ray.
    ``material='quartz' | 'MgF2' | 'calcite'`` adds the crystal's
    birefringence dispersion dn(lam) / dn(lam0) (utils/birefringence.py)
    and implies ``chromatic``."""

    def __init__(self, radius, retardance=0.25, angle=0.0,
                 chromatic=False, material=None,
                 design_wavelength=0.5876,
                 angle_grad=False, retardance_grad=False,
                 name='waveplate', **kw):
        if material is not None:
            mat = str(material).upper()
            if mat not in WAVEPLATE_MATERIALS:
                raise ValueError(
                    f'unknown waveplate material {material!r}; have '
                    f'{sorted(WAVEPLATE_MATERIALS)}')
            self.material = mat
            chromatic = True
        self.chromatic = bool(chromatic)
        super().__init__(radius, angle=angle, retardance_waves=retardance,
                         design_wavelength=design_wavelength,
                         angle_grad=angle_grad,
                         retardance_grad=retardance_grad, name=name, **kw)


class QuarterWaveplate(Waveplate):
    """Quarter-wave plate: at 45 degrees to a linear input it gives circular
    polarization."""

    def __init__(self, radius, angle=0.0, name='qwp', **kw):
        super().__init__(radius, retardance=0.25, angle=angle, name=name,
                         **kw)


class HalfWaveplate(Waveplate):
    """Half-wave plate: rotates a linear polarization at angle a to the fast
    axis by 2a."""

    def __init__(self, radius, angle=0.0, name='hwp', **kw):
        super().__init__(radius, retardance=0.5, angle=angle, name=name,
                         **kw)
