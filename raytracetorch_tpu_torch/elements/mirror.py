"""Mirror elements: the ideal spherical reflector.

Counterpart of ``raytracetorch_tpu/elements/mirror.py`` (``_MirrorBase``
and ``SphericalMirror``) for the ideal reflector only: ``metal=None``, no
coating, no roughness.  Metal and coated faces are ROADMAP Queue 1 item 12
(their complex-Fresnel physics); rough mirrors and the other mirror types
(cylindrical, parabolic, off-axis) are item 14.  Each of those options
raises NotImplementedError naming its item.
"""

from __future__ import annotations

from ..constants import PhysKind, SBKind
from ..core.static_dispatch import TODO_ELEMENTS, TODO_FEATURES
from ..core.table import SurfaceRec
from ..geom.surfaces import q_quadric
from ..geom.transform import mm
from .base import Element, compose_world, frame_params
from .ideal import paraxial_mirror_mat


class _MirrorBase(Element):
    """Shared mirror machinery: one reflecting face (``PhysKind.REFLECT``,
    R = 1 always) with curvature parameter ``c``.  ``ambient_ior`` and
    ``albedo`` are accepted as in the JAX package; the ideal reflector reads
    neither."""

    def __init__(self, metal=None, coating=None, coating_grad=False,
                 metal_dispersion=False, ambient_ior=1.0, roughness=None,
                 roughness_grad=False, albedo=1.0, **kw):
        super().__init__(**kw)
        if coating and metal is None:
            raise ValueError(
                "mirror coatings need a metal substrate (metal='Al', ... "
                "or an (n, k) pair) -- a dielectric stack on an ideal "
                "reflector has no effect")
        if roughness is not None and float(roughness) < 0.0:
            raise ValueError(f'roughness must be >= 0, got {roughness}')
        if not 0.0 <= float(albedo) <= 1.0:
            raise ValueError(f'albedo must be in [0, 1], got {albedo}')
        if metal is not None or coating or metal_dispersion:
            raise NotImplementedError(
                f'metal and coated mirrors are {TODO_FEATURES}')
        if roughness is not None:
            raise NotImplementedError(f'rough mirrors are {TODO_ELEMENTS}')
        self._ambient = float(ambient_ior)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'c': self._c_init}

    def extra_trainable(self):
        return {'c': self._c_grad}

    def R(self, p):
        return 1.0 / p['c']

    def f(self, p):
        return 1.0 / (2.0 * p['c'])

    def paraxial(self, p):
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        return [p['trans'][2]], [mm(t_inv, mm(paraxial_mirror_mat(
            p['c'], p['c']), t))]


class SphericalMirror(_MirrorBase):
    """Hemisphere-clipped spherical mirror with an optional aperture
    diameter (JAX ``SphericalMirror``).  The effective aperture follows
    the JAX package: an explicit ``diameter`` wins; else ``d`` when it is
    positive; else unbounded (1e18)."""

    def __init__(self, c1, d, diameter=float('inf'), c1_grad=False,
                 d_grad=False, diameter_grad=False, name='sph_mirror', **kw):
        super().__init__(name=name, **kw)
        self._c_init, self._c_grad = float(c1), c1_grad
        self._d_init, self._d_grad = float(d), d_grad
        self._diam_init, self._diam_grad = float(diameter), diameter_grad

    def extra_params(self):
        if self._diam_init != float('inf'):
            aperture = self._diam_init
        elif self._d_init > 0:
            aperture = self._d_init
        else:
            aperture = 1e18
        return {'c': self._c_init, 'd': self._d_init, 'diameter': aperture}

    def extra_trainable(self):
        return {'c': self._c_grad, 'd': self._d_grad,
                'diameter': self._diam_grad}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_quadric(p['c'], 0.0)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.HEMI_APER,
                           sb=(p['c'], (p['diameter'] / 2.0) ** 2),
                           ph_kind=PhysKind.REFLECT)]
