"""Mirror elements: the spherical, cylindrical, parabolic, conic, aspheric,
Mangin and off-axis parabolic reflectors.

Counterpart of ``raytracetorch_tpu/elements/mirror.py``.  Every mirror
shares ``_MirrorBase``: an ideal reflector (``metal=None``, R = 1), or a
metal substrate (a name of utils/coatings.py::METALS or an (n, k) pair)
that reflects with the complex-Fresnel reflectance, optionally under a
thin-film ``coating`` (trainable thicknesses ``coat_d``) and with the
metal's tabulated dispersion (``metal_dispersion=True``).  Rough mirrors
(``roughness=``, a SCATTER row) are ROADMAP Queue 1 item 14 and raise
NotImplementedError.
"""

from __future__ import annotations

import math

import torch

from ..constants import MAX_COAT_LAYERS, PhysKind, SBKind, VBKind
from ..core.static_dispatch import TODO_ELEMENTS
from ..core.table import SurfaceRec
from ..geom.surfaces import q_cylinder, q_quadric, q_quadric_zy, sag_z
from ..geom.transform import mm
from ..utils.coatings import METAL_NK, METALS, parse_coating_entries
from .base import Element, compose_world, frame_params, zvec
from .ideal import (paraxial_dist_mat, paraxial_mirror_mat,
                    paraxial_refract_mat)


class _MirrorBase(Element):
    """Shared mirror machinery: one reflecting face (``PhysKind.REFLECT``)
    with curvature parameter ``c``.

    - ``metal=None``: the ideal reflector (R = 1); or a metal name ('Al',
      'Ag', 'Au', 'Cu') or an explicit (n, k) pair: the face reflects with
      the unpolarized complex-Fresnel reflectance of the metal.
    - ``coating=[(n, d_um), ...]``: a thin-film stack on the metal,
      outermost first (absorbing layers as ``(n, k, d_um)`` or ``('Ag',
      d_um)``); its thicknesses are the parameter ``coat_d``, trainable with
      ``coating_grad``.  Needs ``metal``.
    - ``metal_dispersion=True`` (a named metal): the substrate's (n, k)
      follow each ray's wavelength on the metal's METAL_NK knots.
    - ``ambient_ior``: the index of the medium the mirror sits in.
    - ``roughness`` raises NotImplementedError (a SCATTER lobe, ROADMAP
      Queue 1 item 14); ``albedo`` is checked and read by it alone."""

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
        if roughness is not None and metal is not None:
            raise NotImplementedError(
                'roughness + metal reflectance on one face is not '
                'modeled -- approximate the metal loss with albedo=R')
        if not 0.0 <= float(albedo) <= 1.0:
            raise ValueError(f'albedo must be in [0, 1], got {albedo}')
        if roughness is not None:
            raise NotImplementedError(f'rough mirrors are {TODO_ELEMENTS}')
        self._metal_nk = None
        if metal_dispersion:
            if not isinstance(metal, str):
                raise ValueError(
                    "metal_dispersion=True needs a NAMED metal (one of "
                    f"{sorted(METAL_NK)}) -- an explicit (n, k) pair has no "
                    "tabulated dispersion")
            self._metal_nk = METAL_NK[metal.upper()]
        if isinstance(metal, str):
            metal = METALS[metal.upper()]
        self._metal = ((float(metal[0]), float(metal[1]))
                       if metal is not None else None)
        self._ambient = float(ambient_ior)
        if coating:
            if len(coating) > MAX_COAT_LAYERS:
                raise ValueError(
                    f"at most {MAX_COAT_LAYERS} coating layers per surface")
            ns, ks, ds = parse_coating_entries(coating)
            self.coating_n = ns
            self.coating_k = ks if any(k != 0.0 for k in ks) else None
            self._coat_d_init = ds
            self._coat_grad = coating_grad

    def init_params(self, device, dtype=torch.float32):
        p = super().init_params(device, dtype)
        if getattr(self, 'coating_n', None):
            p['coat_d'] = torch.tensor(self._coat_d_init, dtype=dtype,
                                       device=device)
        return p

    def trainable(self):
        t = super().trainable()
        if getattr(self, 'coating_n', None):
            t['coat_d'] = self._coat_grad
        return t

    def _phys_rec_kwargs(self, p):
        """Physics fields of the reflecting face for SurfaceRec."""
        if self._metal is None:
            return dict(ph_kind=PhysKind.REFLECT)
        n_m, k_m = self._metal
        ns = getattr(self, 'coating_n', None)
        coat = []
        for li, nl in enumerate(ns or ()):
            coat += [nl, p['coat_d'][li]]
        return dict(ph_kind=PhysKind.REFLECT, ph=(n_m, k_m, self._ambient),
                    coat=coat, n_coat=len(ns or ()), is_metal=True,
                    metal_nk=self._metal_nk,
                    coat_k=getattr(self, 'coating_k', None))

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

    def _mirror_mat(self, p):
        return paraxial_mirror_mat(p['c'], p['c'])

    def paraxial(self, p):
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        return [p['trans'][2]], [mm(t_inv, mm(self._mirror_mat(p), t))]


def _aperture_bound(p, d_init, hemi):
    """The face bound of a mirror with a hemisphere clip ``hemi``: with an
    aperture (``d > 0``) HEMI_APER, else HEMI."""
    if d_init > 0:
        return SBKind.HEMI_APER, (hemi, (p['d'] / 2.0) ** 2)
    return SBKind.HEMI, (hemi,)


def _disk_bound(p, d_init):
    """The face bound of a paraboloid: a disk of the aperture (``d > 0``),
    else none."""
    if d_init > 0:
        return SBKind.DISK, ((p['d'] / 2.0) ** 2,)
    return SBKind.NONE, ()


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
                           **self._phys_rec_kwargs(p))]


class _ApertureMirror(_MirrorBase):
    """A mirror with curvature ``c1`` and aperture diameter ``d``."""

    def __init__(self, c1, d, c1_grad=False, d_grad=False, **kw):
        super().__init__(**kw)
        self._c_init, self._c_grad = float(c1), c1_grad
        self._d_init, self._d_grad = float(d), d_grad

    def extra_params(self):
        return {'c': self._c_init, 'd': self._d_init}

    def extra_trainable(self):
        return {'c': self._c_grad, 'd': self._d_grad}

    def _rec(self, p, q, sign, sb_kind, sb, **extra):
        Re, te = frame_params(p)
        Rw, tw, Rs, ts = compose_world(Re, te)
        return SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                          sb_kind=sb_kind, sb=sb, **extra,
                          **self._phys_rec_kwargs(p))


class CylindricalMirror(_ApertureMirror):
    """Cylindrical mirror: curves in y, invariant in x (JAX
    ``CylindricalMirror``); ``d > 0`` bounds it with HEMI_APER, else
    HEMI."""

    def __init__(self, c1, d, c1_grad=False, d_grad=False,
                 name='cyl_mirror', **kw):
        super().__init__(c1, d, c1_grad, d_grad, name=name, **kw)

    def build(self, p):
        q, sign = q_quadric_zy(p['c'], 0.0)
        return [self._rec(p, q, sign,
                          *_aperture_bound(p, self._d_init, p['c']))]

    def _mirror_mat(self, p):
        return paraxial_mirror_mat(torch.zeros_like(p['c']), p['c'])


class ParabolicMirror(_ApertureMirror):
    """Paraboloid of revolution, the quadric with k = -1 (JAX
    ``ParabolicMirror``); ``d > 0`` bounds it to a disk of that
    diameter."""

    def __init__(self, c1, d, c1_grad=False, d_grad=False,
                 name='parabolic_mirror', **kw):
        super().__init__(c1, d, c1_grad, d_grad, name=name, **kw)

    def build(self, p):
        q, sign = q_quadric(p['c'], -1.0)
        return [self._rec(p, q, sign, *_disk_bound(p, self._d_init))]


class ParabolicMirrorXZ(_ApertureMirror):
    """Parabolic trough focusing in x: QuadricZY(k=-1) turned 90 degrees
    about z (JAX ``ParabolicMirrorXZ``: the fixed 90-degree frame replaces
    the user's rotation; only the translation is kept)."""

    def __init__(self, c1, d, c1_grad=False, d_grad=False,
                 name='parabolic_mirror_xz', **kw):
        super().__init__(c1, d, c1_grad, d_grad, name=name, **kw)
        self._rot_init = [0.0, 0.0, math.pi / 2.0]

    def build(self, p):
        q, sign = q_quadric_zy(p['c'], -1.0)
        return [self._rec(p, q, sign, *_disk_bound(p, self._d_init))]

    def _mirror_mat(self, p):
        return paraxial_mirror_mat(p['c'], torch.zeros_like(p['c']))


class ConicMirror(_MirrorBase):
    """Conic-of-revolution mirror: curvature ``c1`` and conic constant
    ``k`` (JAX ``ConicMirror``: 0 sphere, -1 < k < 0 prolate ellipsoid, -1
    paraboloid, k < -1 hyperboloid).  The face is clipped to its vertex
    sheet by the hemisphere bound |z c (1 + k)| < 1 (HEMI, or HEMI_APER with
    ``d > 0``), so a non-sequential trace never meets the far sheet."""

    def __init__(self, c1, k, d, c1_grad=False, k_grad=False,
                 d_grad=False, name='conic_mirror', **kw):
        super().__init__(name=name, **kw)
        self._c_init, self._c_grad = float(c1), c1_grad
        self._k_init, self._k_grad = float(k), k_grad
        self._d_init, self._d_grad = float(d), d_grad

    def extra_params(self):
        return {'c': self._c_init, 'k': self._k_init, 'd': self._d_init}

    def extra_trainable(self):
        return {'c': self._c_grad, 'k': self._k_grad, 'd': self._d_grad}

    def _recs(self, p, **extra):
        Re, te = frame_params(p)
        q, sign = q_quadric(p['c'], p['k'])
        Rw, tw, Rs, ts = compose_world(Re, te)
        sb_kind, sb = _aperture_bound(p, self._d_init,
                                      p['c'] * (1.0 + p['k']))
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=sb_kind, sb=sb, **extra,
                           **self._phys_rec_kwargs(p))]

    def build(self, p):
        return self._recs(p)


class AsphericMirror(ConicMirror):
    """Even-asphere mirror: a conic base plus a4 r^4 .. a10 r^10 (``a``,
    up to four coefficients, JAX ``AsphericMirror``), its roots refined and
    its normal taken as an ``AsphericLens`` face's."""

    def __init__(self, c1, d, k=0.0, a=(), a_grad=False,
                 name='aspheric_mirror', **kw):
        super().__init__(c1, k, d, name=name, **kw)
        a = [float(v) for v in a]
        if len(a) > 4:
            raise ValueError(
                f'at most four even-asphere coefficients (r^4..r^10), '
                f'got {len(a)}')
        self._a_init = a + [0.0] * (4 - len(a))
        self._a_grad = bool(a_grad)

    def extra_params(self):
        p = super().extra_params()
        p['a'] = self._a_init
        return p

    def extra_trainable(self):
        t = super().extra_trainable()
        t['a'] = self._a_grad
        return t

    def param_scales(self):
        """Natural optimization magnitudes, as AsphericLens.param_scales."""
        r = max(self._d_init / 2.0, 1e-6)
        return {'a': [r ** -(2 * i + 4) for i in range(4)]}

    def build(self, p):
        return self._recs(p, asph=tuple(p['a'][j] for j in range(4)),
                          is_asphere=True)


class ManginMirror(_MirrorBase):
    """Mangin mirror: a meniscus whose back face is silvered (JAX
    ``ManginMirror``).  Four rows trace the double pass in one sequential
    pass: the front face (SNELL, media -> glass), the back face (REFLECT,
    ideal or the metal with the GLASS as its ambient medium), the front
    face again (glass -> media) and the edge cylinder (BLOCK).  The
    non-sequential trace needs no special case: the repeated front row is
    geometrically the first, and the winner merge (the first of equal
    distances wins) takes the first."""

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 c1_grad=False, c2_grad=False, t_grad=False,
                 ior_glass_grad=False, name='mangin', **kw):
        super().__init__(name=name, **kw)
        from .lens import _validate_faces
        _validate_faces([c1, c2], [t], d / 2.0, [-t / 2.0, t / 2.0])
        self._c1_init, self._c1_grad = float(c1), c1_grad
        self._c2_init, self._c2_grad = float(c2), c2_grad
        self._d_init = float(d)
        self._t_init, self._t_grad = float(t), t_grad
        self._n_init, self._n_grad = float(ior_glass), ior_glass_grad
        self._media = float(ior_media)

    @property
    def n_surfaces(self):
        return 4

    def extra_params(self):
        return {'c1': self._c1_init, 'c2': self._c2_init,
                'd': self._d_init, 't': self._t_init,
                'ior_glass': self._n_init}

    def extra_trainable(self):
        return {'c1': self._c1_grad, 'c2': self._c2_grad, 'd': False,
                't': self._t_grad, 'ior_glass': self._n_grad}

    def build(self, p):
        Re, te = frame_params(p)
        r = p['d'] / 2.0
        z1, z2 = -p['t'] / 2.0, p['t'] / 2.0
        n_g, n_m = p['ior_glass'], self._media

        def face(c, zv, ph_kind, ph, **extra):
            q, sign = q_quadric(c, 0.0)
            Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(zv))
            return SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                              sb_kind=SBKind.HEMI, sb=(c,),
                              vb_kind=VBKind.APER_R2, vb=(r * r,),
                              ph_kind=ph_kind, ph=ph, **extra)

        # the back face: the ideal REFLECT, or the metal seen from the glass
        back_kw = self._phys_rec_kwargs(p)
        if back_kw.get('is_metal'):
            n_metal, k_metal = self._metal
            back_kw['ph'] = (n_metal, k_metal, n_g)
        recs = [
            face(p['c1'], z1, PhysKind.SNELL, (n_g, n_m)),
            face(p['c2'], z2, back_kw.pop('ph_kind'), back_kw.pop('ph', ()),
                 **back_kw),
            face(p['c1'], z1, PhysKind.SNELL, (n_g, n_m)),
        ]
        q, sign = q_cylinder(r)
        Rw, tw, Rs, ts = compose_world(Re, te)
        recs.append(SurfaceRec(
            q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
            vb_kind=VBKind.Z_BETWEEN,
            vb=(sag_z(p['c1'], r) + z1, sag_z(p['c2'], r) + z2),
            ph_kind=PhysKind.BLOCK, ph=(n_m, n_g)))
        return recs

    def paraxial(self, p):
        """One equivalent mirror matrix at the front vertex, composed in the
        path frame (refract, travel t, the back mirror, travel t, refract
        back), then the slope flip of the plain mirror's reversed-beam
        convention (JAX ``ManginMirror.paraxial``)."""
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        z1 = p['trans'][2] - p['t'] / 2.0
        n_g, n_m = p['ior_glass'], self._media
        m = paraxial_refract_mat(p['c1'], p['c1'], n_m, n_g)
        m = mm(paraxial_dist_mat(p['t']), m)
        m = mm(paraxial_mirror_mat(-p['c2'], -p['c2']), m)
        m = mm(paraxial_dist_mat(p['t']), m)
        m = mm(paraxial_refract_mat(-p['c1'], -p['c1'], n_g, n_m), m)
        flip = torch.diag(torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0],
                                       dtype=m.dtype, device=m.device))
        m = mm(flip, m)
        return [z1], [mm(t_inv, mm(m, t))]

    def optical_zs(self, p):
        z0 = p['trans'][2]
        return [z0 - p['t'] / 2.0, z0 + p['t'] / 2.0]


class ParabolicMirrorOffAxis(_MirrorBase):
    """Off-axis parabolic segment (JAX ``ParabolicMirrorOffAxis``): the
    parent paraboloid bounded by a disk of diameter ``d`` decentred by
    ``off_axis`` along +y (the DISK bound's offset); the element frame sits
    at the parent vertex."""

    def __init__(self, c1, d, off_axis, c1_grad=False, d_grad=False,
                 off_axis_grad=False, name='oap', **kw):
        super().__init__(name=name, **kw)
        self._c_init, self._c_grad = float(c1), c1_grad
        self._d_init, self._d_grad = float(d), d_grad
        self._off_init, self._off_grad = float(off_axis), off_axis_grad

    def extra_params(self):
        return {'c': self._c_init, 'd': self._d_init,
                'off_axis': self._off_init}

    def extra_trainable(self):
        return {'c': self._c_grad, 'd': self._d_grad,
                'off_axis': self._off_grad}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_quadric(p['c'], -1.0)
        Rw, tw, Rs, ts = compose_world(Re, te)
        zero = p['c'] * 0.0
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=SBKind.DISK,
                           sb=((p['d'] / 2.0) ** 2, zero, p['off_axis']),
                           **self._phys_rec_kwargs(p))]
