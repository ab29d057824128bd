"""Thick lenses: the spherical singlet, doublet and triplet, the cylindrical
singlet, the even-asphere singlet, the freeform and Zernike singlets, and
the wedge prism.

Counterpart of ``raytracetorch_tpu/elements/lens.py`` (``_SphericLens``,
``SingletLens``, ``DoubletLens``, ``TripletLens``, ``CylSingletLens``,
``AsphericLens``, ``FreeformLens``, ``ZernikeLens`` and ``WedgePrism``).
Optical
faces are hemisphere-clipped quadrics bounded by the lens aperture; the edges
are cylinders bounded between the adjacent faces' sag heights (a cylindrical
lens: four side planes bounded between the faces' y-dependent sags).  Each
surface's physics carries ``(ior_normal_side, ior_far_side)``: faces have +z
normals, the edge an outward normal.

Glasses may disperse: an Abbe number (``abbe_vd*``, the 2-term Cauchy
model) or 3-term Sellmeier coefficients (``sellmeier*``,
utils/glass.py::glass) per medium put the model and its coefficients into
the face's ``disp`` columns, read per ray by
core/static_dispatch.py::dispersive_iors.
"""

from __future__ import annotations

import math

import torch

from ..constants import (MAX_COAT_LAYERS, MAX_FF_TERMS, DispModel, PhysKind,
                         SBKind, VBKind)
from ..core.table import SurfaceRec
from ..geom.surfaces import q_cylinder, q_plane, q_quadric, q_quadric_zy, sag_z
from ..geom.transform import mm, rodrigues
from ..geom.zernike import zernike_monomial_map
from ..utils.coatings import parse_coating_entries
from .base import Element, compose_world, frame_params, zvec
from .ideal import paraxial_refract_mat


def _sag_float(c, r):
    term = max(1.0 - c * c * r * r, 0.0)
    return (c * r * r) / (1.0 + math.sqrt(term))


# Cauchy 2-term model n(l) = n_d + B (1/l^2 - 1/l_d^2): the Abbe number
# v_d = (n_d - 1)/(n_F - n_C) with F/C lines 0.4861/0.6563 um gives
# B = (n_d - 1) / (v_d * (1/l_F^2 - 1/l_C^2)).
_ABBE_FC = 1.0 / 0.4861 ** 2 - 1.0 / 0.6563 ** 2


def abbe_to_cauchy_b(n_d, v_d):
    """Cauchy B (um^2) from a d-line index and an Abbe number."""
    return (n_d - 1.0) / (v_d * _ABBE_FC)


def _disp_rec(dc, i_norm, i_far):
    """(disp 12-vector, disp_model pair, is_dispersive) of one optical face
    from a per-medium dispersion chain ``dc`` (``_SphericLens._disp_chain``);
    the face's physics is ph=(iors[i_norm], iors[i_far]), so the table's
    [in 6 | out 6] layout pairs dc[i_norm] with the in side."""
    if dc is None:
        return (), (0, 0), False

    def pad6(c):
        c = list(c)
        return c + [0.0] * (6 - len(c))

    m_in, c_in = dc[i_norm]
    m_out, c_out = dc[i_far]
    return (tuple(pad6(c_in) + pad6(c_out)),
            (int(m_in), int(m_out)), bool(m_in or m_out))


def _fresnel_option(fresnel):
    """The ``fresnel`` option of a lens: False (SNELL), True (the
    Monte-Carlo FRESNEL branch draw) or 'weighted' (FRESNEL_W)."""
    if fresnel not in (False, True, 'weighted'):
        raise ValueError(f"fresnel must be False, True or 'weighted', got "
                         f"{fresnel!r}")
    return fresnel


def _validate_faces(curvatures, thicknesses, aperture_r, z_list):
    """Constructor-time physicality checks."""
    for i, c in enumerate(curvatures):
        if abs(0.5 * c) > 1.0 / (2.0 * aperture_r):
            raise ValueError(f"|R{i+1}| must be larger than D/2")
    for i, t in enumerate(thicknesses):
        if t <= 1e-6:
            raise ValueError(f"Thickness T{i+1} must be positive")
    sags = [_sag_float(c, aperture_r) + z for c, z in zip(curvatures, z_list)]
    for i in range(len(sags) - 1):
        if sags[i] > sags[i + 1]:
            raise ValueError(f"Optical surfaces {i+1} and {i+2} intersect")


class _SphericLens(Element):
    """Shared machinery for spherical lens stacks.  Subclasses define
    ``_curv_names`` / ``_thick_names`` / ``_ior_chain``."""

    _curv_names: tuple = ()
    _thick_names: tuple = ()

    def _vertex_zs(self, p):
        """Cumulative vertex z's centred on the element."""
        ts = [p[n] for n in self._thick_names]
        z = -sum(ts) / 2.0
        zs = [z]
        for t in ts:
            z = z + t
            zs.append(z)
        return zs

    def _ior_chain(self, p):
        raise NotImplementedError

    @property
    def n_optical(self):
        return len(self._curv_names)

    @property
    def n_surfaces(self):
        return 2 * self.n_optical - 1   # faces + edges

    fresnel = False

    def _refract_kind(self):
        """The optical faces' physics: SNELL, or with ``fresnel=True`` the
        Monte-Carlo FRESNEL draw, with ``fresnel='weighted'`` FRESNEL_W."""
        if self.fresnel == 'weighted':
            return PhysKind.FRESNEL_W
        return PhysKind.FRESNEL if self.fresnel else PhysKind.SNELL

    def _set_coating(self, coating, coating_grad):
        """Thin-film stacks on the optical faces (JAX ``_set_coating``).

        - a list ``[(index, thickness_um), ...]`` (outermost, air side
          first) coats both external faces, which share one trainable
          thickness vector ``coat_d``;
        - a dict ``{face: [(n, d_um), ...]}`` coats each named face
          (cemented interfaces included, such as a doublet's face 1), each
          with its own thickness vector ``coat_d[str(face)]``.

        Layers may absorb: ``(n, k, d_um)`` or a named metal film ``('Ag',
        d_um)`` (utils/coatings.py::parse_coating_entries).  The indices are
        static; the thicknesses are the trainable ``coat_d``.  A stack acts
        on the intensity only through the Fresnel kinds (``fresnel=True``
        or ``'weighted'``); under SNELL it is carried and ignored."""
        if not coating:
            return
        if isinstance(coating, dict):
            faces = {int(f): list(st) for f, st in coating.items()}
            for f in faces:
                if not 0 <= f < self.n_optical:
                    raise ValueError(
                        f"coating face index {f} out of range "
                        f"(element has {self.n_optical} optical faces)")
            self._coat_per_face = True
        else:
            faces = {f: list(coating) for f in {0, self.n_optical - 1}}
            self._coat_per_face = False
        for st in faces.values():
            if len(st) > MAX_COAT_LAYERS:
                raise ValueError(
                    f"at most {MAX_COAT_LAYERS} coating layers per surface")
        parsed = {f: parse_coating_entries(st) for f, st in faces.items()}
        self.coating_n = {f: ns for f, (ns, _, _) in parsed.items()}
        # static per-layer extinction (absorbing films; None: dielectric)
        self.coating_k = {f: (ks if any(k != 0.0 for k in ks) else None)
                          for f, (_, ks, _) in parsed.items()}
        if self._coat_per_face:
            self._init['coat_d'] = {str(f): ds
                                    for f, (_, _, ds) in parsed.items()}
        else:
            self._init['coat_d'] = parsed[0][2]
        self._grads['coat_d'] = coating_grad

    def _face_coat(self, p, i):
        """(coat interleave list, n_coat, coat_k) of optical face ``i``."""
        coat_ns = getattr(self, 'coating_n', None)
        if not coat_ns or i not in coat_ns:
            return [], 0, None
        ds = p['coat_d'][str(i)] if self._coat_per_face else p['coat_d']
        coat = []
        for li, nl in enumerate(coat_ns[i]):
            coat += [nl, ds[li]]
        return coat, len(coat_ns[i]), self.coating_k[i]

    def _edge_phys(self, p):
        iors = self._ior_chain(p)
        return PhysKind.BLOCK, (iors[0], iors[1])

    def _b_chain(self, p):
        """Cauchy B per medium (parallel to ``_ior_chain``), or None: no
        Abbe numbers.  Subclasses with Abbe numbers override."""
        return None

    def _sellmeier_chain(self):
        """Per-medium Sellmeier coefficient tuples (B1 B2 B3 C1 C2 C3,
        um^2), parallel to ``_ior_chain``, from the ``sellmeier*`` keyword
        arguments; None entries fall back to the Abbe/Cauchy model or a
        constant index.  None: no Sellmeier glass."""
        return getattr(self, '_sellmeier_media', None)

    def _disp_chain(self, p):
        """Per-medium (DispModel, coefficients) pairs, or None when no
        medium disperses.  A Sellmeier glass takes precedence over an Abbe
        number."""
        sell = self._sellmeier_chain()
        bs = self._b_chain(p)
        if sell is None and bs is None:
            return None
        out = []
        for i in range(len(self._ior_chain(p))):
            si = sell[i] if sell is not None else None
            if si is not None:
                out.append((DispModel.SELLMEIER, tuple(si)))
            elif bs is not None:
                out.append((DispModel.CAUCHY, (bs[i],)))
            else:
                out.append((DispModel.NONE, ()))
        return out

    def build(self, p):
        Re, te = frame_params(p)
        r = p['radius']
        zs = self._vertex_zs(p)
        cs = [p[n] for n in self._curv_names]
        iors = self._ior_chain(p)
        kind = self._refract_kind()
        dc = self._disp_chain(p)
        recs = []
        for i, (c, zv) in enumerate(zip(cs, zs)):
            q, sign = q_quadric(c, 0.0)
            Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(zv))
            disp, dm, isd = _disp_rec(dc, i + 1, i)
            coat, n_coat, coat_k = self._face_coat(p, i)
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                sb_kind=SBKind.HEMI, sb=(c,),
                vb_kind=VBKind.APER_R2, vb=(r * r,),
                ph_kind=kind, ph=(iors[i + 1], iors[i]),
                disp=disp, disp_model=dm, is_dispersive=isd,
                coat=coat, n_coat=n_coat, coat_k=coat_k))
        edge_kind, edge_ph = self._edge_phys(p)
        for i in range(self.n_optical - 1):
            q, sign = q_cylinder(r)
            Rw, tw, Rs, ts = compose_world(Re, te)
            z_lo = sag_z(cs[i], r) + zs[i]
            z_hi = sag_z(cs[i + 1], r) + zs[i + 1]
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                vb_kind=VBKind.Z_BETWEEN, vb=(z_lo, z_hi),
                ph_kind=edge_kind, ph=edge_ph))
        return recs

    def paraxial(self, p):
        """Per-face refraction matrices at the vertex z's, wrapped in the
        element decenter shifts."""
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        zs = self._vertex_zs(p)
        cs = [p[n] for n in self._curv_names]
        iors = self._ior_chain(p)
        z0 = p['trans'][2]
        Zs = [z0 + zv for zv in zs]
        mats = [mm(t_inv, mm(paraxial_refract_mat(c, c, iors[i],
                                                  iors[i + 1]), t))
                for i, c in enumerate(cs)]
        return Zs, mats

    def optical_zs(self, p):
        z0 = p['trans'][2]
        return [z0 + zv for zv in self._vertex_zs(p)]


class SingletLens(_SphericLens):
    """Biconvex/meniscus singlet: 2 refracting faces + edge cylinder.

    ``d`` is the diameter and ``t`` the centre thickness.  The glass
    disperses with an Abbe number ``abbe_vd`` or Sellmeier coefficients
    ``sellmeier`` (``**glass(name, model)``).  ``fresnel=True`` makes the
    faces' physics the Monte-Carlo FRESNEL branch draw (a trace then needs a
    generator), ``fresnel='weighted'`` the deterministic FRESNEL_W.
    ``coating`` puts thin-film stacks on its faces (``_set_coating``; their
    thicknesses ``coat_d`` train with ``coating_grad``)."""

    _curv_names = ('c1', 'c2')
    _thick_names = ('t',)

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 c1_grad=False, c2_grad=False, t_grad=False, d_grad=False,
                 ior_glass_grad=False, ior_media_grad=False,
                 abbe_vd=None, sellmeier=None, coating=None,
                 coating_grad=False, fresnel=False, inked=False,
                 name='singlet', **kw):
        super().__init__(name=name, **kw)
        self.fresnel = _fresnel_option(fresnel)
        self.abbe_vd = abbe_vd
        self.sellmeier = tuple(sellmeier) if sellmeier is not None else None
        if self.sellmeier is not None:
            self._sellmeier_media = [None, self.sellmeier, None]
        _validate_faces([c1, c2], [t], d / 2.0, [-t / 2.0, t / 2.0])
        self._init = dict(c1=c1, c2=c2, t=t, radius=d / 2.0,
                          ior_glass=ior_glass, ior_media=ior_media)
        self._grads = dict(c1=c1_grad, c2=c2_grad, t=t_grad, radius=d_grad,
                           ior_glass=ior_glass_grad,
                           ior_media=ior_media_grad)
        self._set_coating(coating, coating_grad)
        self.inked = inked

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _ior_chain(self, p):
        return [p['ior_media'], p['ior_glass'], p['ior_media']]

    def _b_chain(self, p):
        if self.abbe_vd is None:
            return None
        b = abbe_to_cauchy_b(p['ior_glass'], self.abbe_vd)
        zero = b * 0.0
        return [zero, b, zero]

    def _edge_phys(self, p):
        """The edge refracts unless inked; its normal points outward."""
        if self.inked:
            return PhysKind.BLOCK, ()
        return self._refract_kind(), (p['ior_media'], p['ior_glass'])

    # -- thick-lens analytics ----------------------------------------------

    def power1(self, p):
        return p['c1'] * (p['ior_glass'] - p['ior_media'])

    def power2(self, p):
        return p['c2'] * (p['ior_media'] - p['ior_glass'])

    def power(self, p):
        p1, p2 = self.power1(p), self.power2(p)
        return p1 + p2 - p1 * p2 * p['t'] / p['ior_glass']

    def f(self, p):
        return 1.0 / self.power(p)

    def f_bfl(self, p):
        return self.f(p) * (1.0 - p['t'] * self.power1(p) / p['ior_glass'])

    def f_ffl(self, p):
        return -self.f(p) * (1.0 - p['t'] * self.power2(p) / p['ior_glass'])

    def R1(self, p):
        return 1.0 / p['c1']

    def R2(self, p):
        return -1.0 / p['c2']


class DoubletLens(_SphericLens):
    """Cemented doublet: 3 refracting faces + 2 blocked edge cylinders.
    Glass 1 (between faces 1 and 2) and glass 2 (between faces 2 and 3)
    disperse with Abbe numbers ``abbe_vd1``/``abbe_vd2`` or Sellmeier
    coefficients ``sellmeier1``/``sellmeier2`` (``**glass_pair(crown,
    flint, model)``).  ``fresnel`` and coatings as for ``SingletLens``."""

    _curv_names = ('c1', 'c2', 'c3')
    _thick_names = ('t1', 't2')

    def __init__(self, c1, c2, c3, d, t1, t2, ior_glass1, ior_glass2,
                 ior_media=1.0, c1_grad=False, c2_grad=False, c3_grad=False,
                 t1_grad=False, t2_grad=False, d_grad=False,
                 ior_glass1_grad=False, ior_glass2_grad=False,
                 ior_media_grad=False, abbe_vd1=None, abbe_vd2=None,
                 sellmeier1=None, sellmeier2=None, coating=None,
                 coating_grad=False, fresnel=False, name='doublet', **kw):
        super().__init__(name=name, **kw)
        self.fresnel = _fresnel_option(fresnel)
        self.abbe_vd1, self.abbe_vd2 = abbe_vd1, abbe_vd2
        self.sellmeier1 = (tuple(sellmeier1) if sellmeier1 is not None
                           else None)
        self.sellmeier2 = (tuple(sellmeier2) if sellmeier2 is not None
                           else None)
        if sellmeier1 is not None or sellmeier2 is not None:
            self._sellmeier_media = [None, self.sellmeier1,
                                     self.sellmeier2, None]
        tt = t1 + t2
        zs = [-tt / 2.0, -tt / 2.0 + t1, tt / 2.0]
        _validate_faces([c1, c2, c3], [t1, t2], d / 2.0, zs)
        self._init = dict(c1=c1, c2=c2, c3=c3, t1=t1, t2=t2, radius=d / 2.0,
                          ior_glass1=ior_glass1, ior_glass2=ior_glass2,
                          ior_media=ior_media)
        self._grads = dict(c1=c1_grad, c2=c2_grad, c3=c3_grad, t1=t1_grad,
                           t2=t2_grad, radius=d_grad,
                           ior_glass1=ior_glass1_grad,
                           ior_glass2=ior_glass2_grad,
                           ior_media=ior_media_grad)
        self._set_coating(coating, coating_grad)

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _ior_chain(self, p):
        return [p['ior_media'], p['ior_glass1'], p['ior_glass2'],
                p['ior_media']]

    def _b_chain(self, p):
        if self.abbe_vd1 is None and self.abbe_vd2 is None:
            return None
        zero = p['ior_media'] * 0.0
        b1 = (abbe_to_cauchy_b(p['ior_glass1'], self.abbe_vd1)
              if self.abbe_vd1 else zero)
        b2 = (abbe_to_cauchy_b(p['ior_glass2'], self.abbe_vd2)
              if self.abbe_vd2 else zero)
        return [zero, b1, b2, zero]

    def _edge_phys(self, p):
        return PhysKind.BLOCK, ()

    def R1(self, p):
        return 1.0 / p['c1']

    def R2(self, p):
        return 1.0 / p['c2']

    def R3(self, p):
        return -1.0 / p['c3']


class TripletLens(_SphericLens):
    """Cemented triplet: 4 refracting faces + 3 blocked edge cylinders.
    Its glasses disperse with Sellmeier coefficients ``sellmeier1`` ..
    ``sellmeier3`` (the JAX class takes no Abbe numbers).  ``fresnel`` and
    coatings as for ``SingletLens``."""

    _curv_names = ('c1', 'c2', 'c3', 'c4')
    _thick_names = ('t1', 't2', 't3')

    def __init__(self, c1, c2, c3, c4, d, t1, t2, t3, ior_glass1, ior_glass2,
                 ior_glass3, ior_media=1.0, c1_grad=False, c2_grad=False,
                 c3_grad=False, c4_grad=False, t1_grad=False, t2_grad=False,
                 t3_grad=False, d_grad=False, ior_glass1_grad=False,
                 ior_glass2_grad=False, ior_glass3_grad=False,
                 ior_media_grad=False, sellmeier1=None, sellmeier2=None,
                 sellmeier3=None, coating=None, coating_grad=False,
                 fresnel=False, name='triplet', **kw):
        super().__init__(name=name, **kw)
        self.fresnel = _fresnel_option(fresnel)
        sells = [sellmeier1, sellmeier2, sellmeier3]
        if any(sl is not None for sl in sells):
            self._sellmeier_media = ([None]
                                     + [tuple(sl) if sl is not None else None
                                        for sl in sells] + [None])
        tt = t1 + t2 + t3
        zs = [-tt / 2.0]
        for t in (t1, t2, t3):
            zs.append(zs[-1] + t)
        _validate_faces([c1, c2, c3, c4], [t1, t2, t3], d / 2.0, zs)
        self._init = dict(c1=c1, c2=c2, c3=c3, c4=c4, t1=t1, t2=t2, t3=t3,
                          radius=d / 2.0, ior_glass1=ior_glass1,
                          ior_glass2=ior_glass2, ior_glass3=ior_glass3,
                          ior_media=ior_media)
        self._grads = dict(c1=c1_grad, c2=c2_grad, c3=c3_grad, c4=c4_grad,
                           t1=t1_grad, t2=t2_grad, t3=t3_grad, radius=d_grad,
                           ior_glass1=ior_glass1_grad,
                           ior_glass2=ior_glass2_grad,
                           ior_glass3=ior_glass3_grad,
                           ior_media=ior_media_grad)
        self._set_coating(coating, coating_grad)

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _ior_chain(self, p):
        return [p['ior_media'], p['ior_glass1'], p['ior_glass2'],
                p['ior_glass3'], p['ior_media']]

    def _edge_phys(self, p):
        return PhysKind.BLOCK, ()


# Outward-normal rotations of the 4 side planes of a box edge (+x, -x, +y,
# -y)
_SIDE_ROTS = (
    (0.0, math.pi / 2.0, 0.0),
    (0.0, -math.pi / 2.0, 0.0),
    (-math.pi / 2.0, 0.0, 0.0),
    (math.pi / 2.0, 0.0, 0.0),
)


class CylSingletLens(SingletLens):
    """Cylindrical singlet: two faces curved in y only (QUADRIC_ZY, HEMI
    bound, rectangular volume bound) and four side planes bounded between
    the faces' y-dependent sags (CYL_EDGE).  ``height`` and ``width`` are the
    full extents in y and x.  ``fresnel`` as for ``SingletLens``, and
    ``coating=`` / ``coating_grad=`` as keywords: the JAX class takes no
    ``coating``; a coated face here carries the columns a coated
    ``SingletLens`` face carries."""

    def __init__(self, c1, c2, height, width, t, ior_glass, ior_media=1.0,
                 c1_grad=False, c2_grad=False, t_grad=False,
                 height_grad=False, width_grad=False, ior_glass_grad=False,
                 ior_media_grad=False, fresnel=False, inked=False,
                 name='cyl_singlet', **kw):
        # coating= and coating_grad= ride the keywords: the JAX class has
        # neither, and the positional signature stays the JAX one
        coating = kw.pop('coating', None)
        coating_grad = kw.pop('coating_grad', False)
        Element.__init__(self, name=name, **kw)
        self.fresnel = _fresnel_option(fresnel)
        if abs(0.5 * c1) > 1.0 / height or abs(0.5 * c2) > 1.0 / height:
            raise ValueError("|R| must be larger than Height/2")
        if (_sag_float(c1, height / 2) - t / 2
                > _sag_float(c2, height / 2) + t / 2):
            raise ValueError("Front and back surfaces intersecting")
        self._init = dict(c1=c1, c2=c2, t=t, half_w=width / 2.0,
                          half_h=height / 2.0, ior_glass=ior_glass,
                          ior_media=ior_media)
        self._grads = dict(c1=c1_grad, c2=c2_grad, t=t_grad,
                           half_w=width_grad, half_h=height_grad,
                           ior_glass=ior_glass_grad,
                           ior_media=ior_media_grad)
        self._set_coating(coating, coating_grad)
        self.inked = inked

    @property
    def n_surfaces(self):
        return 6

    def build(self, p):
        Re, te = frame_params(p)
        hw, hh, t = p['half_w'], p['half_h'], p['t']
        zs = [-t / 2.0, t / 2.0]
        iors = self._ior_chain(p)
        rect = (-hw, hw, -hh, hh)
        recs = []
        for i, (c, zv) in enumerate(zip([p['c1'], p['c2']], zs)):
            q, sign = q_quadric_zy(c, 0.0)
            Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(zv))
            coat, n_coat, coat_k = self._face_coat(p, i)
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                sb_kind=SBKind.HEMI, sb=(c,),
                vb_kind=VBKind.RECT, vb=rect,
                ph_kind=self._refract_kind(), ph=(iors[i + 1], iors[i]),
                coat=coat, n_coat=n_coat, coat_k=coat_k))
        edge_kind, edge_ph = self._edge_phys(p)
        edge_vb = (p['c1'], zs[0], p['c2'], zs[1]) + rect
        zero = torch.zeros_like(hw)
        offsets = [torch.stack([hw, zero, zero]),
                   torch.stack([-hw, zero, zero]),
                   torch.stack([zero, hh, zero]),
                   torch.stack([zero, -hh, zero])]
        for rot, off in zip(_SIDE_ROTS, offsets):
            q, sign = q_plane(te.dtype, te.device)
            Rp = rodrigues(torch.tensor(rot, dtype=te.dtype,
                                        device=te.device))
            Rw, tw, Rs, ts = compose_world(Re, te, Rp, off)
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                vb_kind=VBKind.CYL_EDGE, vb=edge_vb, is_plane=True,
                ph_kind=edge_kind, ph=edge_ph))
        return recs

    def paraxial(self, p):
        """No power in x: each face's matrix refracts in y alone."""
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        z0 = p['trans'][2]
        zs = [-p['t'] / 2.0, p['t'] / 2.0]
        iors = self._ior_chain(p)
        zero = torch.zeros_like(p['c1'])
        mats = [mm(t_inv, mm(paraxial_refract_mat(zero, p[f'c{i + 1}'],
                                                  iors[i], iors[i + 1]), t))
                for i in range(2)]
        return [z0 + zv for zv in zs], mats

    def optical_zs(self, p):
        z0 = p['trans'][2]
        return [z0 - p['t'] / 2.0, z0 + p['t'] / 2.0]


class AsphericLens(SingletLens):
    """Singlet whose faces are even aspheres: conic constant ``k`` and the
    a4 r^4 .. a10 r^10 terms (``a1``, ``a2``: up to 4 each, padded with
    zeros) per face, refined from the base conic's roots by 4 Halley steps
    (geom/surfaces.py::asph_refine) and differentiable in every one of them.
    Its glass disperses, ``fresnel`` selects the faces' physics and
    ``coating`` coats them, as for ``SingletLens`` (whose keyword arguments
    it passes on)."""

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 k1=0.0, k2=0.0, a1=(), a2=(),
                 c1_grad=False, c2_grad=False, t_grad=False, d_grad=False,
                 k1_grad=False, k2_grad=False, a1_grad=False, a2_grad=False,
                 ior_glass_grad=False, ior_media_grad=False,
                 fresnel=False, inked=False, name='asphere', **kw):
        super().__init__(c1, c2, d, t, ior_glass, ior_media=ior_media,
                         c1_grad=c1_grad, c2_grad=c2_grad, t_grad=t_grad,
                         d_grad=d_grad, ior_glass_grad=ior_glass_grad,
                         ior_media_grad=ior_media_grad, fresnel=fresnel,
                         inked=inked, name=name, **kw)

        def pad4(a):
            a = [float(v) for v in a]
            return a + [0.0] * (4 - len(a))
        self._init.update(k1=float(k1), k2=float(k2), a1=pad4(a1),
                          a2=pad4(a2))
        self._grads.update(k1=k1_grad, k2=k2_grad, a1=a1_grad, a2=a2_grad)

    def param_scales(self):
        """Natural optimization magnitudes: a_{2i+4} scales like
        r_aperture^-(2i+4), so a unit step moves the edge sag by O(1); pass
        to ``fit(scales=...)`` for joint conic and polynomial design."""
        r = self._init['radius']
        poly = [r ** -(2 * i + 4) for i in range(4)]
        return {'a1': poly, 'a2': list(poly)}

    def build(self, p):
        Re, te = frame_params(p)
        r = p['radius']
        zs = [-p['t'] / 2.0, p['t'] / 2.0]
        iors = self._ior_chain(p)
        dc = self._disp_chain(p)
        recs = []
        for i, (cn, kn, an, zv) in enumerate(
                [('c1', 'k1', 'a1', zs[0]), ('c2', 'k2', 'a2', zs[1])]):
            q, sign = q_quadric(p[cn], p[kn])
            Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(zv))
            disp, dm, isd = _disp_rec(dc, i + 1, i)
            coat, n_coat, coat_k = self._face_coat(p, i)
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                sb_kind=SBKind.HEMI, sb=(p[cn],),
                vb_kind=VBKind.APER_R2, vb=(r * r,),
                ph_kind=self._refract_kind(), ph=(iors[i + 1], iors[i]),
                disp=disp, disp_model=dm, is_dispersive=isd,
                coat=coat, n_coat=n_coat, coat_k=coat_k,
                asph=tuple(p[an][j] for j in range(4)), is_asphere=True))
        edge_kind, edge_ph = self._edge_phys(p)
        q, sign = q_cylinder(r)
        Rw, tw, Rs, ts = compose_world(Re, te)
        z_lo = sag_z(p['c1'], r) + zs[0]
        z_hi = sag_z(p['c2'], r) + zs[1]
        recs.append(SurfaceRec(
            q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
            vb_kind=VBKind.Z_BETWEEN, vb=(z_lo, z_hi),
            ph_kind=edge_kind, ph=edge_ph))
        return recs


class FreeformLens(AsphericLens):
    """Singlet whose faces add an XY-polynomial freeform sag to the conic and
    even-asphere base: S(x, y) = conic(r^2) + sum a_k r^(2k+4) + sum_m c_m
    x^i y^j.  ``xy1`` / ``xy2`` give each face's terms as (i, j, coeff)
    triples: the exponent pairs are static (they pick the polynomial), the
    coefficients parameters (``xy1_grad=True`` trains the face's whole
    coefficient vector).  The intersection is 8 Newton steps from the base
    conic's root (geom/surfaces.py::ff_refine) and the normal the sag's
    gradient's, so refraction differentiates in every coefficient."""

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 k1=0.0, k2=0.0, a1=(), a2=(), xy1=(), xy2=(),
                 xy1_grad=False, xy2_grad=False, name='freeform', **kw):
        super().__init__(c1, c2, d, t, ior_glass, ior_media=ior_media,
                         k1=k1, k2=k2, a1=a1, a2=a2, name=name, **kw)

        def split(xy, label):
            terms = [(int(i), int(j), float(v)) for i, j, v in xy]
            if len(terms) > MAX_FF_TERMS:
                raise ValueError(
                    f"{label}: at most {MAX_FF_TERMS} freeform terms "
                    f"per face (got {len(terms)})")
            for i, j, _ in terms:
                if i < 0 or j < 0 or i + j < 1:
                    raise ValueError(
                        f"{label}: exponents must be >= 0 with i+j >= 1 "
                        f"(got ({i}, {j}); piston belongs in translation)")
            return (tuple((i, j) for i, j, _ in terms),
                    [v for _, _, v in terms])

        pw1, v1 = split(xy1, 'xy1')
        pw2, v2 = split(xy2, 'xy2')
        self._ff_powers = (pw1, pw2)
        if pw1:
            self._init.update(xy1=v1)
            self._grads.update(xy1=xy1_grad)
        if pw2:
            self._init.update(xy2=v2)
            self._grads.update(xy2=xy2_grad)

    def param_scales(self):
        """``AsphericLens.param_scales`` and r_aperture^-(i+j) for each
        freeform term."""
        scales = super().param_scales()
        r = self._init['radius']
        for key, pw in zip(('xy1', 'xy2'), self._ff_powers):
            if pw:
                scales[key] = [r ** -(i + j) for i, j in pw]
        return scales

    def build(self, p):
        recs = super().build(p)
        for face, (key, pw) in enumerate(zip(('xy1', 'xy2'),
                                             self._ff_powers)):
            if pw:
                recs[face].ff = tuple(p[key][m] for m in range(len(pw)))
                recs[face].ff_powers = pw
        return recs


class ZernikeLens(AsphericLens):
    """Singlet whose faces add a Zernike sag to the conic and even-asphere
    base: S(x, y) = conic(r^2) + sum a_k r^(2k+4) + sum z_j Z_j(x/R_n,
    y/R_n).  ``z1`` / ``z2`` give each face's terms as (j, coeff) pairs in
    Noll indexing (as utils/wavefront.py::zernike_fit), unnormalized sag
    amplitudes over ``norm_radius`` (default: the semi-diameter).  Each term
    is expanded on the host into exact monomials (geom/zernike.py), so the
    surface traces as a freeform, while the parameters stay in the Zernike
    basis: ``build`` applies the static basis change."""

    def __init__(self, c1, c2, d, t, ior_glass, ior_media=1.0,
                 k1=0.0, k2=0.0, a1=(), a2=(), z1=(), z2=(),
                 z1_grad=False, z2_grad=False, norm_radius=None,
                 name='zernike', **kw):
        super().__init__(c1, c2, d, t, ior_glass, ior_media=ior_media,
                         k1=k1, k2=k2, a1=a1, a2=a2, name=name, **kw)
        rn = float(d) / 2.0 if norm_radius is None else float(norm_radius)
        if rn <= 0.0:
            raise ValueError(f"norm_radius must be positive, got {rn}")
        self._norm_radius = rn

        def split(terms, label):
            idx, vals = [], []
            for j, v in terms:
                j = int(j)
                if j < 2:
                    raise ValueError(
                        f"{label}: piston (Noll j=1) is a pure z offset, "
                        "not a surface shape — use translation")
                if j in idx:
                    raise ValueError(f"{label}: duplicate Noll index {j}")
                idx.append(j)
                vals.append(float(v))
            if not idx:
                return [], None
            powers, M = zernike_monomial_map(tuple(idx), rn)
            if len(powers) > MAX_FF_TERMS:
                raise ValueError(
                    f"{label}: Zernike set spans {len(powers)} monomials "
                    f"(> MAX_FF_TERMS={MAX_FF_TERMS}); use fewer / "
                    "lower-order terms")
            return vals, (powers, M)

        v1, m1 = split(z1, 'z1')
        v2, m2 = split(z2, 'z2')
        self._zern_maps = (m1, m2)
        if m1:
            self._init.update(z1=v1)
            self._grads.update(z1=z1_grad)
        if m2:
            self._init.update(z2=v2)
            self._grads.update(z2=z2_grad)

    def param_scales(self):
        """``AsphericLens.param_scales`` and 1 for each Zernike coefficient
        (already a rim-sag amplitude in length units)."""
        scales = super().param_scales()
        for key in ('z1', 'z2'):
            if key in self._init:
                scales[key] = [1.0] * len(self._init[key])
        return scales

    def build(self, p):
        recs = super().build(p)
        for face, (key, zm) in enumerate(zip(('z1', 'z2'),
                                             self._zern_maps)):
            if zm:
                powers, M = zm
                z = p[key]
                ff = []
                # the static basis change as unrolled scalar multiply-adds
                # in the JAX package's order; autograd carries z's gradient
                # into the row's ff columns
                for row in M:
                    acc = None
                    for k, w in enumerate(row):
                        if w != 0.0:
                            term = w * z[k]
                            acc = term if acc is None else acc + term
                    ff.append(acc if acc is not None else 0.0 * z[0])
                recs[face].ff = tuple(ff)
                recs[face].ff_powers = powers
        return recs


class WedgePrism(Element):
    """Thin wedge prism: a flat entrance face and an exit face tilted by
    ``wedge_angle`` about x, refracting with the glass index: two SNELL
    planes.  The small-angle deviation is (n - 1) * wedge_angle."""

    def __init__(self, wedge_angle, d, t, ior_glass, ior_media=1.0,
                 wedge_angle_grad=False, ior_glass_grad=False,
                 name='wedge', **kw):
        super().__init__(name=name, **kw)
        self._init = dict(wedge_angle=float(wedge_angle), radius=d / 2.0,
                          t=float(t), ior_glass=float(ior_glass),
                          ior_media=float(ior_media))
        self._grads = dict(wedge_angle=wedge_angle_grad, radius=False,
                           t=False, ior_glass=ior_glass_grad,
                           ior_media=False)

    @property
    def n_surfaces(self):
        return 2

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def build(self, p):
        Re, te = frame_params(p)
        r2 = p['radius'] ** 2
        zero = p['t'] * 0.0
        q, sign = q_plane(dtype=te.dtype, device=te.device)
        recs = []
        # entrance face: the plane at -t/2, normal +z (into the glass)
        Rw, tw, Rs, ts = compose_world(Re, te, None, zvec(-p['t'] / 2.0))
        recs.append(SurfaceRec(
            q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
            sb_kind=SBKind.DISK, sb=(r2,), is_plane=True,
            ph_kind=PhysKind.SNELL, ph=(p['ior_glass'], p['ior_media'])))
        # exit face: the plane at +t/2 tilted about x by the wedge angle
        Rt = rodrigues(torch.stack([p['wedge_angle'], zero, zero]))
        Rw, tw, Rs, ts = compose_world(Re, te, Rt, zvec(p['t'] / 2.0))
        recs.append(SurfaceRec(
            q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
            sb_kind=SBKind.DISK, sb=(r2,), is_plane=True,
            ph_kind=PhysKind.SNELL, ph=(p['ior_media'], p['ior_glass'])))
        return recs
