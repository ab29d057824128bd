"""Convex-polyhedron solids: the box, the four-sided barrel and general
half-space volumes.

Counterpart of ``raytracetorch_tpu/elements/solids.py``.  Each face is an
infinite plane clipped by the volume's half-space bound set: every other
face's plane (a face omits its own).  Faces carry outward normals and the
half-spaces are stated in outward form, ``n . x <= d`` inside, checked with
CVX_EPS of slack (core/static_dispatch.py::vb_check_one, HALFSPACES).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import MAX_HALFSPACES, PhysKind, VBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from ..geom.transform import rodrigues
from .base import Element, compose_world, frame_params

# rot_vec mapping the canonical +z plane normal to each outward axis
_FACE_ROTS = {
    '+z': (0.0, 0.0, 0.0),
    '-z': (0.0, math.pi, 0.0),
    '+x': (0.0, math.pi / 2.0, 0.0),
    '-x': (0.0, -math.pi / 2.0, 0.0),
    '+y': (-math.pi / 2.0, 0.0, 0.0),
    '-y': (math.pi / 2.0, 0.0, 0.0),
}
_FACE_NORMALS = {
    '+z': (0.0, 0.0, 1.0), '-z': (0.0, 0.0, -1.0),
    '+x': (1.0, 0.0, 0.0), '-x': (-1.0, 0.0, 0.0),
    '+y': (0.0, 1.0, 0.0), '-y': (0.0, -1.0, 0.0),
}


def box_face_recs(faces, ph_kind=PhysKind.BLOCK, ph=(), dtype=torch.float32,
                  device=None):
    """Plane SurfaceRecs (element-frame geometry only: ``Rw`` and ``tw``
    are None) of ``faces``, a list of (axis key, offset); each face's
    half-space set holds every other face."""
    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)
    q, sign = q_plane(dtype, device)
    recs = []
    for i, (axis, off) in enumerate(faces):
        halfspaces = [(t(_FACE_NORMALS[axis_j]), t(off_j))
                      for j, (axis_j, off_j) in enumerate(faces) if j != i]
        recs.append(SurfaceRec(
            q=q, n_sign=sign, Rw=None, tw=None,
            Rs=rodrigues(t(_FACE_ROTS[axis])),
            ts=t(_FACE_NORMALS[axis]) * t(off), vb_kind=VBKind.HALFSPACES,
            halfspaces=halfspaces, is_plane=True, ph_kind=ph_kind, ph=ph))
    return recs


class _BoxBase(Element):
    _face_axes: tuple = ()

    def __init__(self, ph_kind=PhysKind.BLOCK, ph=(), name='box', **kw):
        super().__init__(name=name, **kw)
        self.ph_kind = ph_kind
        self.ph = tuple(ph)

    @property
    def n_surfaces(self):
        return len(self._face_axes)

    def extra_params(self):
        return dict(self._init)

    def extra_trainable(self):
        return dict(self._grads)

    def _face_offsets(self, p):
        raise NotImplementedError

    def build(self, p):
        Re, te = frame_params(p)
        faces = list(zip(self._face_axes, self._face_offsets(p)))
        recs = box_face_recs(faces, self.ph_kind, self.ph, dtype=te.dtype,
                             device=te.device)
        for r in recs:
            r.Rw, r.tw, _, _ = compose_world(Re, te, r.Rs, r.ts)
        return recs


class BoxElement(_BoxBase):
    """Six-plane rectangular prism, faces ordered +z, -z, +x, -x, +y, -y;
    ``length`` along z, ``width`` along x, ``height`` along y."""

    _face_axes = ('+z', '-z', '+x', '-x', '+y', '-y')

    def __init__(self, length, width, height, l_grad=False, w_grad=False,
                 h_grad=False, **kw):
        super().__init__(**kw)
        self._init = dict(length=float(length), width=float(width),
                          height=float(height))
        self._grads = dict(length=l_grad, width=w_grad, height=h_grad)

    def _face_offsets(self, p):
        l2, w2, h2 = p['length'] / 2, p['width'] / 2, p['height'] / 2
        return (l2, l2, w2, w2, h2, h2)


class Box4SideElement(_BoxBase):
    """Four side planes without caps (+x, -x, +y, -y): the lens barrel, or
    with REFLECT faces a lightpipe."""

    _face_axes = ('+x', '-x', '+y', '-y')

    def __init__(self, width, height, w_grad=False, h_grad=False, **kw):
        super().__init__(**kw)
        self._init = dict(width=float(width), height=float(height))
        self._grads = dict(width=w_grad, height=h_grad)

    def _face_offsets(self, p):
        w2, h2 = p['width'] / 2, p['height'] / 2
        return (w2, w2, h2, h2)


def _rot_vec_to_normal(n):
    """Axis-angle (host-side, static) rotating the canonical +z plane
    normal onto the unit normal ``n``."""
    z = np.array([0.0, 0.0, 1.0])
    axis = np.cross(z, n)
    s = float(np.linalg.norm(axis))
    c = float(np.dot(z, n))
    if s < 1e-12:
        return (math.pi, 0.0, 0.0) if c < 0.0 else (0.0, 0.0, 0.0)
    return tuple(axis / s * math.atan2(s, c))


class CvxPolyhedronElement(Element):
    """General convex polyhedron: the intersection of outward half-spaces
    ``{x : n_i . x <= d_i}``, each face bounded by the others.

    An absorber (BLOCK faces) by default; ``ior_glass`` makes a refracting
    glass solid (a prism) traced with Snell or, with ``fresnel=True``,
    Monte-Carlo Fresnel physics.  Normals need not be unit (normalized at
    construction, with the offsets rescaled to match); the offsets are
    parameters (trainable with ``offsets_grad``).  At most
    MAX_HALFSPACES + 1 faces (each face's bound holds the others).
    """

    def __init__(self, normals, offsets, ior_glass=None, ior_media=1.0,
                 fresnel=False, offsets_grad=False, ior_glass_grad=False,
                 name='polyhedron', **kw):
        super().__init__(name=name, **kw)
        norms = np.asarray(normals, np.float64)
        if norms.ndim != 2 or norms.shape[1] != 3:
            raise ValueError("normals must be [K, 3]")
        k = norms.shape[0]
        if k < 3:
            raise ValueError("a polyhedron needs at least 3 half-spaces")
        if k - 1 > MAX_HALFSPACES:
            raise ValueError(
                f"at most {MAX_HALFSPACES + 1} faces supported "
                f"(padded half-space capacity), got {k}")
        if len(offsets) != k:
            raise ValueError("offsets must match normals")
        lengths = np.linalg.norm(norms, axis=1)
        if np.any(lengths < 1e-12):
            raise ValueError("zero-length normal")
        norms = norms / lengths[:, None]
        self._normals = [tuple(float(x) for x in row) for row in norms]
        self._rot_vecs = [_rot_vec_to_normal(row) for row in norms]
        self._offsets_init = [float(o) / float(ln)
                              for o, ln in zip(offsets, lengths)]
        self._offsets_grad = offsets_grad
        self.ior_glass = ior_glass
        self.ior_media = ior_media
        self.fresnel = fresnel
        self._ior_grad = ior_glass_grad

    @property
    def n_surfaces(self):
        return len(self._normals)

    def extra_params(self):
        p = {'offsets': self._offsets_init}
        if self.ior_glass is not None:
            p['ior_glass'] = self.ior_glass
            p['ior_media'] = self.ior_media
        return p

    def extra_trainable(self):
        t = {'offsets': self._offsets_grad}
        if self.ior_glass is not None:
            t['ior_glass'] = self._ior_grad
            t['ior_media'] = False
        return t

    def build(self, p):
        Re, te = frame_params(p)
        offs = p['offsets']
        if self.ior_glass is not None:
            kind = PhysKind.FRESNEL if self.fresnel else PhysKind.SNELL
            # outward normals: ior_in is the medium on the normal's side
            ph = (p['ior_media'], p['ior_glass'])
        else:
            kind, ph = PhysKind.BLOCK, ()

        def t(v):
            return torch.as_tensor(v, dtype=te.dtype, device=te.device)
        q, sign = q_plane(te.dtype, te.device)
        recs = []
        for i, n in enumerate(self._normals):
            halfspaces = [(t(self._normals[j]), offs[j])
                          for j in range(self.n_surfaces) if j != i]
            Rp = rodrigues(t(self._rot_vecs[i]))
            ts = t(n) * offs[i]
            Rw, tw, _, _ = compose_world(Re, te, Rp, ts)
            recs.append(SurfaceRec(
                q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rp, ts=ts,
                vb_kind=VBKind.HALFSPACES, halfspaces=halfspaces,
                is_plane=True, ph_kind=kind, ph=ph))
        return recs
