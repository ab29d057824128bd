"""Element specs: static structure plus a differentiable parameter dict.

Counterpart of ``raytracetorch_tpu/elements/base.py``.  An Element is a
plain Python description that owns no tensors.  It

- declares its initial parameters (``init_params``, a dict of tensors on an
  explicit device) and a matching trainability mask (``trainable``);
- compiles itself into SurfaceTable rows from a parameter dict (``build``),
  so gradients flow from traced rays back to every scalar;
- exposes its paraxial surface matrices (``paraxial``) and the global z of
  its optical surfaces (``optical_zs``, the hook of optim/constraints.py).

``ElementCustom`` assembles an element from shape parts
(elements/shapes.py) and one physics spec.
"""

from __future__ import annotations

import torch

from ..constants import MAX_COAT_LAYERS
from ..geom.transform import Frame, mm, rodrigues
from ..utils.coatings import parse_coating_entries


def frame_params(p):
    """(R_e, t_e) of the element frame from its params."""
    return rodrigues(p['rot_vec']), p['trans']


def compose_world(Re, te, Rs=None, ts=None):
    """Compose the element frame with an optional surface sub-frame into the
    world->surface map stored in the table."""
    if Rs is None:
        Rs = torch.eye(3, dtype=te.dtype, device=te.device)
    if ts is None:
        ts = torch.zeros(3, dtype=te.dtype, device=te.device)
    Rw = mm(Re, Rs)
    tw = te + mm(ts, Re.T)
    return Rw, tw, Rs, ts


def zvec(z):
    """(0, 0, z) with a tensor z."""
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z])


class Element:
    """Base element spec.  Subclasses add parameters via ``extra_params`` /
    ``extra_trainable`` and implement ``build``."""

    def __init__(self, name='element', rotation=None, translation=None,
                 rot_grad=False, trans_grad=False, rot_mask=None,
                 trans_mask=None):
        self.name = name
        self._rot_init = [0.0, 0.0, 0.0] if rotation is None else list(rotation)
        self._trans_init = ([0.0, 0.0, 0.0] if translation is None
                            else list(translation))
        self.rot_grad, self.trans_grad = rot_grad, trans_grad
        self.rot_mask, self.trans_mask = rot_mask, trans_mask

    def init_params(self, device, dtype=torch.float32):
        p = {'rot_vec': torch.tensor(self._rot_init, dtype=dtype,
                                     device=device),
             'trans': torch.tensor(self._trans_init, dtype=dtype,
                                   device=device)}
        for k, v in self.extra_params().items():
            # a dict-valued parameter (a per-face coat_d {str(face): [L]})
            # keeps its structure; its leaves become tensors
            p[k] = ({kk: torch.tensor(vv, dtype=dtype, device=device)
                     for kk, vv in v.items()} if isinstance(v, dict)
                    else torch.tensor(v, dtype=dtype, device=device))
        return p

    def trainable(self):
        """Gradient mask: True where a parameter is meant to be optimized
        (the caller sets ``requires_grad`` on those leaves); a trainable pose
        with ``rot_mask`` or ``trans_mask`` gives that per-component float
        mask (optim/fit.py multiplies the leaf's gradient by it)."""
        def mask(flag, mask3):
            if not flag:
                return False
            return True if mask3 is None else [float(m) for m in mask3]
        t = {'rot_vec': mask(self.rot_grad, self.rot_mask),
             'trans': mask(self.trans_grad, self.trans_mask)}
        t.update(self.extra_trainable())
        return t

    def extra_params(self):
        return {}

    def extra_trainable(self):
        return {}

    @property
    def n_surfaces(self):
        raise NotImplementedError

    @property
    def is_sensor(self):
        return False

    @property
    def is_aperture(self):
        """True for pure aperture elements, which the 3D renderer leaves out
        of its occlusion (render/camera.py)."""
        return False

    def frame(self, p):
        return Frame(rot_vec=p['rot_vec'], trans=p['trans'])

    def build(self, p):
        """-> list[SurfaceRec] (length == n_surfaces)."""
        raise NotImplementedError

    def paraxial(self, p):
        """-> ([z...], [5x5 matrix...]): the identity wrapped in the frame's
        decenter shifts."""
        f = self.frame(p)
        eye = torch.eye(5, dtype=p['trans'].dtype, device=p['trans'].device)
        return [p['trans'][2]], [mm(f.paraxial_inv(), mm(eye, f.paraxial()))]

    def optical_zs(self, p):
        """Global z of each optical surface, differentiable."""
        return [p['trans'][2]]


class ElementCustom(Element):
    """Arbitrary shape parts with one physics spec replicated across their
    surfaces (elements/shapes.py holds the builders)."""

    def __init__(self, shape_fn, n_surfaces, ph_kind, ph=(), name='custom',
                 extra=None, extra_grad=None, coating=None,
                 coating_grad=False, **kw):
        """``shape_fn(p, Re, te) -> list[SurfaceRec]`` supplies the geometry;
        the physics fields are overwritten uniformly.  ``extra`` holds the
        shape's parameters ({name: initial value}), ``extra_grad`` which of
        them train.  ``coating`` puts one thin-film stack ``[(n, d_um),
        ...]`` (outermost first; utils/coatings.py::parse_coating_entries;
        trainable thicknesses 'coat_d' with ``coating_grad``) on every
        face; it acts through FRESNEL and FRESNEL_W physics."""
        super().__init__(name=name, **kw)
        self._shape_fn = shape_fn
        self._n = n_surfaces
        self._ph_kind = ph_kind
        self._ph = tuple(ph)
        self._extra = dict(extra or {})
        self._extra_grad = dict(extra_grad or {})
        if coating:
            if len(coating) > MAX_COAT_LAYERS:
                raise ValueError(
                    f"at most {MAX_COAT_LAYERS} coating layers per surface")
            ns, ks, ds = parse_coating_entries(coating)
            self.coating_n = ns
            self.coating_k = ks if any(k != 0.0 for k in ks) else None
            self._extra['coat_d'] = ds
            self._extra_grad['coat_d'] = coating_grad

    @property
    def n_surfaces(self):
        return self._n

    def extra_params(self):
        return dict(self._extra)

    def extra_trainable(self):
        return {k: self._extra_grad.get(k, False) for k in self._extra}

    def build(self, p):
        Re, te = frame_params(p)
        recs = self._shape_fn(p, Re, te)
        coat_ns = getattr(self, 'coating_n', None)
        for r in recs:
            r.ph_kind = self._ph_kind
            r.ph = self._ph
            if coat_ns:
                coat = []
                for li, nl in enumerate(coat_ns):
                    coat += [nl, p['coat_d'][li]]
                r.coat = coat
                r.n_coat = len(coat_ns)
                r.coat_k = getattr(self, 'coating_k', None)
        return recs
