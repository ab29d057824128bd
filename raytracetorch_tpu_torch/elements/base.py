"""Element specs: static structure plus a differentiable parameter dict.

Counterpart of ``raytracetorch_tpu/elements/base.py``.  An Element is a
plain Python description that owns no tensors.  It

- declares its initial parameters (``init_params``, a dict of tensors on an
  explicit device) and a matching trainability mask (``trainable``);
- compiles itself into SurfaceTable rows from a parameter dict (``build``),
  so gradients flow from traced rays back to every scalar;
- exposes its paraxial surface matrices (``paraxial``) and the global z of
  its optical surfaces (``optical_zs``, the hook of optim/constraints.py).
"""

from __future__ import annotations

import torch

from ..geom.transform import Frame, mm, rodrigues


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
