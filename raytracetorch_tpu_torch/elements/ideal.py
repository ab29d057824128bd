"""5x5 paraxial transfer matrices and ideal (ABCD) elements.

Counterpart of ``raytracetorch_tpu/elements/ideal.py``: the
``paraxial_*_mat`` helpers, the planar ``LinearElement`` with its ideal
ABCD physics (LINEAR) and the thin lenses and mirror built on it, and the
planar ``DiffractionGrating`` (GRATING).  The paraxial state is [x,
theta_x, y, theta_y, 1]; the affine last column carries element decenters
(Frame.paraxial).  Each helper builds its matrix out of place so autograd
reaches its arguments.
"""

from __future__ import annotations

import torch

from ..constants import PhysKind, SBKind
from ..core.table import SurfaceRec
from ..geom.surfaces import q_plane
from ..geom.transform import mm
from .base import Element, compose_world, frame_params


def _mat(entries, like):
    """Identity with the given {(i, j): value} entries set."""
    like = torch.as_tensor(like)
    dtype = like.dtype if like.is_floating_point() else torch.float32
    rows = []
    for i in range(5):
        row = []
        for j in range(5):
            v = entries.get((i, j), 1.0 if i == j else 0.0)
            row.append(torch.as_tensor(v, dtype=dtype, device=like.device))
        rows.append(torch.stack(row))
    return torch.stack(rows)


def paraxial_lens_mat(power_x, power_y):
    """Thin-lens matrix."""
    return _mat({(1, 0): -power_x, (3, 2): -power_y}, power_x)


def paraxial_dist_mat(dist):
    """Free-space propagation matrix."""
    return _mat({(0, 1): dist, (2, 3): dist}, dist)


def paraxial_refract_mat(cx, cy, ior_1, ior_2):
    """Single refracting surface matrix."""
    r = ior_1 / ior_2
    return _mat({(1, 0): cx * (ior_1 - ior_2) / ior_2,
                 (3, 2): cy * (ior_1 - ior_2) / ior_2,
                 (1, 1): r, (3, 3): r}, cx)


def paraxial_mirror_mat(cx, cy):
    """Mirror matrix."""
    return _mat({(1, 0): -2.0 * cx, (3, 2): -2.0 * cy}, cx)


def _plane_bound(diameter):
    """No bound for an infinite diameter, else the disk of it."""
    if diameter == float('inf'):
        return SBKind.NONE, ()
    return SBKind.DISK, ((diameter / 2.0) ** 2,)


class LinearElement(Element):
    """A planar surface with ideal ABCD (LINEAR) physics: the base of the
    thin lenses and the ideal mirror.  Its parameters ``Cx``, ``Cy``,
    ``Dx``, ``Dy`` map (position, slope) per axis."""

    def __init__(self, name='linear', diameter=float('inf'), rotation=None,
                 translation=None, rot_grad=False, trans_grad=False, **kw):
        super().__init__(name=name, rotation=rotation,
                         translation=translation, rot_grad=rot_grad,
                         trans_grad=trans_grad, **kw)
        self.diameter = float(diameter)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'Cx': 0.0, 'Cy': 0.0, 'Dx': 1.0, 'Dy': 1.0}

    def extra_trainable(self):
        return {'Cx': False, 'Cy': False, 'Dx': False, 'Dy': False}

    def _abcd(self, p):
        return p['Cx'], p['Cy'], p['Dx'], p['Dy']

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        cx, cy, dx, dy = self._abcd(p)
        sb_kind, sb = _plane_bound(self.diameter)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=sb_kind, sb=sb, is_plane=True,
                           ph_kind=PhysKind.LINEAR,
                           ph=(0.0, 0.0, cx, cy, dx, dy))]

    def _paraxial_mat(self, p):
        # M[1, 0] = +Cx: the sign convention of the refraction matrices
        cx, cy, _, _ = self._abcd(p)
        return paraxial_lens_mat(-cx, -cy)

    def paraxial(self, p):
        f = self.frame(p)
        t, t_inv = f.paraxial(), f.paraxial_inv()
        return [p['trans'][2]], [mm(t_inv, mm(self._paraxial_mat(p), t))]


class IdealThinLens(LinearElement):
    """Ideal thin lens of focal length ``focal``: P = -1/f on both axes."""

    def __init__(self, focal, focal_grad=False, name='ideal_lens', **kw):
        super().__init__(name=name, **kw)
        self.focal_init = float(focal)
        self.focal_grad = focal_grad

    def extra_params(self):
        return {'P': -1.0 / self.focal_init}

    def extra_trainable(self):
        return {'P': self.focal_grad}

    def _abcd(self, p):
        return p['P'], p['P'], 1.0, 1.0

    def f(self, p):
        return -1.0 / p['P']


class IdealCylThinLens(LinearElement):
    """Ideal cylindrical thin lens with independent x and y powers, both on
    the one surface."""

    def __init__(self, focal_x, focal_y, focal_x_grad=False,
                 focal_y_grad=False, name='ideal_cyl_lens', **kw):
        super().__init__(name=name, **kw)
        self.fx_init, self.fy_init = float(focal_x), float(focal_y)
        self.fx_grad, self.fy_grad = focal_x_grad, focal_y_grad

    def extra_params(self):
        return {'Px': -1.0 / self.fx_init, 'Py': -1.0 / self.fy_init}

    def extra_trainable(self):
        return {'Px': self.fx_grad, 'Py': self.fy_grad}

    def _abcd(self, p):
        return p['Px'], p['Py'], 1.0, 1.0


class IdealMirror(LinearElement):
    """Ideal mirror with per-axis radii, Px = -2 / Rx.  Its LINEAR physics
    leaves towards +z of its frame, so it folds the ray unfolded, as the
    JAX package's does; its paraxial matrix is the mirror's."""

    def __init__(self, radius_x, radius_y, radius_x_grad=False,
                 radius_y_grad=False, name='ideal_mirror', **kw):
        super().__init__(name=name, **kw)
        self.rx_init, self.ry_init = float(radius_x), float(radius_y)
        self.rx_grad, self.ry_grad = radius_x_grad, radius_y_grad

    def extra_params(self):
        return {'Px': -2.0 / self.rx_init, 'Py': -2.0 / self.ry_init}

    def extra_trainable(self):
        return {'Px': self.rx_grad, 'Py': self.ry_grad}

    def _abcd(self, p):
        return p['Px'], p['Py'], 1.0, 1.0

    def _paraxial_mat(self, p):
        return paraxial_mirror_mat(-p['Px'] / 2.0, -p['Py'] / 2.0)


class DiffractionGrating(Element):
    """Planar linear diffraction grating (GRATING): grooves along local y,
    the grating vector along local x, the configured ``order`` diffracted
    with ideal efficiency.  Transmissive by default; ``reflective=True``
    folds the beam.  ``period_um`` is in the rays' wavelength unit (um), so
    sin(theta_out) = sin(theta_in) + m lambda / period."""

    def __init__(self, period_um, order=1, reflective=False,
                 diameter=float('inf'), period_grad=False, name='grating',
                 **kw):
        super().__init__(name=name, **kw)
        self._period_init = float(period_um)
        self._period_grad = period_grad
        self.order = int(order)
        self.reflective = bool(reflective)
        self.diameter = float(diameter)

    @property
    def n_surfaces(self):
        return 1

    def extra_params(self):
        return {'period_um': self._period_init}

    def extra_trainable(self):
        return {'period_um': self._period_grad}

    def build(self, p):
        Re, te = frame_params(p)
        q, sign = q_plane(te.dtype, te.device)
        Rw, tw, Rs, ts = compose_world(Re, te)
        sb_kind, sb = _plane_bound(self.diameter)
        return [SurfaceRec(q=q, n_sign=sign, Rw=Rw, tw=tw, Rs=Rs, ts=ts,
                           sb_kind=sb_kind, sb=sb, is_plane=True,
                           ph_kind=PhysKind.GRATING,
                           ph=(0.0, 0.0, p['period_um'], float(self.order),
                               1.0 if self.reflective else 0.0))]
