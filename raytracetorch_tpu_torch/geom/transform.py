"""Coordinate frames: axis-angle rotations, world<->local maps, paraxial shifts.

Counterpart of ``raytracetorch_tpu/geom/transform.py``.  Convention
(row-vector form): world->local ``(p - t) @ R``; local->world
``p @ R.T + t``; ``R = rodrigues(rot_vec)``.
"""

from __future__ import annotations

import dataclasses

import torch


def mm(a, b):
    """Matrix product.  TF32 is switched off at package import, so a float32
    product on the card runs in full float32 (the TPU code pins HIGHEST
    precision for the same reason: a reduced-precision rotation is only good
    to ~1e-3)."""
    return torch.matmul(a, b)


def vec_mat(v, m):
    """v [..., 3] @ m [..., 3, 3] as explicit products."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        vx * m[..., 0, 0] + vy * m[..., 1, 0] + vz * m[..., 2, 0],
        vx * m[..., 0, 1] + vy * m[..., 1, 1] + vz * m[..., 2, 1],
        vx * m[..., 0, 2] + vy * m[..., 1, 2] + vz * m[..., 2, 2],
    ], dim=-1)


def skew(r):
    """K(r) = [[0,-z,y],[z,0,-x],[-y,x,0]]."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rodrigues(rot_vec):
    """exp(K(r)) by the Rodrigues formula, differentiable at r = 0 (double
    where: the small-angle branch never feeds sqrt or a division)."""
    theta2 = torch.sum(rot_vec * rot_vec, dim=-1)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    K = skew(rot_vec)
    KK = mm(K, K)
    eye = torch.eye(3, dtype=rot_vec.dtype,
                    device=rot_vec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


@dataclasses.dataclass
class Frame:
    """Rigid transform from axis-angle ``rot_vec`` [3] and ``trans`` [3]."""

    rot_vec: torch.Tensor
    trans: torch.Tensor

    @classmethod
    def create(cls, rotation=None, translation=None, dtype=torch.float32,
               device=None):
        def vec(v):
            if v is None:
                return torch.zeros(3, dtype=dtype, device=device)
            return torch.as_tensor(v, dtype=dtype, device=device)
        return cls(rot_vec=vec(rotation), trans=vec(translation))

    @property
    def rot(self):
        return rodrigues(self.rot_vec)

    def to_local(self, pos, direction):
        R = self.rot
        return vec_mat(pos - self.trans, R), vec_mat(direction, R)

    def to_world(self, pos, direction):
        R = self.rot
        return vec_mat(pos, R.T) + self.trans, vec_mat(direction, R.T)

    def place(self, pos, direction):
        """Bundle placement: rotate then translate sampled local rays."""
        return self.to_world(pos, direction)

    def paraxial(self):
        """5x5 shift into the element frame for the paraxial state
        [x, theta_x, y, theta_y, 1]."""
        one = torch.ones((), dtype=self.trans.dtype, device=self.trans.device)
        affine = -torch.stack([self.trans[0], self.rot_vec[0], self.trans[1],
                               self.rot_vec[1], -one])[:, None]
        left = torch.eye(5, dtype=self.trans.dtype,
                         device=self.trans.device)[:, :4]
        return torch.cat([left, affine], dim=1)

    def paraxial_inv(self):
        one = torch.ones((), dtype=self.trans.dtype, device=self.trans.device)
        affine = torch.stack([self.trans[0], self.rot_vec[0], self.trans[1],
                              self.rot_vec[1], one])[:, None]
        left = torch.eye(5, dtype=self.trans.dtype,
                         device=self.trans.device)[:, :4]
        return torch.cat([left, affine], dim=1)


def compose(R_outer, t_outer, R_inner, t_inner):
    """Compose nested frames into one world->inner map: with world->outer
    ``(p - t_o) @ R_o`` and outer->inner ``(e - t_i) @ R_i`` the composition
    is ``(p - t_c) @ R_c`` with ``R_c = R_o @ R_i`` and ``t_c = t_o + t_i @
    R_o.T`` (one rotate and translate per surface)."""
    R_c = mm(R_outer, R_inner)
    t_c = t_outer + mm(t_inner, torch.swapaxes(R_outer, -1, -2))
    return R_c, t_c
