"""Component-planar 3-vector math.

Counterpart of ``raytracetorch_tpu/geom/vec3.py``.  Every 3-vector is a tuple
``(x, y, z)`` of equal-shaped tensors rather than an ``[N, 3]`` block: on a
GPU the planar layout makes each component a coalesced stream, which is
what the fused kernel (ops/fused_trace.py) reads.

Rotation convention (row-vector form): ``rot(v, R) = v @ R`` and
``rot_t(v, R) = v @ R.T``.
"""

from __future__ import annotations

import torch


def from_array(a):
    """[..., 3] -> (x, y, z)."""
    return a[..., 0], a[..., 1], a[..., 2]


def to_array(v):
    """(x, y, z) -> [..., 3]."""
    return torch.stack(v, dim=-1)


def dot(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def add(u, v):
    return u[0] + v[0], u[1] + v[1], u[2] + v[2]


def sub(u, v):
    return u[0] - v[0], u[1] - v[1], u[2] - v[2]


def scale(v, s):
    return v[0] * s, v[1] * s, v[2] * s


def fma(u, s, v):
    """u + s * v."""
    return u[0] + s * v[0], u[1] + s * v[1], u[2] + s * v[2]


def where(mask, u, v):
    return (torch.where(mask, u[0], v[0]), torch.where(mask, u[1], v[1]),
            torch.where(mask, u[2], v[2]))


def norm2(v):
    return v[0] * v[0] + v[1] * v[1] + v[2] * v[2]


def cross(u, v):
    return (u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0])


def rotate_between(a, b, v):
    """Apply the minimal rotation taking unit vector ``a`` to unit vector
    ``b`` to ``v`` (Rodrigues, normalize-free form):

        R(v) = c v + w x v + w (w . v) / (1 + c),   c = a.b, w = a x b

    the parallel transport of a polarization frame along a bending ray
    (core/grin.py).  It preserves norms and maps a-transverse vectors to
    b-transverse ones; 1 + c is held at 1e-6 or more (a 180-degree flip has
    no minimal axis, and no caller's ray reverses within one step)."""
    c = dot(a, b)
    w = cross(a, b)
    s = dot(w, v) / torch.clamp(1.0 + c, min=1e-6)
    return (c * v[0] + (w[1] * v[2] - w[2] * v[1]) + w[0] * s,
            c * v[1] + (w[2] * v[0] - w[0] * v[2]) + w[1] * s,
            c * v[2] + (w[0] * v[1] - w[1] * v[0]) + w[2] * s)


def rot(v, R):
    """v @ R as nine scalar products."""
    x, y, z = v
    return (x * R[..., 0, 0] + y * R[..., 1, 0] + z * R[..., 2, 0],
            x * R[..., 0, 1] + y * R[..., 1, 1] + z * R[..., 2, 1],
            x * R[..., 0, 2] + y * R[..., 1, 2] + z * R[..., 2, 2])


def rot_t(v, R):
    """v @ R.T."""
    x, y, z = v
    return (x * R[..., 0, 0] + y * R[..., 0, 1] + z * R[..., 0, 2],
            x * R[..., 1, 0] + y * R[..., 1, 1] + z * R[..., 1, 2],
            x * R[..., 2, 0] + y * R[..., 2, 1] + z * R[..., 2, 2])
