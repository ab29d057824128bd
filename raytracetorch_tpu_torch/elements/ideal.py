"""5x5 paraxial transfer matrices.

Counterpart of the ``paraxial_*_mat`` helpers of
``raytracetorch_tpu/elements/ideal.py`` (the ideal ABCD elements are ROADMAP
Queue 1 item 14).  The paraxial state is [x, theta_x, y, theta_y, 1]; the
affine last column carries element decenters (Frame.paraxial).  Each helper
builds its matrix out of place so autograd reaches its arguments.
"""

from __future__ import annotations

import torch


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
