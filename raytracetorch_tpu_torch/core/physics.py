"""Surface interaction physics on component-planar vectors.

Counterpart of ``raytracetorch_tpu/core/physics.py`` (reflection and Snell
refraction; the Fresnel, grating, scatter and phase models are ROADMAP
Queue 1 item 12).  ``ph[0]`` is the index on the side the geometric normal
points toward, ``ph[1]`` the far side.  Snell is the physical one:
n1 = medium of incidence, mu = n1 / n2.
"""

from __future__ import annotations

import torch

from ..geom import vec3 as v3


def reflect_dir(d, n):
    """Specular reflection R = I - 2 (I.N) N."""
    return v3.fma(d, -2.0 * v3.dot(d, n), n)


def refract_components(d, n, ior_in, ior_out):
    """Shared Snell geometry: (dot, cos_i, n1, n2, mu, tir, cos_t,
    eff_sign); the normal flipped against the incident ray is
    ``eff_sign * n``."""
    dot = v3.dot(d, n)
    from_in = dot < 0
    eff_sign = torch.where(from_in, 1.0, -1.0)
    cos_i = torch.abs(dot)
    n1 = torch.where(from_in, ior_in, ior_out)
    n2 = torch.where(from_in, ior_out, ior_in)
    mu = n1 / torch.where(torch.abs(n2) < 1e-12, 1e-12, n2)
    sin2_t = mu * mu * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.where(tir, 1.0,
                                   torch.clamp(1.0 - sin2_t, min=0.0)))
    cos_t = torch.where(tir, 0.0, cos_t)
    return dot, cos_i, n1, n2, mu, tir, cos_t, eff_sign


def snell_dir(d, n, ior_in, ior_out):
    """Vector Snell; total internal reflection reflects."""
    dot, cos_i, _, _, mu, tir, cos_t, eff_sign = refract_components(
        d, n, ior_in, ior_out)
    coef = (mu * cos_i - cos_t) * eff_sign
    v_refract = v3.fma(v3.scale(d, mu), coef, n)
    v_reflect = v3.fma(d, -2.0 * dot, n)
    return v3.where(tir, v_reflect, v_refract)
