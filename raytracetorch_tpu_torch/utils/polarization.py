"""Polarization analysis over the field transport of the sequential trace.

Counterpart of ``raytracetorch_tpu/utils/polarization.py`` (its sequential
part).  The transport itself is core/field.py, carried by
``SequentialScene.simulate(track_field=True)`` and ``simulate_fused`` (the
kernels K1 and K2 on the card); this module keeps the standalone trace
and the Stokes analysis.  ``JonesPupil`` and ``jones_pupil`` are ROADMAP
Queue 1 position 3b.
"""

from __future__ import annotations

import torch

from ..core.field import FieldState
from ..geom import vec3 as v3


def polarized_sequential_trace(scene, params, rays, E0, fused=False,
                               **kw):
    """Sequential trace carrying a complex field per ray from ``E0`` ([N, 3]
    real or complex, or broadcastable; projected and normalized so |E|^2
    starts at 1) -> ``(rays_out, power [N], (Er, Ei))``: |E|^2 is the
    polarization-resolved transmitted power fraction.  ``fused=True`` runs
    ``simulate_fused`` (the kernels on the card); ``kw`` goes to the trace
    (a FRESNEL scene's ``generator``)."""
    trace = scene.simulate_fused if fused else scene.simulate
    out, _, aux = trace(params, rays, track_field=True, E0=E0, **kw)
    field = aux['field']
    return out, aux['field_power'], (field.r_c, field.i_c)


def stokes_parameters(field: FieldState, d):
    """Stokes vector ``(S0, S1, S2, S3)`` per ray of the transported field,
    in the transverse basis (h, v) of the ray directions ``d`` (a component
    tuple; h = normalize(z x d), or x at the poles): S0 = |E|^2, S3 > 0
    right-hand circular."""
    hx = -d[1]
    hy = d[0]
    h2 = hx * hx + hy * hy
    pole = h2 < 1e-12
    inv = 1.0 / torch.sqrt(torch.where(pole, 1.0, h2))
    h = (torch.where(pole, 1.0, hx * inv), torch.where(pole, 0.0, hy * inv),
         torch.zeros_like(hx))
    v = (d[1] * h[2] - d[2] * h[1],
         d[2] * h[0] - d[0] * h[2],
         d[0] * h[1] - d[1] * h[0])
    Er, Ei = field.r_c, field.i_c
    ah_r, ah_i = v3.dot(Er, h), v3.dot(Ei, h)
    av_r, av_i = v3.dot(Er, v), v3.dot(Ei, v)
    s0 = ah_r ** 2 + ah_i ** 2 + av_r ** 2 + av_i ** 2
    s1 = ah_r ** 2 + ah_i ** 2 - av_r ** 2 - av_i ** 2
    s2 = 2.0 * (ah_r * av_r + ah_i * av_i)
    s3 = 2.0 * (ah_r * av_i - ah_i * av_r)
    return s0, s1, s2, s3


def degree_of_polarization(s0, s1, s2, s3):
    """Degree of polarization of an (ensemble-averaged) Stokes vector: 1
    for a pure state."""
    return torch.sqrt(s1 * s1 + s2 * s2 + s3 * s3) / torch.clamp(s0,
                                                                 min=1e-24)
