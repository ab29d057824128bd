"""Polarization analysis over the field transport of the sequential trace.

Counterpart of ``raytracetorch_tpu/utils/polarization.py`` (its sequential
part).  The transport itself is core/field.py, carried by
``SequentialScene.simulate(track_field=True)`` and ``simulate_fused`` (the
kernels K1 and K2 on the card); this module keeps the standalone trace,
the Stokes analysis and the Jones pupil (``jones_pupil``, ``JonesPupil``):
a system's 2 x 2 Jones matrix at every pupil sample, and its
transmittance, diattenuation, retardance and Mueller maps.
"""

from __future__ import annotations

import math

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


class JonesPupil:
    """The polarization aberration map of a system: the 2 x 2 Jones matrix
    at each pupil sample, from two field-tracked traces (x- and
    y-polarized input).

    ``j_re`` / ``j_im`` ``[n, n, 2, 2]`` (row: the output's x/y analyzer,
    column: the input's x/y polarization), ``mask`` ``[n, n]`` (the samples
    that reached the end with power), ``xs`` the pupil coordinates.  The
    maps are computed in float64 (complex128) with ``torch.linalg`` on the
    pupil's device; a sample outside ``mask`` reads 0."""

    def __init__(self, j_re, j_im, mask, xs):
        self.j_re, self.j_im, self.mask, self.xs = j_re, j_im, mask, xs

    @property
    def jones(self):
        """[n, n, 2, 2] complex Jones matrices (complex128)."""
        return torch.complex(self.j_re.double(), self.j_im.double())

    def _masked(self, m):
        return torch.where(self.mask, m, torch.zeros_like(m))

    @property
    def transmittance(self):
        """Unpolarized intensity transmittance: the mean of |J e|^2 over the
        two input polarizations, ||J||_F^2 / 2."""
        return self._masked(0.5 * (self.j_re.double() ** 2
                                   + self.j_im.double() ** 2).sum((-2, -1)))

    @property
    def diattenuation(self):
        """D = (T_max - T_min) / (T_max + T_min) from the singular values
        of J: 0 for a polarization-neutral sample, 1 for a perfect
        polarizer."""
        s = torch.linalg.svdvals(self.jones)
        s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2
        return self._masked((s1 - s2) / torch.clamp(s1 + s2, min=1e-24))

    @property
    def mueller(self):
        """[n, n, 4, 4] Mueller matrices M = A (J kron J*) A^-1 (A the
        Stokes-from-coherency map): the Mueller-Jones matrices of a
        coherent trace."""
        J = self.jones
        A = torch.tensor([[1, 0, 0, 1], [1, 0, 0, -1], [0, 1, 1, 0],
                          [0, 1j, -1j, 0]], dtype=J.dtype, device=J.device)
        K = torch.einsum('...ij,...kl->...ikjl', J, J.conj()).reshape(
            J.shape[:-2] + (4, 4))
        M = (A @ K @ torch.linalg.inv(A)).real
        return torch.where(self.mask[..., None, None], M,
                           torch.zeros_like(M))

    @property
    def retardance(self):
        """The phase difference (radians) of the eigenvalues of J's unitary
        factor U (J = U H, U = W Vh of the SVD J = W S Vh): the phase
        aberration between polarization states, free of the shared path
        length (``track_opl``'s)."""
        W, _, Vh = torch.linalg.svd(self.jones)
        lam = torch.linalg.eigvals(W @ Vh)
        d = torch.abs(torch.angle(lam[..., 0] * torch.conj(lam[..., 1])))
        return self._masked(torch.where(d > math.pi, 2 * math.pi - d, d))


def pupil_rays(pupil_radius, n, launch_z=-10.0, wavelength=None,
               device='cpu'):
    """The Jones pupil's rays: an ``n`` x ``n`` grid of rays along +z at
    ``launch_z`` over [-R (1 - 1/2n), R (1 - 1/2n)]^2 (R = ``pupil_radius``),
    intensity 1 inside the pupil disk and 0 outside, at ``wavelength`` (None:
    unset) -> ``(rays, xs, inside)``; the grid's row index is y, its
    column x."""
    from ..rays.ray import Rays
    R = float(pupil_radius)
    xs = torch.linspace(-R * (1 - 0.5 / n), R * (1 - 0.5 / n), n,
                        device=device)
    Y, X = torch.meshgrid(xs, xs, indexing='ij')
    x, y = X.reshape(-1), Y.reshape(-1)
    inside = (x * x + y * y) <= R * R
    zero = torch.zeros_like(x)
    rays = Rays.from_components(
        (x, y, zero + launch_z), (zero, zero, torch.ones_like(x)),
        inside.to(torch.float32), torch.zeros_like(x, dtype=torch.int32),
        zero if wavelength is None else zero + wavelength)
    return rays, xs, inside


def exit_components(out, field):
    """The final field on the exit basis of each ray: x_out the
    normalization of x - (x . d) d (the parallel transport of x onto the
    final direction d), y_out = d x x_out -> ``((Ex_r, Ex_i), (Ey_r,
    Ey_i))``, so that a perfect axial system reads as the identity times
    its transmission."""
    d = out.dir_c
    bx = (1.0 - d[0] * d[0], -d[0] * d[1], -d[0] * d[2])
    nrm = 1.0 / torch.sqrt(torch.clamp(v3.dot(bx, bx), min=1e-24))
    bx = tuple(c * nrm for c in bx)
    by = (d[1] * bx[2] - d[2] * bx[1],
          d[2] * bx[0] - d[0] * bx[2],
          d[0] * bx[1] - d[1] * bx[0])
    return ((v3.dot(bx, field.r_c), v3.dot(bx, field.i_c)),
            (v3.dot(by, field.r_c), v3.dot(by, field.i_c)))


def pupil_of(columns, inside, xs):
    """A ``JonesPupil`` from the two traces' ``(out, field)`` (x-, then
    y-polarized input) on ``pupil_rays``' grid."""
    n = xs.shape[0]
    (xx, yx), (xy, yy) = (exit_components(out, f) for out, f in columns)
    j_re = torch.stack([torch.stack([xx[0], xy[0]], -1),
                        torch.stack([yx[0], yy[0]], -1)], -2)
    j_im = torch.stack([torch.stack([xx[1], xy[1]], -1),
                        torch.stack([yx[1], yy[1]], -1)], -2)
    mask = inside & (columns[0][0].intensity > 0) & (
        columns[1][0].intensity > 0)
    return JonesPupil(j_re.reshape(n, n, 2, 2), j_im.reshape(n, n, 2, 2),
                      mask.reshape(n, n), xs)


def jones_pupil(scene, params, pupil_radius, n=32, launch_z=-10.0,
                wavelength=None, **kw):
    """Trace the Jones pupil of ``scene``: ``pupil_rays``' n x n grid,
    traced by ``scene.simulate`` with the field twice (x- and y-polarized
    E0), the final fields read on the exit basis (``exit_components``) ->
    ``JonesPupil``.  The rays lie on the device of ``params``; ``kw`` goes
    to ``simulate`` (a FRESNEL scene's ``generator`` or ``uniforms``)."""
    device = next(t.device for el in params.values() for t in el.values()
                  if torch.is_tensor(t))
    rays, xs, inside = pupil_rays(pupil_radius, n, launch_z, wavelength,
                                  device)
    columns = []
    for E0 in ([[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]):
        out, _, aux = scene.simulate(params, rays, track_field=True, E0=E0,
                                     **kw)
        columns.append((out, aux['field']))
    return pupil_of(columns, inside, xs)
