"""Electric-field (polarization) transport as optional ray state.

Counterpart of ``raytracetorch_tpu/core/field.py``.  Each ray can carry a
complex E-vector perpendicular to its direction (``FieldState``: six
planar tensors, the real and imaginary parts of x, y and z); every
refraction decomposes E into s and p components, applies the
flux-normalized Fresnel amplitudes (complex under TIR) and rebuilds E
around the outgoing direction, so |E|^2 is the polarization-resolved power
fraction.  ``trace_sequential(track_field=True, E0=...)`` carries it
(core/trace.py): the sensor moments and grids are weighted by
``intensity * |E|^2``, and ``aux['field']`` / ``aux['field_power']`` hold
the final state; ``trace_nonsequential`` carries it through the bounce
loop likewise.  The fused kernels K1, K2, K5 and K6 run the same functions
(csrc/field.cuh).

On the Fresnel kinds (FRESNEL, FRESNEL_W, REFLECT_W) the branch power lives
in the draw or the intensity factor (core/static_dispatch.py::polarized_RT),
so the field is renormalized there and carries the branch's polarization
state alone.  A coated interface takes its thin-film stack's complex
amplitudes (utils/coatings.py::coating_amplitudes; a coated SNELL row's
transmission is not renormalized, so |E|^2 carries the coating's T), a
metal mirror its metal's (metal_reflection_amplitudes), renormalized as its
polarized R weighs the intensity.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import PhysKind
from ..geom import vec3 as v3
from ..utils.birefringence import birefringence
from ..utils.coatings import coating_amplitudes, metal_reflection_amplitudes
from .static_dispatch import _stack_lam, in_ray_order, metal_nk, stack_columns

# the kinds whose transport takes the Fresnel amplitudes
FIELD_FRESNEL_KINDS = (PhysKind.SNELL, PhysKind.FRESNEL, PhysKind.FRESNEL_W,
                       PhysKind.REFLECT_W)


def sp_basis(d, n):
    """s/p basis of an interaction: s = normalize(d x n) (at normal
    incidence, a perpendicular built from d's smallest component), p = s x
    d, so (s, p, d) is right-handed.  Component tuples of [N]."""
    sx = d[1] * n[2] - d[2] * n[1]
    sy = d[2] * n[0] - d[0] * n[2]
    sz = d[0] * n[1] - d[1] * n[0]
    s2 = sx * sx + sy * sy + sz * sz
    degen = s2 < 1e-12
    inv = 1.0 / torch.sqrt(torch.where(degen, 1.0, s2))
    ax = torch.where(torch.abs(d[0]) < 0.9, 1.0, 0.0)
    ay = 1.0 - ax
    fx = ay * d[2] - 0.0
    fy = 0.0 - ax * d[2]
    fz = ax * d[1] - ay * d[0]
    f2 = torch.sqrt(fx * fx + fy * fy + fz * fz + 1e-24)
    s = (torch.where(degen, fx / f2, sx * inv),
         torch.where(degen, fy / f2, sy * inv),
         torch.where(degen, fz / f2, sz * inv))
    p = (s[1] * d[2] - s[2] * d[1],
         s[2] * d[0] - s[0] * d[2],
         s[0] * d[1] - s[1] * d[0])
    return s, p


def sp_power_fractions(Er, Ei, d, n):
    """The field's component powers ``(|Es|^2, |Ep|^2)`` in the
    interaction's s/p basis (their sum is |E|^2 for E perpendicular to d):
    the weights of the polarized Fresnel reflectance."""
    s_hat, p_hat = sp_basis(d, n)
    es_r, es_i = v3.dot(Er, s_hat), v3.dot(Ei, s_hat)
    ep_r, ep_i = v3.dot(Er, p_hat), v3.dot(Ei, p_hat)
    return es_r * es_r + es_i * es_i, ep_r * ep_r + ep_i * ep_i


def _tir_r(a, b):
    """(a - i b) / (a + i b), a unit complex number, as (real, imag)."""
    den = a * a + b * b + 1e-24
    return (a * a - b * b) / den, -2.0 * a * b / den


def fresnel_amplitudes(n1, n2, cos_i, sin2_t):
    """Flux-normalized amplitudes of an interface: ``(ts, tp)`` the real
    transmission magnitudes (0 under TIR), ``(rs, rp)`` the complex
    reflections as (real, imag) pairs (unit modulus with the TIR phase
    under TIR), and the TIR mask."""
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.where(tir, 1.0, torch.clamp(1.0 - sin2_t,
                                                         min=0.0)))
    kappa = torch.sqrt(torch.where(tir, torch.clamp(sin2_t - 1.0, min=0.0),
                                   0.0))
    ts = 2 * n1 * cos_i / (n1 * cos_i + n2 * cos_t + 1e-12)
    tp = 2 * n1 * cos_i / (n2 * cos_i + n1 * cos_t + 1e-12)
    flux = torch.sqrt(torch.clamp(n2 * cos_t, min=0.0)
                      / torch.clamp(n1 * cos_i, min=1e-12))
    ts_flux = torch.where(tir, 0.0, ts * flux)
    tp_flux = torch.where(tir, 0.0, tp * flux)
    rs_r = (n1 * cos_i - n2 * cos_t) / (n1 * cos_i + n2 * cos_t + 1e-12)
    rp_r = (n2 * cos_i - n1 * cos_t) / (n2 * cos_i + n1 * cos_t + 1e-12)
    rs_tr, rs_ti = _tir_r(n1 * cos_i, n2 * kappa)
    rp_tr, rp_ti = _tir_r(n2 * cos_i, n1 * kappa)
    rs = (torch.where(tir, rs_tr, rs_r), torch.where(tir, rs_ti, 0.0))
    rp = (torch.where(tir, rp_tr, rp_r), torch.where(tir, rp_ti, 0.0))
    return ts_flux, tp_flux, rs, rp, tir


class FieldState:
    """The complex E-field of each ray, component-planar: six [N] tensors
    ``erx, ery, erz`` (real part) and ``eix, eiy, eiz`` (imaginary)."""

    __slots__ = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')
    FIELDS = __slots__

    def __init__(self, erx, ery, erz, eix, eiy, eiz):
        self.erx, self.ery, self.erz = erx, ery, erz
        self.eix, self.eiy, self.eiz = eix, eiy, eiz

    @staticmethod
    def of(Er, Ei):
        """From the (real, imaginary) component tuples."""
        return FieldState(*Er, *Ei)

    @property
    def r_c(self):
        return (self.erx, self.ery, self.erz)

    @property
    def i_c(self):
        return (self.eix, self.eiy, self.eiz)

    def streams(self):
        """The six tensors, in ``FIELDS`` order."""
        return tuple(getattr(self, f) for f in self.FIELDS)

    def power(self):
        """|E|^2, the polarization-resolved power fraction, [N]."""
        return v3.norm2(self.r_c) + v3.norm2(self.i_c)

    def masked(self, mask, Er_new, Ei_new):
        return FieldState.of(v3.where(mask, Er_new, self.r_c),
                             v3.where(mask, Ei_new, self.i_c))

    @classmethod
    def init(cls, rays, E0=None):
        """The launch field: ``E0`` is ``[N, 3]``, ``[1, 3]`` or ``[3]``
        (a list, an array or a tensor; real means linear polarization,
        complex elliptical); None is x-linear.  It is projected
        perpendicular to the launch directions and normalized to |E|^2 = 1
        per ray, differentiably in a real or complex tensor ``E0``."""
        d = rays.dir_c
        n, dt, dev = rays.n, rays.px.dtype, rays.px.device
        if E0 is None:
            zero = torch.zeros(n, dtype=dt, device=dev)
            Er = (torch.ones(n, dtype=dt, device=dev), zero, zero)
            Ei = (zero, zero, zero)
        else:
            if not torch.is_tensor(E0):
                E0 = np.asarray(E0)
                E0 = torch.from_numpy(np.array(E0, dtype=np.complex128
                                               if np.iscomplexobj(E0)
                                               else np.float64))
            re, im = ((torch.real(E0), torch.imag(E0)) if E0.is_complex()
                      else (E0, None))

            def as_n3(a):
                a = a.to(dtype=dt, device=dev)
                if a.dim() == 1:
                    a = a[None, :]
                return a.expand(n, 3)

            Er = v3.from_array(as_n3(re))
            Ei = (v3.from_array(as_n3(im)) if im is not None
                  else (torch.zeros(n, dtype=dt, device=dev),) * 3)
        Er = tuple(e - v3.dot(Er, d) * dd for e, dd in zip(Er, d))
        Ei = tuple(e - v3.dot(Ei, d) * dd for e, dd in zip(Ei, d))
        norm = torch.sqrt(torch.clamp(v3.norm2(Er) + v3.norm2(Ei),
                                      min=1e-24))
        return cls.of(v3.scale(Er, 1.0 / norm), v3.scale(Ei, 1.0 / norm))


def _cmul(a, e_r, e_i):
    """(a_r + i a_i) (e_r + i e_i) with a = (a_r, a_i) -> (real, imag)."""
    return a[0] * e_r - a[1] * e_i, a[0] * e_i + a[1] * e_r


def _renormalize(Er, Ei, Er_new, Ei_new):
    """Scale the new field to the old one's power (a zero-amplitude branch,
    such as the reflected branch of pure p at Brewster, to 0)."""
    p_in = v3.norm2(Er) + v3.norm2(Ei)
    p_raw = v3.norm2(Er_new) + v3.norm2(Ei_new)
    ok = p_raw > 1e-20
    scale = torch.sqrt(p_in / torch.where(ok, p_raw, 1.0))
    scale = torch.where(ok, scale, 0.0)
    return v3.scale(Er_new, scale), v3.scale(Ei_new, scale)


def transport_field(meta, row, d_in, new_dir, n_w, imod, Er, Ei,
                    wavelength=None):
    """One interaction applied to the E-field -> the new ``(Er, Ei)``
    component tuples (unmasked: the caller merges with the row's active
    mask).  ``d_in`` is the incoming direction, ``new_dir`` the one the
    intensity trace chose, ``imod`` its intensity factor (after a fuzzy
    callable's).

    SNELL and the Fresnel kinds apply the Fresnel amplitudes (reflection
    where the direction's normal component flipped: TIR or a FRESNEL
    reflection draw), a coated row its stack's (``_coated_amplitudes``),
    renormalized on the Fresnel kinds; a metal mirror reflects with its
    metal's amplitudes, renormalized (``_metal``); JONES multiplies
    the transverse field by its Jones matrix, with axes at ``ph[0]`` from
    the element-local x axis projected transverse to the ray, retardance
    ``ph[3]`` (scaled by lam0 / lam on a chromatic plate, and by the
    crystal's dn(lam) / dn(lam0) on a plate of a material); DOE and
    PHASE_GRID rebuild the s/p components around the new direction with
    amplitude sqrt(imod); a perfect (not metal) REFLECT reflects the field
    like a direction, BLOCK zeroes it, and every other kind scales it by
    sqrt(imod)."""
    if meta.ph in FIELD_FRESNEL_KINDS:
        if meta.disp and wavelength is not None:
            from .static_dispatch import dispersive_iors
            n_in, n_out = dispersive_iors(row, wavelength, meta)
        else:
            n_in, n_out = row.ph[..., 0], row.ph[..., 1]
        dot = v3.dot(d_in, n_w)
        from_in = dot < 0
        n1 = torch.where(from_in, n_in, n_out)
        n2 = torch.where(from_in, n_out, n_in)
        cos_i = torch.abs(dot)
        sin2_t = (n1 / n2) ** 2 * (1.0 - cos_i ** 2)
        ts, tp, rs, rp, tir = fresnel_amplitudes(n1, n2, cos_i, sin2_t)
        ts_c, tp_c = (ts, torch.zeros_like(ts)), (tp, torch.zeros_like(tp))
        if meta.n_coat:
            ts_c, tp_c, rs, rp = _coated_amplitudes(
                meta, row, n1, n2, cos_i, tir, rs, rp, wavelength)
        s_hat, p_in = sp_basis(d_in, n_w)
        _, p_out = sp_basis(new_dir, n_w)       # the same s, the new p
        Es_r, Es_i = v3.dot(Er, s_hat), v3.dot(Ei, s_hat)
        Ep_r, Ep_i = v3.dot(Er, p_in), v3.dot(Ei, p_in)
        reflected = (v3.dot(new_dir, n_w) * dot) < 0.0
        t_s, r_s = _cmul(ts_c, Es_r, Es_i), _cmul(rs, Es_r, Es_i)
        t_p, r_p = _cmul(tp_c, Ep_r, Ep_i), _cmul(rp, Ep_r, Ep_i)
        as_r = torch.where(reflected, r_s[0], t_s[0])
        as_i = torch.where(reflected, r_s[1], t_s[1])
        ap_r = torch.where(reflected, r_p[0], t_p[0])
        ap_i = torch.where(reflected, r_p[1], t_p[1])
        Er_new = v3.add(v3.scale(s_hat, as_r), v3.scale(p_out, ap_r))
        Ei_new = v3.add(v3.scale(s_hat, as_i), v3.scale(p_out, ap_i))
        if meta.ph != PhysKind.SNELL:
            Er_new, Ei_new = _renormalize(Er, Ei, Er_new, Ei_new)
        return Er_new, Ei_new
    if meta.ph == PhysKind.REFLECT and meta.metal:
        return _metal(meta, row, d_in, new_dir, n_w, Er, Ei, wavelength)
    if meta.ph == PhysKind.JONES:
        return _jones(meta, row, new_dir, Er, Ei, wavelength)
    if meta.ph in (PhysKind.DOE, PhysKind.PHASE_GRID):
        s_hat, p_in = sp_basis(d_in, n_w)
        _, p_out = sp_basis(new_dir, n_w)
        amp = torch.sqrt(torch.clamp(imod, min=0.0))
        Es_r, Es_i = v3.dot(Er, s_hat), v3.dot(Ei, s_hat)
        Ep_r, Ep_i = v3.dot(Er, p_in), v3.dot(Ei, p_in)
        return (v3.add(v3.scale(s_hat, amp * Es_r),
                       v3.scale(p_out, amp * Ep_r)),
                v3.add(v3.scale(s_hat, amp * Es_i),
                       v3.scale(p_out, amp * Ep_i)))
    if meta.ph == PhysKind.REFLECT:
        return (v3.fma(Er, -2.0 * v3.dot(Er, n_w), n_w),
                v3.fma(Ei, -2.0 * v3.dot(Ei, n_w), n_w))
    if meta.ph == PhysKind.BLOCK:
        zero = (torch.zeros_like(Er[0]),) * 3
        return zero, zero
    amp = torch.sqrt(torch.clamp(imod, min=0.0))
    return v3.scale(Er, amp), v3.scale(Ei, amp)


def _coated_amplitudes(meta, row, n1, n2, cos_i, tir, rs, rp, wavelength):
    """A coated interface's ``(ts, tp, rs, rp)`` as (re, im) pairs: its
    stack's complex amplitudes (``coating_amplitudes``) in the order the ray
    meets its layers (``in_ray_order``); under TIR the bare interface's
    reflections ``rs``, ``rp`` (an evanescent-coupled stack is out of
    scope)."""
    lam = _stack_lam(wavelength)
    ts, rs_c = in_ray_order(meta, row, n1, n2, lambda ns, ds, ks: (
        coating_amplitudes(ns, ds, n1, n2, cos_i, lam, pol='s', k_stack=ks)))
    tp, rp_c = in_ray_order(meta, row, n1, n2, lambda ns, ds, ks: (
        coating_amplitudes(ns, ds, n1, n2, cos_i, lam, pol='p', k_stack=ks)))
    return (ts, tp, tuple(torch.where(tir, a, b) for a, b in zip(rs, rs_c)),
            tuple(torch.where(tir, a, b) for a, b in zip(rp, rp_c)))


def _metal(meta, row, d_in, new_dir, n_w, Er, Ei, wavelength):
    """A metal mirror's transport: the complex s and p reflections of its
    (coated) metal (``metal_reflection_amplitudes``; ph = (n_metal,
    k_metal, n_ambient), a dispersive metal's (n, k) at the rays'
    wavelength on its knots), renormalized to the incoming |E|^2 (the
    intensity carries the polarized R, core/static_dispatch.py)."""
    cos_i = torch.abs(v3.dot(d_in, n_w))
    lam = _stack_lam(wavelength)
    n_m, k_m = metal_nk(meta, row, lam, cos_i)
    ns, ds, ks = stack_columns(meta, row)
    rs, rp = (metal_reflection_amplitudes(ns, ds, row.ph[..., 2], n_m, k_m,
                                          cos_i, lam, pol=pol, k_stack=ks)
              for pol in ('s', 'p'))
    s_hat, p_in = sp_basis(d_in, n_w)
    _, p_out = sp_basis(new_dir, n_w)
    a_s = _cmul(rs, v3.dot(Er, s_hat), v3.dot(Ei, s_hat))
    a_p = _cmul(rp, v3.dot(Er, p_in), v3.dot(Ei, p_in))
    return _renormalize(
        Er, Ei, v3.add(v3.scale(s_hat, a_s[0]), v3.scale(p_out, a_p[0])),
        v3.add(v3.scale(s_hat, a_s[1]), v3.scale(p_out, a_p[1])))


def jones_retardance(meta, row, wavelength=None):
    """A JONES row's retardance at the rays' wavelength: ``ph[3]``, times
    lam0 / lam on a chromatic plate (lam the ray's wavelength, lam0 =
    ``ph[4]`` where it is unset), times dn(lam) / dn(lam0) of its crystal
    (``meta.jones_bire``)."""
    delta = row.ph[..., 3]
    if not meta.jones_chrom:
        return delta
    lam0 = row.ph[..., 4]
    lam = (torch.where(wavelength > 0, wavelength, lam0)
           if wavelength is not None else lam0)
    delta = delta * lam0 / lam
    if meta.jones_bire is not None:
        delta = delta * birefringence(meta.jones_bire, lam) \
            / birefringence(meta.jones_bire, lam0)
    return delta


def _jones(meta, row, d, Er, Ei, wavelength):
    """The JONES transport: J = R(theta) diag(a1 e^{-i delta/2}, a2
    e^{+i delta/2}) R(-theta) on the transverse field, its axes the
    element-local x axis (world column Rw[:, 0]) projected transverse to
    the ray (Rw[:, 1] for a ray along that axis)."""
    theta = row.ph[..., 0]
    a1, a2 = row.ph[..., 1], row.ph[..., 2]
    delta = jones_retardance(meta, row, wavelength)
    xw = (row.Rw[..., 0, 0], row.Rw[..., 1, 0], row.Rw[..., 2, 0])
    yw = (row.Rw[..., 0, 1], row.Rw[..., 1, 1], row.Rw[..., 2, 1])
    e1 = tuple(x - v3.dot(xw, d) * dd for x, dd in zip(xw, d))
    degen = v3.norm2(e1) < 1e-12
    e1b = tuple(y - v3.dot(yw, d) * dd for y, dd in zip(yw, d))
    e1 = v3.where(degen, e1b, e1)
    e1 = v3.scale(e1, 1.0 / torch.sqrt(v3.norm2(e1) + 1e-24))
    e2 = (d[1] * e1[2] - d[2] * e1[1],
          d[2] * e1[0] - d[0] * e1[2],
          d[0] * e1[1] - d[1] * e1[0])
    ca, sa = torch.cos(theta), torch.sin(theta)
    ax = tuple(ca * u + sa * v for u, v in zip(e1, e2))
    bx = tuple(-sa * u + ca * v for u, v in zip(e1, e2))
    ch, sh = torch.cos(0.5 * delta), torch.sin(0.5 * delta)
    oa = _cmul((a1 * ch, -a1 * sh), v3.dot(Er, ax), v3.dot(Ei, ax))
    ob = _cmul((a2 * ch, a2 * sh), v3.dot(Er, bx), v3.dot(Ei, bx))
    return (v3.add(v3.scale(ax, oa[0]), v3.scale(bx, ob[0])),
            v3.add(v3.scale(ax, oa[1]), v3.scale(bx, ob[1])))
