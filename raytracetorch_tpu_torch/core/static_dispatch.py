"""Statically specialized bound and physics evaluation for the sequential path.

Counterpart of ``raytracetorch_tpu/core/static_dispatch.py``.  In a
sequential trace every row's kinds are known before the trace runs
(``StaticRowMeta``), so each step evaluates exactly one bound formula and
one physics model.

The port covers the kinds of the main path, of the mirror family, of the
pixelated phase plate, of the mixed-surface and asphere scenes, of the
diffractive and ideal elements and of the convex solids and custom shapes:
surface bounds NONE/DISK/RECT/ELLIPSE/HEMI/HEMI_APER/CONE_NAPPE (one nappe
of a cone), volume bounds NONE/APER_R2/Z_BETWEEN/RECT/CYL_EDGE/HALFSPACES
(the AND of a solid's other faces' outward half-spaces), physics
TRANSMIT, BLOCK, REFLECT (the ideal mirror, and a metal one:
``mirror_reflectances_sp``), SNELL, APERTURE and PHASE_GRID, the ideal ABCD
map LINEAR, the linear GRATING, the radial-phase kinoform DOE (its
coefficients in the row's ``ff`` columns, its term count and efficiency
flag on ``meta.doe``) and the microlens array MLA, the Fresnel kinds
FRESNEL (the Monte-Carlo branch draw: it reads the ray's uniform ``u``),
FRESNEL_W (refract, intensity times 1 - R) and REFLECT_W (the ghost
reflection, intensity times R) on bare or thin-film coated interfaces
(``coated_rt_sp``, absorbing films included), even-asphere and freeform
rows (``meta.ff``, the static exponent pairs), dispersive media (Cauchy
and Sellmeier, ``dispersive_iors``) and the polarizers' and waveplates'
JONES, a geometric pass-through whose action is on the tracked field
(core/field.py), which raises without one.  GRIN rows are traced by the
trace loops themselves (core/grin.py): ``apply_physics_one`` and
``medium_after`` raise on them, as the JAX package's physics does.  Under
``track_field`` (a ``field``, core/field.py::FieldState) the Fresnel kinds,
bare or coated, take the polarized reflectance and transmittance of the
rays' field state (``polarized_RT``): FRESNEL's draw compares the same
``u`` with R_pol,
FRESNEL_W weighs by 1 - R_pol (an absorbing stack's by T_pol) and
REFLECT_W by R_pol; a metal mirror weighs by its polarized R.  Every other
kind (SCATTER) raises NotImplementedError naming the ROADMAP item that
brings it.  ``medium_after`` gives the index of the medium a ray travels in
after a row, for the optical path length (``track_opl``).
"""

from __future__ import annotations

import torch

from ..constants import (CVX_EPS, CYL_EDGE_EPS, CYL_RECT_EPS, INTERSECT_EPS,
                         DispModel, PhysKind, SBKind, VBKind)
from ..geom import vec3 as v3
from ..geom.surfaces import sag_z
from ..utils.coatings import (D_LINE_UM, _max, coating_rt, metal_nk_at,
                              metal_reflectance)
from .physics import (doe_dir, fresnel_dir, fresnel_reflectance,
                      fresnel_rs_rp, grating_dir,
                      kinoform_efficiency, linear_dir, mla_dir,
                      phase_grid_dir, reflect_dir, refract_components,
                      snell_dir)

# ROADMAP.md "Queue 1" items that bring the rest of the feature matrix
TODO_FEATURES = 'ROADMAP Queue 1 item 12 (remaining sequential features)'
TODO_ELEMENTS = 'ROADMAP Queue 1 item 14 (remaining elements)'
# the Fresnel kinds: the Monte-Carlo branch draw, the weighted transmission
# and the ghost reflection
FRESNEL_KINDS = (PhysKind.FRESNEL, PhysKind.FRESNEL_W, PhysKind.REFLECT_W)
# the diffractive and ideal elements: per-ray direction maps of a plane
DIFFRACTIVE_KINDS = (PhysKind.LINEAR, PhysKind.GRATING, PhysKind.DOE,
                     PhysKind.MLA)


def sb_check_one(kind: int, sb, hit):
    """Single-kind surface-local bound; ``hit`` is a component tuple."""
    x, y, z = hit
    if kind == SBKind.NONE:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if kind == SBKind.DISK:
        dx_ = x - sb[..., 1]
        dy_ = y - sb[..., 2]
        return dx_ * dx_ + dy_ * dy_ <= sb[..., 0]
    if kind == SBKind.RECT:
        return (torch.abs(x) <= sb[..., 0]) & (torch.abs(y) <= sb[..., 1])
    if kind == SBKind.ELLIPSE:
        # [r_major, r_minor, rotation]
        c, s = torch.cos(sb[..., 2]), torch.sin(sb[..., 2])
        u = x * c - y * s
        v = x * s + y * c
        return (u / sb[..., 0]) ** 2 + (v / sb[..., 1]) ** 2 <= 1.0
    if kind == SBKind.HEMI:
        return torch.abs(z * sb[..., 0]) < 1.0 + INTERSECT_EPS
    if kind == SBKind.HEMI_APER:
        return ((torch.abs(z * sb[..., 0]) < 1.0 + INTERSECT_EPS)
                & (x * x + y * y <= sb[..., 1]))
    if kind == SBKind.CONE_NAPPE:
        # [slope]: the nappe on the slope's side of z = 0
        return z * sb[..., 0] >= -INTERSECT_EPS
    raise NotImplementedError(
        f'surface bound {SBKind(kind).name} is {TODO_ELEMENTS}')


def vb_check_one(kind: int, vb, hit, hp=None):
    """Single-kind volume bound on the element-frame hit.  ``hp`` is the
    row's ``(hp_n [P, 3], hp_d [P], hp_mask [P])`` for HALFSPACES (the mask
    bool, or float 0/1 as a flat row carries it)."""
    x, y, z = hit
    if kind == VBKind.NONE:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if kind == VBKind.APER_R2:
        return x * x + y * y <= vb[..., 0]
    if kind == VBKind.Z_BETWEEN:
        return (z >= vb[..., 0]) & (z <= vb[..., 1])
    if kind == VBKind.RECT:
        # [xmin, xmax, ymin, ymax] with CYL_RECT_EPS of slack
        return _in_rect(vb, 0, x, y)
    if kind == VBKind.CYL_EDGE:
        # [c1, z1, c2, z2, xmin, xmax, ymin, ymax]: inside the rectangle and
        # between the y-dependent sags of a cylindrical lens's two faces
        z_front = sag_z(vb[..., 0], y) + vb[..., 1]
        z_back = sag_z(vb[..., 2], y) + vb[..., 3]
        return (_in_rect(vb, 4, x, y) & (z >= z_front + CYL_EDGE_EPS)
                & (z <= z_back - CYL_EDGE_EPS))
    if kind == VBKind.HALFSPACES:
        # inside every active plane n . h - d < CVX_EPS (a solid's face
        # omits its own plane)
        hp_n, hp_d, hp_mask = hp
        active = hp_mask if hp_mask.dtype == torch.bool else hp_mask > 0.5
        signed = (hp_n[..., 0] * x[..., None] + hp_n[..., 1] * y[..., None]
                  + hp_n[..., 2] * z[..., None]) - hp_d
        return torch.all((signed < CVX_EPS) | ~active, dim=-1)
    raise NotImplementedError(
        f'volume bound {VBKind(kind).name} is {TODO_ELEMENTS}')


def _in_rect(vb, i, x, y):
    return ((x <= vb[..., i + 1] + CYL_RECT_EPS)
            & (x >= vb[..., i] - CYL_RECT_EPS)
            & (y <= vb[..., i + 3] + CYL_RECT_EPS)
            & (y >= vb[..., i + 2] - CYL_RECT_EPS))


class StaticRowMeta:
    """Compile-time kinds of one surface row, read off the element specs
    before tracing (``SequentialScene.static_meta``).  Carries every slot of
    the JAX class, so a reference scene's metadata converts one to one."""

    __slots__ = ('ph', 'sb', 'vb', 'sensor', 'invert', 'asph', 'disp',
                 'plane', 'slot', 'n_coat', 'dispm', 'metal', 'metal_nk',
                 'coat_k', 'ff', 'scatter', 'jones_chrom', 'jones_bire',
                 'grin_steps', 'doe', 'depol')

    def __init__(self, ph, sb, vb, sensor=False, invert=False, asph=False,
                 disp=False, plane=False, slot=0, n_coat=0,
                 dispm=(1, 1), metal=False, metal_nk=None, coat_k=None,
                 ff=None, scatter=None, jones_chrom=False,
                 jones_bire=None, grin_steps=0, doe=None, depol=False):
        self.ph, self.sb, self.vb = int(ph), int(sb), int(vb)
        self.sensor = bool(sensor)
        self.invert = bool(invert)
        self.asph = bool(asph)
        self.disp = bool(disp)
        self.plane = bool(plane)
        self.slot = int(slot)
        self.n_coat = int(n_coat)
        self.dispm = (int(dispm[0]), int(dispm[1]))
        self.metal = bool(metal)
        self.metal_nk = (tuple(map(tuple, metal_nk))
                         if metal_nk is not None else None)
        self.ff = (tuple((int(a), int(b)) for a, b in ff) if ff else None)
        ck = (tuple(float(k) for k in coat_k)
              if coat_k is not None else None)
        self.coat_k = ck if ck is not None and any(ck) else None
        self.scatter = str(scatter) if scatter is not None else None
        self.jones_chrom = bool(jones_chrom)
        self.jones_bire = (str(jones_bire).upper()
                           if jones_bire is not None else None)
        self.grin_steps = int(grin_steps)
        self.doe = ((int(doe[0]), bool(doe[1])) if doe is not None else None)
        self.depol = bool(depol)

    def __eq__(self, other):
        return isinstance(other, StaticRowMeta) and all(
            getattr(self, s) == getattr(other, s) for s in self.__slots__)


def coat_acts(meta: StaticRowMeta):
    """Whether the row's thin-film stack or metal substrate changes the
    rays' intensity: a metal mirror, or a stack on a Fresnel kind (on a
    SNELL row a stack acts on the polarized field's amplitudes alone:
    ``field_coat_acts``)."""
    return meta.metal or bool(meta.n_coat and meta.ph in FRESNEL_KINDS)


def field_coat_acts(meta: StaticRowMeta):
    """Whether the row's stack or metal changes a trace with the polarized
    field: ``coat_acts``, or a stack on a SNELL row (whose field takes the
    stack's transmission amplitudes, core/field.py::transport_field)."""
    return coat_acts(meta) or bool(meta.n_coat and meta.ph == PhysKind.SNELL)


def unsupported(meta: StaticRowMeta):
    """Why the port cannot trace this row yet (None when it can)."""
    if meta.metal and meta.ph != PhysKind.REFLECT:
        return 'a metal substrate is a REFLECT row\'s'
    if meta.ph == PhysKind.SCATTER:
        return f'physics {PhysKind(meta.ph).name} is {TODO_ELEMENTS}'
    if meta.ph == PhysKind.GRIN and meta.grin_steps < 1:
        return 'a GRIN row needs its static RK4 step count (grin_steps >= 1)'
    if meta.ph not in (PhysKind.TRANSMIT, PhysKind.BLOCK, PhysKind.REFLECT,
                       PhysKind.SNELL, PhysKind.APERTURE,
                       PhysKind.PHASE_GRID, PhysKind.JONES,
                       PhysKind.GRIN) + \
            FRESNEL_KINDS + DIFFRACTIVE_KINDS:
        return f'physics {PhysKind(meta.ph).name} is {TODO_FEATURES}'
    if meta.ph == PhysKind.DOE and not (
            meta.doe is not None and 1 <= meta.doe[0] <= 8):
        return 'a DOE row needs its static (1..8 terms, efficiency) doe'
    if meta.sb not in (SBKind.NONE, SBKind.DISK, SBKind.RECT, SBKind.ELLIPSE,
                       SBKind.HEMI, SBKind.HEMI_APER, SBKind.CONE_NAPPE):
        return f'surface bound {SBKind(meta.sb).name} is {TODO_ELEMENTS}'
    if meta.vb not in (VBKind.NONE, VBKind.APER_R2, VBKind.Z_BETWEEN,
                       VBKind.RECT, VBKind.CYL_EDGE, VBKind.HALFSPACES):
        return f'volume bound {VBKind(meta.vb).name} is {TODO_ELEMENTS}'
    return None


def dispersive_iors(row, wavelength_um, meta=None):
    """Per-ray media indices ``(n_in, n_out)`` of a dispersive surface.

    Each side's model is static (``meta.dispm``, a DispModel pair; None
    keeps Cauchy on both sides).  The row's ``disp`` columns are laid out
    [in side 6 | out side 6]:

    - CAUCHY: n = n_d + B (1/lambda^2 - 1/lambda_d^2), B (um^2) in the
      side's first slot, the d-line index (0.5876 um) in ph[side];
    - SELLMEIER: n^2 = 1 + sum_i Bi lambda^2 / (lambda^2 - Ci), the side's
      six slots holding B1 B2 B3 C1 C2 C3 (Ci in um^2);
    - NONE: the constant ph value.

    Unset wavelengths (0) evaluate at the d line; lambda^2 is held at
    1e-6 or more and each Sellmeier denominator off zero by 1e-9, as in the
    JAX package."""
    d2 = 0.5876 ** 2
    l2 = torch.where(wavelength_um > 0,
                     torch.clamp(wavelength_um * wavelength_um, min=1e-6), d2)
    inv_l2, inv_d2 = 1.0 / l2, 1.0 / d2
    models = (meta.dispm if meta is not None
              else (DispModel.CAUCHY, DispModel.CAUCHY))

    def side(j, base):
        nd = row.ph[..., j]
        if models[j] == DispModel.SELLMEIER:
            n2 = torch.ones_like(l2)
            for i in range(3):
                b = row.disp[..., base + i]
                c = row.disp[..., base + 3 + i]
                den = l2 - c
                den = torch.where(torch.abs(den) < 1e-9,
                                  torch.where(den < 0, -1e-9, 1e-9), den)
                n2 = n2 + b * l2 / den
            return torch.sqrt(torch.clamp(n2, min=1e-6))
        if models[j] == DispModel.CAUCHY:
            return nd + row.disp[..., base] * (inv_l2 - inv_d2)
        return nd + 0.0 * l2

    return side(0, 0), side(1, 6)


def _stack_lam(wavelength):
    """The wavelength a stack is evaluated at: the ray's own, or the d line
    (0.5876 um) where it is unset (0) or the rays carry none."""
    if wavelength is None:
        return D_LINE_UM
    return torch.where(wavelength > 0, wavelength, D_LINE_UM)


def coated_reflectance(meta: StaticRowMeta, row, d, n, n_in, n_out,
                       wavelength=None):
    """Unpolarized reflectance of the row's thin-film stack at the ray's
    incidence (``coated_rt_sp``'s mean of Rs and Rp)."""
    rs, rp = coated_reflectance_sp(meta, row, d, n, n_in, n_out, wavelength)
    return 0.5 * (rs + rp)


def coated_reflectance_sp(meta: StaticRowMeta, row, d, n, n_in, n_out,
                          wavelength=None):
    """Per-polarization (Rs, Rp) of the row's thin-film stack."""
    rs, rp, _, _ = coated_rt_sp(meta, row, d, n, n_in, n_out, wavelength)
    return rs, rp


def coated_rt_sp(meta: StaticRowMeta, row, d, n, n_in, n_out,
                 wavelength=None):
    """Per-polarization (Rs, Rp, Ts, Tp) of the row's thin-film stack
    (utils/coatings.py::coating_rt; ``meta.n_coat`` layers, ``row.coat``
    interleaving (index, thickness um), ``meta.coat_k`` the static per-layer
    extinction of absorbing films, which make R + T < 1).

    The stack is listed from the low-index (air) side; a ray arriving from
    the higher-index side (n1 >= n2, ``refract_components``'s sides) meets
    the layers in reverse order, which matters for a stack of more than one
    layer, so both orders are computed and selected per ray, as in the JAX
    package.  The wavelength is the ray's own, or 0.5876 um where it is
    0."""
    _, cos_i, n1, n2, _, _, _, _ = refract_components(d, n, n_in, n_out)
    lam = _stack_lam(wavelength)
    rs, ts = in_ray_order(meta, row, n1, n2, lambda ns, ds, ks: coating_rt(
        ns, ds, n1, n2, cos_i, lam, pol='s', k_stack=ks))
    rp, tp = in_ray_order(meta, row, n1, n2, lambda ns, ds, ks: coating_rt(
        ns, ds, n1, n2, cos_i, lam, pol='p', k_stack=ks))
    return rs, rp, ts, tp


def stack_columns(meta: StaticRowMeta, row):
    """A row's stack as ``(ns, ds, ks)``: the layers' indices and
    thicknesses (its coat columns, outermost first) and their static
    extinction (None: a dielectric stack)."""
    ns = [row.coat[..., 2 * i] for i in range(meta.n_coat)]
    ds = [row.coat[..., 2 * i + 1] for i in range(meta.n_coat)]
    return ns, ds, list(meta.coat_k) if meta.coat_k is not None else None


def in_ray_order(meta: StaticRowMeta, row, n1, n2, fn):
    """``fn(ns, ds, ks)`` (a tuple of tensors, or of (re, im) pairs) of the
    row's stack in the order a ray from index n1 into n2 meets its layers:
    reversed where n1 >= n2 when there are more than one (both orders are
    computed and selected per ray, as in the JAX package)."""
    ns, ds, ks = stack_columns(meta, row)
    out = fn(ns, ds, ks)
    if meta.n_coat < 2:
        return out
    rev = fn(ns[::-1], ds[::-1], ks[::-1] if ks is not None else None)

    def pick(a, b):
        if isinstance(a, tuple):
            return tuple(pick(x, y) for x, y in zip(a, b))
        return torch.where(n1 < n2, a, b)
    return pick(out, rev)


def metal_nk(meta: StaticRowMeta, row, lam, like):
    """A metal row's substrate index ``(n, k)``: ph[0:2], or with
    ``meta.metal_nk`` (metal_dispersion=True) its knots at ``lam`` (the
    stack's wavelength, a float or a tensor shaped as ``like``)."""
    if meta.metal_nk is None:
        return row.ph[..., 0], row.ph[..., 1]
    lam_t = lam if torch.is_tensor(lam) else torch.full_like(like, lam)
    return metal_nk_at(meta.metal_nk[0], meta.metal_nk[1], lam_t)


def mirror_reflectances_sp(meta: StaticRowMeta, row, d, n, wavelength=None):
    """Per-polarization (Rs, Rp) of a metal mirror row, bare or under a
    dielectric (or absorbing) stack (utils/coatings.py::
    metal_reflectance).  The row's ph holds (n_metal, k_metal, n_ambient);
    ``row.coat`` lists the stack outermost first, the order the ambient
    side sees (light reaches a mirror from its ambient side alone: no
    reversal).  With ``meta.metal_nk`` (metal_dispersion=True) the
    substrate's (n, k) follow the ray's wavelength on the metal's knots
    (``metal_nk_at``); an unset wavelength evaluates at the d line on the
    same knots."""
    cos_i = torch.abs(v3.dot(d, n))
    n_amb = row.ph[..., 2]
    ns, ds, ks = stack_columns(meta, row)
    lam = _stack_lam(wavelength)
    n_m, k_m = metal_nk(meta, row, lam, cos_i)
    rs = metal_reflectance(ns, ds, n_amb, n_m, k_m, cos_i, lam, pol='s',
                           k_stack=ks)
    rp = metal_reflectance(ns, ds, n_amb, n_m, k_m, cos_i, lam, pol='p',
                           k_stack=ks)
    return rs, rp


def polarized_R(meta: StaticRowMeta, row, d, n, n_in, n_out, field,
                wavelength=None):
    """The polarization-weighted reflectance R_pol = (Rs |Es|^2 + Rp
    |Ep|^2) / |E|^2 of the row's interface (bare or coated) for the rays'
    field state: the branch probability of the polarized FRESNEL draw and
    the weighted kinds' loss, so that intensity * |E|^2 is energy-exact."""
    return polarized_RT(meta, row, d, n, n_in, n_out, field, wavelength)[0]


def polarized_RT(meta: StaticRowMeta, row, d, n, n_in, n_out, field,
                 wavelength=None):
    """Polarization-weighted ``(R_pol, T_pol)`` of the row's interface for
    the rays' field state (``field``, a core/field.py::FieldState): (Rs, Rp,
    Ts, Tp) of the bare interface (T = 1 - R) or of its thin-film stack
    (``coated_rt_sp`` at the rays' ``wavelength``; an absorbing stack has T
    < 1 - R), weighted by the field's s and p powers; ``(1, 0)`` under
    TIR."""
    from .field import sp_power_fractions
    _, cos_i, n1, n2, _, tir, cos_t, _ = refract_components(d, n, n_in,
                                                            n_out)
    if meta.n_coat:
        Rs, Rp, Ts, Tp = coated_rt_sp(meta, row, d, n, n_in, n_out,
                                      wavelength)
    else:
        Rs, Rp = fresnel_rs_rp(cos_i, cos_t, n1, n2)
        Ts, Tp = 1.0 - Rs, 1.0 - Rp
    fs, fp = sp_power_fractions(field.r_c, field.i_c, d, n)
    frac = torch.clamp(fs + fp, min=1e-20)
    R = (Rs * fs + Rp * fp) / frac
    T = (Ts * fs + Tp * fp) / frac
    return torch.where(tir, 1.0, R), torch.where(tir, 0.0, T)


def medium_after(meta: StaticRowMeta, row, d, n, wavelength=None, u=None,
                 field=None):
    """Index of the medium a ray travels in AFTER this row, for the optical
    path length; None where the row leaves the medium unchanged.

    SNELL and FRESNEL_W move the ray into the transmission-side medium
    unless total internal reflection keeps it in the incidence medium:
    ``where(tir, n1, n2)``; FRESNEL follows its drawn branch, ``where(u <
    R, n1, n2)`` with R = 1 under TIR (``u``, the row's uniform, the same
    one the physics read; R the coated stack's on a coated row,
    ``coated_reflectance``); PHASE_GRID always transmits (an evanescent
    order is dead): ``n2``.  ``n1`` and ``n2`` come from
    ``refract_components``, so they follow the side the ray arrives from
    (the sign of ``d . n``); a dispersive row takes its indices at the rays'
    ``wavelength`` (``dispersive_iors``).  A DOE row, like PHASE_GRID,
    always transmits: ``n2``.  Every other ported kind (REFLECT_W, metal
    mirrors, LINEAR, GRATING and MLA among them) returns None; the kinds the
    port lacks are refused by ``unsupported``, as everywhere.  With
    ``field`` (track_field) FRESNEL's R is the polarized one
    (``polarized_R``), as its physics draws with."""
    why = unsupported(meta)
    if why:
        raise NotImplementedError(why)
    if meta.ph == PhysKind.GRIN:
        raise NotImplementedError(
            'a GRIN rod leaves its ray in the ambient medium ph[0]: the '
            'traces take it from core/grin.py, not from medium_after')
    if meta.ph not in (PhysKind.SNELL, PhysKind.PHASE_GRID, PhysKind.FRESNEL,
                       PhysKind.FRESNEL_W, PhysKind.DOE):
        return None
    if meta.disp and wavelength is not None:
        n_in, n_out = dispersive_iors(row, wavelength, meta)
    else:
        n_in, n_out = row.ph[..., 0], row.ph[..., 1]
    _, cos_i, n1, n2, _, tir, cos_t, _ = refract_components(d, n, n_in,
                                                            n_out)
    if meta.ph in (PhysKind.PHASE_GRID, PhysKind.DOE):
        return n2
    if meta.ph == PhysKind.FRESNEL:
        if field is not None:
            R = polarized_R(meta, row, d, n, n_in, n_out, field, wavelength)
            return torch.where(_draw(u) < R, n1, n2)
        if meta.n_coat:
            r_raw = coated_reflectance(meta, row, d, n, n_in, n_out,
                                       wavelength)
        else:
            r_raw = fresnel_reflectance(cos_i, cos_t, n1, n2)
        R = torch.where(tir, 1.0, r_raw)
        return torch.where(_draw(u) < R, n1, n2)
    return torch.where(tir, n1, n2)


def _draw(u):
    if u is None:
        raise ValueError('a FRESNEL row needs its per-ray uniform draw u '
                         '(core/trace.py passes it from the trace\'s '
                         'generator or injected draws)')
    return u


def apply_physics_one(meta: StaticRowMeta, row, hit_local, d, n,
                      wavelength=None, grid=None, plain=False, u=None,
                      field=None):
    """Single-kind physics -> (new direction tuple, intensity factor).

    FRESNEL reflects where the row's uniform ``u`` < R (``fresnel_dir``;
    intensity unchanged, the choice without derivative); FRESNEL_W refracts
    (TIR reflects at full power) with intensity factor ``clip(1 - R, 0,
    1)``; REFLECT_W reflects with ``clip(R, 0, 1)`` (1 under TIR).  R is
    the unpolarized reflectance of the bare interface
    (``fresnel_reflectance``) or, on a coated row (``meta.n_coat``), of its
    thin-film stack (``coated_rt_sp``), differentiable in the direction,
    the normal, the indices, the layer thicknesses and the wavelength.  An
    absorbing stack (``meta.coat_k``) loses the film's absorptance: FRESNEL's
    transmitted branch carries ``clip(T / max(1 - R, 1e-12), 0, 1)`` and
    FRESNEL_W weighs by ``clip(T, 0, 1)``.  A metal REFLECT row
    (``meta.metal``) reflects with intensity factor ``(Rs + Rp) / 2`` of
    ``mirror_reflectances_sp``.

    A dispersive row (``meta.disp``) takes its media indices per ray from
    ``dispersive_iors`` at the rays' ``wavelength`` (None: the d-line
    indices ph[0:2]).  A PHASE_GRID row reads its ``[H, W]`` map ``grid``
    (the side channel of ``Scene.side_grids``) and the rays' ``wavelength``
    (None: all unset, the plate's design wavelength); its four corner reads
    are kernel K4 on CUDA tensors (ops/phase_grid.py), its plain version
    with ``plain=True``.

    The diffractive and ideal elements read the rays' ``wavelength`` (None:
    all unset) and the surface-frame hit: LINEAR maps (position, slope) by
    ph[2:6] = (Cx, Cy, Dx, Dy); GRATING diffracts order ph[3] of period
    ph[2] um (reflective where ph[4] > 0.5); MLA focuses by lenslets of
    pitch ph[0] and focal length ph[1]; DOE kicks by its radial phase
    (``meta.doe`` terms of the ``ff`` columns) at order ph[2] and design
    wavelength ph[3], between the side-aware media (dispersive where
    ``meta.disp``), with intensity factor ``ok`` times, with the efficiency
    flag, ``kinoform_efficiency``.  An evanescent GRATING or DOE order has
    intensity factor 0.

    ``field`` (a core/field.py::FieldState, under ``track_field``) gives the
    Fresnel kinds, bare or coated, the polarized reflectance and
    transmittance of the rays' field state (``polarized_RT``,
    ``_polarized_fresnel``) and a metal mirror the factor (Rs |Es|^2 + Rp
    |Ep|^2) / max(|E|^2, 1e-20); a JONES row passes the ray through
    (its action is core/field.py::transport_field's) and raises without
    a field."""
    why = unsupported(meta)
    if why:
        raise NotImplementedError(why)
    kind = meta.ph
    ones = torch.ones_like(d[0])
    if meta.disp and wavelength is not None:
        n_in, n_out = dispersive_iors(row, wavelength, meta)
    else:
        n_in, n_out = row.ph[..., 0], row.ph[..., 1]
    if kind == PhysKind.TRANSMIT:
        return d, ones
    if kind == PhysKind.BLOCK:
        zero = torch.zeros_like(d[0])
        return (zero, zero, zero), zero
    if kind == PhysKind.REFLECT:
        if meta.metal:
            rs, rp = mirror_reflectances_sp(meta, row, d, n, wavelength)
            if field is None:
                return reflect_dir(d, n), 0.5 * (rs + rp)
            from .field import sp_power_fractions
            fs, fp = sp_power_fractions(field.r_c, field.i_c, d, n)
            return reflect_dir(d, n), (rs * fs + rp * fp) / torch.clamp(
                fs + fp, min=1e-20)
        return reflect_dir(d, n), ones
    if kind == PhysKind.SNELL:
        return snell_dir(d, n, n_in, n_out), ones
    if kind == PhysKind.JONES:
        if field is None:
            raise NotImplementedError(
                'polarizer/waveplate (JONES) surfaces act on the tracked '
                'E-field: trace with track_field=True (an unpolarized '
                'ensemble has no per-ray Jones action)')
        return d, ones
    if kind == PhysKind.GRIN:
        raise NotImplementedError(
            'GRIN rods are a volumetric interaction that the traces handle '
            'directly (core/grin.py::grin_surface_step, grin_interaction), '
            'not a surface physics')
    if field is not None and kind in FRESNEL_KINDS:
        return _polarized_fresnel(meta, row, d, n, n_in, n_out, u, field,
                                  wavelength)
    if kind == PhysKind.FRESNEL:
        if not meta.n_coat:
            return fresnel_dir(d, n, n_in, n_out, _draw(u)), ones
        rs, rp, ts, tp = coated_rt_sp(meta, row, d, n, n_in, n_out,
                                      wavelength)
        r_ov, t_ov = 0.5 * (rs + rp), 0.5 * (ts + tp)
        out = fresnel_dir(d, n, n_in, n_out, _draw(u), R_override=r_ov)
        if meta.coat_k is None:
            return out, ones
        # an absorbing stack: the transmitted branch carries T / (1 - R), so
        # that the expected flux is R + T and the absorptance is lost; the
        # branch is fresnel_dir's (same R, same TIR rule, same compare)
        tir = refract_components(d, n, n_in, n_out)[5]
        r_eff = torch.where(tir, 1.0, r_ov)
        w_t = t_ov / _max(1.0 - r_eff, 1e-12)
        return out, torch.where(_draw(u) < r_eff, ones,
                                torch.clamp(w_t, 0.0, 1.0))
    if kind in (PhysKind.FRESNEL_W, PhysKind.REFLECT_W):
        _, cos_i, n1, n2, _, tir, cos_t, _ = refract_components(
            d, n, n_in, n_out)
        if kind == PhysKind.FRESNEL_W and meta.coat_k is not None:
            # an absorbing stack: the weight is its transmittance T
            _, _, ts, tp = coated_rt_sp(meta, row, d, n, n_in, n_out,
                                        wavelength)
            return snell_dir(d, n, n_in, n_out), torch.where(
                tir, 1.0, torch.clamp(0.5 * (ts + tp), 0.0, 1.0))
        if meta.n_coat:
            R = coated_reflectance(meta, row, d, n, n_in, n_out, wavelength)
        else:
            R = fresnel_reflectance(cos_i, cos_t, n1, n2)
        if kind == PhysKind.FRESNEL_W:
            return snell_dir(d, n, n_in, n_out), torch.where(
                tir, 1.0, torch.clamp(1.0 - R, 0.0, 1.0))
        return reflect_dir(d, n), torch.where(tir, 1.0,
                                              torch.clamp(R, 0.0, 1.0))
    if kind == PhysKind.PHASE_GRID:
        if grid is None:
            raise ValueError('a PHASE_GRID row needs its [H, W] map: pass '
                             'grids={row: map} (Scene.side_grids)')
        from ..ops.phase_grid import grid_corners, grid_corners_plain
        wl = torch.zeros_like(d[0]) if wavelength is None else wavelength
        from_in = v3.dot(d, n) < 0
        n1 = torch.where(from_in, n_in, n_out)
        n2 = torch.where(from_in, n_out, n_in)
        out, ok = phase_grid_dir(
            d, row.Rw, hit_local, grid, row.ph[..., 2], row.ph[..., 3], wl,
            n1, n2, row.ph[..., 4], row.ph[..., 5],
            corners_fn=grid_corners_plain if plain else grid_corners)
        return out, ok.to(d[0].dtype)
    if kind in DIFFRACTIVE_KINDS:
        return _diffractive(meta, row, hit_local, d, n, n_in, n_out,
                            wavelength)
    # APERTURE: the filter re-checks its own RAW (non-inverted) bound
    mod = sb_check_one(meta.sb, row.sb, hit_local).to(d[0].dtype)
    return (d[0] * mod, d[1] * mod, d[2] * mod), mod


def _polarized_fresnel(meta, row, d, n, n_in, n_out, u, field, wavelength):
    """``apply_physics_one`` of the Fresnel kinds under the field, with the
    polarized (R_pol, T_pol) of the bare or coated interface
    (``polarized_RT``): FRESNEL reflects where ``u`` < R_pol, FRESNEL_W
    refracts with factor clip(1 - R_pol, 0, 1), REFLECT_W reflects with
    clip(R_pol, 0, 1); TIR reflects at full power.  Under an absorbing
    stack FRESNEL's transmitted branch carries clip(T_pol / max(1 - R_pol,
    1e-12), 0, 1) (the draw's R and branch) and FRESNEL_W clip(T_pol, 0,
    1)."""
    ones = torch.ones_like(d[0])
    R, T = polarized_RT(meta, row, d, n, n_in, n_out, field, wavelength)
    tir = refract_components(d, n, n_in, n_out)[5]
    if meta.ph == PhysKind.FRESNEL:
        out = fresnel_dir(d, n, n_in, n_out, _draw(u), R_override=R)
        if meta.coat_k is None:
            return out, ones
        r_eff = torch.where(tir, 1.0, R)
        w_t = T / _max(1.0 - r_eff, 1e-12)
        return out, torch.where(_draw(u) < r_eff, ones,
                                torch.clamp(w_t, 0.0, 1.0))
    if meta.ph == PhysKind.FRESNEL_W:
        if meta.coat_k is not None:
            return snell_dir(d, n, n_in, n_out), torch.where(
                tir, 1.0, torch.clamp(T, 0.0, 1.0))
        R = torch.where(tir, 0.0, R)
        return snell_dir(d, n, n_in, n_out), torch.where(
            tir, 1.0, torch.clamp(1.0 - R, 0.0, 1.0))
    return reflect_dir(d, n), torch.where(tir, 1.0,
                                          torch.clamp(R, 0.0, 1.0))


def _diffractive(meta, row, hit_local, d, n, n_in, n_out, wavelength):
    """``apply_physics_one`` of the diffractive and ideal kinds."""
    kind = meta.ph
    wl = torch.zeros_like(d[0]) if wavelength is None else wavelength
    if kind == PhysKind.LINEAR:
        return linear_dir(d, hit_local, row.Rw, row.ph[..., 2],
                          row.ph[..., 3], row.ph[..., 4],
                          row.ph[..., 5]), torch.ones_like(d[0])
    if kind == PhysKind.MLA:
        return mla_dir(d, hit_local, row.Rw, row.ph[..., 0],
                       row.ph[..., 1]), torch.ones_like(d[0])
    if kind == PhysKind.GRATING:
        out, ok = grating_dir(d, row.Rw, row.ph[..., 2], row.ph[..., 3],
                              row.ph[..., 4], wl)
        return out, ok.to(d[0].dtype)
    n_terms, use_eff = meta.doe
    coeffs = [row.ff[..., i] for i in range(n_terms)]
    from_in = v3.dot(d, n) < 0
    n1 = torch.where(from_in, n_in, n_out)
    n2 = torch.where(from_in, n_out, n_in)
    out, ok = doe_dir(d, row.Rw, hit_local, coeffs, row.ph[..., 2],
                      row.ph[..., 3], wl, n1, n2)
    imod = ok.to(d[0].dtype)
    if use_eff:
        imod = imod * kinoform_efficiency(row.ph[..., 2], row.ph[..., 3], wl)
    return out, imod
