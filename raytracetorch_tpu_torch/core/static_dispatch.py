"""Statically specialized bound and physics evaluation for the sequential path.

Counterpart of ``raytracetorch_tpu/core/static_dispatch.py``.  In a
sequential trace every row's kinds are known before the trace runs
(``StaticRowMeta``), so each step evaluates exactly one bound formula and
one physics model.

The port covers the kinds of the main path, of the ideal spherical mirror
and of the pixelated phase plate: bounds NONE/DISK/RECT/HEMI/HEMI_APER and
NONE/APER_R2/Z_BETWEEN, physics TRANSMIT, BLOCK, REFLECT (ideal mirror),
SNELL, APERTURE and PHASE_GRID.  Every other kind raises
NotImplementedError naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import torch

from ..constants import INTERSECT_EPS, PhysKind, SBKind, VBKind
from ..geom import vec3 as v3
from .physics import phase_grid_dir, reflect_dir, snell_dir

# ROADMAP.md "Queue 1" items that bring the rest of the feature matrix
TODO_FEATURES = 'ROADMAP Queue 1 item 12 (remaining sequential features)'
TODO_ELEMENTS = 'ROADMAP Queue 1 item 14 (remaining elements)'


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
    if kind == SBKind.HEMI:
        return torch.abs(z * sb[..., 0]) < 1.0 + INTERSECT_EPS
    if kind == SBKind.HEMI_APER:
        return ((torch.abs(z * sb[..., 0]) < 1.0 + INTERSECT_EPS)
                & (x * x + y * y <= sb[..., 1]))
    raise NotImplementedError(
        f'surface bound {SBKind(kind).name} is {TODO_ELEMENTS}')


def vb_check_one(kind: int, vb, hit):
    """Single-kind volume bound on the element-frame hit."""
    x, y, z = hit
    if kind == VBKind.NONE:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    if kind == VBKind.APER_R2:
        return x * x + y * y <= vb[..., 0]
    if kind == VBKind.Z_BETWEEN:
        return (z >= vb[..., 0]) & (z <= vb[..., 1])
    raise NotImplementedError(
        f'volume bound {VBKind(kind).name} is {TODO_ELEMENTS}')


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


def unsupported(meta: StaticRowMeta):
    """Why the port cannot trace this row yet (None when it can)."""
    if meta.asph or meta.ff:
        return f'aspheric/freeform surfaces are {TODO_FEATURES}'
    if meta.disp:
        return f'dispersion is {TODO_FEATURES}'
    if meta.n_coat or meta.metal:
        return f'coatings and metal mirrors are {TODO_FEATURES}'
    if meta.ph in (PhysKind.SCATTER, PhysKind.JONES, PhysKind.GRIN,
                   PhysKind.DOE, PhysKind.MLA):
        return f'physics {PhysKind(meta.ph).name} is {TODO_ELEMENTS}'
    if meta.ph not in (PhysKind.TRANSMIT, PhysKind.BLOCK, PhysKind.REFLECT,
                       PhysKind.SNELL, PhysKind.APERTURE,
                       PhysKind.PHASE_GRID):
        return f'physics {PhysKind(meta.ph).name} is {TODO_FEATURES}'
    if meta.sb not in (SBKind.NONE, SBKind.DISK, SBKind.RECT, SBKind.HEMI,
                       SBKind.HEMI_APER):
        return f'surface bound {SBKind(meta.sb).name} is {TODO_ELEMENTS}'
    if meta.vb not in (VBKind.NONE, VBKind.APER_R2, VBKind.Z_BETWEEN):
        return f'volume bound {VBKind(meta.vb).name} is {TODO_ELEMENTS}'
    return None


def apply_physics_one(meta: StaticRowMeta, row, hit_local, d, n,
                      wavelength=None, grid=None, plain=False):
    """Single-kind physics -> (new direction tuple, intensity factor).

    A PHASE_GRID row reads its ``[H, W]`` map ``grid`` (the side channel of
    ``Scene.side_grids``) and the rays' ``wavelength`` (None: all unset, the
    plate's design wavelength); its four corner reads are kernel K4 on CUDA
    tensors (ops/phase_grid.py), its plain version with ``plain=True``."""
    why = unsupported(meta)
    if why:
        raise NotImplementedError(why)
    kind = meta.ph
    ones = torch.ones_like(d[0])
    if kind == PhysKind.TRANSMIT:
        return d, ones
    if kind == PhysKind.BLOCK:
        zero = torch.zeros_like(d[0])
        return (zero, zero, zero), zero
    if kind == PhysKind.REFLECT:
        return reflect_dir(d, n), ones
    if kind == PhysKind.SNELL:
        return snell_dir(d, n, row.ph[..., 0], row.ph[..., 1]), ones
    if kind == PhysKind.PHASE_GRID:
        if grid is None:
            raise ValueError('a PHASE_GRID row needs its [H, W] map: pass '
                             'grids={row: map} (Scene.side_grids)')
        from ..ops.phase_grid import grid_corners, grid_corners_plain
        wl = torch.zeros_like(d[0]) if wavelength is None else wavelength
        from_in = v3.dot(d, n) < 0
        n1 = torch.where(from_in, row.ph[..., 0], row.ph[..., 1])
        n2 = torch.where(from_in, row.ph[..., 1], row.ph[..., 0])
        out, ok = phase_grid_dir(
            d, row.Rw, hit_local, grid, row.ph[..., 2], row.ph[..., 3], wl,
            n1, n2, row.ph[..., 4], row.ph[..., 5],
            corners_fn=grid_corners_plain if plain else grid_corners)
        return out, ok.to(d[0].dtype)
    # APERTURE: the filter re-checks its own RAW (non-inverted) bound
    mod = sb_check_one(meta.sb, row.sb, hit_local).to(d[0].dtype)
    return (d[0] * mod, d[1] * mod, d[2] * mod), mod
