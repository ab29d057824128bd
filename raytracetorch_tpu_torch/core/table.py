"""SurfaceTable: the compiled scene as a structure of ``[K, ...]`` tensors.

Counterpart of ``raytracetorch_tpu/core/table.py``.  Every surface of every
element becomes one row: quadric coefficients, composed world->surface
frame, bound specs, physics spec and sensor bookkeeping.  The table is
rebuilt from the parameter dict on every call, so autograd flows from
traced rays back to curvatures, thicknesses and poses.

``flatten_table_rows`` packs the float columns into the fixed-width rows the
fused kernel reads (the layout of ``ops/pallas_trace.py::_ROW_FIELDS``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from ..constants import MAX_FF_TERMS, MAX_HALFSPACES, PhysKind, SBKind, VBKind

# (name, shape) of each float column, in flat-row order: 152 floats padded
# to ROW_WIDTH
ROW_FIELDS = (
    ('q', (5,)), ('n_sign', ()), ('Rw', (3, 3)), ('tw', (3,)),
    ('Rs', (3, 3)), ('ts', (3,)), ('sb', (4,)), ('vb', (8,)),
    ('ph', (6,)), ('asph', (4,)), ('disp', (12,)),
    ('hp_n', (8, 3)), ('hp_d', (8,)), ('hp_mask', (8,)),
    ('coat', (16,)), ('ff', (32,)),
)
ROW_WIDTH = 160


def _size(shape):
    n = 1
    for s in shape:
        n *= s
    return n


ROW_OFFSETS = {}
_off = 0
for _name, _shape in ROW_FIELDS:
    ROW_OFFSETS[_name] = _off
    _off += _size(_shape)
del _off, _name, _shape


@dataclasses.dataclass
class SurfaceTable:
    """All per-surface data, stacked along the leading K axis."""

    q: torch.Tensor          # [K, 5] implicit quadric coefficients
    n_sign: torch.Tensor     # [K] normal orientation sign
    Rw: torch.Tensor         # [K, 3, 3] world->surface rotation
    tw: torch.Tensor         # [K, 3] world->surface translation
    Rs: torch.Tensor         # [K, 3, 3] element->surface rotation
    ts: torch.Tensor         # [K, 3] element->surface translation
    sb_kind: torch.Tensor    # [K] int32 surface-local bound kind
    sb: torch.Tensor         # [K, 4] surface-local bound params
    sb_invert: torch.Tensor  # [K] bool
    vb_kind: torch.Tensor    # [K] int32 volume bound kind
    vb: torch.Tensor         # [K, 8] volume bound params
    hp_n: torch.Tensor       # [K, P, 3] half-space normals (element frame)
    hp_d: torch.Tensor       # [K, P] half-space offsets
    hp_mask: torch.Tensor    # [K, P] bool valid half-spaces
    ph_kind: torch.Tensor    # [K] int32 physics kind
    ph: torch.Tensor         # [K, 6] physics params
    asph: torch.Tensor       # [K, 4] even-asphere coefficients
    ff: torch.Tensor         # [K, MAX_FF_TERMS] freeform coefficients
    disp: torch.Tensor       # [K, 12] dispersion coefficients [in 6 | out 6]
    coat: torch.Tensor       # [K, 16] thin-film stack (n, d_um) x 8
    is_sensor: torch.Tensor  # [K] bool
    sensor_slot: torch.Tensor  # [K] int32
    elem_id: torch.Tensor    # [K] int32
    surf_id: torch.Tensor    # [K] int32

    @property
    def n_surfaces(self):
        return self.q.shape[0]

    def row(self, k):
        """Row view (per-surface scalars and small tensors)."""
        return SurfaceTable(**{f.name: getattr(self, f.name)[k]
                               for f in dataclasses.fields(self)})

    def index_rows(self, order):
        """The table of rows ``order`` (a list of row indices, repeats
        allowed), differentiable in every column."""
        idx = torch.as_tensor(order, dtype=torch.long, device=self.q.device)
        return SurfaceTable(**{f.name: getattr(self, f.name)[idx]
                               for f in dataclasses.fields(self)})

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SurfaceRec:
    """One surface row under construction; numeric fields may be tensors
    that carry gradients back to element parameters.  Only the fields the
    port's elements set are listed (see the JAX SurfaceRec for the full
    feature set)."""

    q: Any                       # [5]
    n_sign: float
    Rw: Any                      # [3, 3]
    tw: Any                      # [3]
    Rs: Any = None               # [3, 3] (defaults to identity)
    ts: Any = None               # [3]
    sb_kind: int = SBKind.NONE
    sb: Sequence = ()
    sb_invert: bool = False
    vb_kind: int = VBKind.NONE
    vb: Sequence = ()
    halfspaces: Sequence = ()    # (normal [3], offset) pairs of a HALFSPACES
                                 # row, element frame, up to MAX_HALFSPACES
    ph_kind: int = PhysKind.TRANSMIT
    ph: Sequence = ()            # up to 6: ior_in, ior_out, ...
    asph: Sequence = ()          # even-asphere a4..a10 (is_asphere marks use)
    is_asphere: bool = False
    disp: Sequence = ()          # 12-wide [in 6 | out 6] per DispModel layout
    disp_model: tuple = (0, 0)   # (DispModel of the ior_in side, of ior_out)
    is_dispersive: bool = False
    coat: Sequence = ()          # interleaved (n, d_um) pairs, outermost first
    n_coat: int = 0              # static layer count (0: a bare interface)
    coat_k: Any = None           # static per-layer extinction (absorbing
                                 # films; None: dielectric), on StaticRowMeta
    is_metal: bool = False       # REFLECT row on an absorbing substrate
                                 # ph = (n_metal, k_metal, n_ambient)
    metal_nk: Any = None         # static ((n knots), (k knots)) of the
                                 # metal's dispersion (utils/coatings.py::
                                 # METAL_NK), on StaticRowMeta
    ff: Sequence = ()            # a freeform row's monomial coefficients
                                 # or a DOE row's radial phase ones (a row
                                 # is one or the other, never both)
    ff_powers: tuple = ()        # static (i, j) exponent pairs of a freeform
                                 # row's terms, on StaticRowMeta.ff
    doe: Any = None              # static (n_radial_terms, efficiency) of a
                                 # DOE row, on StaticRowMeta
    jones_chrom: bool = False    # static: a JONES row's retardance scales
                                 # as lam0 / lam (a true zero-order plate)
    jones_bire: Any = None       # static: its crystal ('QUARTZ', 'MGF2',
                                 # 'CALCITE'; utils/birefringence.py), whose
                                 # dn(lam) / dn(lam0) scales it too
    grin_steps: int = 0          # static: a GRIN row's RK4 step count,
                                 # on StaticRowMeta
    is_sensor: bool = False
    sensor_slot: int = 0
    is_plane: bool = False       # static: row is a z=0 plane (fast path)


def _pad_vec(values, width, dtype, device):
    vals = [torch.as_tensor(v, dtype=dtype, device=device) for v in values]
    vals += [torch.zeros((), dtype=dtype, device=device)] * (width - len(vals))
    return torch.stack(vals[:width])


def _hp_columns(recs, dtype, device):
    """``hp_n [K, P, 3]``, ``hp_d [K, P]`` and ``hp_mask [K, P]`` of the
    records' half-spaces, padded to P = MAX_HALFSPACES (zeros and False
    past a row's own; all zeros when no row has any)."""
    k = len(recs)
    hp_n = torch.zeros(k, MAX_HALFSPACES, 3, dtype=dtype, device=device)
    hp_d = torch.zeros(k, MAX_HALFSPACES, dtype=dtype, device=device)
    mask = torch.zeros(k, MAX_HALFSPACES, dtype=torch.bool, device=device)
    if not any(r.halfspaces for r in recs):
        return hp_n, hp_d, mask
    zero3, zero = hp_n[0, 0], hp_d[0, 0]
    ns, ds, ms = [], [], []
    for r in recs:
        if len(r.halfspaces) > MAX_HALFSPACES:
            raise ValueError(f'a row takes at most {MAX_HALFSPACES} '
                             f'half-spaces, got {len(r.halfspaces)}')
        pad = MAX_HALFSPACES - len(r.halfspaces)
        ns.append(torch.stack([torch.as_tensor(n, dtype=dtype, device=device)
                               for n, _ in r.halfspaces] + [zero3] * pad))
        ds.append(torch.stack([torch.as_tensor(d, dtype=dtype, device=device)
                               for _, d in r.halfspaces] + [zero] * pad))
        ms.append([True] * len(r.halfspaces) + [False] * pad)
    return (torch.stack(ns), torch.stack(ds),
            torch.tensor(ms, dtype=torch.bool, device=device))


def stack_records(recs, elem_ids, surf_ids, dtype=torch.float32,
                  device=None):
    """Pack SurfaceRecs into a SurfaceTable on ``device``."""
    eye = torch.eye(3, dtype=dtype, device=device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)
    hp_n, hp_d, hp_mask = _hp_columns(recs, dtype, device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    def ints(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int32,
                            device=device)

    def bools(vals):
        return torch.tensor([bool(v) for v in vals], device=device)

    return SurfaceTable(
        q=torch.stack([t(r.q) for r in recs]),
        n_sign=torch.tensor([float(r.n_sign) for r in recs], dtype=dtype,
                            device=device),
        Rw=torch.stack([t(r.Rw) for r in recs]),
        tw=torch.stack([t(r.tw) for r in recs]),
        Rs=torch.stack([eye if r.Rs is None else t(r.Rs) for r in recs]),
        ts=torch.stack([zero3 if r.ts is None else t(r.ts) for r in recs]),
        sb_kind=ints(r.sb_kind for r in recs),
        sb=torch.stack([_pad_vec(r.sb, 4, dtype, device) for r in recs]),
        sb_invert=bools(r.sb_invert for r in recs),
        vb_kind=ints(r.vb_kind for r in recs),
        vb=torch.stack([_pad_vec(r.vb, 8, dtype, device) for r in recs]),
        hp_n=hp_n, hp_d=hp_d, hp_mask=hp_mask,
        ph_kind=ints(r.ph_kind for r in recs),
        ph=torch.stack([_pad_vec(r.ph, 6, dtype, device) for r in recs]),
        asph=torch.stack([_pad_vec(r.asph, 4, dtype, device) for r in recs]),
        ff=torch.stack([_pad_vec(r.ff, MAX_FF_TERMS, dtype, device)
                        for r in recs]),
        disp=torch.stack([_pad_vec(r.disp, 12, dtype, device) for r in recs]),
        coat=torch.stack([_pad_vec(r.coat, 16, dtype, device)
                          for r in recs]),
        is_sensor=bools(r.is_sensor for r in recs),
        sensor_slot=ints(r.sensor_slot for r in recs),
        elem_id=ints(elem_ids),
        surf_id=ints(surf_ids),
    )


def flatten_table_rows(table):
    """[K, ROW_WIDTH] float32 flat table: the float columns of each row in
    ROW_FIELDS order, zero-padded from 152 to 160."""
    k = table.n_surfaces
    cols = [getattr(table, name).to(torch.float32).reshape(k, -1)
            for name, _ in ROW_FIELDS]
    flat = torch.cat(cols, dim=1)
    return torch.nn.functional.pad(flat, (0, ROW_WIDTH - flat.shape[1]))


class FlatRow:
    """A SurfaceTable row read from one row of the flat table (the float
    columns only; kinds come from StaticRowMeta).  Lets the plain version of
    the fused kernel run the same core functions on the layout the kernel
    reads."""

    def __init__(self, flat_row):
        for name, shape in ROW_FIELDS:
            off = ROW_OFFSETS[name]
            v = flat_row[off:off + _size(shape)]
            setattr(self, name, v[0] if shape == () else v.reshape(shape))
