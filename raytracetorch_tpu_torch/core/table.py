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
    ph_kind: int = PhysKind.TRANSMIT
    ph: Sequence = ()            # up to 6: ior_in, ior_out, ...
    is_sensor: bool = False
    sensor_slot: int = 0
    is_plane: bool = False       # static: row is a z=0 plane (fast path)


def _pad_vec(values, width, dtype, device):
    vals = [torch.as_tensor(v, dtype=dtype, device=device) for v in values]
    vals += [torch.zeros((), dtype=dtype, device=device)] * (width - len(vals))
    return torch.stack(vals[:width])


def stack_records(recs, elem_ids, surf_ids, dtype=torch.float32,
                  device=None):
    """Pack SurfaceRecs into a SurfaceTable on ``device``."""
    k = len(recs)
    eye = torch.eye(3, dtype=dtype, device=device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)

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
        hp_n=torch.zeros(k, MAX_HALFSPACES, 3, dtype=dtype, device=device),
        hp_d=torch.zeros(k, MAX_HALFSPACES, dtype=dtype, device=device),
        hp_mask=torch.zeros(k, MAX_HALFSPACES, dtype=torch.bool,
                            device=device),
        ph_kind=ints(r.ph_kind for r in recs),
        ph=torch.stack([_pad_vec(r.ph, 6, dtype, device) for r in recs]),
        asph=torch.zeros(k, 4, dtype=dtype, device=device),
        ff=torch.zeros(k, MAX_FF_TERMS, dtype=dtype, device=device),
        disp=torch.zeros(k, 12, dtype=dtype, device=device),
        coat=torch.zeros(k, 16, dtype=dtype, device=device),
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
