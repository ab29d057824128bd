"""Layouts that the CUDA sources and the Python wrappers must agree on,
read from the sources on the CPU:

- K5's packed scan record (csrc/trace_seq_common.cuh, also read by K6's
  replay): each float field copies the flat-row columns of its name in
  core/table.py ROW_FIELDS, the record is whole float4s, and its kinds are
  the columns of ops/fused_trace.py::kind_rows that the intersection
  branches on;
- the occupancy queries that K1, K2, K5 and K6 export are bound by the
  wrappers, and every C entry point the wrappers bind takes as many
  arguments in its source as the wrappers pass;
- a dispersive row's DispModels in its kinds row's physics column, the
  flat-row offsets and the dispersion columns the adjoints reduce.

The kernels themselves are held to their plain versions on the card in
tests/test_torch_cuda.py."""

import math
import pathlib
import re

import pytest

from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_trace

CSRC = pathlib.Path(fused_trace.__file__).resolve().parents[1] / 'csrc'
COMMON = (CSRC / 'trace_seq_common.cuh').read_text()


def _constants(src):
    """Every ``constexpr int name = value`` of a source (several per line)."""
    out = {}
    for decl in re.findall(r'constexpr int ([^;]+);', src):
        for part in decl.split(','):
            m = re.fullmatch(r'\s*(k\w+)\s*=\s*(\d+)\s*', part)
            if m:
                out[m.group(1)] = int(m.group(2))
    return out


C = _constants(COMMON)
# (record field, flat field of ROW_FIELDS, words the intersection reads)
RECORD = (('kRecTw', 'tw', 3), ('kRecRw', 'Rw', 9), ('kRecQ', 'q', 5),
          ('kRecSb', 'sb', 3), ('kRecVb', 'vb', 2), ('kRecTs', 'ts', 3),
          ('kRecRs', 'Rs', 9))
FLAT = {'tw': 'kTw', 'Rw': 'kRw', 'q': 'kQ', 'sb': 'kSb', 'vb': 'kVb',
        'ts': 'kTs', 'Rs': 'kRs'}
SIZES = {name: math.prod(shape) for name, shape in ROW_FIELDS}


def test_record_is_whole_float4s():
    """The scan's four kinds fill the first float4, the float fields follow
    one another without a gap, and the padding closes the last float4."""
    assert C['kRecScan'] == 0 and C['kRecTw'] == 4
    offsets = [C[f] for f, _, _ in RECORD] + [C['kRecPad']]
    assert offsets == sorted(offsets)
    for (f, _, words), nxt in zip(RECORD, offsets[1:]):
        assert nxt - C[f] == words, f
    assert C['kRecWords'] % 4 == 0
    assert 0 <= C['kRecWords'] - C['kRecPad'] < 4


def test_scan_kinds_are_the_intersections():
    """The scan's float4 of kinds holds the plane flag, the surface bound,
    the volume bound and the invert flag of the kinds row, in that order,
    and RecRow::scan_kinds puts each into its RowKinds field."""
    built = re.findall(r'w == kRecScan(?: \+ (\d))?\s*\?\s*__int_as_float\('
                       r'kd\[(k\w+Col)\]', COMMON)
    assert [(int(j or 0), col) for j, col in built] == [
        (0, 'kPlaneCol'), (1, 'kSbCol'), (2, 'kVbCol'), (3, 'kInvertCol')]
    fields = re.search(r'struct RowKinds \{\s*int ([^;]*);\s*bool ([^;]*);',
                       COMMON)
    names = [f.strip() for f in fields.group(1).split(',')] + \
        [f.strip() for f in fields.group(2).split(',')]
    body = re.search(r'RowKinds scan_kinds\(\) const \{(.*?)\n  \}', COMMON,
                     re.S).group(1)
    init = re.search(r'return \{(.*?)\};', body, re.S).group(1)
    parts = [p.strip() for p in init.split(',')]
    assert len(parts) == len(names)
    lane = {'x': 'plane', 'y': 'sb', 'z': 'vb', 'w': 'invert'}
    for name, part in zip(names, parts):
        m = re.search(r'k\.([xyzw])', part)
        assert (lane[m.group(1)] if m else None) == (
            name if name in lane.values() else None), (name, part)


@pytest.mark.parametrize('field,flat,words', RECORD)
def test_record_field_copies_its_flat_columns(field, flat, words):
    """The header's flat offset of the field is ROW_OFFSETS', the field
    fits the flat field's size, and rec_col maps the field's words onto
    its columns in order."""
    assert C[FLAT[flat]] == ROW_OFFSETS[flat]
    assert words <= SIZES[flat]
    arms = re.findall(r'w < (kRec\w+)\s*\?\s*(k\w+) \+ \(w - (kRec\w+)\)',
                      COMMON)
    mine = [(end, col) for end, col, start in arms if start == field]
    assert len(mine) == 1, arms
    end, col = mine[0]
    assert col == FLAT[flat] and C[end] == C[field] + words


@pytest.mark.parametrize('lib', ['trace_seq_fwd', 'trace_seq_bwd',
                                 'trace_nonseq_fwd', 'trace_nonseq_bwd'])
def test_occupancy_queries_are_bound(lib):
    """K1, K2, K5 and K6 export their occupancy query, and the wrapper
    binds it (fused_trace.blocks_per_sm)."""
    sym = f'rtt_{lib}_occupancy'
    assert sym in fused_trace._LIBRARIES[lib][1]
    src = (CSRC / fused_trace._LIBRARIES[lib][0]).read_text()
    assert f'extern "C" int {sym}(' in src


@pytest.mark.parametrize('lib', sorted(fused_trace._LIBRARIES))
def test_bound_entry_points_take_their_arguments(lib):
    """Each C entry point that ``fused_trace._LIBRARIES`` binds is an
    ``extern "C"`` function of its library's source with as many parameters
    as its ``argtypes``: ctypes passes what it is told, so a mismatch would
    reach the card unnoticed."""
    src_name, entries = fused_trace._LIBRARIES[lib]
    src = (CSRC / src_name).read_text()
    for sym, argtypes in entries.items():
        m = re.search(r'extern "C" int ' + sym + r'\(([^)]*)\)', src)
        assert m is not None, sym
        assert len(m.group(1).split(',')) == len(argtypes), sym


ADJOINT = (CSRC / 'trace_seq_adjoint.cuh').read_text()


def test_flat_row_offsets_of_the_physics_and_dispersion():
    """The flat-row offsets the physics reads (ph, asph, and a dispersive
    row's 12 disp columns) are core/table.py's."""
    for const, name in (('kPh', 'ph'), ('kAsph', 'asph'), ('kDisp', 'disp')):
        assert C[const] == ROW_OFFSETS[name], const
    assert SIZES['disp'] == 12


@pytest.mark.parametrize('dispm', [(1, 1), (2, 2), (0, 2), (2, 0), (1, 2)])
def test_kinds_encode_dispersion_in_the_physics_column(dispm):
    """A dispersive row's two DispModels ride its physics column from bit
    kDispShift on, two bits a side, in then out, as read_row_kinds<true>
    decodes them (``kd >> kDispShift`` and ``disp_model``: ``(dispm >> 2
    side) & 3``, the kind ``kd & (1 << kDispShift) - 1``); the kinds row
    stays KIND_WIDTH = 8 ints, and a row that does not disperse keeps its
    bare kind."""
    from raytracetorch_tpu_torch.core.sensor import SensorConfig
    from raytracetorch_tpu_torch.core.static_dispatch import StaticRowMeta
    assert C['kDispShift'] == fused_trace.DISP_SHIFT == 8
    assert C['kKindWidth'] == fused_trace.KIND_WIDTH == 8
    assert 'kd[kPhCol] & ((1 << kDispShift) - 1)' in COMMON
    assert 'kd[kPhCol] >> kDispShift' in COMMON
    assert 'return (dispm >> (2 * side)) & 3;' in COMMON
    meta = [StaticRowMeta(3, 4, 1, disp=True, dispm=dispm),
            StaticRowMeta(3, 4, 1, dispm=dispm)]
    rows = fused_trace.kind_rows(meta, SensorConfig())
    assert all(len(r) == 8 for r in rows)
    code = rows[0][0]
    assert code & ((1 << C['kDispShift']) - 1) == 3
    word = code >> C['kDispShift']
    assert ((word >> 0) & 3, (word >> 2) & 3) == dispm
    assert rows[1][0] == 3


def test_dispersion_models_and_columns_match_the_kernels():
    """The kernels' DispModel values and the d line are constants.py's and
    core/static_dispatch.py's; K2 and K6 reduce DISP_GRAD_COLS (12 columns
    after the 27 of the extended kinds) for a table with a dispersive row."""
    from raytracetorch_tpu_torch.constants import DispModel
    m = re.search(r'enum DispModel \{([^}]*)\}', COMMON)
    vals = dict(re.findall(r'(DISP_\w+) = (\d+)', m.group(1)))
    assert {k: int(v) for k, v in vals.items()} == {
        'DISP_NONE': DispModel.NONE, 'DISP_CAUCHY': DispModel.CAUCHY,
        'DISP_SELLMEIER': DispModel.SELLMEIER}
    assert 'static_cast<float>(0.5876 * 0.5876)' in COMMON
    a = _constants(ADJOINT)
    assert a['kDispGradCols'] == len(fused_trace.DISP_GRAD_COLS) == 12
    assert a['kExtGradCols'] == len(fused_trace.EXT_GRAD_COLS)
    assert fused_trace.DISP_GRAD_COLS == tuple(
        range(ROW_OFFSETS['disp'], ROW_OFFSETS['disp'] + 12))
