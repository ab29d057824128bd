"""Layouts that the CUDA sources and the Python wrappers must agree on,
read from the sources on the CPU:

- K5's packed scan record (csrc/trace_seq_common.cuh, also read by K6's
  replay): each float field copies the flat-row columns of its name in
  core/table.py ROW_FIELDS, the record is whole float4s, and its kinds are
  the columns of ops/fused_trace.py::kind_rows that the intersection
  branches on;
- the occupancy queries that K1, K2, K5 and K6 export are bound by the
  wrappers, and every C entry point the wrappers bind takes as many
  arguments in its source as the wrappers pass.

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

