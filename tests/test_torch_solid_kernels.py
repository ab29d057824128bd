"""K1's, K2's, K5's and K6's plain versions with the solids' and cones'
bounds (HALFSPACES, CONE_NAPPE) against the JAX fused kernels in interpret
mode on the CPU, and what the CUDA sources and the wrappers must agree on
for those bounds.

- K1/K2: a sequential table in which rays meet each new bound: the bench
  singlet, a box face as a rectangular obscuration (a BLOCK plane bounded
  by four half-spaces, ``box_face_recs`` through ``ElementCustom``), a
  refracting single cone (SNELL, CONE_NAPPE: every ray crosses the lower
  nappe's plane of roots first, which the bound rejects) and the sensor.
- K5/K6: the glass wedge polyhedron and the box absorber of
  tests/test_pallas.py:225-254 as a 6-bounce Scene, the JAX package's own
  HALFSPACES scene of its fused kernels.  K5 is held to the JAX kernel in
  interpret mode; K6 to ``jax.vjp`` of the JAX package's XLA bounce loop,
  the driver that test holds the JAX kernel to (the JAX kernel's backward
  in interpret mode takes ~220 s on this 13-row scene on the CPU, the
  XLA loop's vjp ~27 s).

Tolerances as tests/test_torch_freeform_kernels.py's: per ray rtol 2e-4 /
atol 1e-5 and the table rtol 1e-4 / atol 1e-5 of the stream's or field's
scale where that exceeds 1 (float32 adjoints summed in another order);
positions atol 1e-7 of the scene's depth, moments rtol 1e-4 / atol 1e-3.
"""

import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.constants import PhysKind
from raytracetorch_tpu.elements import base as jbase
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu.core.trace import trace_nonsequential
from raytracetorch_tpu.elements import solids as jsolids
from raytracetorch_tpu.ops.pallas_trace import (trace_nonseq_pallas,
                                               trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import (CVX_EPS, MAX_HALFSPACES,
                                               SBKind, VBKind)
from raytracetorch_tpu_torch.core.static_dispatch import unsupported
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.elements import base as tbase
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.elements import solids as tsolids
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
COMMON = (pathlib.Path(fused_trace.__file__).resolve().parents[1] / 'csrc'
          / 'trace_seq_common.cuh').read_text()


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the sources' constants ----

def test_bound_constants_match_the_port():
    """The kernels' enums, half-space column offsets, plane count and
    slack equal constants.py's and core/table.py's layout."""
    ints = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'\b(k\w+|SB_\w+|VB_\w+)\s*=\s*(\d+)\b', COMMON)}
    assert ints['SB_CONE_NAPPE'] == SBKind.CONE_NAPPE
    assert ints['VB_HALFSPACES'] == VBKind.HALFSPACES
    assert ints['kMaxHalfspaces'] == MAX_HALFSPACES
    for const, field in (('kHpN', 'hp_n'), ('kHpD', 'hp_d'),
                         ('kHpMask', 'hp_mask')):
        assert ints[const] == ROW_OFFSETS[field], const
    assert dict(ROW_FIELDS)['hp_n'] == (MAX_HALFSPACES, 3)
    eps = re.search(r'kCvxEps = ([0-9.e-]+)f;', COMMON).group(1)
    assert float(eps) == CVX_EPS


def test_new_bounds_take_the_extended_instantiation():
    """``unsupported`` lets both bounds through, ``ext_kinds`` sends a
    table with either to the instantiation with the extended kinds (and
    every one built on it), and ``kind_rows`` passes the kinds on."""
    for meta in (trt.StaticRowMeta(PhysKind.BLOCK, SBKind.NONE,
                                   VBKind.HALFSPACES, plane=True),
                 trt.StaticRowMeta(PhysKind.REFLECT, SBKind.CONE_NAPPE,
                                   VBKind.NONE)):
        assert unsupported(meta) is None
        assert fused_trace.ext_kinds([meta])
        row = fused_trace.kind_rows([meta], trt.SensorConfig())[0]
        assert (row[1], row[2]) == (meta.sb, meta.vb)
    plain = trt.StaticRowMeta(PhysKind.SNELL, SBKind.HEMI, VBKind.APER_R2)
    assert not fused_trace.ext_kinds([plain])


# ---- K1 and K2: a sequential table with both bounds ----

OBSCURATION = [('-z', 0.0), ('+x', 1.5), ('-x', 1.5), ('+y', 1.0),
               ('-y', 1.0)]


def stop_face(solids, base):
    """``ElementCustom``'s shape: the first face of ``OBSCURATION`` (a
    -z plane bounded by |x| <= 1.5, |y| <= 1.0), posed in the element."""
    def shape_fn(p, Re, te):
        kw = {} if solids is jsolids else {'device': te.device}
        rec = solids.box_face_recs(OBSCURATION, dtype=te.dtype, **kw)[0]
        rec.Rw, rec.tw, _, _ = base.compose_world(Re, te, rec.Rs, rec.ts)
        return [rec]
    return shape_fn


def bounds_table(rt, shapes, solids, base):
    """The bench singlet, the box face's obscuration at z = 4, a
    refracting single cone (slope 2, apex at z = 7) and a sensor at
    z = 20."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.ElementCustom(stop_face(solids, base), 1, PhysKind.BLOCK,
                         translation=[0, 0, 4.0], name='stop'),
        rt.ElementCustom(shapes.single_cone, 1, PhysKind.SNELL,
                         ph=(1.0, 1.3), extra={'slope': 2.0},
                         translation=[0, 0, 7.0], name='cone'),
        rt.SensorElement(radius=50.0, translation=[0, 0, 20.0],
                         name='sensor')])


def _disk(n, radius, z0, seed):
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, z0)],
                   -1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    return (JaxRays.create(jnp.asarray(pos), jnp.asarray(d)),
            trt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d)))


def _cotangents(n, shape, seed):
    rng = np.random.default_rng(seed)
    return ([rng.standard_normal(n).astype(np.float32)
             for _ in fused_trace.COMPS],
            rng.standard_normal(tuple(shape)).astype(np.float32))


def _check_rays(out_t, out_j, depth, pos_atol=1e-7):
    for c in fused_trace.COMPS:
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-5,
               atol=pos_atol * depth if c[0] == 'p' else 2e-6, err_msg=c)


def _check_cotangents(g_flat, g_in, ct_table, ct):
    for c, g in zip(fused_trace.COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g, ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        ref = ref.reshape(k, -1)
        off = ROW_OFFSETS[name]
        scale = max(1.0, float(np.abs(ref).max()))
        _close(g_flat[:, off:off + ref.shape[1]], ref, rtol=1e-4,
               atol=1e-5 * scale, err_msg=name)


def test_plain_k1_k2_match_jax_kernels():
    """K1's and K2's plain versions on the table of both bounds against
    ``trace_sequential_pallas_v2`` and its backward in interpret mode, at
    128 rays (one block of the TPU kernel): rays, moments, ray and table
    cotangents.  The obscuration blocks the rays inside its rectangle and
    passes the others; every ray that reaches the cone refracts at its
    upper nappe."""
    js = bounds_table(jrt, jshapes, jsolids, jbase)
    ts = bounds_table(trt, tshapes, tsolids, tbase)
    rays_j, rays_t = _disk(128, 4.0, -10.0, seed=21)
    table_j = js.build_table(js.init_params())
    flat = trt.flatten_table_rows(interop.table_from_numpy(_np(table_j),
                                                           'cpu'))
    meta = fused_trace.TraceMeta(interop.meta_from_slots(js.static_meta()))
    assert list(meta) == ts.static_meta() and fused_trace.ext_kinds(meta)
    cfg, cfg_j = ts.sensor_config(), js.sensor_config()
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays_j, KEY, cfg_j, js.static_meta(), interpret=True,
        block_rows=1)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps)
    # the cone's quadratic cancels (its discriminant B^2 - 4AC is a small
    # difference of terms of ~B^2 for a ray near the axis), so each
    # package's hit carries ~1e-6 of t and its normal the same: directions
    # to 2e-6, positions to 1e-6 of the depth after the 13 mm to the sensor
    # (the JAX kernel in interpret mode and its own eager trace read 5e-7
    # and 4.6e-5 apart)
    _check_rays(out_t, out_j, 20.0, pos_atol=1e-6)
    _close(sens_t.moments, sens_j.moments, rtol=1e-4, atol=1e-3)
    blocked = out_t.intensity == 0
    assert 0 < int(blocked.sum()) < rays_t.n
    assert float(out_t.pz[~blocked].min()) > 15.0
    g_rays, g_mom = _cotangents(rays_t.n, sens_t.moments.shape, 22)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays_j, KEY, cfg_j, js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays_j.ray_id),
                wavelength=np.zeros(rays_t.n, np.float32)),
        g_mom, interpret=True, block_rows=1)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps)[:2]
    _check_cotangents(g_flat, g_in, ct_table, ct)
    # the cone's pose carries a cotangent; the bounds' columns none
    tw = ROW_OFFSETS['tw']
    assert float(g_flat[3, tw:tw + 3].abs().max()) > 0
    for name in ('hp_n', 'hp_d', 'hp_mask', 'sb', 'vb'):
        off, width = ROW_OFFSETS[name], math.prod(dict(ROW_FIELDS)[name])
        assert float(g_flat[:, off:off + width].abs().max()) == 0.0, name


# ---- K5 and K6: the wedge and the box absorber ----

def wedge_scene(rt):
    """tests/test_pallas.py:225-254: the glass wedge polyhedron, a box
    absorber beside its deviated beam and a sensor, 6 bounces."""
    sa, ca = math.sin(0.2), math.cos(0.2)
    prism = rt.CvxPolyhedronElement(
        normals=[(0, 0, -1), (sa, 0, ca), (0, 1, 0), (0, -1, 0),
                 (1, 0, 0), (-1, 0, 0)],
        offsets=[0.0, 2.0, 5.0, 5.0, 8.0, 8.0], ior_glass=1.5, name='wedge')
    return rt.Scene([prism,
                     rt.BoxElement(length=2.0, width=2.0, height=2.0,
                                   name='blocker',
                                   translation=[6.0, 0.0, 15.0]),
                     rt.SensorElement(radius=50.0, translation=[0, 0, 30.0],
                                      name='s')], n_bounces=6)


def test_plain_k5_k6_match_jax():
    """K5's plain version on the wedge scene against ``trace_nonseq_pallas``
    in interpret mode, and K6's against ``jax.vjp`` of the JAX bounce loop,
    at 256 rays: rays, moments, ray and table cotangents; every wedge ray
    refracts twice and reaches the sensor (the box stands beside the
    beam)."""
    js, ts = wedge_scene(jrt), wedge_scene(trt)
    rays_j = jrt.CollimatedDisk.make(radius=jnp.float32(2.0),
                                     translation=[0, 0, -5.0]).sample(
        KEY, 256)
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    table_j = js.build_table(js.init_params())
    flat = trt.flatten_table_rows(interop.table_from_numpy(_np(table_j),
                                                           'cpu'))
    meta = interop.meta_from_slots(js.static_meta())
    assert meta == ts.static_meta() and fused_trace.ext_kinds(meta)
    cfg, cfg_j = ts.sensor_config(), js.sensor_config()
    out_j, sens_j, _ = trace_nonseq_pallas(
        table_j, rays_j, KEY, js.n_bounces, cfg_j,
        static_meta=js.static_meta(),
        interpret=True, block_rows=2)
    out_t, sens_t = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays_t, cfg, meta, js.n_bounces)
    _check_rays(out_t, out_j, 30.0)
    _close(sens_t.moments, sens_j.moments, rtol=1e-4, atol=1e-3)
    assert float(sens_t.moments[0, 0, 0]) == rays_t.n
    delta = math.asin(1.5 * math.sin(0.2)) - 0.2
    _close(out_t.dx, -math.sin(delta), atol=1e-5)
    g_rays, g_mom = _cotangents(rays_t.n, sens_t.moments.shape, 23)

    def loop(table, px, py, pz, dx, dy, dz, intensity):
        rays = rays_j.replace(px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz,
                              intensity=intensity)
        out, sens, _ = trace_nonsequential(table, rays, KEY, js.n_bounces,
                                           cfg_j, static_meta=js.static_meta())
        return [getattr(out, c) for c in fused_trace.COMPS], sens.moments
    _, vjp = jax.vjp(loop, table_j,
                     *[getattr(rays_j, c) for c in fused_trace.COMPS])
    ct_table, *ct_rays = vjp(([jnp.asarray(g) for g in g_rays],
                              jnp.asarray(g_mom)))
    ct = dict(zip(fused_trace.COMPS, ct_rays))
    g_flat, g_in = fused_nonseq.trace_nonseq_bwd_plain(
        flat, rays_t, cfg, meta, js.n_bounces,
        [torch.from_numpy(g) for g in g_rays], torch.from_numpy(g_mom))[:2]
    _check_cotangents(g_flat, g_in, ct_table, ct)
    # the wedge's tilted face and its index carry cotangents
    assert float(g_flat[1, ROW_OFFSETS['ph'] + 1].abs()) > 0
