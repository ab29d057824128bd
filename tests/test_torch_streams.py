"""The deterministic streams of the PyTorch port against the JAX package, on
the CPU: ``medium_after`` on every ported kind; the optical path length
(``track_opl``: ``opl``, ``n_final``), path and hit recording
(``record_paths``, ``record_hits``) of the eager ``trace_sequential`` and
``trace_nonsequential`` on the bench singlet, the ring-former plate, the
achromat (Abbe and Sellmeier glasses), the mixed-surface scene, the
Sellmeier Cooke triplet and a total-internal-reflection lens, and of the
bounce loop on the naive scene (with a budget past the last bounce, whose
records are padded), the mirror fold and the plate as a Scene; the plain
versions of K1, K2, K5 and K6 (the functions the card's kernels compute)
with the streams against the JAX kernels in interpret mode; the gradients
through ``opl`` and ``n_final`` against ``jax.grad``, and through ``hits``
by the recording run's eager recompute.

Inputs are made by the JAX package from a seed and carried over through
numpy.  Tolerances, each with its reason:

- positions (``paths``, ``hits``): atol 2e-5 in units of the scene's length
  scale (the largest |value|, at least 1): float32 rounding of a chain of
  rows in another order, as tests/test_torch_dispersion.py holds positions;
- ``hit_weights``: atol 1e-6, ``n_final`` and ``hit_slots`` exactly (the
  same branch decisions);
- ``opl``: atol 1e-5 of its largest value (~30-130 here: the float32
  rounding of n t summed over the rows, ~1e-5 relative, the floor of
  tests/test_wavefront.py:52-58);
- gradients in the scene's leaves: rtol 2e-4 (float32 adjoints summed over
  the rays in another order), per-ray cotangents as
  tests/test_torch_fused_grad.py (rtol 2e-4, atol 1e-5 of the stream's
  scale);
- the JAX kernels' non-sequential hit slots: only where a sensor won
  (``hit_weights > 0``); see ``test_plain_nonseq_streams_match_jax_kernel``.
Non-finite values must agree in place (``equal_nan``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.static_dispatch import \
    medium_after as jax_medium_after
from raytracetorch_tpu.ops.pallas_trace import (trace_nonseq_pallas,
                                               trace_nonseq_pallas_bwd,
                                               trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.static_dispatch import medium_after
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace

torch.set_num_threads(2)

N = 600
KEY = jax.random.PRNGKey(0)
STREAMS = dict(track_opl=True, record_paths=True, record_hits=True)
COMPS = fused_trace.COMPS
PLATE_SHAPE = (32, 32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _tir_scene(rt, n_bounces=None):
    """A thick n = 1.8 lens whose steep back face (R = -5) turns rays above
    height ~2.8 back by total internal reflection."""
    els = [rt.SingletLens(c1=0.0, c2=-0.2, d=9.0, t=6.0, ior_glass=1.8,
                          name='lens'),
           rt.SensorElement(radius=30.0, translation=[0.0, 0.0, 20.0],
                            name='sensor')]
    return (rt.SequentialScene(els) if n_bounces is None
            else rt.Scene(els, n_bounces=n_bounces))


def _disk(rt, radius, z, wavelength=None):
    kw = {} if wavelength is None else {'wavelength': wavelength}
    return rt.CollimatedDisk.make(radius=radius, translation=[0.0, 0.0, z],
                                  **kw)


# name -> (scene maker (rt, n_bounces), bundles maker (rt, n), bundles)
CASES = {
    'bench': (lambda rt, nb=None: (chip_smoke.bench_scene(rt) if nb is None
                                   else chip_smoke.naive_scene(rt, 0.0, nb)),
              lambda rt, n: [(_disk(rt, 4.0, -10.0), n)], 1),
    'plate': (lambda rt, nb=None: chip_smoke.ring_scene(
        rt, PLATE_SHAPE, bounces=nb),
              lambda rt, n: [(_disk(rt, 3.0, -3.0, chip_smoke.DO_LAM), n)],
              1),
    'achromat_abbe': (lambda rt, nb=None: chip_smoke.achromat_scene(
        rt, 'abbe', nb), lambda rt, n: chip_smoke.achromat_bundles(
            rt, n // 2), 2),
    'achromat_sellmeier': (lambda rt, nb=None: chip_smoke.achromat_scene(
        rt, 'sellmeier', nb), lambda rt, n: chip_smoke.achromat_bundles(
            rt, n // 2), 2),
    'mixed': (lambda rt, nb=None: chip_smoke.mixed_scene(rt, nb),
              lambda rt, n: [(_disk(rt, 4.0, -10.0), n)], 1),
    'cooke': (lambda rt, nb=None: chip_smoke.cooke_scene(rt, nb),
              chip_smoke.cooke_bundles, 6),
    'tir': (_tir_scene, lambda rt, n: [(_disk(rt, 4.4, -10.0), n)], 1),
    'fold': (lambda rt, nb=None: chip_smoke.mirror_fold_scene(rt),
             lambda rt, n: [(_disk(rt, 2.0, 1.0), n)], 1),
}


def _case(name, n_bounces=None, n=N, seed=3):
    """(JAX scene, its params, JAX rays, port scene, port params, port
    rays, bundles) of a CASES name; with ``n_bounces`` the Scene."""
    make, bundles, nb = CASES[name]
    js = make(jrt, n_bounces)
    ts = make(trt, n_bounces)
    pj = js.init_params()
    if name == 'plate':
        grid = chip_smoke.ring_map(PLATE_SHAPE, 'cpu').numpy()
        pj['plate']['grid'] = jnp.asarray(grid)
    rays = js.sample_rays(jax.random.PRNGKey(seed), bundles(jrt, n))
    return (js, pj, rays, ts, interop.params_from_numpy(_np(pj), 'cpu'),
            interop.rays_from_numpy(_np(rays), 'cpu'), nb)


def _assert_aux_close(aux_t, aux_j, keys=None):
    keys = sorted(aux_j) if keys is None else keys
    assert sorted(aux_t) == sorted(aux_j)
    for k in keys:
        a, b = aux_t[k].detach().numpy(), np.asarray(aux_j[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        if k in ('paths', 'hits'):
            scale = max(1.0, float(np.nanmax(np.abs(b))))
            _close(a, b, rtol=0, atol=2e-5 * scale, equal_nan=True,
                   err_msg=k)
        elif k == 'opl':
            _close(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()),
                   equal_nan=True, err_msg=k)
        elif k == 'hit_weights':
            _close(a, b, rtol=0, atol=1e-6, equal_nan=True, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# ---- medium_after ----

def _row_cases():
    """(name, JAX scene, row index, wavelengths or None) of every ported
    kind: SNELL (constant, Cauchy, Sellmeier glass), PHASE_GRID, and rows
    that leave the medium (TRANSMIT sensor, APERTURE stop, the lens's
    edge bound)."""
    return [('snell', chip_smoke.bench_scene(jrt), 0, None),
            ('snell_back', chip_smoke.bench_scene(jrt), 1, None),
            ('edge', chip_smoke.bench_scene(jrt), 2, None),
            ('aperture', chip_smoke.bench_scene(jrt), 3, None),
            ('sensor', chip_smoke.bench_scene(jrt), 4, None),
            ('plate', chip_smoke.ring_scene(jrt, PLATE_SHAPE), 0, None),
            ('cauchy', chip_smoke.achromat_scene(jrt, 'abbe'), 1, 'set'),
            ('sellmeier', chip_smoke.achromat_scene(jrt, 'sellmeier'), 1,
             'set'),
            ('sellmeier_unset', chip_smoke.achromat_scene(jrt, 'sellmeier'),
             0, 'unset')]


@pytest.mark.parametrize('name,scene,k,wl', _row_cases(),
                         ids=[c[0] for c in _row_cases()])
def test_medium_after_matches_jax(name, scene, k, wl):
    """``medium_after`` on one row for random directions from both sides
    and steep ones (total internal reflection on the glass side): the JAX
    package's indices, None where the JAX function returns None."""
    rng = np.random.default_rng(11)
    n = 512
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wavelength = None
    if wl is not None:
        wavelength = (rng.uniform(0.4, 0.8, n).astype(np.float32)
                      if wl == 'set' else np.zeros(n, np.float32))
    table_j = scene.build_table(scene.init_params())
    meta_j = scene.static_meta()[k]
    ref = jax_medium_after(meta_j, table_j.row(k), tuple(d.T),
                           tuple(nrm.T), jnp.zeros(n),
                           wavelength=None if wavelength is None
                           else jnp.asarray(wavelength))
    table_t = interop.table_from_numpy(_np(table_j), 'cpu')
    meta_t = interop.meta_from_slots([meta_j])[0]
    got = medium_after(meta_t, table_t.row(k),
                       tuple(torch.from_numpy(c) for c in d.T),
                       tuple(torch.from_numpy(c) for c in nrm.T),
                       None if wavelength is None
                       else torch.from_numpy(wavelength))
    assert (got is None) == (ref is None)
    if ref is not None:
        _close(got.numpy(), ref, rtol=1e-6)
        if name != 'plate':                 # the plate sits in air
            assert len(np.unique(np.asarray(ref))) > 1   # both sides


def test_medium_after_refuses_unported_kinds():
    meta = trt.StaticRowMeta(10, 0, 0)            # SCATTER
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        medium_after(meta, None, None, None)


# ---- the eager traces ----

SEQ_CASES = ('bench', 'plate', 'achromat_abbe', 'achromat_sellmeier',
             'mixed', 'cooke', 'tir')


@pytest.mark.parametrize('case', SEQ_CASES)
def test_trace_sequential_streams_match_jax(case):
    """Eager ``SequentialScene.simulate`` with all three streams: the JAX
    package's aux keys, shapes, dtypes and values, and the rays."""
    js, pj, rays, ts, pt, rays_t, nb = _case(case)
    out_j, _, aux_j = js.simulate(pj, rays, KEY, n_bundles=nb, **STREAMS)
    out_t, _, aux_t = ts.simulate(pt, rays_t, nb, **STREAMS)
    k = len(js.static_meta())
    assert tuple(aux_t['paths'].shape) == (k + 1, N, 3)
    assert tuple(aux_t['hits'].shape) == (k, N, 3)
    _assert_aux_close(aux_t, aux_j)
    _close(out_t.pos.numpy(), out_j.pos, atol=2e-5 * 100)
    if case == 'tir':
        # total internal reflection keeps rays in the glass
        assert float((aux_t['n_final'] == 1.8).sum()) > 0.1 * N
    if case == 'bench':
        np.testing.assert_array_equal(aux_t['paths'][0].numpy(),
                                      np.asarray(rays.pos))


def test_axial_opl_anchor():
    """tests/test_wavefront.py:19-28: an axial ray's OPL is the air path
    plus n times the glass thickness, 8 + 1.5168 * 4, ending in air."""
    scene = trt.SequentialScene([trt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        name='lens')])
    r = trt.Rays.create([[0.0, 0.0, -10.0]], [[0.0, 0.0, 1.0]])
    for sim in (scene.simulate, scene.simulate_fused):
        _, _, aux = sim(scene.init_params('cpu'), r, track_opl=True)
        _close(float(aux['opl'][0]), 8.0 + 1.5168 * 4.0, rtol=1e-6)
        _close(float(aux['n_final'][0]), 1.0, rtol=1e-6)


NS_CASES = {'bench': 8, 'fold': 4, 'plate': 3, 'achromat_sellmeier': 6,
            'tir': 6}


@pytest.mark.parametrize('case', sorted(NS_CASES))
def test_trace_nonsequential_streams_match_jax(case):
    """Eager ``Scene.simulate`` with all three streams against the JAX
    bounce loop: ``paths`` and the hit records of every bounce of the
    budget, ``opl`` and ``n_final``."""
    js, pj, rays, ts, pt, rays_t, nb = _case(case, NS_CASES[case])
    out_j, _, aux_j = js.simulate(pj, rays, KEY, n_bundles=nb, **STREAMS)
    out_t, _, aux_t = ts.simulate(pt, rays_t, nb, **STREAMS)
    b = NS_CASES[case]
    assert tuple(aux_t['paths'].shape) == (b, N, 3)
    assert aux_t['hit_slots'].dtype == torch.int32
    _assert_aux_close(aux_t, aux_j)
    assert float(aux_t['hit_weights'].sum()) > 0


def test_nonsequential_records_pad_the_budget():
    """A budget of 20 bounces on the naive scene, whose rays settle after
    ~4: the loop stops early, and the records of the bounces after it hold
    the final positions and zero hits, weights and slots, as the JAX loop's
    dead branch records them."""
    js, pj, rays, ts, pt, rays_t, nb = _case('bench', 20)
    out_j, _, aux_j = js.simulate(pj, rays, KEY, **STREAMS)
    out_t, _, aux_t = ts.simulate(pt, rays_t, **STREAMS)
    _assert_aux_close(aux_t, aux_j)
    last = aux_t['paths'][-1]
    np.testing.assert_array_equal(last.numpy(), out_t.pos.numpy())
    assert float(aux_t['hit_weights'][10:].abs().sum()) == 0.0
    assert float(aux_t['hits'][10:].abs().sum()) == 0.0
    assert int(aux_t['hit_slots'][10:].abs().sum()) == 0
    # the fused trace's plain version pads the same
    _, _, aux_f = ts.simulate_fused(pt, rays_t, **STREAMS)
    for k in aux_t:
        np.testing.assert_array_equal(aux_f[k].numpy(), aux_t[k].numpy())


# ---- the plain versions against the JAX kernels ----

def _port_inputs(js, pj, rays, nb):
    table = interop.table_from_numpy(_np(js.build_table(pj)), 'cpu')
    meta = interop.meta_from_slots(js.static_meta())
    cfg = js.sensor_config(nb)
    cfg_t = trt.SensorConfig(n_sensors=cfg.n_sensors, n_bundles=cfg.n_bundles,
                             grid_shape=tuple(cfg.grid_shape),
                             grid_half_extent=cfg.grid_half_extent)
    return (trt.flatten_table_rows(table), meta, cfg_t,
            interop.rays_from_numpy(_np(rays), 'cpu'))


def _cotangents(n, cfg, seed):
    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(n).astype(np.float32) for _ in range(9)]
    g_mom = rng.standard_normal(
        (max(cfg.n_sensors, 1), cfg.n_bundles, 7)).astype(np.float32)
    return g[:7], g_mom, g[7], g[8]


def _assert_backward_close(g_flat, g_in, ct_table, ct):
    for c, g in zip(COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g.numpy(), ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        ref = ref.reshape(k, -1)
        off = ROW_OFFSETS[name]
        scale = max(1.0, float(np.abs(ref).max()))
        _close(g_flat[:, off:off + ref.shape[1]].numpy(), ref, rtol=1e-4,
               atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize('case', ['bench', 'achromat_sellmeier'])
def test_plain_seq_streams_match_jax_kernel(case):
    """K1's and K2's plain versions with the streams against the JAX
    package's ``trace_sequential_pallas_v2`` and its backward in interpret
    mode: the aux streams, and the ray and table cotangents under
    numpy-seeded cotangents of the rays, the moments, ``opl`` and
    ``n_final``."""
    js, pj, rays, _, _, _, nb = _case(case, n=256)
    flat, meta, cfg, rays_t = _port_inputs(js, pj, rays, nb)
    table_j = js.build_table(pj)
    maps = fused_trace.plate_maps(meta, None)
    _, _, aux_j = trace_sequential_pallas_v2(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        interpret=True, block_rows=2, **STREAMS)
    _, _, aux_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps, **STREAMS)
    _assert_aux_close(aux_t, aux_j)
    g_rays, g_mom, g_opl, g_nf = _cotangents(rays_t.n, cfg, 5)
    zero = np.zeros(rays_t.n, np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id), wavelength=zero),
        g_mom, interpret=True, block_rows=2, g_opl=g_opl, g_nfinal=g_nf)
    res = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps, g_opl=torch.from_numpy(g_opl),
        g_nfinal=torch.from_numpy(g_nf))
    _assert_backward_close(res[0], res[1], ct_table, ct)


def test_plain_nonseq_streams_match_jax_kernel():
    """K5's and K6's plain versions with the streams against the JAX
    package's ``trace_nonseq_pallas`` and its scan backward in interpret
    mode on the naive scene (8 bounces).  The JAX kernel writes slot 0 where
    a nearer non-sensor row overtook a sensor candidate, where the XLA loop
    (and the port) keeps the candidate's slot with weight 0, so the slots
    are compared where a sensor won; on this scene the sensor is the last
    row, so the two agree everywhere anyway."""
    js, pj, rays, _, _, _, nb = _case('bench', 8, n=256)
    flat, meta, cfg, rays_t = _port_inputs(js, pj, rays, nb)
    table_j = js.build_table(pj)
    _, _, aux_j = trace_nonseq_pallas(
        table_j, rays, KEY, 8, js.sensor_config(), js.static_meta(),
        interpret=True, block_rows=2, **STREAMS)
    _, _, aux_t = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays_t, cfg, meta, 8, None, **STREAMS)
    won = aux_t['hit_weights'].numpy() > 0
    np.testing.assert_array_equal(aux_t['hit_slots'].numpy()[won],
                                  np.asarray(aux_j['hit_slots'])[won])
    _assert_aux_close(aux_t, aux_j, keys=['paths', 'hits', 'hit_weights',
                                          'opl', 'n_final'])
    g_rays, g_mom, g_opl, g_nf = _cotangents(rays_t.n, cfg, 6)
    zero = np.zeros(rays_t.n, np.float32)
    ct_table, ct = trace_nonseq_pallas_bwd(
        table_j, rays, KEY, js.sensor_config(), js.static_meta(), 8,
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id), wavelength=zero),
        g_mom, interpret=True, block_rows=2, g_opl=g_opl, g_nfinal=g_nf)
    res = fused_nonseq.trace_nonseq_bwd_plain(
        flat, rays_t, cfg, meta, 8, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), g_opl=torch.from_numpy(g_opl),
        g_nfinal=torch.from_numpy(g_nf))
    _assert_backward_close(res[0], res[1], ct_table, ct)


# ---- gradients ----

TRAINED = {'bench': (('lens', 'c1'), ('lens', 'c2')),
           'achromat_sellmeier': (('achromat', 'c1'), ('achromat', 'c2'),
                                  ('achromat', 'c3')),
           'plate': (('plate', 'grid'),)}


def _loss_streams(aux):
    """A scalar of every stream a gradient test reads: opl, n_final and,
    when recorded, the hits."""
    loss = (aux['opl'] * aux['opl']).mean() + aux['n_final'].sum()
    if 'hits' in aux:
        loss = loss + (aux['hits'][..., :2] ** 2).mean()
    return loss


def _jax_grads(js, pj, rays, nb, trained, **kw):
    def loss(p):
        _, _, aux = js.simulate(p, rays, KEY, n_bundles=nb, **kw)
        return _loss_streams(aux)
    g = jax.grad(loss)(pj)
    return [np.asarray(g[el][k]) for el, k in trained]


def _torch_grads(sim, pt, rays_t, nb, trained, **kw):
    p = {el: dict(v) for el, v in pt.items()}
    for el, k in trained:
        p[el][k] = p[el][k].clone().requires_grad_(True)
    _, _, aux = sim(p, rays_t, nb, **kw)
    _loss_streams(aux).backward()
    return [p[el][k].grad.numpy() for el, k in trained]


@pytest.mark.parametrize('case,bounces', [('bench', None),
                                          ('achromat_sellmeier', None),
                                          ('plate', None), ('bench', 8)])
def test_opl_gradients_match_jax(case, bounces):
    """The gradient of a loss on ``opl`` and ``n_final`` in the scene's
    leaves, through the eager trace and ``simulate_fused`` (the plain
    versions of K1/K2 or K5/K6 on the CPU, FusedTraceStreams or
    FusedNonseqStreams), against ``jax.grad`` of the JAX trace."""
    js, pj, rays, ts, pt, rays_t, nb = _case(case, bounces, n=300)
    trained = TRAINED[case]
    ref = _jax_grads(js, pj, rays, nb, trained, track_opl=True)
    for sim in (ts.simulate, ts.simulate_fused):
        got = _torch_grads(sim, pt, rays_t, nb, trained, track_opl=True)
        for g, r, (el, k) in zip(got, ref, trained):
            assert np.abs(r).max() > 0
            _close(g, r, rtol=2e-4, atol=1e-5 * np.abs(r).max(),
                   err_msg=f'{el}.{k}')


@pytest.mark.parametrize('bounces', [None, 8])
def test_record_gradients_recompute_eagerly(bounces):
    """A loss on the recorded hits through ``simulate_fused``: the
    recording run's backward recomputes the eager trace (counted in
    ``RECORD_RECOMPUTES``, no K2 or K6 tried) and matches ``jax.grad`` of
    the JAX trace with the same streams."""
    js, pj, rays, ts, pt, rays_t, nb = _case('bench', bounces, n=300)
    trained = TRAINED['bench']
    kw = dict(track_opl=True, record_hits=True)
    ref = _jax_grads(js, pj, rays, nb, trained, **kw)
    before = fused_trace.RECORD_RECOMPUTES
    got = _torch_grads(ts.simulate_fused, pt, rays_t, nb, trained, **kw)
    assert fused_trace.RECORD_RECOMPUTES == before + 1
    for g, r in zip(got, ref):
        _close(g, r, rtol=2e-4, atol=1e-5 * np.abs(r).max())


def test_streams_ray_cotangents_match_eager():
    """``FusedTraceStreams`` with ``track_opl``: the cotangents of the 7 ray
    streams under a loss on ``opl``, ``n_final`` and the exit rays equal
    autograd of the eager chain (the plain K2 against the eager trace)."""
    js, pj, rays, ts, pt, rays_t, nb = _case('achromat_abbe', n=256)
    grads = []
    for sim in (ts.simulate, ts.simulate_fused):
        comps = {c: getattr(rays_t, c).clone().requires_grad_(True)
                 for c in COMPS}
        r = rays_t.replace(**comps)
        out, _, aux = sim(pt, r, nb, track_opl=True)
        (_loss_streams(aux) + out.px.sum()).backward()
        # (autograd leaves None where the loss does not reach a stream)
        grads.append([np.zeros(rays_t.n, np.float32)
                      if comps[c].grad is None else comps[c].grad.numpy()
                      for c in COMPS])
    for c, a, b in zip(COMPS, *grads):
        _close(a, b, rtol=2e-4, atol=1e-5 * max(1.0, np.abs(b).max()),
               err_msg=c)
