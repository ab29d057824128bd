"""The Fresnel physics of the PyTorch port and its random draws, against
the JAX package, on the CPU: ``fresnel_reflectance`` and ``fresnel_dir``
(total internal reflection included); ``apply_physics_one`` and
``medium_after`` for FRESNEL, FRESNEL_W and REFLECT_W, at constant and
dispersive indices; the eager ``trace_sequential`` of the singlet, the
achromatic doublet and the Cooke triplet with ``fresnel=True`` (fed the JAX
package's very uniforms, ``reference_prng.fresnel_uniforms``) and
``fresnel='weighted'``; the plain versions of K1 and K2 against the JAX
kernels in interpret mode on the same key's streams; ``jax.grad`` of
FRESNEL_W losses; the eager and plain non-sequential loops against the JAX
XLA loop fed its fold_in draws; Philox's known-answer vectors; the plain K5
and K6 against the eager loop under one seed; small-N twins of
tests/test_fresnel_trace.py and of tests/fresnel_anchors.py; and the
refusals (no source of draws, a stochastic recording run's gradient).

Tolerances, each with its reason:

- a ray whose uniform lies within ~1e-5 of R at a FRESNEL row may take the
  other branch in the other package (R differs by float32 rounding):
  such rays are found by tracing again with the uniforms moved by -1e-5 and
  +1e-5 (``_stable``) and left out; at most 2 of a test's rays may be
  (the expected count is ~N x rows x 2e-5, under 0.1 here);
- positions atol 2e-5 of the scene's length scale, directions atol 2e-6,
  intensities rtol 1e-5 (float32 rounding of a chain of rows in another
  order, as tests/test_torch_streams.py holds them);
- moments rtol 1e-4, atol 1e-3 (sums over the rays in another order);
- gradients rtol 1e-4 of the leaf (float32 adjoints summed over the rays in
  another order), per-ray cotangents rtol 2e-4, atol 1e-5 of the stream's
  scale, as tests/test_torch_fused_grad.py;
- Philox's words exactly; the draws of both packages' references exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import fresnel_anchors
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core import physics as jphys
from raytracetorch_tpu.core.static_dispatch import \
    apply_physics_one as jax_apply_physics_one
from raytracetorch_tpu.core.static_dispatch import \
    medium_after as jax_medium_after
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu.utils.ghosts import _meta_with_ph
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core import physics
from raytracetorch_tpu_torch.core.static_dispatch import (apply_physics_one,
                                                          medium_after)
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from raytracetorch_tpu_torch.rays import draws, reference_prng

torch.set_num_threads(2)

N = 600
KEY = jax.random.PRNGKey(0)
COMPS = fused_trace.COMPS
NS_BOUNCES = 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _disk(rt, radius, z):
    return rt.CollimatedDisk.make(radius=radius, translation=[0.0, 0.0, z])


# name -> (scene maker (rt, mode, n_bounces), bundles maker (rt, n), bundles)
CASES = {
    'singlet': (lambda rt, mode, nb=None: chip_smoke.fresnel_scene(
        rt, mode, nb), lambda rt, n: [(_disk(rt, 4.0, -10.0), n)], 1),
    'doublet': (lambda rt, mode, nb=None: chip_smoke.with_fresnel(
        chip_smoke.achromat_scene(rt, 'abbe', nb), mode),
        lambda rt, n: chip_smoke.achromat_bundles(rt, n // 2), 2),
    'cooke': (lambda rt, mode, nb=None: chip_smoke.with_fresnel(
        chip_smoke.cooke_scene(rt, nb), mode), chip_smoke.cooke_bundles, 6),
}


def _case(name, mode, n_bounces=None, n=N, seed=3):
    """(JAX scene, its params, JAX rays, port scene, port params, port
    rays, bundles) of a CASES name in Fresnel ``mode``."""
    make, bundles, nb = CASES[name]
    js, ts = make(jrt, mode, n_bounces), make(trt, mode, n_bounces)
    pj = js.init_params()
    rays = js.sample_rays(jax.random.PRNGKey(seed), bundles(jrt, n))
    return (js, pj, rays, ts, interop.params_from_numpy(_np(pj), 'cpu'),
            interop.rays_from_numpy(_np(rays), 'cpu'), nb)


def _jax_uniforms(meta, n, key=0):
    """The JAX package's Fresnel streams of a sequential trace under
    PRNGKey(key), as the port takes them."""
    return reference_prng.fresnel_uniforms(reference_prng.prng_key(key),
                                           meta, n)


def _outcome(out):
    return torch.stack([out.px, out.py, out.pz, out.dx, out.dy, out.dz,
                        out.intensity])


def _stable(trace, u, shift=1e-5):
    """The rays whose every FRESNEL draw lies more than ``shift`` from its
    R: those whose trace is the same with the uniforms moved down and up
    by ``shift`` (``trace(u) -> rays``)."""
    lo = _outcome(trace(torch.clamp(u - shift, min=0.0)))
    hi = _outcome(trace(torch.clamp(u + shift, max=1.0 - 2 ** -24)))
    return torch.isclose(lo, hi, rtol=1e-4, atol=1e-4).all(0).numpy()


def _assert_rays_close(out_t, out_j, keep=None):
    keep = np.ones(out_t.n, bool) if keep is None else keep
    pos_j, dir_j = np.asarray(out_j.pos)[keep], np.asarray(out_j.dir)[keep]
    scale = max(1.0, float(np.abs(pos_j).max()))
    _close(out_t.pos.detach().numpy()[keep], pos_j, rtol=0,
           atol=2e-5 * scale)
    _close(out_t.dir.detach().numpy()[keep], dir_j, rtol=0, atol=2e-6)
    _close(out_t.intensity.detach().numpy()[keep],
           np.asarray(out_j.intensity)[keep], rtol=1e-5, atol=1e-7)


# ---- physics ----

def _random_interfaces(n=4096, seed=0):
    """Unit directions and normals, media indices from {1, 1.5, 1.8} on
    each side (many pairs reflect totally) and uniforms."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    iors = np.array([1.0, 1.5, 1.8], np.float32)
    n_in = iors[rng.integers(0, 3, n)]
    n_out = iors[rng.integers(0, 3, n)]
    u = rng.random(n).astype(np.float32)
    return d, nrm, n_in, n_out, u


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fresnel_reflectance_and_dir_match_jax():
    """``fresnel_rs_rp``, ``fresnel_reflectance`` and ``fresnel_dir`` on
    random interfaces against the JAX package's (rtol 1e-6 on R; the
    directions atol 2e-6, except where u is within 1e-5 of R).

    The port's side runs on one CPU thread: torch hands the second
    2048-element half of these [4096] square roots to an OpenMP worker,
    and in one of five runs of this test after six of the JAX package's
    test files in one process (test_checkpoint, test_gui, test_sharding,
    test_propagation, test_mie, test_thermal) that worker's square roots
    came out ~1e-4 relative off on rays 2048..4095 only, while the same
    call repeated in the same process was exact: the state of a pool
    thread, not the port's arithmetic."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _fresnel_functions_match_jax()
    finally:
        torch.set_num_threads(threads)


def _fresnel_functions_match_jax():
    d, nrm, n_in, n_out, u = _random_interfaces()
    comps_j = jphys.refract_components(tuple(d.T), tuple(nrm.T), n_in, n_out)
    _, cos_i, n1, n2, _, tir, cos_t, _ = comps_j
    assert 0.05 < float(np.mean(tir)) < 0.5        # TIR is exercised
    r_j = jphys.fresnel_reflectance(cos_i, cos_t, n1, n2)
    rs_j, rp_j = jphys.fresnel_rs_rp(cos_i, cos_t, n1, n2)
    args = [_t(np.asarray(a)) for a in (cos_i, cos_t, n1, n2)]
    rs_t, rp_t = physics.fresnel_rs_rp(*args)
    _close(rs_t.numpy(), rs_j, rtol=1e-6, atol=1e-7)
    _close(rp_t.numpy(), rp_j, rtol=1e-6, atol=1e-7)
    _close(physics.fresnel_reflectance(*args).numpy(), r_j, rtol=1e-6,
           atol=1e-7)
    dir_j = np.stack(jphys.fresnel_dir(tuple(d.T), tuple(nrm.T), n_in,
                                       n_out, u), 1)
    dir_t = torch.stack(physics.fresnel_dir(
        tuple(_t(c) for c in d.T), tuple(_t(c) for c in nrm.T), _t(n_in),
        _t(n_out), _t(u)), 1).numpy()
    r_eff = np.where(np.asarray(tir), 1.0, np.asarray(r_j))
    far = np.abs(u - r_eff) > 1e-5
    assert far.mean() > 0.99
    _close(dir_t[far], dir_j[far], rtol=0, atol=2e-6)
    # both branches and total internal reflection occur
    reflect = u < r_eff
    assert reflect.any() and (~reflect).any() and (reflect & ~far).sum() < 5


def test_masked_rays_at_the_critical_angle_keep_finite_gradients():
    """A ray that a row's mask leaves out (a row it misses) and that meets
    the row exactly at the critical angle (sin2_t == 1 in float32: equal
    indices, d . n = 0) gets a zero cotangent through Snell's direction and
    the Fresnel weights, not 0 / 0 = NaN (core/physics.py::
    refract_components); so does every ray of the Cooke triplet's ghost
    (0, 8) on 250,000 rays of the seed where one such miss occurs, whose
    table cotangent stays finite."""
    d = [torch.tensor([1.0], requires_grad=True) for _ in range(3)]
    zero, one = torch.zeros(1), torch.ones(1)
    n = (zero, zero, one)
    ior = torch.full((1,), 1.5)
    _, _, _, _, _, tir, cos_t, _ = physics.refract_components(
        (d[0], zero * d[1], zero * d[2]), n, ior, ior)
    assert not bool(tir) and float(cos_t.detach()) == 0.0
    keep = torch.zeros(1, dtype=torch.bool)
    nd = physics.snell_dir((d[0], zero * d[1], zero * d[2]), n, ior, ior)
    r = physics.fresnel_reflectance(*physics.refract_components(
        (d[0], zero * d[1], zero * d[2]), n, ior, ior)[1:4], cos_t)
    loss = sum(torch.where(keep, c, 0.0).sum() for c in nd) \
        + torch.where(keep, r, 0.0).sum()
    loss.backward()
    assert torch.isfinite(d[0].grad).all()
    sc, build, params, rays, cfg, _ = chip_smoke.fresnel_case(
        trt, torch, 'cooke_ghost', 250_000, 'cpu', 113)
    table, meta = build(params)
    flat = trt.flatten_table_rows(table).detach()
    g_rays, g_mom, _ = chip_smoke.random_cotangents(torch, rays.n, cfg,
                                                    'cpu', 13)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(flat, rays, cfg, meta,
                                                   g_rays, g_mom)
    assert torch.isfinite(g_flat).all()
    assert all(bool(torch.isfinite(g).all()) for g in g_in)


def _kind_rows():
    """(name, JAX scene, row, wavelengths) of the Fresnel kinds' rows: the
    singlet's front face, and the Abbe achromat's cemented face at set
    wavelengths (dispersive)."""
    return [('singlet', chip_smoke.fresnel_scene(jrt, True), 0, False),
            ('singlet_back', chip_smoke.fresnel_scene(jrt, True), 1, False),
            ('doublet', chip_smoke.with_fresnel(
                chip_smoke.achromat_scene(jrt, 'abbe'), True), 1, True)]


@pytest.mark.parametrize('kind', [4, 8, 9], ids=['FRESNEL', 'FRESNEL_W',
                                                 'REFLECT_W'])
@pytest.mark.parametrize('name,scene,k,disp', _kind_rows(),
                         ids=[c[0] for c in _kind_rows()])
def test_apply_physics_and_medium_match_jax(kind, name, scene, k, disp):
    """``apply_physics_one`` (direction and intensity factor) and
    ``medium_after`` of one row in each Fresnel kind, for random directions
    from both sides (total internal reflection from the glass side),
    against the JAX package's; at the doublet's cemented face at set
    wavelengths (dispersive indices)."""
    rng = np.random.default_rng(7)
    n = 1024
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    nrm += 0.3 * rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = rng.random(n).astype(np.float32)
    wl = (rng.uniform(0.45, 0.7, n).astype(np.float32) if disp
          else np.zeros(n, np.float32))
    table_j = scene.build_table(scene.init_params())
    meta_j = _meta_with_ph(scene.static_meta()[k], kind)
    assert meta_j.disp == disp
    zero = np.zeros(n, np.float32)
    hit = (zero, zero, zero)
    dir_j, imod_j = jax_apply_physics_one(
        meta_j, table_j.row(k), hit, tuple(d.T), tuple(nrm.T), u,
        wavelength=jnp.asarray(wl))
    med_j = jax_medium_after(meta_j, table_j.row(k), tuple(d.T),
                             tuple(nrm.T), u, wavelength=jnp.asarray(wl))
    table_t = interop.table_from_numpy(_np(table_j), 'cpu')
    meta_t = interop.meta_from_slots([meta_j])[0]
    tup = (lambda a: tuple(_t(c) for c in a.T))
    dir_t, imod_t = apply_physics_one(meta_t, table_t.row(k),
                                      tuple(_t(zero) for _ in range(3)),
                                      tup(d), tup(nrm), _t(wl), u=_t(u))
    med_t = medium_after(meta_t, table_t.row(k), tup(d), tup(nrm), _t(wl),
                         _t(u))
    _close(torch.stack(dir_t, 1).numpy(), np.stack(dir_j, 1), rtol=0,
           atol=2e-6)
    _close(imod_t.numpy(), imod_j, rtol=1e-5, atol=1e-7)
    assert (med_t is None) == (med_j is None) == (kind == 9)
    if med_j is not None:
        _close(med_t.numpy(), med_j, rtol=1e-6)
        assert len(np.unique(np.asarray(med_j))) > 1
    if kind != 4:
        # the weights lie in [0, 1] and take the reflectance's range
        assert 0.0 <= float(imod_t.min()) < float(imod_t.max()) <= 1.0


def test_reference_draws_match_jax():
    """``reference_prng.fresnel_uniforms`` rebuilds the JAX package's
    sequential Fresnel streams (``uniform(split(key, K)[k], (N,))`` for
    FRESNEL row k) and ``fold_in`` its non-sequential keys, exactly."""
    scene = chip_smoke.cooke_scene(jrt)
    chip_smoke.with_fresnel(scene, True)
    meta = scene.static_meta()
    u = _jax_uniforms(meta, 333, key=5).numpy()
    keys = jax.random.split(jax.random.PRNGKey(5), len(meta))
    ref = [np.asarray(jax.random.uniform(keys[k], (333,)))
           for k, m in enumerate(meta) if m.ph == 4]
    assert u.shape == (len(ref), 333) and len(ref) == 9  # 3 x (2 faces, edge)
    np.testing.assert_array_equal(u, np.stack(ref))
    for data in (0, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            reference_prng.fold_in(reference_prng.prng_key(5), data),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(5), data)))


# ---- the eager sequential trace ----

@pytest.mark.parametrize('mode', [True, 'weighted'], ids=['mc', 'weighted'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_trace_sequential_matches_jax(case, mode):
    """Eager ``SequentialScene.simulate`` in each Fresnel mode against the
    JAX package's ``simulate`` with PRNGKey(0): with ``fresnel=True`` fed
    the JAX package's very uniforms (``uniforms=``), on every ray whose
    draws lie more than 1e-5 from R (at most 2 do not); the rays, and the
    moments when every ray is compared."""
    js, pj, rays, ts, pt, rays_t, nb = _case(case, mode)
    out_j, sens_j, _ = js.simulate(pj, rays, KEY, n_bundles=nb)
    meta = ts.static_meta()
    u = _jax_uniforms(meta, N)
    assert u.shape[0] == (sum(m.ph == 4 for m in meta) if mode is True
                          else 0)
    out_t, sens_t, _ = ts.simulate(pt, rays_t, nb, uniforms=u)
    keep = None
    if mode is True:
        keep = _stable(lambda v: ts.simulate(pt, rays_t, nb,
                                             uniforms=v)[0], u)
        assert (~keep).sum() <= 2
        # reflections happen: some rays end going backward
        assert float((out_t.dz < 0).sum()) > 0
    else:
        assert float(out_t.intensity.max()) < 1.0
    _assert_rays_close(out_t, out_j, keep)
    if keep is None or keep.all():
        _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4, atol=1e-3)


def test_eager_and_fused_draw_the_same_streams():
    """``simulate`` and ``simulate_fused`` (K1's plain version here) draw
    the same streams from the same generator state, and so trace alike; a
    generator in another state draws others."""
    ts = chip_smoke.fresnel_scene(trt, True)
    p = ts.init_params('cpu')
    rays = chip_smoke.sample_rays(trt, torch, 2000, 'cpu', 4)
    o1, s1, _ = ts.simulate(p, rays, generator=torch.Generator().manual_seed(
        9))
    o2, s2, _ = ts.simulate_fused(p, rays,
                                  generator=torch.Generator().manual_seed(9))
    for c in COMPS:
        torch.testing.assert_close(getattr(o1, c), getattr(o2, c), rtol=0,
                                   atol=0)
    torch.testing.assert_close(s1.moments, s2.moments, rtol=1e-6, atol=1e-4)
    o3, _, _ = ts.simulate(p, rays, generator=torch.Generator().manual_seed(
        10))
    assert float((o1.dz - o3.dz).abs().max()) > 1e-3


# ---- the plain versions of K1 and K2 against the JAX kernels ----

def _port_inputs(js, pj, rays, nb):
    table = interop.table_from_numpy(_np(js.build_table(pj)), 'cpu')
    meta = interop.meta_from_slots(js.static_meta())
    cfg = js.sensor_config(nb)
    cfg_t = trt.SensorConfig(n_sensors=cfg.n_sensors, n_bundles=cfg.n_bundles,
                             grid_shape=tuple(cfg.grid_shape),
                             grid_half_extent=cfg.grid_half_extent)
    return (trt.flatten_table_rows(table), meta, cfg_t,
            interop.rays_from_numpy(_np(rays), 'cpu'))


def test_plain_k1_k2_match_jax_kernels():
    """K1's and K2's plain versions with ``fresnel=True`` on the singlet
    against ``trace_sequential_pallas_v2`` and its backward in interpret
    mode, on the same key's streams: the rays, the moments, and the ray and
    table cotangents under numpy-seeded cotangents (no ray's draw lies
    within 1e-5 of its R here)."""
    js, pj, rays, _, _, _, nb = _case('singlet', True, n=256)
    flat, meta, cfg, rays_t = _port_inputs(js, pj, rays, nb)
    table_j = js.build_table(pj)
    u = _jax_uniforms(meta, rays_t.n)
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        interpret=True, block_rows=2)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps, uniforms=u)
    keep = _stable(lambda v: fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps, uniforms=v)[0], u)
    assert keep.all()
    _assert_rays_close(out_t, out_j)
    _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(5)
    g_rays = [rng.standard_normal(rays_t.n).astype(np.float32)
              for _ in range(7)]
    g_mom = rng.standard_normal((1, nb, 7)).astype(np.float32)
    zero = np.zeros(rays_t.n, np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id), wavelength=zero),
        g_mom, interpret=True, block_rows=2)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps, uniforms=u)[:2]
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
        _close(g_flat[:, off:off + ref.shape[1]].numpy(), ref, rtol=2e-4,
               atol=1e-5 * scale, err_msg=name)


# ---- gradients of FRESNEL_W losses ----

TRAINED = {'singlet': (('lens', 'c1'), ('lens', 'c2')),
           'doublet': (('achromat', 'c1'), ('achromat', 'c2'),
                       ('achromat', 'c3'))}


def _loss(sensors, n):
    """A spot loss that reads the weights: every bundle's spot RMS plus its
    transmitted share."""
    return (sensors.spot_rms(0).sum()
            + sensors.total_weight(0).sum() / n)


@pytest.mark.parametrize('case', sorted(TRAINED))
def test_weighted_gradients_match_jax(case):
    """The gradient of a spot and transmission loss of FRESNEL_W faces in
    the curvatures, through the eager trace and ``simulate_fused`` (K1's
    and K2's plain versions: the reflectance's adjoint in the weights),
    against ``jax.grad`` of the JAX trace (rtol 1e-4); on the doublet at
    F and C light (dispersive indices)."""
    js, pj, rays, ts, pt, rays_t, nb = _case(case, 'weighted', n=400)
    trained = TRAINED[case]

    def jax_loss(p):
        _, sens, _ = js.simulate(p, rays, KEY, n_bundles=nb)
        return jnp.sum(sens.spot_rms(0)) + jnp.sum(sens.total_weight(0)) / 400
    g = jax.grad(jax_loss)(pj)
    ref = [np.asarray(g[el][k]) for el, k in trained]
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        for el, k in trained:
            p[el][k] = p[el][k].clone().requires_grad_(True)
        _, sens, _ = sim(p, rays_t, nb)
        _loss(sens, 400).backward()
        for (el, k), r in zip(trained, ref):
            assert np.abs(r).max() > 0
            _close(p[el][k].grad.numpy(), r, rtol=1e-4,
                   atol=1e-4 * np.abs(r).max(), err_msg=f'{el}.{k}')


def test_weighted_ior_gradient_is_the_reflectance_adjoint():
    """The transmitted share of a FRESNEL_W window at normal incidence is
    (1 - R)^2 with R = ((n - 1) / (n + 1))^2: its derivative in the glass
    index is the closed form's, through the eager chain and K2's plain
    version alike."""
    ts = chip_smoke.with_fresnel(chip_smoke.window_scene(trt), 'weighted')
    p = ts.init_params('cpu')
    rays = trt.Rays.create(torch.tensor([[0.3, -0.2, -5.0]] * 8),
                           torch.tensor([[0.0, 0.0, 1.0]] * 8))
    n = 1.5
    R = ((n - 1) / (n + 1)) ** 2
    dR = 4 * (n - 1) / (n + 1) ** 3
    want = -2 * (1 - R) * dR
    for sim in (ts.simulate, ts.simulate_fused):
        q = {el: dict(v) for el, v in p.items()}
        q['win']['ior_glass'] = q['win']['ior_glass'].clone() \
            .requires_grad_(True)
        out, _, _ = sim(q, rays)
        out.intensity.mean().backward()
        _close(float(out.intensity[0].detach()), (1 - R) ** 2, rtol=1e-6)
        _close(float(q['win']['ior_glass'].grad), want, rtol=1e-4)


# ---- the non-sequential loop ----

def _jax_nonseq_draws(n, n_bounces, key=0, shift=0.0):
    """The JAX XLA loop's draws of FRESNEL row k at bounce b,
    ``uniform(fold_in(split(key, B)[b], k), (N,))``, moved by ``shift``."""
    keys = reference_prng.split(reference_prng.prng_key(key), n_bounces)

    def fn(b, k):
        u = reference_prng.uniform(reference_prng.fold_in(keys[b], k), n)
        return np.clip(u + shift, 0.0, 1.0 - 2 ** -24).astype(np.float32)
    return fn


@pytest.mark.parametrize('mode', [True, 'weighted'], ids=['mc', 'weighted'])
def test_nonsequential_matches_jax(mode):
    """The eager ``Scene.simulate`` and K5's plain version on the naive
    scene with a Fresnel singlet against the JAX XLA bounce loop, fed its
    fold_in draws (``draws=``): the rays whose draws lie more than 1e-5
    from R (at most 2 do not), and the moments when every ray is
    compared."""
    js, pj, rays, ts, pt, rays_t, nb = _case('singlet', mode, NS_BOUNCES)
    out_j, sens_j, _ = js.simulate(pj, rays, KEY)
    flat, meta, cfg, _ = _port_inputs(js, pj, rays, nb)
    maps = fused_trace.plate_maps(meta, None)

    def eager(shift=0.0):
        return ts.simulate(pt, rays_t, draws=_jax_nonseq_draws(
            N, NS_BOUNCES, shift=shift))

    def plain(shift=0.0):
        return fused_nonseq.trace_nonseq_fused_plain(
            flat, rays_t, cfg, meta, NS_BOUNCES, maps,
            draws=_jax_nonseq_draws(N, NS_BOUNCES, shift=shift))
    keep = None
    if mode is True:
        lo, hi = _outcome(eager(-1e-5)[0]), _outcome(eager(1e-5)[0])
        keep = torch.isclose(lo, hi, rtol=1e-4, atol=1e-4).all(0).numpy()
        assert (~keep).sum() <= 2
    for out_t, sens_t in (eager()[:2], plain()):
        _assert_rays_close(out_t, out_j, keep)
        if keep is None or keep.all():
            _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4,
                   atol=1e-3)
            _close(sens_t.grid.numpy(), sens_j.grid, rtol=1e-4, atol=1e-4)


def test_philox_known_answers():
    """Philox4x32-10 of rays/draws.py against the generator's published
    known-answer vectors (counter and key 0; all words 0xffffffff; the
    digits of pi), and the draw ``(word0 >> 8) 2^-24`` of counter (n, b, k,
    0)."""
    m = 0xFFFFFFFF
    for ctr, key, want in (
            ((0, 0, 0, 0), (0, 0),
             (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((m, m, m, m), (m, m),
             (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
             (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))):
        got = draws.philox4x32(*(torch.tensor([c]) for c in ctr), key)
        assert tuple(int(w) for w in got) == want
    n = torch.arange(5)
    u = draws.philox_uniform(n, 3, 2, (11, 12))
    w0 = draws.philox4x32(n, 3, 2, 0, (11, 12))[0]
    assert u.dtype == torch.float32
    assert torch.equal(u, (w0 >> 8).float() / 2 ** 24)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_plain_k5_k6_match_eager_under_one_seed():
    """K5's and K6's plain versions (``Scene.simulate_fused`` on the CPU)
    against the eager loop under one seed: both draw the same Philox key
    from the same generator state, and give the same rays and moments bit
    for bit and the same gradients in the curvatures."""
    _, _, _, ts, pt, rays_t, _ = _case('singlet', True, NS_BOUNCES, n=800)

    def gen():
        return torch.Generator().manual_seed(123456789)
    out_e, sens_e, _ = ts.simulate(pt, rays_t, generator=gen())
    out_f, sens_f, _ = ts.simulate_fused(pt, rays_t, generator=gen())
    for c in COMPS:
        assert torch.equal(getattr(out_e, c), getattr(out_f, c)), c
    assert torch.equal(sens_e.moments, sens_f.moments)
    assert float((out_e.dz < 0).sum()) > 0          # reflections happen
    grads = []
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        p['lens']['c1'] = p['lens']['c1'].clone().requires_grad_(True)
        _, sens, _ = sim(p, rays_t, generator=gen())
        _loss(sens, rays_t.n).backward()
        grads.append(float(p['lens']['c1'].grad))
    assert grads[0] != 0.0
    _close(grads[1], grads[0], rtol=1e-5)
    # another seed, another branch for some rays
    o3, _, _ = ts.simulate_fused(pt, rays_t,
                                 generator=torch.Generator().manual_seed(3))
    assert not torch.equal(o3.px, out_f.px)


# ---- tests/test_fresnel_trace.py and tests/fresnel_anchors.py, small ----

def test_fresnel_lens_transmission_statistics():
    """tests/test_fresnel_trace.py's transmission statistics: near-normal
    incidence through two n = 1.5168 faces reflects ~4.2% of the rays at
    each, so ~91.8% go on forward (atol 0.01, 40,000 rays); the
    intensities stay 1 (a branch draw, not an attenuation)."""
    scene = trt.SequentialScene([trt.SingletLens(
        c1=0.016667, c2=-0.00283, d=25.4, t=4.0, ior_glass=1.5168,
        fresnel=True, name='lens')])
    rays = trt.CollimatedDisk.make(radius=2.0, translation=[0, 0, -10.0]
                                   ).sample(torch.Generator().manual_seed(0),
                                            40000, 'cpu')
    out, _, _ = scene.simulate(scene.init_params('cpu'), rays,
                               generator=torch.Generator().manual_seed(1))
    R = ((1.5168 - 1) / (1.5168 + 1)) ** 2
    _close(float((out.dz > 0.5).float().mean()), (1 - R) ** 2, atol=0.01)
    _close(out.intensity.numpy(), 1.0, atol=1e-6)


def test_fresnel_reproducible_and_generator_sensitive():
    """tests/test_fresnel_trace.py's reproducibility: the same generator
    state gives the same trace, another state another one."""
    scene = trt.SequentialScene([trt.SingletLens(
        c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5, fresnel=True,
        name='lens')])
    p = scene.init_params('cpu')
    rays = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -10.0]
                                   ).sample(torch.Generator().manual_seed(0),
                                            2000, 'cpu')

    def run(seed):
        return scene.simulate(p, rays, generator=torch.Generator()
                              .manual_seed(seed))[0].dir
    np.testing.assert_array_equal(run(0).numpy(), run(0).numpy())
    assert float((run(0) - run(7)).abs().max()) > 1e-3


@pytest.mark.parametrize('mode', [True, 'weighted'], ids=['mc', 'weighted'])
def test_anchor_statistics_match_jax_small(mode):
    """tests/fresnel_anchors.py's sequential statistics at 4,096 rays: the
    port on the reference's threefry rays (``collimated_disk``) and, with
    ``fresnel=True``, its very uniforms, against the JAX package's, as
    chip_smoke.py section 11 holds them at 1M rays (the forward share to
    FRESNEL_FLIPS per million, the mean intensity to FRESNEL_W_RTOL, the
    spot RMS to FRESNEL_RMS_RTOL)."""
    n = 4096
    ref = fresnel_anchors.seq_stats(n, mode)
    ts = chip_smoke.fresnel_scene(trt, mode)
    rays = reference_prng.collimated_disk(reference_prng.prng_key(0), n, 4.0,
                                          (0.0, 0.0, -10.0))
    out, sens, _ = ts.simulate(ts.init_params('cpu'), rays,
                               uniforms=_jax_uniforms(ts.static_meta(), n))
    got = chip_smoke.fresnel_stats(out.dz.numpy(), out.intensity.numpy(),
                                   sens.moments.numpy())
    assert abs(got['forward'] - ref['forward']) <= 2 / n
    _close(got['mean_intensity'], ref['mean_intensity'],
           rtol=chip_smoke.FRESNEL_W_RTOL)
    _close(got['spot_rms'], ref['spot_rms'], rtol=chip_smoke.FRESNEL_RMS_RTOL)
    _close(got['sensor_share'], ref['sensor_share'], atol=2 / n)


def test_anchor_nonseq_share_matches_jax_small():
    """tests/fresnel_anchors.py's non-sequential sensor share at 4,096
    rays, the port under its counter-based draws (a generator) against the
    JAX XLA loop's, within FRESNEL_NS_SIGMAS binomial sigmas of the
    difference, as chip_smoke.py section 11 holds them at 1M rays."""
    n = 4096
    ref = fresnel_anchors.nonseq_share(n, chunks=2)
    ts = chip_smoke.fresnel_scene(trt, True, chip_smoke.NS_BOUNCES)
    rays = reference_prng.collimated_disk(reference_prng.prng_key(0), n, 4.0,
                                          (0.0, 0.0, -10.0))
    _, sens, _ = ts.simulate_fused(ts.init_params('cpu'), rays,
                                   generator=torch.Generator().manual_seed(0))
    got = float(sens.moments[0, 0, 6]) / n
    sigma = np.sqrt(2 * ref * (1 - ref) / n)
    assert 0.5 < got < 0.99
    assert abs(got - ref) <= chip_smoke.FRESNEL_NS_SIGMAS * sigma, (got, ref)


# ---- refusals ----

def test_missing_generator_raises():
    """A scene with a FRESNEL row and no source of draws raises ValueError
    in every entry point; it never draws from a default seed."""
    seq = chip_smoke.fresnel_scene(trt, True)
    ns = chip_smoke.fresnel_scene(trt, True, NS_BOUNCES)
    rays = chip_smoke.sample_rays(trt, torch, 64, 'cpu', 1)
    for sc in (seq, ns):
        p = sc.init_params('cpu')
        for sim in (sc.simulate, sc.simulate_fused):
            with pytest.raises(ValueError, match='generator'):
                sim(p, rays)
    flat = trt.flatten_table_rows(ns.build_table(ns.init_params('cpu')))
    with pytest.raises(ValueError, match='key'):
        fused_nonseq.trace_nonseq_fused_plain(
            flat, rays, ns.sensor_config(), ns.static_meta(), NS_BOUNCES)
    with pytest.raises(ValueError, match='uniforms'):
        seq.simulate(seq.init_params('cpu'), rays,
                     uniforms=torch.rand(2, 64))
    # the weighted kinds draw nothing and need no generator
    w = chip_smoke.fresnel_scene(trt, 'weighted')
    w.simulate_fused(w.init_params('cpu'), rays)


def test_stochastic_recording_gradient_raises():
    """As the JAX package's ``_fused_nonseq_bwd`` does, gradients through a
    recording run of the fused non-sequential trace of a drawing scene
    raise; without the records (K6's replay by counter) they run."""
    ns = chip_smoke.fresnel_scene(trt, True, NS_BOUNCES)
    p = ns.init_params('cpu')
    p['lens']['c1'] = p['lens']['c1'].clone().requires_grad_(True)
    rays = chip_smoke.sample_rays(trt, torch, 64, 'cpu', 2)
    out, _, aux = ns.simulate_fused(p, rays, record_hits=True,
                                    generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match='weighted'):
        (aux['hits'] ** 2).sum().backward()
    out, sens, _ = ns.simulate_fused(
        p, rays, generator=torch.Generator().manual_seed(1))
    sens.moments.sum().backward()
    assert p['lens']['c1'].grad is not None
