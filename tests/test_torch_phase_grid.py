"""Pixelated phase plates in the PyTorch port against the JAX package.

The deep-optics path: ``PhaseGridPlate`` (elements/diffractive.py), its
physics ``phase_grid_dir`` (core/physics.py), the corner reads of kernel K4
(ops/phase_grid.py; its plain version runs on CPU tensors) and the plates in
both scene types, eager and fused (the fused kernels' plain versions run on
the CPU).  Inputs are made once, with numpy or the JAX package, and carried
across by ``interop``.  Tolerances, each stated at its test:

- ``phase_grid_dir`` and K4's plain gather: the same float32 operations as
  the reference, values to 1e-6 and exact reads; gradients to rtol 1e-4 of
  their scale (the port and XLA order the sums of the scatter differently);
- the scenes: tests/test_phase_grid.py's own bounds (directions atol 1e-7,
  positions 1e-6, moments rtol 1e-5 atol 1e-3, map gradients atol 1e-7,
  ``trans[2]`` rtol 1e-4) where they hold.

The CUDA kernels are compared with these plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.physics import \
    phase_grid_dir as jax_phase_grid_dir
from raytracetorch_tpu.core.static_dispatch import \
    sb_check_one as jax_sb_check_one
from raytracetorch_tpu.ops.pallas_trace import _grid_corners_mxu
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import SBKind
from raytracetorch_tpu_torch.core.physics import corner_clip, phase_grid_dir
from raytracetorch_tpu_torch.core.static_dispatch import sb_check_one
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace, phase_grid

torch.set_num_threads(2)

HX = 4.0
LAM0 = 0.5876
KEY = jax.random.PRNGKey(0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _smooth_map(n, seed=0, scale=1.0):
    """A ramp, a bowl and seeded pixel noise, in cycles."""
    xs = np.linspace(-HX, HX, n)
    X, Y = np.meshgrid(xs, xs, indexing='xy')
    noise = np.random.default_rng(seed).normal(size=(n, n))
    return (scale * (30.0 * X + 4.0 * Y * Y + 2.0 * X * Y + noise)
            ).astype(np.float32)


def _probe(xs, ys, wavelength=LAM0):
    xs = np.asarray(xs, np.float32)
    ys = np.asarray(ys, np.float32)
    pos = np.stack([xs, ys, np.full_like(xs, -3.0)], -1)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (xs.shape[0], 1))
    return JaxRays.create(jnp.asarray(pos), jnp.asarray(d),
                          wavelength=jnp.full(xs.shape[0], wavelength,
                                              jnp.float32))


def _rotation(rv):
    rv = np.asarray(rv, np.float64)
    th = np.linalg.norm(rv)
    k = rv / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * K @ K).astype(np.float32)


def test_corner_clip_rounds_as_the_reference():
    """The clip bound is ``n - 1 - 1e-6`` in double rounded once to float32,
    as the reference's ``jnp.clip`` bound; from 34 pixels on it is
    ``n - 1`` itself, so a ray at the far rim reads cell ``n - 1``."""
    for n in (2, 16, 32, 33, 34, 40, 256):
        assert corner_clip(n) == float(np.float32(n - 1 - 1e-6))
    assert corner_clip(33) < 32.0 and corner_clip(34) == 33.0


def _dir_inputs(n_map, seed, n=512):
    """Seeded inputs of phase_grid_dir: tilted unit directions, hits over
    [-1.2 hx, 1.2 hx] x [-1.2 hy, 1.2 hy] (a sixth beyond the rims), half
    the rays at 0.55 um and half unset, a rotated frame, a map steep enough
    to kick some rays evanescent."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)) * [0.2, 0.2, 1.0] + [0.0, 0.0, 2.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hy = 3.0
    hit = np.stack([rng.uniform(-1.2, 1.2, n) * HX,
                    rng.uniform(-1.2, 1.2, n) * hy, np.zeros(n)],
                   -1).astype(np.float32)
    wl = np.where(np.arange(n) % 2 == 0, 0.55, 0.0).astype(np.float32)
    grid = _smooth_map(n_map, seed, scale=40.0)
    return dict(d=d, hit=hit, wl=wl, grid=grid, hy=hy,
                Rw=_rotation([0.1, -0.2, 0.05]),
                w=rng.normal(size=(4, n)).astype(np.float32))


def _jax_dir(a, d, hit, grid, Rw, hx, hy):
    out, ok = jax_phase_grid_dir(
        tuple(d[:, j] for j in range(3)), Rw,
        tuple(hit[:, j] for j in range(3)), grid, 1.0, LAM0,
        jnp.asarray(a['wl']), 1.0, 1.5, hx, hy)
    return out, ok


def _torch_dir(a, d, hit, grid, Rw, hx, hy):
    return phase_grid_dir(
        tuple(d[:, j] for j in range(3)), Rw,
        tuple(hit[:, j] for j in range(3)), grid, 1.0, LAM0,
        torch.from_numpy(a['wl']), 1.0, 1.5, hx, hy,
        corners_fn=phase_grid.grid_corners)


@pytest.mark.parametrize('n_map', [16, 40])
def test_phase_grid_dir_matches_jax(n_map):
    """Values to atol 1e-6 (the same float32 operations), the same
    evanescent rays; the gradients of a seeded scalar of the outputs in
    the direction, the hit, the map, the frame and the half extents to
    rtol 1e-4 of each one's largest entry."""
    a = _dir_inputs(n_map, seed=n_map)
    out_j, ok_j = _jax_dir(a, jnp.asarray(a['d']), jnp.asarray(a['hit']),
                           jnp.asarray(a['grid']), jnp.asarray(a['Rw']),
                           jnp.float32(HX), jnp.float32(a['hy']))
    t = {k: torch.from_numpy(np.array(a[k])).requires_grad_(True)
         for k in ('d', 'hit', 'grid', 'Rw')}
    hx_t = torch.tensor(HX, requires_grad=True)
    hy_t = torch.tensor(a['hy'], requires_grad=True)
    out_t, ok_t = _torch_dir(a, t['d'], t['hit'], t['grid'], t['Rw'],
                             hx_t, hy_t)
    assert 0 < int((~ok_t).sum()) < ok_t.numel() // 2
    assert torch.equal(ok_t, torch.from_numpy(np.asarray(ok_j)))
    for c in range(3):
        np.testing.assert_allclose(out_t[c].detach().numpy(),
                                   np.asarray(out_j[c]), atol=1e-6)

    # The reference's gather clamps a corner beyond the map, but its
    # transpose drops that corner's cotangent (PROMISE_IN_BOUNDS), while
    # the port scatters it into the clamped cell, the exact transpose of
    # the clamped read (test_rim_and_miss_rays_follow_the_xla_gather).  The
    # rays whose far corner leaves the map (maps of 34 pixels and more)
    # are left out of the compared gradients.
    u = (a['hit'][:, 0] + HX) / (2 * HX) * (n_map - 1)
    v = (a['hit'][:, 1] + a['hy']) / (2 * a['hy']) * (n_map - 1)
    far = ((u >= corner_clip(n_map)) | (v >= corner_clip(n_map))) \
        & (corner_clip(n_map) == n_map - 1)
    assert far.any() == (n_map >= 34)
    w = a['w'] * ~far

    def jax_scalar(d, hit, grid, Rw, hx, hy):
        out, ok = _jax_dir(a, d, hit, grid, Rw, hx, hy)
        return sum(jnp.sum(w[c] * out[c]) for c in range(3))

    g_j = jax.grad(jax_scalar, argnums=tuple(range(6)))(
        jnp.asarray(a['d']), jnp.asarray(a['hit']), jnp.asarray(a['grid']),
        jnp.asarray(a['Rw']), jnp.float32(HX), jnp.float32(a['hy']))
    sum(torch.sum(torch.from_numpy(w[c]) * out_t[c])
        for c in range(3)).backward()
    g_t = (t['d'].grad, t['hit'].grad, t['grid'].grad, t['Rw'].grad,
           hx_t.grad, hy_t.grad)
    for name, gt, gj in zip(('d', 'hit', 'grid', 'Rw', 'hx', 'hy'), g_t,
                            g_j):
        gj = np.asarray(gj)
        scale = float(np.abs(gj).max())
        assert scale > 0, name
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_rim_and_miss_rays_follow_the_xla_gather():
    """On a 40-wide map ``u`` clips to exactly 39 at and beyond the far rim,
    so the corner ``iu + 1`` is column 40.  The port clamps it, as XLA's
    gather does in the reference's ``simulate``: eager and fused traces
    equal JAX ``simulate`` (directions atol 1e-7, positions 1e-6, moments
    rtol 1e-5 atol 1e-3) and do not
    raise.  The reference's fused kernel reads 0 there through its one-hot
    reads and differs, and the reference's gradient drops the clamped
    corner's cotangent: both divergences are recorded here."""
    n = 40
    xs = np.linspace(-HX, HX, n)
    X, Y = np.meshgrid(xs, xs, indexing='xy')
    g = (3.0 * X + 0.15 * Y * Y + 0.7 * X * Y).astype(np.float32)

    def scene(rt):
        return rt.SequentialScene([
            rt.PhaseGridPlate(half_x=HX, half_y=HX, shape=(n, n), init=g,
                              name='pp'),
            rt.SensorElement(radius=20.0, translation=[0, 0, 50.0],
                             name='s')])

    # far rim in x, far rim in y, the corner, beyond in x, the near
    # corner, beyond in y
    rays = _probe([4.0, 0.3, 4.0, 5.0, -4.0, 2.0],
                  [0.5, 4.0, 4.0, 0.0, -4.0, 6.0])
    js, ts = scene(jrt), scene(trt)
    o_x, s_x, _ = js.simulate(js.init_params(), rays, KEY)
    o_f, _, _ = js.simulate_fused(js.init_params(), rays, KEY,
                                  auto_dispatch=False, interpret=True)
    r_t = interop.rays_from_numpy(_np(rays), 'cpu')
    p_t = ts.init_params('cpu')
    for sim in (ts.simulate, ts.simulate_fused):
        o_t, s_t, _ = sim(p_t, r_t)
        np.testing.assert_allclose(o_t.dir.numpy(), np.asarray(o_x.dir),
                                   atol=1e-7)
        np.testing.assert_allclose(o_t.pos.numpy(), np.asarray(o_x.pos),
                                   atol=1e-6)
        np.testing.assert_allclose(s_t.moments.numpy(),
                                   np.asarray(s_x.moments), rtol=1e-5,
                                   atol=1e-3)
    # the rim rays take no kick along the clamped axis in the XLA path ...
    assert float(o_x.dx[0]) == 0.0 and float(o_x.dy[1]) == 0.0
    # ... and a kick from a zero corner in the reference's fused kernel
    assert abs(float(o_f.dx[0])) > 1e-2 and abs(float(o_f.dy[1])) > 1e-2
    # The rim ray's dx does not depend on the map (both x corners read
    # column 39): the port's gradient, the transpose of the clamped read,
    # is zero; the reference's transpose drops the clamped corner's
    # cotangent and leaves one in column 39 (its phase_grid_dir on the
    # first ray's hit).
    def jax_dx(grid):
        out, _ = jax_phase_grid_dir(
            tuple(jnp.float32([c]) for c in (0.0, 0.0, 1.0)), jnp.eye(3),
            tuple(jnp.float32([c]) for c in (HX, 0.5, 0.0)), grid, 1.0,
            LAM0, jnp.float32([LAM0]), 1.0, 1.0, HX, HX)
        return out[0][0]

    g_j = np.asarray(jax.grad(jax_dx)(jnp.asarray(g)))
    assert np.abs(g_j[:, 39]).max() > 0 and not g_j[:, :39].any()
    p_g = ts.init_params('cpu')
    p_g['pp']['grid'].requires_grad_(True)
    for sim in (ts.simulate, ts.simulate_fused):
        (g_t,) = torch.autograd.grad(sim(p_g, r_t)[0].dx[0],
                                     p_g['pp']['grid'], allow_unused=True)
        assert g_t is None or not g_t.any()


def _check_corners_against_tpu(shape, iv, iu, rng):
    """K4's plain gather, its plain scatter and autograd of the gather
    against ``_grid_corners_mxu`` and its ``jax.vjp`` on cells (iv, iu)."""
    grid = rng.normal(size=shape).astype(np.float32)
    cts = [rng.normal(size=iv.shape).astype(np.float32) for _ in range(4)]
    c_j, vjp = jax.vjp(lambda g: _grid_corners_mxu(g, jnp.asarray(iv),
                                                   jnp.asarray(iu)),
                       jnp.asarray(grid))
    (g_j,) = vjp(tuple(jnp.asarray(c) for c in cts))
    grid_t = torch.from_numpy(grid).requires_grad_(True)
    iv_t, iu_t = torch.from_numpy(iv), torch.from_numpy(iu)
    c_t = phase_grid.grid_corners(grid_t, iv_t, iu_t)
    for a, b in zip(c_t, c_j):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    torch.autograd.backward(c_t, [torch.from_numpy(c) for c in cts])
    g_s = phase_grid.grid_corners_bwd_plain(
        [torch.from_numpy(c) for c in cts], iv_t, iu_t, shape)
    for g in (grid_t.grad, g_s):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-6)


@pytest.mark.parametrize('shape', [(16, 16), (40, 24)])
def test_plain_corners_match_the_tpu_kernel_function(shape):
    """K4's plain version against the TPU kernel function
    ``_grid_corners_mxu``, called directly on in-range ``[rows, 128]``
    cells: the reads are exact (one-hot products at HIGHEST precision on
    the CPU); the scatter (``jax.vjp`` of the one-hot products) to atol
    1e-6, both by ``grid_corners_bwd_plain`` and by autograd of the plain
    gather."""
    h, w = shape
    rng = np.random.default_rng(h)
    iv = rng.integers(0, h - 1, size=(4, 128)).astype(np.int32)
    iu = rng.integers(0, w - 1, size=(4, 128)).astype(np.int32)
    _check_corners_against_tpu(shape, iv, iu, rng)


def _k4_pattern(pattern, rng):
    """(shape, iv, iu) of in-range [4, 128] cells on which K4's scatter
    branches on the card: row pairs at each position in a 16-byte group
    (flat offset c00 = 0..3 mod 4) on an even and an odd width, pairs
    ending in the last column (on a map tall enough that few share a cell:
    the tolerance is for sums of a few terms), a 32 x 32 map (held in
    shared memory by the kernel), and a map larger than any shared-memory
    copy."""
    shape = {'residues_even': (40, 24), 'residues_odd': (40, 37),
             'last_column': (257, 45), 'map_32x32': (32, 32),
             'map_128x128': (128, 128)}[pattern]
    h, w = shape
    iv = rng.integers(0, h - 1, size=(4, 128)).astype(np.int32)
    if pattern.startswith('residues'):
        base = rng.integers(0, w - 4, size=(4, 128))
        res = np.arange(4 * 128).reshape(4, 128) % 4
        iu = (base + (res - (iv * w + base)) % 4).astype(np.int32)
        assert ((iv * w + iu) % 4 == res).all()
    elif pattern == 'last_column':
        iu = np.full((4, 128), w - 2, dtype=np.int32)
    else:
        iu = rng.integers(0, w - 1, size=(4, 128)).astype(np.int32)
    return shape, iv, iu


@pytest.mark.parametrize('pattern', ['residues_even', 'residues_odd',
                                     'last_column', 'map_32x32',
                                     'map_128x128'])
def test_plain_corners_match_the_tpu_kernel_on_scatter_patterns(pattern):
    """As ``test_plain_corners_match_the_tpu_kernel_function``, on the
    cells that K4's scatter paths on the card tell apart (the TPU function
    takes in-range cells only; clamping is held by
    ``test_corner_reads_clamp_out_of_range_cells``)."""
    rng = np.random.default_rng(len(pattern))
    shape, iv, iu = _k4_pattern(pattern, rng)
    assert (iu <= shape[1] - 2).all() and (iv <= shape[0] - 2).all()
    _check_corners_against_tpu(shape, iv, iu, rng)


def test_corner_reads_clamp_out_of_range_cells():
    """Cells outside the map read (and scatter into) the nearest cell, as
    XLA's gather clamps; a CPU tensor never launches K4."""
    grid = torch.arange(12.0).reshape(3, 4)
    iv = torch.tensor([2, -1, 0, 5], dtype=torch.int32)
    iu = torch.tensor([3, 0, 9, -3], dtype=torch.int32)
    phase_grid.CORNER_LAUNCHES = 0
    c = phase_grid.grid_corners(grid, iv, iu)
    assert phase_grid.CORNER_LAUNCHES == 0
    expect = [[11, 0, 3, 8], [11, 1, 3, 8], [11, 0, 7, 8], [11, 1, 7, 8]]
    for got, want in zip(c, expect):
        assert got.tolist() == [float(v) for v in want]
    g = phase_grid.grid_corners_bwd_plain([torch.ones(4)] * 4, iv, iu,
                                          (3, 4))
    assert float(g.sum()) == 16.0 and float(g[2, 3]) == 4.0


def test_rect_bound_matches_jax():
    """The RECT surface bound, |x| <= sb0 and |y| <= sb1, point by point
    (the rims included)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3, 3, size=(3, 400)).astype(np.float32)
    pts[0, :4] = [2.0, -2.0, 2.0, 1.0]
    pts[1, :4] = [1.0, 0.0, -1.0, -1.0]
    sb = np.array([2.0, 1.0, 0.0, 0.0], np.float32)
    want = np.asarray(jax_sb_check_one(
        SBKind.RECT, jnp.asarray(sb), tuple(jnp.asarray(p) for p in pts)))
    got = sb_check_one(SBKind.RECT, torch.from_numpy(sb),
                       tuple(torch.from_numpy(p) for p in pts))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:4].all() and 0 < want.sum() < want.size


def _plate_elements(rt, n=16, **kw):
    return [rt.PhaseGridPlate(half_x=HX, half_y=HX, shape=(n, n),
                              name='pp', **kw),
            rt.SensorElement(radius=20.0, translation=[0, 0, 50.0],
                             name='s')]


def test_plate_builds_the_reference_table():
    """``PhaseGridPlate.build`` gives the reference's table row, kinds and
    trainable flags; the map rides ``side_grids`` (row 0); the guards
    raise as the reference's."""
    g = _smooth_map(16)
    js = jrt.SequentialScene(_plate_elements(jrt, order=2, init=g,
                                             design_wavelength=0.65,
                                             ior_out=1.2))
    ts = trt.SequentialScene(_plate_elements(trt, order=2, init=g,
                                             design_wavelength=0.65,
                                             ior_out=1.2))
    tj = _np(js.build_table(js.init_params()))
    pt = ts.init_params('cpu')
    tt = ts.build_table(pt)
    for f in dataclasses.fields(trt.SurfaceTable):
        a, b = getattr(tt, f.name).numpy(), np.asarray(getattr(tj, f.name))
        assert a.shape == b.shape, f.name
        np.testing.assert_allclose(a.astype(float), b.astype(float), rtol=0,
                                   atol=1e-6, err_msg=f.name)
    assert [m.ph for m in ts.static_meta()] == \
        [m.ph for m in js.static_meta()]
    assert ts.trainable()['pp']['grid'] is True
    assert set(ts.side_grids(pt)) == {0}
    assert torch.equal(ts.side_grids(pt)[0], torch.from_numpy(g))
    with pytest.raises(ValueError):
        trt.PhaseGridPlate(half_x=0.0, half_y=4.0)
    with pytest.raises(ValueError):
        trt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(1, 8))
    with pytest.raises(ValueError):
        trt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(4, 4),
                           init=np.zeros((8, 8)))
    with pytest.raises(ValueError):
        trt.PhaseGridPlate(half_x=4.0, half_y=4.0, order=0)


def test_ramp_map_is_a_grating():
    """tests/test_phase_grid.py::test_ramp_grid_is_a_grating on the port:
    phi = c x exits every ray with dx = m lam_mm c (rtol 1e-5)."""
    c, n = 30.0, 17
    xs = np.linspace(-HX, HX, n)
    grid = np.broadcast_to(c * xs[None, :], (n, n)).astype(np.float32)
    sc = trt.SequentialScene([trt.PhaseGridPlate(
        half_x=HX, half_y=HX, shape=(n, n), init=grid, name='pp')])
    rays = interop.rays_from_numpy(
        _np(_probe([0.3, -2.1, 1.7], [0.5, -1.0, 3.0])), 'cpu')
    for sim in (sc.simulate, sc.simulate_fused):
        out, _, _ = sim(sc.init_params('cpu'), rays)
        np.testing.assert_allclose(out.dx.numpy(), LAM0 * 1e-3 * c,
                                   rtol=1e-5)
        np.testing.assert_allclose(out.dy.numpy(), 0.0, atol=1e-7)
        np.testing.assert_allclose(out.intensity.numpy(), 1.0, atol=1e-6)


def _steerer(rt, scene_cls, n=16, **kw):
    xs = np.linspace(-HX, HX, n)
    X, Y = np.meshgrid(xs, xs, indexing='xy')
    sc = scene_cls(_plate_elements(rt, n), **kw)
    return sc, (3.0 * X + 0.15 * Y * Y).astype(np.float32)


def _moment_loss(lib):
    def loss(sens):
        m = sens.moments[0, 0]
        den = (jnp.maximum(m[0], 1e-9) if lib is jnp
               else torch.clamp(m[0], min=1e-9))
        return m[1] / den + 1e-3 * m[3]
    return loss


def _jax_params(sc, g):
    p = sc.init_params()
    p['pp']['grid'] = jnp.asarray(g)
    return p


def _port_params(p_j, *grad_leaves):
    p = interop.params_from_numpy(_np(p_j), 'cpu')
    for k in grad_leaves:
        p['pp'][k].requires_grad_(True)
    return p


def _disk_rays(n):
    return jrt.CollimatedDisk.make(radius=jnp.float32(2.0),
                                   translation=[0, 0, -3.0],
                                   wavelength=LAM0).sample(KEY, n)


@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_scene_traces_match_jax(kind):
    """The steerer scene (tests/test_phase_grid.py::_steerer_scene) as a
    ``SequentialScene``, and as the 3-bounce ``Scene`` with an 8 x 8
    irradiance grid (``_nonseq_pg_scene``), on 2,048 JAX-sampled rays:
    ``simulate`` and ``simulate_fused`` of the port against JAX
    ``simulate``, with tests/test_phase_grid.py's bounds (directions atol
    1e-7, positions 1e-6, moments and grid rtol 1e-5 atol 1e-3); the
    gradients of its moment loss in the map (atol 1e-7) and ``trans[2]``
    (rtol 1e-4)."""
    if kind == 'sequential':
        js, g = _steerer(jrt, jrt.SequentialScene)
        ts, _ = _steerer(trt, trt.SequentialScene)
    else:
        js, g = _steerer(jrt, jrt.Scene, n_bounces=3)
        ts, _ = _steerer(trt, trt.Scene, n_bounces=3)
        for sc in (js, ts):
            sc.grid_shape, sc.grid_half_extent = (8, 8), 8.0
    p_j = _jax_params(js, g)
    rays = _disk_rays(2048)
    o_x, s_x, _ = js.simulate(p_j, rays, KEY)
    g_x = jax.grad(lambda p: _moment_loss(jnp)(
        js.simulate(p, rays, KEY)[1]))(p_j)['pp']
    r_t = interop.rays_from_numpy(_np(rays), 'cpu')
    for sim in ('simulate', 'simulate_fused'):
        p_t = _port_params(p_j, 'grid', 'trans')
        o_t, s_t, _ = getattr(ts, sim)(p_t, r_t)
        np.testing.assert_allclose(o_t.dx.detach().numpy(),
                                   np.asarray(o_x.dx), atol=1e-7)
        np.testing.assert_allclose(o_t.px.detach().numpy(),
                                   np.asarray(o_x.px), atol=1e-6)
        np.testing.assert_allclose(s_t.moments.detach().numpy(),
                                   np.asarray(s_x.moments), rtol=1e-5,
                                   atol=1e-3)
        if kind == 'scene':
            np.testing.assert_allclose(s_t.grid.detach().numpy(),
                                       np.asarray(s_x.grid), rtol=1e-5,
                                       atol=1e-3)
        _moment_loss(torch)(s_t).backward()
        gg = np.asarray(g_x['grid'])
        assert float(np.abs(gg).max()) > 0
        np.testing.assert_allclose(p_t['pp']['grid'].grad.numpy(), gg,
                                   atol=1e-7, err_msg=sim)
        np.testing.assert_allclose(p_t['pp']['trans'].grad[2].item(),
                                   float(g_x['trans'][2]), rtol=1e-4,
                                   err_msg=sim)


def test_scene_grid_loss_gradients_match_jax():
    """tests/test_phase_grid.py::test_nonseq_fused_phase_grid_scan_bwd's
    loss (total weight + spot RMS + 1e-2 sum(grid * W)) through the port's
    ``Scene.simulate_fused`` (``FusedNonseq``; K6's plain version) against
    ``jax.grad`` through the JAX bounce loop: the map's gradient to atol
    1e-7, the ray streams' to rtol 1e-4 atol 1e-6."""
    js, g = _steerer(jrt, jrt.Scene, n_bounces=3)
    ts, _ = _steerer(trt, trt.Scene, n_bounces=3)
    for sc in (js, ts):
        sc.grid_shape, sc.grid_half_extent = (8, 8), 8.0
    p_j = _jax_params(js, g)
    rays = _disk_rays(1024)
    W = np.random.default_rng(3).normal(size=(1, 8, 8)).astype(np.float32)
    comps = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')

    def jax_loss(p, *rc):
        _, s, _ = js.simulate(p, rays.replace(**dict(zip(comps, rc))), KEY)
        return (s.total_weight(0)[0] + s.spot_rms(0)[0]
                + jnp.sum(s.grid * W) * 1e-2)

    grads = jax.grad(jax_loss, argnums=tuple(range(8)))(
        p_j, *(getattr(rays, c) for c in comps))
    p_t = _port_params(p_j, 'grid')
    r_t = interop.rays_from_numpy(_np(rays), 'cpu')
    r_t = r_t.replace(**{c: getattr(r_t, c).requires_grad_(True)
                         for c in comps})
    _, s, _ = ts.simulate_fused(p_t, r_t)
    (s.total_weight(0)[0] + s.spot_rms(0)[0]
     + (s.grid * torch.from_numpy(W)).sum() * 1e-2).backward()
    np.testing.assert_allclose(p_t['pp']['grid'].grad.numpy(),
                               np.asarray(grads[0]['pp']['grid']), atol=1e-7)
    for c, ref in zip(comps, grads[1:]):
        np.testing.assert_allclose(getattr(r_t, c).grad.numpy(),
                                   np.asarray(ref), rtol=1e-4, atol=1e-6,
                                   err_msg=c)


def test_ordered_scene_equals_the_sequential_trace():
    """tests/test_phase_grid.py::test_phase_grid_nonseq_parity on the port,
    fused: the ordered ``Scene`` equals the ``SequentialScene`` (directions
    atol 1e-7, positions 1e-5, moments rtol/atol 1e-6, map gradients atol
    1e-7), and ``to_base`` / ``to_sequential`` keep the plate."""
    seq, g = _steerer(trt, trt.SequentialScene)
    nsc = seq.to_base()
    nsc.n_bounces = 3
    assert isinstance(nsc.to_sequential(), trt.SequentialScene)
    p = seq.init_params('cpu')
    p['pp']['grid'] = torch.from_numpy(g)
    probe = interop.rays_from_numpy(
        _np(_probe([0.4, 1.3, -2.2, 3.1], [0.2, -0.8, 1.1, -1.9])), 'cpu')
    o1, s1, _ = seq.simulate_fused(p, probe)
    o2, s2, _ = nsc.simulate_fused(p, probe)
    torch.testing.assert_close(o2.dir, o1.dir, rtol=0, atol=1e-7)
    torch.testing.assert_close(o2.pos, o1.pos, rtol=0, atol=1e-5)
    torch.testing.assert_close(s2.moments, s1.moments, rtol=1e-6, atol=1e-6)
    grads = []
    for sc in (seq, nsc):
        q = {k: dict(v) for k, v in p.items()}
        q['pp']['grid'] = p['pp']['grid'].clone().requires_grad_(True)
        _moment_loss(torch)(sc.simulate_fused(q, probe)[1]).backward()
        grads.append(q['pp']['grid'].grad)
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-7)


@pytest.mark.parametrize('kind', ['sequential', 'scene'])
def test_map_only_gradient_reaches_the_map(kind):
    """Example 28 trains the map alone: neither the table nor the rays
    require grad.  ``simulate_fused`` must still go through its autograd
    Function and give the map the eager trace's gradient (atol 1e-7)."""
    cls, kw = ((trt.SequentialScene, {}) if kind == 'sequential'
               else (trt.Scene, {'n_bounces': 3}))
    sc, g = _steerer(trt, cls, **kw)
    rays = interop.rays_from_numpy(_np(_disk_rays(512)), 'cpu')
    grads = []
    for sim in (sc.simulate_fused, sc.simulate):
        p = sc.init_params('cpu')
        p['pp']['grid'] = torch.from_numpy(g).requires_grad_(True)
        _, s, _ = sim(p, rays)
        _moment_loss(torch)(s).backward()
        grads.append(p['pp']['grid'].grad)
    assert grads[0] is not None and float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-7)


def test_fused_plain_launches_nothing_on_the_cpu():
    """CPU tensors run the plain versions: no kernel counter moves."""
    sc, g = _steerer(trt, trt.SequentialScene)
    p = sc.init_params('cpu')
    p['pp']['grid'] = torch.from_numpy(g).requires_grad_(True)
    rays = interop.rays_from_numpy(_np(_disk_rays(64)), 'cpu')
    fused_trace.LAUNCHES = fused_trace.BWD_LAUNCHES = 0
    fused_nonseq.NONSEQ_LAUNCHES = fused_nonseq.NONSEQ_BWD_LAUNCHES = 0
    phase_grid.CORNER_LAUNCHES = phase_grid.CORNER_BWD_LAUNCHES = 0
    _moment_loss(torch)(sc.simulate_fused(p, rays)[1]).backward()
    _moment_loss(torch)(sc.simulate(p, rays)[1]).backward()
    assert (fused_trace.LAUNCHES, fused_trace.BWD_LAUNCHES,
            phase_grid.CORNER_LAUNCHES,
            phase_grid.CORNER_BWD_LAUNCHES) == (0, 0, 0, 0)


def test_steerer_design_through_fit():
    """tests/test_phase_grid.py::test_grid_gradient_designs_a_steerer on
    the port's ``fit`` (Adam, 600 steps, lr 2) through ``simulate_fused``,
    on the same 2,000 JAX-sampled rays, with that test's ranges: the loss
    under 0.05 and under 2% of its start, the learned mean x-slope over the
    lit pixels within 25% of the steering ramp xt / (L m lam_mm)."""
    L, xt = 50.0, 1.5
    sc = trt.SequentialScene([
        trt.PhaseGridPlate(half_x=HX, half_y=HX, shape=(16, 16), name='pp'),
        trt.SensorElement(radius=20.0, translation=[0, 0, L], name='s')])
    rays = interop.rays_from_numpy(_np(_disk_rays(2000)), 'cpu')

    def loss(p):
        _, sens, _ = sc.simulate_fused(p, rays)
        c = sens.centroid(0)[0]
        rms = sens.spot_rms(0)[0]
        return (c[0] - xt) ** 2 + c[1] ** 2 + rms ** 2

    p, hist = trt.fit(loss, sc.init_params('cpu'), trainable=sc.trainable(),
                      steps=600, lr=2.0)
    assert float(hist[-1]) < 0.05
    assert float(hist[-1]) < 0.02 * float(hist[0])
    grid = p['pp']['grid'].detach().numpy()
    lit = slice(4, 12)
    slope = np.mean(np.diff(grid[lit, lit], axis=1)) / (2 * HX / 15)
    assert slope == pytest.approx(xt / (L * LAM0 * 1e-3), rel=0.25)
    # the table's other leaves did not move
    assert torch.equal(p['pp']['trans'], sc.init_params('cpu')['pp']['trans'])


def test_reference_prng_draws_the_reference_rays():
    """``rays/reference_prng.py`` reproduces ``jax.random``'s keys and
    uniform draws bit for bit, and example 28's 30,000 rays (JAX
    ``CollimatedDisk.sample`` with key 0) to one float32 rounding of the
    cosine and sine (atol 1e-6)."""
    from raytracetorch_tpu_torch.rays import reference_prng as rp
    for seed in (0, 1, 2 ** 32 - 1):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(rp.prng_key(seed),
                                      np.asarray(jax.random.key_data(key)))
        np.testing.assert_array_equal(rp.split(rp.prng_key(seed), 3),
                                      np.asarray(jax.random.split(key, 3)))
        np.testing.assert_array_equal(
            rp.uniform(rp.prng_key(seed), 1000, 0.0, 9.0),
            np.asarray(jax.random.uniform(key, (1000,), minval=0.0,
                                          maxval=9.0)))
    ref = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                  translation=[0, 0, -3.0],
                                  wavelength=LAM0).sample(KEY, 30_000)
    got = rp.collimated_disk(rp.prng_key(0), 30_000, 3.0, (0.0, 0.0, -3.0),
                             LAM0)
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity', 'wavelength'):
        np.testing.assert_allclose(getattr(got, c).numpy(),
                                   np.asarray(getattr(ref, c)), rtol=0,
                                   atol=1e-6, err_msg=c)
    with pytest.raises(ValueError):
        rp.prng_key(-1)
