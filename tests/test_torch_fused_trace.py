"""The fused forward trace of the PyTorch port (ops/fused_trace.py).

On the CPU its dispatcher runs the plain version, which must match the JAX
package's fused kernel ``trace_sequential_pallas_v2`` (run in interpret
mode, as tests/test_pallas.py runs it) on the same table and rays, with
tests/test_pallas.py's bounds: positions atol 1e-5, intensity atol 1e-6,
moments rtol 1e-5 atol 1e-3.  The CUDA kernel itself is compared with the
plain version on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu import ElementCustom
from raytracetorch_tpu.constants import PhysKind
from raytracetorch_tpu.elements import shapes
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas,
                                               trace_sequential_pallas_v2)
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.ops import fused_trace

torch.set_num_threads(2)

N = 2999


def _bench():
    return jrt.SequentialScene([
        jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        name='lens'),
        jrt.CircularAperture(radius=5.0, name='stop'),
        jrt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                          name='sensor'),
    ])


def _two_bundle():
    """Two sensors, two bundles: a tilted mirror disk (REFLECT) and an
    off-axis absorbing disk (BLOCK) ahead of a singlet and an inverted
    iris."""
    return jrt.SequentialScene([
        ElementCustom(shapes.disk, 1, PhysKind.REFLECT,
                      extra={'radius': 1.0}, rotation=[0.3, 0.0, 0.0],
                      name='mirror'),
        ElementCustom(shapes.disk, 1, PhysKind.BLOCK, extra={'radius': 0.5},
                      translation=[2.0, 0.0, 4.0], name='block'),
        jrt.SensorElement(radius=20.0, translation=[0, 0, 6.0], name='s0'),
        jrt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        translation=[0, 0, 9.0], name='lens'),
        jrt.CircularAperture(radius=3.0, invert=True,
                             translation=[0, 0, 14.0], name='iris'),
        jrt.SensorElement(radius=20.0, translation=[0, 0, 30.0], name='s1'),
    ])


def _rays(n, n_bundles, seed):
    key = jax.random.PRNGKey(seed)
    if n_bundles == 1:
        return jrt.CollimatedDisk.make(
            radius=jnp.float32(4.0),
            translation=[0, 0, -10.0]).sample(key, n)
    k0, k1 = jax.random.split(key)
    a = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                translation=[0, 0, -10.0],
                                ray_id=0).sample(k0, n // 2)
    b = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                translation=[0.5, 0, -10.0],
                                rotation=[0.05, 0.0, 0.0],
                                ray_id=1).sample(k1, n - n // 2)
    return jrt.Rays.concatenate([a, b])


def _port_inputs(scene, rays, n_bundles):
    """The JAX scene's table, kinds and rays, carried over through numpy."""
    to_np = jax.tree_util.tree_map
    table = interop.table_from_numpy(
        to_np(np.asarray, scene.build_table(scene.init_params())), 'cpu')
    meta = interop.meta_from_slots(scene.static_meta())
    cfg = trt.SensorConfig(n_sensors=scene.n_sensors, n_bundles=n_bundles)
    return table, interop.rays_from_numpy(to_np(np.asarray, rays),
                                          'cpu'), cfg, meta


@pytest.mark.parametrize('case', ['bench', 'two_bundle'])
def test_plain_matches_jax_kernel(case):
    scene, nb = (_bench(), 1) if case == 'bench' else (_two_bundle(), 2)
    rays = _rays(N, nb, seed=nb)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        scene.build_table(scene.init_params()), rays, jax.random.PRNGKey(0),
        scene.sensor_config(n_bundles=nb), scene.static_meta(),
        interpret=True, block_rows=4)
    table, rays_t, cfg, meta = _port_inputs(scene, rays, nb)
    fused_trace.LAUNCHES = 0
    out_t, sens_t = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert fused_trace.LAUNCHES == 0        # CPU tensors: plain version
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.dir.numpy(), np.asarray(out_j.dir),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.intensity.numpy(),
                               np.asarray(out_j.intensity), atol=1e-6)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)
    if case == 'two_bundle':
        # every row kind did work: reflections, absorptions, both sensors
        # saw both bundles
        assert (out_t.dz.numpy() < 0).sum() > 0
        assert (out_t.intensity.numpy() == 0).sum() > 0
        assert (sens_t.moments[:, :, 0].numpy() > 0).all()


def test_plain_matches_eager_trace():
    """The plain version over the flat rows equals the eager trace over
    the table (same formulas, another row layout)."""
    scene = _two_bundle()
    table, rays, cfg, meta = _port_inputs(scene, _rays(N, 2, seed=4), 2)
    out_f, sens_f = trt.trace_sequential_fused(table, rays, cfg, meta)
    out_e, sens_e, _ = trt.trace_sequential(table, rays, cfg, meta)
    for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'):
        torch.testing.assert_close(getattr(out_f, c), getattr(out_e, c),
                                   rtol=0, atol=0)
    torch.testing.assert_close(sens_f.moments, sens_e.moments, rtol=1e-6,
                               atol=1e-4)


def _scatter_scene():
    # a SCATTER row: the Fresnel kinds are ported, scattering is not
    return jrt.SequentialScene([
        ElementCustom(shapes.plane, 1, PhysKind.SCATTER, ph=(1.5, 1.0),
                      name='iface'),
        jrt.SensorElement(radius=50.0, translation=[0, 0, 25.0],
                          name='sensor')])


def _jones_scene():
    # a JONES row: the polarization field is not ported (freeform faces,
    # refused here before, trace now: tests/test_torch_freeform.py)
    return jrt.SequentialScene([
        ElementCustom(shapes.plane, 1, PhysKind.JONES, ph=(0.0, 0.0),
                      name='plate'),
        jrt.SensorElement(radius=50.0, translation=[0, 0, 25.0],
                          name='sensor')])


def _rect_scene():
    # a rectangular (RECT-bound) microlens array: the bound and the MLA
    # physics are ported
    return jrt.SequentialScene([
        jrt.MicrolensArray(half_x=2.0, half_y=1.0, pitch=0.5, f=10.0,
                           name='mla'),
        jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                          name='sensor')])


def _ellipse_scene():
    return jrt.SequentialScene([
        jrt.EllipticAperture(r_major=2.0, r_minor=1.0, name='ellipse'),
        jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                          name='sensor')])


def _grin_scene():
    # a GRIN rod: it traces (tests/test_torch_grin.py), under the polarized
    # field too (tests/test_torch_grin_field.py)
    return jrt.SequentialScene([
        jrt.GrinRod(radius=5.0, thickness=10.0, n_steps=8,
                    translation=[0, 0, 5.0], name='grin'),
        jrt.SensorElement(radius=50.0, translation=[0, 0, 25.0],
                          name='sensor')])


def _box_scene():
    # a box with SCATTER faces: its HALFSPACES bound is ported
    # (tests/test_torch_solids.py), scattering is not
    return jrt.SequentialScene([
        jrt.BoxElement(length=4.0, width=6.0, height=8.0,
                       ph_kind=PhysKind.SCATTER,
                       translation=[0.0, 0.0, 10.0], name='box'),
        jrt.SensorElement(radius=50.0, translation=[0, 0, 25.0],
                          name='sensor')])


@pytest.mark.parametrize('make', [_scatter_scene, _jones_scene,
                                  _grin_scene, _box_scene])
def test_dispatcher_raises_on_unsupported_rows(make):
    """Rows the fused trace does not take raise NotImplementedError naming
    their ROADMAP item; a JONES row (ported with the polarized field) raises
    naming the field it needs when the trace carries none; a GRIN rod
    traces, and under the polarized field the fused trace equals the eager
    one, rays and field."""
    scene = make()
    table, rays, cfg, meta = _port_inputs(scene, _rays(64, 1, seed=0), 1)
    if make is _grin_scene:
        out, _ = trt.trace_sequential_fused(table, rays, cfg, meta)
        assert bool(torch.isfinite(out.px).all())
        assert float((out.intensity > 0).float().mean()) > 0.5
        out_f, _, aux_f = trt.trace_sequential_fused(table, rays, cfg, meta,
                                                     track_field=True)
        out_e, _, aux_e = trt.trace_sequential(table, rays, cfg, meta,
                                               track_field=True)
        for c in ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity'):
            torch.testing.assert_close(getattr(out_f, c), getattr(out_e, c),
                                       rtol=0, atol=1e-5)
        torch.testing.assert_close(aux_f['field_power'],
                                   aux_e['field_power'], rtol=0, atol=1e-6)
        return
    why = 'track_field' if make is _jones_scene else 'ROADMAP'
    with pytest.raises(NotImplementedError, match=why):
        trt.trace_sequential_fused(table, rays, cfg, meta)


@pytest.mark.parametrize('make', [_rect_scene, _ellipse_scene])
def test_dispatcher_traces_diffractive_rows(make):
    """The MLA physics and the ELLIPSE bound, refused before, trace through
    the dispatcher (the plain version here) as the JAX package's trace
    does."""
    scene = make()
    rays = _rays(N, 1, seed=3)
    out_j, sens_j, _ = scene.simulate(scene.init_params(), rays,
                                      jax.random.PRNGKey(0))
    table, rays_t, cfg, meta = _port_inputs(scene, rays, 1)
    out_t, sens_t = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    assert fused_trace.diffractive_kinds(meta)
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.dir.numpy(), np.asarray(out_j.dir),
                               atol=1e-5)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)


def test_rect_bound_rows_trace():
    """The RECT surface bound (a phase plate's aperture) is ported: an
    inverted rectangular stop's row traces through the dispatcher and
    matches the JAX package's fused kernel, with the bounds of
    test_plain_matches_jax_kernel; it passes the rays inside the rectangle
    and blocks the others."""
    scene = jrt.SequentialScene([
        jrt.RectangularAperture(half_x=2.0, half_y=1.0, invert=True,
                                name='rect'),
        jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                          name='sensor')])
    rays = _rays(N, 1, seed=5)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        scene.build_table(scene.init_params()), rays, jax.random.PRNGKey(0),
        scene.sensor_config(), scene.static_meta(), interpret=True,
        block_rows=4)
    table, rays_t, cfg, meta = _port_inputs(scene, rays, 1)
    out_t, sens_t = trt.trace_sequential_fused(table, rays_t, cfg, meta)
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.intensity.numpy(),
                               np.asarray(out_j.intensity), atol=1e-6)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)
    passed = np.asarray(out_j.intensity) > 0
    assert 0 < passed.sum() < N


def test_plate_code_only_for_plate_kinds():
    """``plate_maps`` selects the kernels' instantiation with plate code
    (anything but None) exactly for scenes with a PHASE_GRID row, a RECT
    bound or an extended kind: None for the bench scene, () for a
    rectangular stop or sensor, the map for a plate.  ``ext_kinds`` selects
    the instantiation with the extended kinds exactly for scenes with an
    asphere, a rectangular volume bound or a cylindrical lens's edge: the
    suite's mixed-surface and asphere scenes (() for their maps), not a
    scene whose only new kind is the RECT surface bound."""
    def meta_of(scene):
        return _port_inputs(scene, _rays(8, 1, seed=0), 1)[3]
    bench = meta_of(_bench())
    assert fused_trace.plate_maps(bench, None) is None
    assert not fused_trace.ext_kinds(bench)
    for rect in (jrt.RectangularAperture(half_x=2.0, half_y=1.0,
                                         name='rect'),
                 jrt.SensorElement(half_x=2.0, half_y=1.0,
                                   translation=[0, 0, 5.0], name='rect')):
        meta = meta_of(jrt.SequentialScene([
            rect, jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                                    name='sensor')]))
        assert fused_trace.plate_maps(meta, None) == ()
        assert not fused_trace.ext_kinds(meta)
    plate = jrt.SequentialScene([
        jrt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(8, 8), name='pp'),
        jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                          name='sensor')])
    grid = torch.zeros(8, 8)
    assert fused_trace.plate_maps(meta_of(plate), {0: grid})[0] is grid
    assert not fused_trace.ext_kinds(meta_of(plate))
    with pytest.raises(ValueError, match='no phase map'):
        fused_trace.plate_maps(meta_of(plate), None)
    for scene in (chip_smoke.mixed_scene(jrt), chip_smoke.asphere_scene(jrt),
                  chip_smoke.mixed_scene(jrt, 12)):
        meta = meta_of(scene)
        assert fused_trace.ext_kinds(meta)
        assert fused_trace.plate_maps(meta, None) == ()


def test_v1_matches_jax_first_kernel():
    """K0's counterpart ``trace_sequential_v1`` (the chain with every stream
    off) against the JAX package's ``trace_sequential_pallas`` in interpret
    mode on the bench scene, with tests/test_pallas.py::
    test_pallas_matches_xla's bounds: positions atol 1e-5, directions and
    intensity atol 1e-6, moments rtol 1e-5 atol 1e-3.  CPU tensors run the
    plain version (no launch)."""
    scene = _bench()
    rays = _rays(3000, 1, seed=0)
    out_j, sens_j, _ = trace_sequential_pallas(
        scene.build_table(scene.init_params()), rays, jax.random.PRNGKey(0),
        scene.sensor_config(), scene.static_meta(), interpret=True)
    table, rays_t, cfg, meta = _port_inputs(scene, rays, 1)
    fused_trace.V1_LAUNCHES = 0
    out_t, sens_t, aux = trt.trace_sequential_v1(table, rays_t, cfg, meta)
    assert fused_trace.V1_LAUNCHES == 0 and aux == {}
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.dir.numpy(), np.asarray(out_j.dir),
                               atol=1e-6)
    np.testing.assert_allclose(out_t.intensity.numpy(),
                               np.asarray(out_j.intensity), atol=1e-6)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)


def test_v1_keeps_the_first_kernels_contract():
    """Like ``trace_sequential_pallas`` it refuses an irradiance grid and
    phase-grid rows (and, through the dispatcher, more than 8 slots)."""
    table, rays_t, cfg, meta = _port_inputs(_bench(), _rays(64, 1, seed=0),
                                            1)
    grid_cfg = trt.SensorConfig(n_sensors=1, grid_shape=(8, 8),
                                grid_half_extent=1.0)
    with pytest.raises(ValueError, match='grid'):
        trt.trace_sequential_v1(table, rays_t, grid_cfg, meta)
    plate = jrt.SequentialScene([
        jrt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(8, 8), name='pp'),
        jrt.SensorElement(radius=10.0, translation=[0, 0, 25.0],
                          name='sensor')])
    table, rays_t, cfg, meta = _port_inputs(plate, _rays(64, 1, seed=0), 1)
    with pytest.raises(ValueError, match='phase-grid'):
        trt.trace_sequential_v1(table, rays_t, cfg, meta)


def test_kernel_limits_raise():
    table, rays, cfg, meta = _port_inputs(_bench(), _rays(64, 1, seed=0), 1)
    with pytest.raises(NotImplementedError, match='bundles'):
        trt.trace_sequential_fused(table, rays,
                                   trt.SensorConfig(1, n_bundles=19), meta)
    with pytest.raises(ValueError, match='CUDA'):
        fused_trace.trace_seq_fwd_cuda(
            trt.flatten_table_rows(table),
            torch.tensor(fused_trace.kind_rows(meta, cfg), dtype=torch.int32),
            rays, cfg)


def test_kind_rows_of_bench_scene():
    """The int rows the kernel reads: ph, sb, vb, plane, sensor, slot,
    invert, pad (kinds as in the row table of the bench scene)."""
    scene = trt.SequentialScene([
        trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        name='lens'),
        trt.CircularAperture(radius=5.0, name='stop'),
        trt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                          name='sensor')])
    assert fused_trace.kind_rows(scene.static_meta(),
                                 scene.sensor_config()) == [
        [3, 4, 1, 0, 0, 0, 0, 0], [3, 4, 1, 0, 0, 0, 0, 0],
        [3, 0, 2, 0, 0, 0, 0, 0], [6, 1, 0, 1, 0, 0, 0, 0],
        [0, 1, 0, 1, 1, 0, 0, 0]]
