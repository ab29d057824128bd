"""Parity of the PyTorch port's scene compilation with the JAX package:
surface tables, static row kinds, the kernel's flat rows, paraxial optics,
parameter interop.  Tables are compared at atol 1e-6 (float32 rounding of
rotations built by different sin/cos libraries)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import (
    flatten_table_rows as jax_flatten)
from raytracetorch_tpu_torch import interop

torch.set_num_threads(2)


def _bench(rt):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.CircularAperture(radius=5.0, name='stop'),
        rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                         name='sensor'),
    ])


def _tilted(rt):
    """Decentred, tilted meniscus; inverted curved stop; unbounded sensor;
    a second disk sensor."""
    return rt.SequentialScene([
        rt.SingletLens(c1=0.04, c2=0.01, d=12.0, t=4.0, ior_glass=1.62,
                       ior_media=1.01, rotation=[0.02, -0.03, 0.1],
                       translation=[0.3, -0.2, 1.0], name='meniscus'),
        rt.CircularAperture(radius=3.0, invert=True, curvature=-0.02,
                            translation=[0, 0, 9.0], name='iris'),
        rt.SensorElement(translation=[0, 0, 20.0], name='s0'),
        rt.SensorElement(radius=4.0, rotation=[0.0, 0.1, 0.0],
                         translation=[0, 0.5, 30.0], name='s1'),
    ])


SCENES = {'bench': _bench, 'tilted': _tilted}


@pytest.mark.parametrize('name', sorted(SCENES))
def test_build_table_matches_jax(name):
    js, ts = SCENES[name](jrt), SCENES[name](trt)
    tj = js.build_table(js.init_params())
    tt = ts.build_table(ts.init_params('cpu'))
    for f in dataclasses.fields(trt.SurfaceTable):
        a, b = getattr(tt, f.name).numpy(), np.asarray(getattr(tj, f.name))
        assert a.shape == b.shape, f.name
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_static_meta_matches_jax(name):
    jm, tm = SCENES[name](jrt).static_meta(), SCENES[name](trt).static_meta()
    assert len(jm) == len(tm)
    for a, b in zip(tm, jm):
        for slot in trt.StaticRowMeta.__slots__:
            assert getattr(a, slot) == getattr(b, slot), slot
    assert interop.meta_from_slots(jm) == tm


@pytest.mark.parametrize('name', sorted(SCENES))
def test_flat_rows_match_jax(name):
    js, ts = SCENES[name](jrt), SCENES[name](trt)
    fj = np.asarray(jax_flatten(js.build_table(js.init_params())))
    ft = trt.flatten_table_rows(ts.build_table(ts.init_params('cpu')))
    assert ft.shape == fj.shape == (len(ts.static_meta()), 160)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-6)


@pytest.mark.parametrize('name', sorted(SCENES))
def test_paraxial_matches_jax(name):
    js, ts = SCENES[name](jrt), SCENES[name](trt)
    mj = np.asarray(js.paraxial(js.init_params()))
    mt = ts.paraxial(ts.init_params('cpu')).numpy()
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6)


def test_bench_focal_length():
    """f = 20.513 for the bench singlet (the JAX package's anchor)."""
    ts = _bench(trt)
    m = ts.paraxial(ts.init_params('cpu'))
    assert abs(float(-1.0 / m[1, 0]) - 20.513) < 1e-3
    assert abs(float(-1.0 / trt.SequentialScene(ts.elements[:1]).paraxial(
        ts.init_params('cpu'))[1, 0]) - 20.513) < 1e-3


def test_focal_length_loss_matches_jax():
    js, ts = _bench(jrt), _bench(trt)
    lj = float(jrt.focal_length_loss(js, js.init_params(), 25.0))
    lt = float(trt.focal_length_loss(ts, ts.init_params('cpu'), 25.0))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_duplicate_names_raise():
    ts = trt.SequentialScene([
        trt.CircularAperture(radius=5.0, name='x'),
        trt.SensorElement(radius=6.0, translation=[0, 0, 19.0], name='x')])
    with pytest.raises(ValueError, match='duplicate element name'):
        ts.init_params('cpu')


def test_params_from_numpy_round_trip():
    """JAX params -> numpy -> port params give the port's own params and
    the same table; back to numpy they are unchanged."""
    js, ts = _tilted(jrt), _tilted(trt)
    pj = jax.tree_util.tree_map(np.asarray, js.init_params())
    pt = interop.params_from_numpy(pj, 'cpu')
    back = jax.tree_util.tree_map(lambda t: t.numpy(), pt)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(pj)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, b)
    own = ts.init_params('cpu')
    for el in own:
        for k in own[el]:
            torch.testing.assert_close(pt[el][k], own[el][k], rtol=0,
                                       atol=0)
    np.testing.assert_array_equal(
        trt.flatten_table_rows(ts.build_table(pt)).numpy(),
        trt.flatten_table_rows(ts.build_table(own)).numpy())


def test_table_from_numpy_round_trip():
    js = _bench(jrt)
    tj = jax.tree_util.tree_map(np.asarray, js.build_table(js.init_params()))
    tt = interop.table_from_numpy(tj, 'cpu')
    for f in dataclasses.fields(trt.SurfaceTable):
        np.testing.assert_array_equal(getattr(tt, f.name).numpy(),
                                      getattr(tj, f.name))


def test_unsupported_elements_raise():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        fresnel=True)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        abbe_vd=64.2)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        trt.SensorElement(half_x=1.0, half_y=1.0)
    with pytest.raises(ValueError, match='larger than D/2'):
        trt.SingletLens(c1=0.5, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5)
