"""Convex solids, custom shapes and the point source in the PyTorch port
against the JAX package, on the CPU: the tables of ``BoxElement``,
``Box4SideElement`` and ``CvxPolyhedronElement`` (half-space columns
included), the 13 shape builders of elements/shapes.py through
``ElementCustom`` (one with a coating), ``PointSource``'s rays from the
reference's key (rays/reference_prng.py), the JAX package's own scenes of
tests/test_elements.py:232-262, tests/test_cvx_polyhedron.py and
tests/test_custom_elements.py:14-80 traced eagerly and by the fused
traces' plain versions, example 27's lightpipe at 2,000 rays, and the
gradients in a polyhedron's ``offsets`` and a lightpipe's ``width`` and
``height`` against ``jax.grad``.  The plain K1, K2, K5 and K6 against the
JAX kernels in interpret mode: tests/test_torch_solid_kernels.py.

Tolerances, each with its reason: tables rtol 1e-6 / atol 1e-7 (the same
float32 products, XLA perhaps contracting a multiply-add); the point
source's directions atol 2e-7 (numpy's float32 cos, sin and arccos against
XLA's: an ulp); positions atol 1e-7 of the scene's depth and directions
atol 1e-6 where both packages trace the same rays (a float32 coordinate's
rounding there, carried along the path; 4e-6 for the axicon's folded dz,
a cancellation of terms of order 1), and 2e-4 of the depth (8e-3 mm) on
the lightpipe, whose rays start an ulp apart and, the pipe having no caps,
reflect for the whole 50-bounce budget on down the pipe to z ~ 400-1200
mm, where float32 rounds a coordinate to 3-12e-5; moments rtol 1e-5 /
atol 1e-4 of their scale (sums in another order); gradients rtol 1e-4
(float32 adjoints).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.constants import PhysKind
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_OFFSETS, SurfaceTable
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.geom import surfaces as tsurf
from raytracetorch_tpu_torch.geom import transform as ttr
from raytracetorch_tpu_torch.rays import reference_prng as rp

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
BOX_NORMALS = [(0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0),
               (0, 1, 0), (0, -1, 0)]


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(js):
    return interop.params_from_numpy(_np(js.init_params()), 'cpu')


def _rays(pos, d):
    """One ray batch for both packages: (JAX Rays, Rays)."""
    pos, d = np.float32(pos), np.float32(d)
    return (JaxRays.create(jnp.asarray(pos), jnp.asarray(d)),
            trt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d)))


def _disk(n, radius, z0, seed=0, r_min=0.0):
    """Collimated +z rays on a uniform disk (an annulus from ``r_min``)."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(r_min ** 2, radius ** 2, n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, z0)], -1)
    return _rays(pos, np.tile([0.0, 0.0, 1.0], (n, 1)))


def _check_rays(out_t, out_j, depth, pos_atol=1e-7, dir_atol=1e-6):
    for c in COMPS:
        ref = np.asarray(getattr(out_j, c))
        _close(getattr(out_t, c).detach(), ref, rtol=1e-6,
               atol=pos_atol * depth if c[0] == 'p' else dir_atol,
               err_msg=c)


def _check_moments(sens_t, sens_j):
    ref = np.asarray(sens_j.moments)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(sens_t.moments.detach(), ref, rtol=1e-5, atol=1e-4 * scale)


def _both(js, ts, rays_j, rays_t, depth, fused=True, **kw):
    """The eager trace and (``fused``) the fused trace's plain version of
    the port against the JAX package's ``simulate``; returns the port's
    eager (rays, sensors)."""
    out_j, sens_j, _ = js.simulate(js.init_params(), rays_j, KEY)
    pt = _params(js)
    out_t, sens_t = ts.simulate(pt, rays_t)[:2]
    _check_rays(out_t, out_j, depth, **kw)
    _check_moments(sens_t, sens_j)
    if fused:
        out_f, sens_f = ts.simulate_fused(pt, rays_t)[:2]
        _check_rays(out_f, out_j, depth, **kw)
        _check_moments(sens_f, sens_j)
    return out_t, sens_t


# ---- tables ----

def wedge(rt, fresnel=False, **kw):
    """The glass wedge of tests/test_cvx_polyhedron.py:51-77: an entrance
    plane, a face tilted by 0.2 rad and four side planes."""
    sa, ca = math.sin(0.2), math.cos(0.2)
    return rt.CvxPolyhedronElement(
        normals=[(0, 0, -1), (sa, 0, ca), (0, 1, 0), (0, -1, 0), (1, 0, 0),
                 (-1, 0, 0)],
        offsets=[0.0, 2.0, 5.0, 5.0, 8.0, 8.0], ior_glass=1.5,
        fresnel=fresnel, name='wedge', **kw)


SOLIDS = {
    'box': lambda rt: rt.BoxElement(length=2.0, width=3.0, height=4.0,
                                    translation=[0.5, -0.2, 5.0],
                                    rotation=[0.1, -0.2, 0.3], name='b'),
    'box4side': lambda rt: rt.Box4SideElement(
        width=4.0, height=3.0, ph_kind=PhysKind.REFLECT, name='b'),
    'polyhedron': lambda rt: rt.CvxPolyhedronElement(
        [(0, 0, 2), (0, 0, -2), (3, 0, 0), (-3, 0, 0), (0, 1, 0),
         (0, -1, 0), (1, 1, 1)], [2.0, 2.0, 4.5, 4.5, 2.0, 2.0, 3.0],
        name='b', translation=[0.0, 1.0, 5.0]),
    'wedge': lambda rt: wedge(rt, fresnel=True),
}


def _table_pair(js, ts):
    tj = _np(js.build_table(js.init_params()))
    tt = ts.build_table(_params(js))
    assert isinstance(tt, SurfaceTable)
    return tj, tt


def _check_table(tj, tt):
    for name in ('q', 'n_sign', 'Rw', 'tw', 'Rs', 'ts', 'sb', 'vb', 'hp_n',
                 'hp_d', 'ph', 'coat'):
        _close(getattr(tt, name).detach(), getattr(tj, name), rtol=1e-6,
               atol=1e-7, err_msg=name)
    for name in ('sb_kind', 'sb_invert', 'vb_kind', 'hp_mask', 'ph_kind',
                 'is_sensor', 'sensor_slot'):
        assert np.array_equal(getattr(tt, name).numpy(),
                              np.asarray(getattr(tj, name))), name


@pytest.mark.parametrize('case', sorted(SOLIDS))
def test_solid_tables_match_jax(case):
    """Every face's pose, its half-spaces (the other faces, padded to
    MAX_HALFSPACES with the mask off) and its physics equal the JAX
    package's; the static metadata too, and a flat row carries the mask as
    float 0/1."""
    js = jrt.Scene([SOLIDS[case](jrt)])
    ts = trt.Scene([SOLIDS[case](trt)])
    tj, tt = _table_pair(js, ts)
    _check_table(tj, tt)
    assert ts.static_meta() == interop.meta_from_slots(js.static_meta())
    k = tt.n_surfaces
    assert np.array_equal(tt.hp_mask.sum(1).numpy(), [k - 1] * k)
    flat = trt.flatten_table_rows(tt)
    off = ROW_OFFSETS['hp_mask']
    assert torch.equal(flat[:, off:off + 8], tt.hp_mask.float())
    assert js.init_params().keys() == ts.init_params('cpu').keys()
    assert js.trainable() == ts.trainable()


def test_solid_constructors_raise():
    """The polyhedron's ValueErrors (tests/test_cvx_polyhedron.py:
    102-114) and its offsets rescaled for non-unit normals (:36-44)."""
    with pytest.raises(ValueError, match='normals must be'):
        trt.CvxPolyhedronElement([1.0, 0.0, 0.0], [1.0])
    with pytest.raises(ValueError, match='at least 3'):
        trt.CvxPolyhedronElement([(0, 0, 1), (0, 0, -1)], [1.0, 1.0])
    with pytest.raises(ValueError, match='at most'):
        trt.CvxPolyhedronElement([(math.cos(i), math.sin(i), 0.3)
                                  for i in range(11)], [1.0] * 11)
    with pytest.raises(ValueError, match='offsets must match'):
        trt.CvxPolyhedronElement(BOX_NORMALS, [1.0])
    with pytest.raises(ValueError, match='zero-length'):
        trt.CvxPolyhedronElement([(0, 0, 0), (0, 0, -1), (1, 0, 0)],
                                 [1.0, 1.0, 1.0])
    el = trt.CvxPolyhedronElement(
        [(0, 0, 2), (0, 0, -2), (3, 0, 0), (-3, 0, 0), (0, 1, 0),
         (0, -1, 0)], [2.0, 2.0, 4.5, 4.5, 2.0, 2.0], name='b')
    _close(el.init_params('cpu')['offsets'], [1.0, 1.0, 1.5, 1.5, 2.0, 2.0],
           atol=1e-7)


@pytest.mark.parametrize('n', [(0.0, 0.0, 1.0), (0.0, 0.0, -1.0),
                               (0.6, 0.0, 0.8), (0.2, -0.3, 0.9327379)])
def test_rot_vec_to_normal_matches_jax(n):
    from raytracetorch_tpu.elements.solids import _rot_vec_to_normal as jrv
    from raytracetorch_tpu_torch.elements.solids import _rot_vec_to_normal
    n = np.asarray(n) / np.linalg.norm(n)
    assert _rot_vec_to_normal(n) == jrv(n)
    R = ttr.rodrigues(torch.tensor(_rot_vec_to_normal(n),
                                   dtype=torch.float64))
    _close(R[:, 2], n, atol=1e-12)


def test_compose_and_quadrics_match_jax():
    """geom/transform.py::compose and the sphere and cone coefficients."""
    from raytracetorch_tpu.geom import surfaces as jsurf
    from raytracetorch_tpu.geom import transform as jtr
    rng = np.random.default_rng(3)
    rv = rng.normal(size=(2, 3)).astype(np.float32)
    t = rng.normal(size=(2, 3)).astype(np.float32)
    Rj = [jtr.rodrigues(jnp.asarray(v)) for v in rv]
    got = ttr.compose(torch.from_numpy(np.asarray(Rj[0])),
                      torch.from_numpy(t[0]),
                      torch.from_numpy(np.asarray(Rj[1])),
                      torch.from_numpy(t[1]))
    ref = jtr.compose(Rj[0], jnp.asarray(t[0]), Rj[1], jnp.asarray(t[1]))
    for u, v in zip(got, ref):
        _close(u, v, rtol=1e-6, atol=1e-7)
    for jf, tf, v in ((jsurf.q_sphere, tsurf.q_sphere, 2.5),
                      (jsurf.q_cone, tsurf.q_cone, 0.7)):
        qj, sj = jf(jnp.float32(v))
        qt, st = tf(torch.tensor(v))
        assert sj == st
        _close(qt, qj, rtol=0, atol=0)


# ---- custom elements and the shape builders ----

BUILDERS = {
    'plane': {}, 'disk': {'radius': 2.0, 'invert': 1.0},
    'rectangle': {'half_x': 1.5, 'half_y': 0.5},
    'ellipse': {'r_major': 2.0, 'r_minor': 1.0, 'rot': 0.3},
    'sphere': {'radius': 3.0}, 'cylinder': {'radius': 2.0},
    'quadric': {'c': 0.05, 'k': -0.5}, 'half_sphere': {'c': 0.1},
    'quadric_zy': {'c': 0.04, 'k': 0.2}, 'half_cyl': {'c': 0.1},
    'cone': {'slope': 0.5}, 'single_cone': {'slope': 1.0},
}


@pytest.mark.parametrize('name', sorted(BUILDERS))
def test_shape_builders_match_jax(name):
    """Each builder through ``ElementCustom`` (posed, its parameters as
    ``extra``): the table, the static metadata, the parameters and their
    trainability equal the JAX package's."""
    def make(rt, shapes):
        return rt.ElementCustom(getattr(shapes, name), 1, PhysKind.REFLECT,
                                extra=BUILDERS[name],
                                extra_grad={k: True for k in BUILDERS[name]},
                                translation=[0.3, -0.1, 10.0],
                                rotation=[0.05, 0.1, 0.0], name='custom')
    js = jrt.Scene([make(jrt, jshapes)])
    ts = trt.Scene([make(trt, tshapes)])
    _check_table(*_table_pair(js, ts))
    assert ts.static_meta() == interop.meta_from_slots(js.static_meta())
    assert js.trainable() == ts.trainable()


def test_box_face_recs_match_jax():
    """The 13th builder: box_face_recs, a solid's faces as shape parts
    (a rectangular window bounded by four half-spaces)."""
    faces = [('-z', 0.0), ('+x', 1.5), ('-x', 1.5), ('+y', 1.0),
             ('-y', 1.0)]

    def make(rt, mod):
        def shape_fn(p, Re, te):
            rec = mod.box_face_recs(faces, dtype=te.dtype)[0] if rt is jrt \
                else mod.box_face_recs(faces, dtype=te.dtype,
                                       device=te.device)[0]
            rec.Rw, rec.tw, _, _ = mod.compose_world(Re, te, rec.Rs, rec.ts)
            return [rec]
        return rt.ElementCustom(shape_fn, 1, PhysKind.BLOCK,
                                translation=[0, 0, 8.0], name='stop')
    from raytracetorch_tpu.elements import base as jbase
    from raytracetorch_tpu.elements import solids as jsol

    from raytracetorch_tpu_torch.elements import base as tbase
    from raytracetorch_tpu_torch.elements import solids as tsol

    class J:
        box_face_recs = staticmethod(jsol.box_face_recs)
        compose_world = staticmethod(jbase.compose_world)

    class T:
        box_face_recs = staticmethod(tsol.box_face_recs)
        compose_world = staticmethod(tbase.compose_world)
    js, ts = jrt.Scene([make(jrt, J)]), trt.Scene([make(trt, T)])
    _check_table(*_table_pair(js, ts))
    assert ts.static_meta()[0].vb == trt.VBKind.HALFSPACES


def test_custom_element_coating_matches_jax():
    """``coating=`` puts one stack on every face: the coat columns, the
    layer count and extinction, the trainable thicknesses; and the
    constructor's ValueError past MAX_COAT_LAYERS."""
    coat = [(1.38, 0.1), (2.35, 0.2, ), (1.5, 0.01, 0.05)]

    def make(rt, shapes):
        return rt.ElementCustom(shapes.quadric, 1, PhysKind.FRESNEL_W,
                                ph=(1.0, 1.5), extra={'c': 0.02, 'k': 0.0},
                                coating=coat, coating_grad=True, name='c')
    js, ts = jrt.Scene([make(jrt, jshapes)]), trt.Scene([make(trt, tshapes)])
    _check_table(*_table_pair(js, ts))
    assert ts.static_meta() == interop.meta_from_slots(js.static_meta())
    assert ts.trainable()['c']['coat_d'] is True
    assert ts.static_meta()[0].n_coat == 3
    with pytest.raises(ValueError, match='at most'):
        trt.ElementCustom(tshapes.plane, 1, PhysKind.FRESNEL,
                          coating=[(1.38, 0.1)] * 9)
    # a coated custom face traced against the JAX package (a dielectric
    # pair: absorbing films read ~1e-4 apart in float32,
    # tests/test_torch_coated_trace.py holds them in float64)
    coat = coat[:2]
    els = lambda rt, sh: [make(rt, sh), rt.SensorElement(  # noqa: E731
        radius=20.0, translation=[0, 0, 30.0], name='s')]
    js = jrt.SequentialScene(els(jrt, jshapes))
    ts = trt.SequentialScene(els(trt, tshapes))
    _both(js, ts, *_disk(256, 4.0, -5.0, seed=5), depth=30.0)


# ---- the point source ----

@pytest.mark.parametrize('na, translation', [(0.35, (0.9, 0.5, 0.0)),
                                             (0.1, (0.0, 0.0, -3.0))])
def test_point_source_rays_match_jax(na, translation):
    """``reference_prng.point_source`` under key 0 gives the JAX package's
    ``PointSource.sample`` rays: the positions exactly, the directions to
    an ulp (numpy's float32 transcendentals against XLA's)."""
    n = 4096
    rj = jrt.PointSource.make(na=jnp.float32(na),
                              translation=list(translation)).sample(KEY, n)
    rt_ = rp.point_source(rp.prng_key(0), n, na, translation)
    for c in ('px', 'py', 'pz', 'intensity', 'wavelength'):
        assert np.array_equal(getattr(rt_, c).numpy(),
                              np.asarray(getattr(rj, c))), c
    for c in ('dx', 'dy', 'dz'):
        _close(getattr(rt_, c), getattr(rj, c), rtol=0, atol=2e-7)
    # inside the cone of half angle asin(na)
    assert float(rt_.dz.min()) >= math.cos(math.asin(na)) - 1e-6


def test_point_source_generator_draws():
    """The port's ``PointSource`` drawn from a torch.Generator: unit
    directions filling the cone, uniform in solid angle (the mean of cos
    phi is halfway between 1 and cos(asin(na)))."""
    src = trt.PointSource.make(na=0.5, translation=[1.0, 2.0, 3.0])
    rays = src.sample(torch.Generator().manual_seed(0), 200_000, 'cpu')
    assert torch.equal(rays.px, torch.full_like(rays.px, 1.0))
    cos_cap = math.cos(math.asin(0.5))
    assert float(rays.dz.min()) >= cos_cap - 1e-6
    assert abs(float(rays.dz.mean()) - (1 + cos_cap) / 2) < 1e-3
    assert abs(trt.cdf_phi(math.asin(0.5)) - (1 - cos_cap) / 2) < 1e-15


# ---- the JAX package's scenes ----

def test_box_halfspace_bounds_match_jax():
    """tests/test_elements.py:232-248: a ray hits the box's -z face inside
    its extents and stops (BLOCK); one beside the box misses the faces'
    infinite planes."""
    def sc(rt):
        return rt.Scene([rt.BoxElement(length=4.0, width=6.0, height=8.0,
                                       translation=[0.0, 0.0, 10.0],
                                       name='box')], n_bounces=1)
    js, ts = sc(jrt), sc(trt)
    out, _ = _both(js, ts, *_rays([[0, 0, 0], [10, 0, 0]],
                                  [[0, 0, 1], [0, 0, 1]]), depth=10.0)
    _close(out.pos[0], [0.0, 0.0, 8.0], atol=1e-5)
    assert float(out.intensity[0]) == 0.0
    _close(out.pos[1], [10.0, 0.0, 0.0], atol=1e-6)


def test_box4side_open_caps_match_jax():
    """tests/test_elements.py:251-262: an axial ray flies through the
    barrel's open ends, a side ray hits its -x wall."""
    def sc(rt):
        return rt.Scene([rt.Box4SideElement(width=6.0, height=8.0,
                                            translation=[0.0, 0.0, 10.0],
                                            name='barrel')], n_bounces=1)
    out, _ = _both(sc(jrt), sc(trt), *_rays([[0, 0, 0], [-10, 0, 10]],
                                             [[0, 0, 1], [1, 0, 0]]),
                   depth=10.0)
    _close(out.pos[0], [0.0, 0.0, 0.0], atol=1e-6)
    _close(out.pos[1], [-3.0, 0.0, 10.0], atol=1e-5)


def test_polyhedron_box_equivalence_matches_jax():
    """tests/test_cvx_polyhedron.py:19-38: a box stated as six half-spaces
    traces as the BoxElement, in both packages."""
    outs = []
    for make in (lambda rt: rt.BoxElement(length=2.0, width=3.0, height=4.0,
                                          name='b',
                                          translation=[0.0, 0.0, 5.0]),
                 lambda rt: rt.CvxPolyhedronElement(
                     BOX_NORMALS, [1.0, 1.0, 1.5, 1.5, 2.0, 2.0], name='b',
                     translation=[0.0, 0.0, 5.0])):
        js = jrt.Scene([make(jrt)], n_bounces=2)
        ts = trt.Scene([make(trt)], n_bounces=2)
        outs.append(_both(js, ts, *_disk(512, 1.8, 0.0, seed=1),
                          depth=6.0)[0])
    # the polyhedron's faces are posed by other rotations (of their
    # normals) than the box's: positions within 1e-5, as the JAX test
    for c in COMPS[:6]:
        _close(getattr(outs[1], c), getattr(outs[0], c), atol=1e-5,
               err_msg=c)
    assert torch.equal(outs[0].intensity, outs[1].intensity)


@pytest.mark.parametrize('fresnel', [False, True])
def test_wedge_deviation_matches_jax(fresnel):
    """tests/test_cvx_polyhedron.py:51-77: a normal-incidence ray leaves the
    wedge deviated by asin(n sin a) - a, exactly as the JAX package traces
    it; with ``fresnel=True`` the Monte-Carlo branch reads injected draws
    (all 0.5: every branch refracts, R < 0.5), eagerly and in K5's plain
    version."""
    def sc(rt):
        return rt.Scene([wedge(rt, fresnel=fresnel), rt.SensorElement(
            radius=50.0, translation=[0, 0, 30.0], name='s')], n_bounces=4)
    js, ts = sc(jrt), sc(trt)
    rays_j, rays_t = _rays([[0, 0, -5.0]], [[0, 0, 1.0]])
    pt = _params(js)
    if fresnel:
        half = lambda b, k: torch.full((1,), 0.5)  # noqa: E731
        out = ts.simulate(pt, rays_t, draws=half)[0]
        out_f = ts.simulate_fused(pt, rays_t,
                                  generator=torch.Generator())[0]
        assert float(out_f.intensity[0]) in (0.0, 1.0)
    else:
        out, _ = _both(js, ts, rays_j, rays_t, depth=30.0)
    delta = math.asin(1.5 * math.sin(0.2)) - 0.2
    _close(out.dir[0], [-math.sin(delta), 0.0, math.cos(delta)], atol=1e-5)
    assert float(out.intensity[0]) == 1.0


def test_custom_cone_and_sphere_scenes_match_jax():
    """tests/test_custom_elements.py:14-55: the 45-degree axicon (its
    upper nappe, CONE_NAPPE) reflects an axis-parallel ray by 90 degrees
    and skips the lower nappe's hit; the BLOCK sphere stops a ray through
    its center and lets one beside it pass."""
    def cone(rt, sh):
        return rt.Scene([rt.ElementCustom(
            sh.single_cone, 1, PhysKind.REFLECT, extra={'slope': 1.0},
            translation=[0.0, 0.0, 10.0], name='axicon')], n_bounces=1)
    out, _ = _both(cone(jrt, jshapes), cone(trt, tshapes),
                   *_rays([[0, 2.0, 0]], [[0, 0, 1]]), depth=12.0)
    _close(out.pos[0], [0.0, 2.0, 12.0], atol=1e-5)
    _close(out.dir[0], [0.0, 1.0, 0.0], atol=1e-5)

    def ball(rt, sh):
        return rt.Scene([rt.ElementCustom(
            sh.sphere, 1, PhysKind.BLOCK, extra={'radius': 3.0},
            translation=[0.0, 0.0, 20.0], name='ball')], n_bounces=1)
    out, _ = _both(ball(jrt, jshapes), ball(trt, tshapes),
                   *_rays([[0, 0, 0], [0, 5.0, 0]], [[0, 0, 1], [0, 0, 1]]),
                   depth=20.0)
    _close(out.pos[0], [0.0, 0.0, 17.0], atol=1e-5)
    assert out.intensity.tolist() == [0.0, 1.0]


def test_axicon_beam_matches_jax():
    """A collimated beam on the axicon as a 2-bounce Scene: every ray folds
    off the upper nappe into the plane of its hit; the eager trace and K5's
    plain version against the JAX package."""
    def sc(rt, sh):
        return rt.Scene([rt.ElementCustom(
            sh.single_cone, 1, PhysKind.REFLECT, extra={'slope': 1.0},
            translation=[0.0, 0.0, 10.0], name='axicon')], n_bounces=2)
    # an annulus: a ray near the apex takes its normal from the small
    # gradient there, which each package rounds otherwise; the folded dz is
    # the cancellation of terms of order 1, a few ulps of 1 (dir_atol)
    out, _ = _both(sc(jrt, jshapes), sc(trt, tshapes),
                   *_disk(512, 3.0, 0.0, seed=2, r_min=0.5), depth=14.0,
                   dir_atol=4e-6)
    assert float(out.dz.abs().max()) < 1e-5


def test_custom_param_gradient_matches_jax():
    """tests/test_custom_elements.py:58-80: a custom parabolic mirror's
    ``c`` trains (``k`` does not), and its gradient equals ``jax.grad``'s."""
    def sc(rt, sh):
        return rt.Scene([rt.ElementCustom(
            sh.quadric, 1, PhysKind.REFLECT, extra={'c': -0.02, 'k': -1.0},
            extra_grad={'c': True}, translation=[0.0, 0.0, 50.0],
            name='pm')], n_bounces=1)
    js, ts = sc(jrt, jshapes), sc(trt, tshapes)
    assert ts.trainable()['pm'] == {'rot_vec': False, 'trans': False,
                                    'c': True, 'k': False}
    rays_j, rays_t = _rays([[0, 3.0, 0]], [[0, 0, 1]])
    g = jax.grad(lambda p: js.simulate(p, rays_j, KEY)[0].dir[0, 1] ** 2)(
        js.init_params())['pm']['c']
    pt = _params(js)
    pt['pm']['c'].requires_grad_(True)
    (ts.simulate(pt, rays_t)[0].dy[0] ** 2).backward()
    assert float(g) != 0.0
    _close(pt['pm']['c'].grad, g, rtol=1e-4)


# ---- example 27 ----

def lightpipe(rt, with_pipe=True, length=40.0, n_bounces=50, grad=False):
    """examples/27_lightpipe_homogenizer.py's scene: a 4 x 4 mirrored
    Box4Side pipe and the exit sensor at ``length``, a 64^2 grid over the
    exit."""
    els = ([rt.Box4SideElement(width=4.0, height=4.0,
                               ph_kind=PhysKind.REFLECT, w_grad=grad,
                               h_grad=grad, name='pipe')]
           if with_pipe else [])
    els.append(rt.SensorElement(half_x=2.0, half_y=2.0,
                                translation=[0, 0, length], name='exit'))
    sc = rt.Scene(els, n_bounces=n_bounces)
    sc.grid_shape = (64, 64)
    sc.grid_half_extent = 2.0
    return sc


def _source(n):
    rj = jrt.PointSource.make(na=jnp.float32(0.35),
                              translation=[0.9, 0.5, 0.0]).sample(KEY, n)
    return rj, rp.point_source(rp.prng_key(0), n, 0.35, (0.9, 0.5, 0.0))


@pytest.mark.parametrize('with_pipe', [True, False])
def test_lightpipe_matches_jax(with_pipe):
    """Example 27 at 2,000 rays of key 0: the eager bounce loop and K5's
    plain version against the JAX package (rays, moments, the exit grid
    but for at most 2 rays' bins); the pipe keeps every ray."""
    js, ts = lightpipe(jrt, with_pipe), lightpipe(trt, with_pipe)
    rays_j, rays_t = _source(2000)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays_j, KEY)
    pt = _params(js)
    for sim in (ts.simulate, ts.simulate_fused):
        out_t, sens_t = sim(pt, rays_t)[:2]
        _check_rays(out_t, out_j, 40.0, pos_atol=2e-4)
        _check_moments(sens_t, sens_j)
        # a ray an ulp apart may land in the next bin: at most 2 such
        assert float((sens_t.grid - torch.from_numpy(
            np.asarray(sens_j.grid))).abs().sum()) <= 4.0
    flux = float(sens_t.moments[0, 0, 0])
    assert (flux > 0.999 * 2000) == with_pipe


def test_lightpipe_width_gradient_matches_jax():
    """The lightpipe's exit spot RMS (from the moments) in its ``width`` and
    ``height``, 1,000 rays, a 20 mm pipe and 12 bounces: the eager trace
    and FusedNonseq (K5's and K6's plain versions) against ``jax.grad``
    through the JAX bounce loop."""
    js = lightpipe(jrt, length=20.0, n_bounces=12, grad=True)
    ts = lightpipe(trt, length=20.0, n_bounces=12, grad=True)
    rays_j, _ = _source(1000)
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    g = jax.grad(lambda p: js.simulate(p, rays_j, KEY)[1].spot_rms(0)[0])(
        js.init_params())['pipe']
    for sim in (ts.simulate, ts.simulate_fused):
        pt = _params(js)
        for leaf in ('width', 'height'):
            pt['pipe'][leaf].requires_grad_(True)
        sim(pt, rays_t)[1].spot_rms(0)[0].backward()
        for leaf in ('width', 'height'):
            assert abs(float(g[leaf])) > 1e-3
            _close(pt['pipe'][leaf].grad, g[leaf], rtol=1e-4, err_msg=leaf)


def _ordered_wedge(rt):
    """The wedge before a sensor, entrance face first: a sequential scene
    and, as 4 bounces, a Scene that traces the same chain (no ray meets a
    side face or reflects)."""
    sa, ca = math.sin(0.2), math.cos(0.2)
    el = rt.CvxPolyhedronElement(
        normals=[(0, 0, -1), (sa, 0, ca), (0, 1, 0), (0, -1, 0), (1, 0, 0),
                 (-1, 0, 0)],
        offsets=[0.0, 2.0, 5.0, 5.0, 8.0, 8.0], ior_glass=1.5,
        offsets_grad=True, ior_glass_grad=True, name='wedge')
    return [el, rt.SensorElement(radius=50.0, translation=[0, 0, 30.0],
                                 name='s')]


def test_polyhedron_offsets_gradient_matches_jax():
    """The spot RMS behind the wedge in its ``offsets`` and ``ior_glass``:
    the port's sequential trace (eager and FusedTrace: K1's and K2's plain
    versions) and its Scene (eager and FusedNonseq: K5's and K6's) against
    ``jax.grad`` of the JAX package's sequential trace (the tilted face's
    offset moves the spot; the bounds' offsets have no derivative, as in
    the JAX package)."""
    rays_j, rays_t = _disk(512, 3.0, -5.0, seed=4)
    js = jrt.SequentialScene(_ordered_wedge(jrt))

    def loss_j(p):
        s = js.simulate(p, rays_j, KEY)[1]
        return s.spot_rms(0)[0] + s.centroid(0)[0][0]
    g = jax.grad(loss_j)(js.init_params())['wedge']
    assert abs(float(g['offsets'][1])) > 1e-3
    scenes = (trt.SequentialScene(_ordered_wedge(trt)),
              trt.Scene(_ordered_wedge(trt), n_bounces=4))
    for ts in scenes:
        for sim in (ts.simulate, ts.simulate_fused):
            pt = _params(js)
            for leaf in ('offsets', 'ior_glass'):
                pt['wedge'][leaf].requires_grad_(True)
            s = sim(pt, rays_t)[1]
            (s.spot_rms(0)[0] + s.centroid(0)[0][0]).backward()
            for leaf in ('offsets', 'ior_glass'):
                _close(pt['wedge'][leaf].grad, g[leaf], rtol=1e-4,
                       atol=1e-6, err_msg=leaf)
