"""Freeform, Zernike and wedge lenses in the PyTorch port against the JAX
package, on the CPU: the exact Zernike monomial map, the freeform sag,
refinement and normal, the eager traces and the fused traces' plain
versions (K1's and K5's functions) of example 19's freeform corrector,
example 20's Zernike corrector (with ``track_opl``) and example 26's
Shack-Hartmann sensor, a freeform ``Scene``, gradients in ``xy1``, ``z1``,
``k`` and ``a`` against ``jax.grad``, a freeform lens with no terms against
the asphere, a Zernike lens against its freeform, the wedge's deviation and
the constructors' ValueErrors.  The plain K1/K2 against the JAX kernels in
interpret mode, and K5/K6's against the JAX bounce loop:
tests/test_torch_freeform_kernels.py.

The same rays go to both packages, made with numpy from a seed.
Tolerances, each with its reason: positions rtol 1e-6 / atol 1e-7 of the
scene's depth (the farthest element's z: a float32 coordinate's rounding
there, carried along the path) and directions atol 1e-6 (float32 Newton
steps in another fusion: both converge to the root within rounding),
intensities atol 1e-6;
path lengths an ulp of the largest a row (a running float32 sum of one
segment a row, whose length and sum each package rounds once, XLA perhaps
contracting a multiply-add that torch rounds twice);
moments rtol 1e-5 / atol 1e-4 of their scale (sums in another order);
gradients rtol 1e-4 (float32 adjoints).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.geom import surfaces as jsurf
from raytracetorch_tpu.geom import zernike as jzern
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.geom import surfaces as tsurf
from raytracetorch_tpu_torch.geom import zernike as tzern
from raytracetorch_tpu_torch.ops import fused_trace

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- scenes: (rt, base=False) -> scene ----

THETA = math.radians(8.0)
# example 19's terms, with coefficients near its design's
EX19_TERMS = [(2, 0, 2.0e-4), (0, 2, -2.2e-4), (2, 1, 1.0e-6),
              (0, 3, -1.5e-6), (1, 1, 1.0e-5)]


def ex19(rt, base=False, n_bounces=6, grad=False):
    """examples/19_freeform_corrector.py's scene: a freeform window before
    a spherical mirror tilted by 8 degrees, the sensor at the medial
    focus."""
    d_beam = np.array([0.0, np.sin(2 * THETA), -np.cos(2 * THETA)])
    sens = np.array([0, 0, 50.0]) + 50.0 * d_beam
    els = [rt.FreeformLens(c1=0.0, c2=0.0, d=24.0, t=2.0, ior_glass=1.5168,
                           translation=[0, 0, 20.0], xy1=EX19_TERMS,
                           xy1_grad=grad, name='corrector'),
           rt.SphericalMirror(c1=-1.0 / 100.0, d=30.0,
                              translation=[0, 0, 50.0],
                              rotation=[THETA, 0, 0], name='mirror'),
           rt.SensorElement(radius=6.0, translation=list(sens),
                            rotation=[np.pi - 2 * THETA, 0, 0],
                            name='sensor')]
    return (rt.Scene(els, n_bounces=n_bounces) if base
            else rt.SequentialScene(els))


N_GLASS = 1.5168
# example 20's terms (Noll 4..11), sag amplitudes of its prescription's size
EX20_TERMS = [(4, 2.0e-4), (5, -3.0e-5), (6, 4.0e-5), (7, 1.5e-5),
              (8, -2.0e-5), (9, 5.0e-6), (10, -4.0e-6), (11, 6.0e-5)]


def ex20(rt, base=False, grad=False, c1=0.0, k1=0.0, a1=()):
    """examples/20_zernike_corrector.py's scene: a Zernike plate before the
    tilted plano-convex singlet (the plate's base curved by ``c1``, ``k1``
    and ``a1`` for the gradient tests)."""
    els = [rt.ZernikeLens(c1=c1, c2=0.0, d=13.2, t=2.0, ior_glass=N_GLASS,
                          z1=EX20_TERMS, z1_grad=grad, norm_radius=6.0,
                          k1=k1, a1=a1, translation=[0, 0, -5.0],
                          name='corrector'),
           rt.SingletLens(c1=0.0, c2=-1.0 / (50.0 * (N_GLASS - 1.0)), d=16.0,
                          t=3.0, ior_glass=N_GLASS, rotation=[0.03, 0.0, 0.0],
                          name='lens'),
           rt.SensorElement(radius=10.0, translation=[0, 0, 52.0],
                            name='sensor')]
    return (rt.Scene(els, n_bounces=6) if base
            else rt.SequentialScene(els))


def ex26(rt, base=False):
    """examples/26_shack_hartmann.py's sensor: a Zernike plate with a hidden
    astigmatism and coma, the microlens array and the detector."""
    els = [rt.ZernikeLens(c1=0.0, c2=0.0, d=10.0, t=1.0, ior_glass=1.5,
                          z1=[(6, 4e-4), (8, 3e-4)], norm_radius=4.0,
                          name='plate'),
           rt.MicrolensArray(half_x=4.0, half_y=4.0, pitch=0.8, f=25.0,
                             translation=[0, 0, 4.0], name='mla'),
           rt.SensorElement(radius=8.0, translation=[0, 0, 29.0], name='det')]
    return (rt.Scene(els, n_bounces=5) if base
            else rt.SequentialScene(els))


# case -> (scene, ray disk radius, launch z, depth)
SCENES = {'ex19': (ex19, 8.0, -10.0, 50.0), 'ex20': (ex20, 6.0, -10.0, 52.0),
          'ex26': (ex26, 3.2, -5.0, 29.0)}


def _disk(n, radius, z0, seed=0):
    """Collimated rays on a uniform disk, from numpy: (JAX Rays, Rays)."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.random(n))
    th = 2 * np.pi * rng.random(n)
    pos = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, z0)],
                   -1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    return (JaxRays.create(jnp.asarray(pos), jnp.asarray(d)),
            trt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d)))


def _pair(case, n=1024, seed=0, **kw):
    make, radius, z0, _ = SCENES[case]
    js, ts = make(jrt, **kw), make(trt, **kw)
    rays_j, rays_t = _disk(n, radius, z0, seed)
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    return js, ts, rays_j, rays_t, pt


def _check_rays(out_t, out_j, case):
    depth = SCENES[case][3]
    for c in COMPS:
        ref = np.asarray(getattr(out_j, c))
        _close(getattr(out_t, c).detach(), ref, rtol=1e-6,
               atol=1e-7 * depth if c[0] == 'p' else 1e-6, err_msg=c)


def _check_moments(sens_t, sens_j):
    ref = np.asarray(sens_j.moments)
    scale = max(1.0, float(np.abs(ref).max()))
    _close(sens_t.moments.detach(), ref, rtol=1e-5, atol=1e-4 * scale)


# ---- the Zernike expansion ----

@pytest.mark.parametrize('j', range(2, 37))
def test_zernike_xy_poly_matches_jax(j):
    """The exact rational expansion of every Noll term up to j = 36 equals
    the JAX package's, key by key."""
    assert tzern.zernike_xy_poly(*tzern.noll_nm(j)) == \
        jzern.zernike_xy_poly(*jzern.noll_nm(j))


@pytest.mark.parametrize('indices, radius', [
    ((4, 5, 6), 6.0), ((6, 8), 4.0), (tuple(range(4, 29)), 6.0),
    ((2, 3, 11, 22, 37), 2.5)])
def test_zernike_monomial_map_matches_jax(indices, radius):
    """The monomials and the basis change equal the JAX package's exactly
    (example 20's full set, Noll 4..28, among them)."""
    pw_t, m_t = tzern.zernike_monomial_map(indices, radius)
    pw_j, m_j = jzern.zernike_monomial_map(indices, radius)
    assert pw_t == pw_j
    assert m_t == m_j


# ---- the surface functions ----

def _ff_inputs(seed=0, n=400):
    rng = np.random.default_rng(seed)
    c, kc2 = np.float32(0.02), np.float32(0.02 * 0.02 * 0.4)
    a = np.float32([1e-5, -2e-7, 1e-9, 0.0])
    powers = ((2, 0), (0, 2), (2, 1), (0, 3), (1, 1), (4, 0), (1, 3))
    cm = np.float32([3e-3, -2e-3, 1e-4, -5e-5, 2e-4, 1e-6, 2e-6])
    o = np.stack([rng.uniform(-6, 6, n), rng.uniform(-6, 6, n),
                  np.full(n, -5.0)]).astype(np.float32)
    d = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n),
                  np.ones(n)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return c, kc2, a, powers, cm, o, d


def test_ff_functions_match_jax():
    """ff_sag_grad, ff_refine (from the base conic's root) and ff_normal
    against the JAX package's on the same float32 inputs."""
    c, kc2, a, powers, cm, o, d = _ff_inputs()
    jt = lambda v: jnp.asarray(v)                  # noqa: E731
    tt = lambda v: torch.tensor(np.asarray(v))      # noqa: E731
    x, y = o[0], o[1]
    sj = jsurf.ff_sag_grad(jt(c), jt(kc2), [jt(v) for v in a], powers,
                           [jt(v) for v in cm], jt(x), jt(y))
    st = tsurf.ff_sag_grad(tt(c), tt(kc2), [tt(v) for v in a], powers,
                           [tt(v) for v in cm], tt(x), tt(y))
    for u, v in zip(st, sj):
        _close(u, v, rtol=1e-6, atol=1e-7)
    q = np.float32([c, c, kc2 / c, -2.0, 0.0])
    (t1, v1), _ = jsurf.solve_roots(jt(q), tuple(jt(v) for v in o),
                                    tuple(jt(v) for v in d))
    tj, vj = jsurf.ff_refine(jt(c), jt(kc2), [jt(v) for v in a], powers,
                             [jt(v) for v in cm], tuple(jt(v) for v in o),
                             tuple(jt(v) for v in d), t1, v1)
    tt_, vt = tsurf.ff_refine(tt(c), tt(kc2), [tt(v) for v in a], powers,
                              [tt(v) for v in cm], tuple(tt(v) for v in o),
                              tuple(tt(v) for v in d),
                              tt(np.asarray(t1)), tt(np.asarray(v1)))
    assert np.array_equal(vt.numpy(), np.asarray(vj)) and vt.all()
    _close(tt_, tj, rtol=1e-6, atol=1e-6)
    h = np.stack([x, y, 0 * x])
    nj = jsurf.ff_normal(jt(c), jt(kc2), [jt(v) for v in a], powers,
                         [jt(v) for v in cm], tuple(jt(v) for v in h))
    nt = tsurf.ff_normal(tt(c), tt(kc2), [tt(v) for v in a], powers,
                         [tt(v) for v in cm], tuple(tt(v) for v in h))
    for u, v in zip(nt, nj):
        _close(u, v, rtol=1e-6, atol=1e-7)


def test_ipow_is_the_left_multiply_chain():
    """_ipow multiplies from the left, out = out * v, and gives ones for
    0, as the JAX package's and csrc/freeform.cuh's do."""
    v = torch.tensor([1.1, -0.7, 3.0])
    assert torch.equal(tsurf._ipow(v, 0), torch.ones(3))
    assert torch.equal(tsurf._ipow(v, 4), ((v * v) * v) * v)


# ---- traces ----

@pytest.mark.parametrize('case', sorted(SCENES))
def test_eager_traces_match_jax(case):
    """The eager trace of examples 19, 20 and 26's scenes against JAX
    ``simulate``: the rays and the moments."""
    js, ts, rays_j, rays_t, pt = _pair(case)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays_j, KEY)
    out_t, sens_t = ts.simulate(pt, rays_t)[:2]
    _check_rays(out_t, out_j, case)
    _check_moments(sens_t, sens_j)
    assert float(out_t.intensity.sum()) > 0.5 * rays_t.n


@pytest.mark.parametrize('case', sorted(SCENES))
def test_fused_plain_traces_match_jax(case):
    """``simulate_fused`` (K1's plain version here) of the three scenes
    against JAX ``simulate``; example 20's with ``track_opl`` (the path
    length and the final medium)."""
    js, ts, rays_j, rays_t, pt = _pair(case)
    opl = case == 'ex20'
    res_j = js.simulate(js.init_params(), rays_j, KEY, track_opl=opl)
    res_t = ts.simulate_fused(pt, rays_t, track_opl=opl)
    _check_rays(res_t[0], res_j[0], case)
    _check_moments(res_t[1], res_j[1])
    if opl:
        ref = np.asarray(res_j[2]['opl'])
        m = np.float32(np.abs(ref).max())
        _close(res_t[2]['opl'], ref, rtol=0,
               atol=len(ts.static_meta()) * float(np.spacing(m)))
        _close(res_t[2]['n_final'], res_j[2]['n_final'], atol=0)


@pytest.mark.parametrize('case', ['ex19', 'ex26'])
def test_scenes_match_jax(case):
    """The scenes as ``Scene``s: the eager bounce loop and K5's plain
    version against the JAX package's bounce loop."""
    js, ts, rays_j, rays_t, pt = _pair(case, n=512, base=True)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays_j, KEY)
    out_t, sens_t = ts.simulate(pt, rays_t)[:2]
    _check_rays(out_t, out_j, case)
    _check_moments(sens_t, sens_j)
    out_f, sens_f = ts.simulate_fused(pt, rays_t)[:2]
    _check_rays(out_f, out_j, case)
    _check_moments(sens_f, sens_j)
    # the folded beam crosses the window again on its way to the sensor
    assert float(sens_f.moments[0, 0, 0]) > 0.5 * rays_t.n


def test_freeform_without_terms_is_the_asphere():
    """A FreeformLens with no terms traces as the AsphericLens of the same
    base (tests/test_freeform.py::test_empty_terms_reduce_to_asphere)."""
    kw = dict(c1=0.03, c2=-0.02, d=14.0, t=3.0, ior_glass=1.5168, k1=-0.5,
              a1=(1e-5, 2e-8))
    sens = trt.SensorElement(radius=20.0, translation=[0, 0, 40.0], name='s')
    sa = trt.SequentialScene([trt.AsphericLens(name='l', **kw), sens])
    sf = trt.SequentialScene([trt.FreeformLens(name='l', **kw), sens])
    _, rays = _disk(257, 5.0, -10.0)
    oa = sa.simulate(sa.init_params('cpu'), rays)[0]
    of = sf.simulate(sf.init_params('cpu'), rays)[0]
    for c in COMPS:
        assert torch.equal(getattr(oa, c), getattr(of, c)), c
    assert sf.static_meta()[0].ff is None


def test_zernike_lens_is_its_freeform():
    """A ZernikeLens traces as the FreeformLens of its monomials (the
    coefficients M @ z, rounded once to float32); the terms without a
    constant monomial (a FreeformLens takes no piston)."""
    terms = [(j, v) for j, v in EX20_TERMS if j not in (4, 11)]
    pw, M = tzern.zernike_monomial_map([j for j, _ in terms], 6.0)
    z = np.float32([v for _, v in terms])
    mono = [(i, j, float(sum(np.float32(w) * z[k]
                             for k, w in enumerate(row) if w != 0.0)))
            for (i, j), row in zip(pw, M)]
    zs = trt.SequentialScene([trt.ZernikeLens(
        c1=0.0, c2=0.0, d=13.2, t=2.0, ior_glass=N_GLASS, z1=terms,
        norm_radius=6.0, translation=[0, 0, -5.0], name='corrector')]
        + ex20(trt).elements[1:])
    fs = trt.SequentialScene([trt.FreeformLens(
        c1=0.0, c2=0.0, d=13.2, t=2.0, ior_glass=N_GLASS, xy1=mono,
        translation=[0, 0, -5.0], name='corrector')] + zs.elements[1:])
    pz, pf = zs.init_params('cpu'), fs.init_params('cpu')
    _close(zs.build_table(pz).ff[0, :len(pw)], pf['corrector']['xy1'],
           rtol=1e-6, atol=1e-12)
    assert zs.static_meta()[0].ff == fs.static_meta()[0].ff == tuple(pw)
    _, rays = _disk(512, 6.0, -10.0)
    oz, sz = zs.simulate(pz, rays)[:2]
    of, sf = fs.simulate(pf, rays)[:2]
    for c in COMPS:
        _close(getattr(oz, c), getattr(of, c), rtol=1e-6, atol=1e-5)
    _close(sz.moments, sf.moments, rtol=1e-5)


def test_wedge_deviates_by_n_minus_one_alpha():
    """The wedge's small-angle deviation is (n - 1) alpha
    (tests/test_oap_wedge.py), its direction equals the JAX package's, and
    the gradient of the deviated d_y in the wedge angle is the slope of the
    port's own trace (a central difference at 1e-3 rad)."""
    alpha, n = 0.05, 1.5168

    def scene(rt, a=alpha):
        return rt.SequentialScene([rt.WedgePrism(
            wedge_angle=a, d=20.0, t=3.0, ior_glass=n,
            wedge_angle_grad=True, name='wedge')])
    rays = trt.Rays.create(torch.tensor([[0.0, 0.0, -10.0]]),
                           torch.tensor([[0.0, 0.0, 1.0]]))
    ts = scene(trt)
    p = ts.init_params('cpu')
    p['wedge']['wedge_angle'].requires_grad_(True)
    out = ts.simulate(p, rays)[0]
    dev = math.atan2(abs(float(out.dy[0])), float(out.dz[0]))
    assert dev == pytest.approx((n - 1) * alpha, rel=5e-3)
    out.dy[0].backward()
    js = scene(jrt)
    out_j = js.simulate(js.init_params(), JaxRays.create(
        jnp.asarray([[0.0, 0.0, -10.0]]), jnp.asarray([[0.0, 0.0, 1.0]])),
        KEY)[0]
    for c in ('dx', 'dy', 'dz'):
        _close(float(getattr(out, c)[0]), float(getattr(out_j, c)[0]),
               rtol=1e-6, atol=1e-7)

    def dy(a):
        sc = scene(trt, a)
        return float(sc.simulate(sc.init_params('cpu'), rays)[0].dy[0])
    slope = (dy(alpha + 1e-3) - dy(alpha - 1e-3)) / 2e-3
    _close(float(p['wedge']['wedge_angle'].grad), slope, rtol=1e-3)


# ---- gradients ----

def _spot_loss_t(scene, p, rays, fused):
    sens = (scene.simulate_fused if fused else scene.simulate)(p, rays)[1]
    m = sens.moments[0, 0]
    w = m[0]
    return (m[3] / w - (m[1] / w) ** 2) + (m[4] / w - (m[2] / w) ** 2)


def _spot_loss_j(scene, p, rays):
    m = scene.simulate(p, rays, KEY)[1].moments[0, 0]
    w = m[0]
    return (m[3] / w - (m[1] / w) ** 2) + (m[4] / w - (m[2] / w) ** 2)


GRAD_KW = {'ex19': dict(grad=True),
           'ex20': dict(grad=True, c1=0.01, k1=-0.2, a1=(2e-6, -1e-8))}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grad(case):
    """The JAX package's spot variance and its ``jax.grad`` on a gradient
    case (one compile for its eager and its fused comparison)."""
    js, _, rays_j, _, _ = _pair(case, n=512, **GRAD_KW[case])
    loss, g = jax.value_and_grad(lambda p: _spot_loss_j(js, p, rays_j))(
        js.init_params())
    return float(loss), _np(g)


@pytest.mark.parametrize('case, leaves, fused', [
    ('ex19', ('xy1',), False), ('ex19', ('xy1',), True),
    ('ex20', ('z1', 'k1', 'a1'), False), ('ex20', ('z1', 'k1', 'a1'), True),
])
def test_gradients_match_jax(case, leaves, fused):
    """The spot variance's gradient in the freeform coefficients ``xy1``,
    the Zernike coefficients ``z1``, the conic ``k1`` and the asphere
    terms ``a1`` against ``jax.grad``, eagerly and through FusedTrace
    (K2's plain version)."""
    _, ts, _, rays_t, pt = _pair(case, n=512, **GRAD_KW[case])
    for leaf in leaves:
        pt['corrector'][leaf].requires_grad_(True)
    loss = _spot_loss_t(ts, pt, rays_t, fused)
    loss.backward()
    loss_j, g = _jax_loss_and_grad(case)
    _close(float(loss), loss_j, rtol=1e-5)
    for leaf in leaves:
        ref = np.asarray(g['corrector'][leaf])
        got = pt['corrector'][leaf].grad.numpy()
        _close(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(),
               err_msg=leaf)
        assert np.abs(ref).max() > 0, leaf


# ---- constructors ----

def test_param_scales_and_trainable_match_jax():
    """param_scales and trainable give the JAX package's values."""
    for make in (lambda rt: rt.FreeformLens(
            c1=0.0, c2=0.01, d=24.0, t=2.0, ior_glass=1.5,
            xy1=EX19_TERMS, xy2=[(1, 0, 1e-3)], xy1_grad=True),
            lambda rt: rt.ZernikeLens(
                c1=0.0, c2=0.0, d=12.0, t=2.0, ior_glass=1.5,
                z1=EX20_TERMS, z2=[(4, 1e-4)], z2_grad=True)):
        et, ej = make(trt), make(jrt)
        assert et.param_scales() == pytest.approx(ej.param_scales())
        assert et.trainable() == ej.trainable()


@pytest.mark.parametrize('make', [
    lambda rt: rt.FreeformLens(c1=0.0, c2=0.0, d=10.0, t=2.0,
                               ior_glass=1.5, xy1=[(0, 0, 1.0)]),
    lambda rt: rt.FreeformLens(c1=0.0, c2=0.0, d=10.0, t=2.0,
                               ior_glass=1.5, xy1=[(2, 0, 1e-3)] * 33),
    lambda rt: rt.FreeformLens(c1=0.0, c2=0.0, d=10.0, t=2.0,
                               ior_glass=1.5, xy2=[(-1, 2, 1e-3)]),
    lambda rt: rt.ZernikeLens(c1=0.0, c2=0.0, d=10.0, t=2.0, ior_glass=1.5,
                              z1=[(1, 1e-3)]),
    lambda rt: rt.ZernikeLens(c1=0.0, c2=0.0, d=10.0, t=2.0, ior_glass=1.5,
                              z1=[(4, 1e-3), (4, 2e-3)]),
    lambda rt: rt.ZernikeLens(c1=0.0, c2=0.0, d=10.0, t=2.0, ior_glass=1.5,
                              z1=[(j, 1e-4) for j in range(2, 40)]),
    lambda rt: rt.ZernikeLens(c1=0.0, c2=0.0, d=10.0, t=2.0, ior_glass=1.5,
                              z1=[(4, 1e-3)], norm_radius=0.0),
], ids=['piston', 'too_many', 'negative', 'noll_piston', 'duplicate',
        'too_many_monomials', 'norm_radius'])
def test_value_errors_match_jax(make):
    """Piston, a negative exponent, more than MAX_FF_TERMS terms or
    monomials, a duplicate Noll index and norm_radius <= 0 raise
    ValueError, as in the JAX package."""
    with pytest.raises(ValueError):
        make(jrt)
    with pytest.raises(ValueError):
        make(trt)


def test_freeform_side_buffer_and_kinds():
    """A freeform row's kinds row has SURF_FREEFORM, its side-buffer row its
    term count and pairs packed i | j << 16; the K2/K6 columns widen to the
    32 ff columns; a freeform table without a callable has no program
    buffer."""
    ts = ex19(trt)
    meta = ts.static_meta()
    kinds = fused_trace.kind_rows(meta, ts.sensor_config())
    assert kinds[0][3] == fused_trace.SURF_FREEFORM
    assert kinds[1][3] == fused_trace.SURF_ASPHERE
    side = fused_trace.ff_side(meta, 'cpu')
    assert side.shape == (len(meta), fused_trace.FF_SIDE)
    assert side[0, 0] == len(EX19_TERMS)
    assert [int(w) for w in side[0, 1:6]] == [i | j << 16
                                              for i, j, _ in EX19_TERMS]
    assert int(side[1:].abs().sum()) == 0
    assert fused_trace.ff_side(ex20(trt).static_meta()[1:], 'cpu') is None
    cols = fused_trace.grad_cols((), True, False, True, True, True)
    assert cols[-32:] == fused_trace.FF_TERM_COLS
    # no program buffer without a callable: the family instantiation reads
    # the freeform pairs alone
    assert fused_trace.fuzzy_buffer(fused_trace.TraceMeta(meta), 'cpu') is None
    assert fused_trace.families(meta) == fused_trace.FAM_FREEFORM
    with pytest.raises(NotImplementedError, match='FF_MAX_EXPONENT'):
        fused_trace.ff_side([trt.StaticRowMeta(3, 0, 0, ff=((1 << 16, 0),))],
                            'cpu')


def test_freeform_backward_shared_memory_limit():
    """K6's instantiation with freeform surfaces takes at most
    MAX_SHARED_BYTES a block: a Scene of sixteen freeform windows (48 rows)
    at 13 bounces raises NotImplementedError naming it under grad, before
    anything runs, on either device; its forward runs."""
    from raytracetorch_tpu_torch.ops import fused_nonseq
    els = [trt.FreeformLens(c1=0.0, c2=0.0, d=20.0, t=1.0, ior_glass=1.5,
                            xy1=[(2, 0, 1e-4)], xy1_grad=True,
                            translation=[0, 0, 5.0 * k], name=f'w{k}')
           for k in range(16)]
    sc = trt.Scene(els + [trt.SensorElement(radius=20.0,
                                            translation=[0, 0, 90.0],
                                            name='s')], n_bounces=13)
    _, rays = _disk(64, 4.0, -5.0)
    p = sc.init_params('cpu')
    need = fused_nonseq.freeform_k6_shared_bytes(
        fused_trace.TraceMeta(sc.static_meta()), sc.sensor_config(), 13)
    assert need > fused_nonseq.MAX_SHARED_BYTES
    with torch.no_grad():
        sc.simulate_fused(p, rays)
    p['w0']['xy1'].requires_grad_(True)
    with pytest.raises(NotImplementedError, match='MAX_SHARED_BYTES'):
        sc.simulate_fused(p, rays)
    assert fused_nonseq.freeform_k6_shared_bytes(
        fused_trace.TraceMeta(ex19(trt, base=True).static_meta()),
        ex19(trt).sensor_config(), 12) < fused_nonseq.MAX_SHARED_BYTES


def test_kernel_constants_match_the_wrappers():
    """The CUDA sources' freeform constants equal the Python side's: the
    surface code, the side buffer's width and the term limit, the Newton
    steps, K6's checkpoints (the shared-memory check's)."""
    import pathlib
    import re
    from raytracetorch_tpu_torch.ops import fused_nonseq
    csrc = pathlib.Path(trt.__file__).parent / 'csrc'
    ff = (csrc / 'freeform.cuh').read_text()
    common = (csrc / 'trace_seq_common.cuh').read_text()
    k6 = (csrc / 'trace_nonseq_bwd.cu').read_text()

    def const(src, name):
        return int(re.search(rf'\b{name} = (\d+)', src).group(1))
    assert const(ff, 'kMaxFfTerms') == trt.constants.MAX_FF_TERMS
    assert 1 + const(ff, 'kMaxFfTerms') == fused_trace.FF_SIDE
    assert const(ff, 'kFfSteps') == tsurf.FF_STEPS
    assert const(common, 'kSurfFreeform') == fused_trace.SURF_FREEFORM
    assert const(k6, 'kCkpt') == fused_nonseq.K6_CHECKPOINTS
