"""Chromatic dispersion in the PyTorch port against the JAX package, on the
CPU: the glass catalog, ``dispersive_iors`` (Cauchy, Sellmeier and constant
sides, set and unset wavelengths), the dispersive ``SingletLens`` and
``AsphericLens``, the ``DoubletLens`` and ``TripletLens``, the achromat and
the Sellmeier Cooke triplet of chip_smoke.py section 9 traced eagerly, as
12-bounce Scenes and through the fused trace's plain versions (the functions
K1, K2, K5 and K6 compute on the card), their gradients (curvatures, glass
indices, the wavelength), and a small achromat design.  The plain versions
against the JAX kernels in interpret mode, the Scenes' gradients and the
first TPU kernel's divergence are in tests/test_torch_dispersion_grad.py.

Inputs are made by the JAX package from a seed and carried over through
numpy.  Tolerances, each with its reason:

- the catalog and the tables: the same float formulas, so equal to float32
  rounding (rtol 1e-6), the catalog's Python floats exactly;
- ``dispersive_iors``: indices rtol 1e-6, gradients rtol 1e-5 (float32
  rounding of a few operations in another order);
- traces, as tests/test_pallas.py holds the JAX kernel to the XLA chain:
  positions atol 1e-5, intensity atol 1e-6, moments rtol 1e-5 atol 1e-3;
- gradients in the scene's leaves: rtol 1e-4 (float32 adjoints summed
  over the rays in another order); the wavelength's per ray: within 1e-4
  of the stream's scale plus rtol 1e-3 (a Sellmeier glass's terms cancel
  about a hundredfold in d n / d lambda);

The CUDA kernels themselves are held to these plain versions on the card
in tests/test_torch_cuda.py and chip_smoke.py section 9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import dispersion_anchors
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core.static_dispatch import \
    dispersive_iors as jax_dispersive_iors
from raytracetorch_tpu.elements.lens import \
    abbe_to_cauchy_b as jax_abbe_to_cauchy_b
from raytracetorch_tpu.utils import glass as jglass
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import DispModel
from raytracetorch_tpu_torch.core.static_dispatch import (StaticRowMeta,
                                                          dispersive_iors)
from raytracetorch_tpu_torch.elements.lens import abbe_to_cauchy_b
from raytracetorch_tpu_torch.ops import fused_trace
from raytracetorch_tpu_torch.utils import glass as tglass

torch.set_num_threads(2)

N = 600
CASES = ('achromat_abbe', 'achromat_sellmeier', 'cooke')


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _scenes(case, n_bounces=None):
    """(JAX scene, port scene, bundles) of a chip_smoke.DISP_CASES name."""
    js, bundles, nb = chip_smoke.disp_case(jrt, case, n_bounces)
    return js, chip_smoke.disp_case(trt, case, n_bounces)[0], bundles, nb


def _rays(case, n, seed):
    js, _, bundles, nb = _scenes(case)
    return js.sample_rays(jax.random.PRNGKey(seed), bundles(jrt, n)), nb


def _port(js, rays_j):
    p = js.init_params()
    return (interop.params_from_numpy(_np(p), 'cpu'),
            interop.table_from_numpy(_np(js.build_table(p)), 'cpu'),
            interop.meta_from_slots(js.static_meta()),
            interop.rays_from_numpy(_np(rays_j), 'cpu'))


def _assert_trace_close(out_t, sens_t, out_j, sens_j):
    _close(out_t.pos.numpy(), out_j.pos, atol=1e-5)
    _close(out_t.intensity.numpy(), out_j.intensity, atol=1e-6)
    _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-5, atol=1e-3)


def _assert_wavelength_grads_close(g_t, g_j):
    g_j = np.asarray(g_j)
    scale = float(np.abs(g_j).max())
    assert scale > 0
    _close(g_t, g_j, rtol=1e-3, atol=1e-4 * scale)


# ---- the glass catalog ----

@pytest.mark.parametrize('model', ['abbe', 'sellmeier', 'const'])
def test_glass_catalog_matches_jax(model):
    """``glass`` and ``glass_pair`` give the JAX package's keyword
    arguments for every glass; the tables are the same."""
    assert tglass.CATALOG == jglass.CATALOG
    assert tglass.SELLMEIER == jglass.SELLMEIER
    for name in tglass.SELLMEIER:
        assert tglass.glass(name, model) == jglass.glass(name, model)
    if model != 'const':
        for crown, flint in (('N-BK7', 'SF2'), ('N-SK16', 'F2'),
                             ('FUSED-SILICA', 'N-SF6')):
            assert (tglass.glass_pair(crown, flint, model)
                    == jglass.glass_pair(crown, flint, model))


def test_sellmeier_index_matches_jax_on_tensors():
    """``sellmeier_index`` and ``sellmeier_nd_vd`` on floats equal the JAX
    package's; on a tensor of wavelengths, the index and d n / d lambda
    match the JAX package's on an array and ``jax.grad``."""
    for name, co in tglass.SELLMEIER.items():
        assert tglass.sellmeier_nd_vd(co) == jglass.sellmeier_nd_vd(co)
        assert tglass.sellmeier_index(co, 0.55) == jglass.sellmeier_index(
            co, 0.55)
    co = tglass.SELLMEIER['N-BK7']
    wl = np.linspace(0.4, 1.0, 13).astype(np.float32)
    wl_t = torch.from_numpy(wl).requires_grad_(True)
    n_t = tglass.sellmeier_index(co, wl_t)
    n_t.sum().backward()
    _close(n_t.detach().numpy(), jglass.sellmeier_index(co, jnp.asarray(wl)),
           rtol=1e-6)
    g_j = jax.grad(lambda w: jglass.sellmeier_index(co, w).sum())(
        jnp.asarray(wl))
    _close(wl_t.grad.numpy(), g_j, rtol=1e-5)


def test_abbe_to_cauchy_b_matches_jax():
    for nd, vd in tglass.CATALOG.values():
        assert abbe_to_cauchy_b(nd, vd) == jax_abbe_to_cauchy_b(nd, vd)


# ---- dispersive_iors ----

@dataclasses.dataclass
class _Row:
    ph: object
    disp: object


@pytest.mark.parametrize('dispm', [(1, 1), (2, 2), (0, 2), (2, 1), (1, 0)])
def test_dispersive_iors_match_jax(dispm):
    """Per-ray indices of each pair of side models at set, unset (0) and
    clamped (lambda^2 under 1e-6) wavelengths, and their gradients in the
    wavelength, the d-line indices ph[0:2] and the 12 disp columns, against
    the JAX function and ``jax.grad``."""
    rng = np.random.default_rng(sum(dispm))
    wl = np.concatenate([rng.uniform(0.4, 1.0, 40), [0.0, 0.0, 5e-4, 1e-4,
                                                     0.5876]]).astype(
        np.float32)
    ph = np.array([1.5168, 1.6727, 0, 0, 0, 0], np.float32)
    side = {0: [0.0] * 6,
            1: [float(abbe_to_cauchy_b(1.6, 40.0))] + [0.0] * 5,
            2: list(tglass.SELLMEIER['N-BK7'])}
    disp = np.array(side[dispm[0]] + (list(tglass.SELLMEIER['SF2'])
                                      if dispm[1] == 2 else side[dispm[1]]),
                    np.float32)
    meta = StaticRowMeta(3, 0, 0, disp=True, dispm=dispm)

    def jax_sum(w, p, d):
        a, b = jax_dispersive_iors(_Row(p, d), w, meta)
        return jnp.sum(a * 1.3 + b * 0.7), (a, b)

    (_, (a_j, b_j)), g_j = jax.value_and_grad(
        jax_sum, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(wl),
                                                  jnp.asarray(ph),
                                                  jnp.asarray(disp))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (wl, ph, disp)]
    a_t, b_t = dispersive_iors(_Row(ts[1], ts[2]), ts[0], meta)
    (a_t * 1.3 + b_t * 0.7).sum().backward()
    _close(a_t.detach().numpy(), a_j, rtol=1e-6)
    _close(b_t.detach().numpy(), b_j, rtol=1e-6)
    for t, g in zip(ts, g_j):
        # a Sellmeier side does not read its ph column: no gradient there
        got = torch.zeros_like(t) if t.grad is None else t.grad
        _close(got.numpy(), g, rtol=1e-5, atol=1e-6)
    # unset wavelengths take the d line
    _close(a_t.detach().numpy()[40:42], a_t.detach().numpy()[44:45].repeat(
        2), rtol=1e-6)


def test_unsupported_lets_dispersion_through():
    """``unsupported`` lets a dispersive row through, and a coated one (a
    stack on a SNELL row is carried and does not act); a metal on a row
    that does not reflect, and SCATTER, still raise."""
    from raytracetorch_tpu_torch.core.static_dispatch import unsupported
    assert unsupported(StaticRowMeta(3, 4, 1, disp=True,
                                     dispm=(2, 0))) is None
    assert unsupported(StaticRowMeta(3, 4, 1, n_coat=1)) is None
    assert 'metal' in unsupported(StaticRowMeta(3, 4, 1, metal=True))
    assert 'SCATTER' in unsupported(StaticRowMeta(10, 4, 1))


# ---- elements ----

def _elements():
    sk16 = jglass.glass('N-SK16', model='sellmeier')
    return {
        'doublet_abbe': lambda rt: rt.DoubletLens(
            **chip_smoke.ACHROMAT_KW, **chip_smoke.ACHROMAT_ABBE,
            name='d'),
        'doublet_sellmeier': lambda rt: rt.DoubletLens(
            **chip_smoke.ACHROMAT_KW,
            **rt.glass_pair('N-BK7', 'SF2', model='sellmeier'), name='d'),
        'triplet': lambda rt: rt.TripletLens(
            c1=0.015, c2=-0.01, c3=0.012, c4=-0.008, d=20.0, t1=3.0, t2=2.0,
            t3=3.0, ior_glass1=1.517, ior_glass2=1.62, ior_glass3=1.517,
            sellmeier1=jglass.SELLMEIER['N-BK7'], sellmeier3=sk16[
                'sellmeier'], name='t'),
        'singlet_abbe': lambda rt: rt.SingletLens(
            c1=0.016667, c2=-0.00283, d=25.4, t=4.0, name='s',
            **rt.glass('N-BK7')),
        'asphere_sellmeier': lambda rt: rt.AsphericLens(
            c1=0.05, k1=-0.6, a1=[2.5e-4, 1e-6], c2=-0.02, d=10.0, t=3.0,
            name='a', **rt.glass('N-SK16', model='sellmeier')),
    }


@pytest.mark.parametrize('name', sorted(_elements()))
def test_dispersive_element_tables_match_jax(name):
    """The element's surface records stack into the JAX package's table,
    the ``disp`` columns included, and its static metadata (``disp``,
    ``dispm``) is the JAX package's."""
    make = _elements()[name]
    js = jrt.SequentialScene([make(jrt)])
    ts = trt.SequentialScene([make(trt)])
    tj = _np(js.build_table(js.init_params()))
    tt = ts.build_table(ts.init_params('cpu'))
    for f in dataclasses.fields(trt.SurfaceTable):
        _close(getattr(tt, f.name).detach().numpy(), getattr(tj, f.name),
               rtol=1e-6, err_msg=f.name)
    assert float(np.abs(tj.disp).max()) > 0
    assert ts.static_meta() == interop.meta_from_slots(js.static_meta())
    assert any(m.disp for m in ts.static_meta())


def test_doublet_paraxial_and_trace():
    """tests/test_elements.py::test_doublet_paraxial_and_trace on the port:
    a unit-height paraxial ray leaves at slope -1/f of the system matrix;
    the matrix equals the JAX package's."""
    kw = dict(c1=0.02, c2=-0.03, c3=-0.005, d=20.0, t1=4.0, t2=2.0,
              ior_glass1=1.517, ior_glass2=1.649, name='doublet')
    ts, js = (trt.SequentialScene([trt.DoubletLens(**kw)]),
              jrt.SequentialScene([jrt.DoubletLens(**kw)]))
    p = ts.init_params('cpu')
    m = ts.paraxial(p)
    _close(m.numpy(), js.paraxial(js.init_params()), rtol=1e-5, atol=1e-7)
    f_sys = float(1.0 / -m[1, 0])
    rays = trt.Rays.create([[0.0, 1.0, -20.0]], [[0.0, 0.0, 1.0]])
    out, _, _ = ts.simulate(p, rays)
    _close(float(out.dy[0] / out.dz[0]), -1.0 / f_sys, rtol=5e-3)
    el, pd = ts.elements[0], p['doublet']
    assert float(el.R1(pd)) == float(1.0 / pd['c1'])
    assert float(el.R3(pd)) == float(-1.0 / pd['c3'])


def test_triplet_trace_converges():
    """tests/test_elements.py::test_triplet_trace_converges on the port."""
    kw = dict(c1=0.015, c2=-0.01, c3=0.012, c4=-0.008, d=20.0, t1=3.0,
              t2=2.0, t3=3.0, ior_glass1=1.517, ior_glass2=1.62,
              ior_glass3=1.517, name='triplet')
    ts, js = (trt.SequentialScene([trt.TripletLens(**kw)]),
              jrt.SequentialScene([jrt.TripletLens(**kw)]))
    p = ts.init_params('cpu')
    m = ts.paraxial(p)
    _close(m.numpy(), js.paraxial(js.init_params()), rtol=1e-5, atol=1e-7)
    f_sys = float(1.0 / -m[1, 0])
    rays = trt.Rays.create([[0.0, 0.5, -20.0]], [[0.0, 0.0, 1.0]])
    out, _, _ = ts.simulate(p, rays)
    _close(float(out.dy[0] / out.dz[0]), -0.5 / f_sys, rtol=5e-3)


@pytest.mark.parametrize('name', ['SingletLens', 'DoubletLens', 'TripletLens',
                                  'AsphericLens', 'CylSingletLens'])
def test_lens_constructors_take_the_jax_arguments(name):
    """Each lens takes the JAX package's constructor arguments, in order
    (the cylindrical singlet's coating= rides its keywords)."""
    import inspect
    params = [list(inspect.signature(getattr(rt, name).__init__).parameters)
              for rt in (jrt, trt)]
    assert params[0] == params[1]


def test_cyl_singlet_takes_no_dispersion():
    """As in the JAX package, the cylindrical singlet takes no glass model
    (its keyword arguments reach ``Element``)."""
    for rt in (jrt, trt):
        with pytest.raises(TypeError):
            rt.CylSingletLens(c1=0.04, c2=-0.04, height=12.0, width=14.0,
                              t=3.0, ior_glass=1.5, abbe_vd=60.0)


# ---- traces ----

@pytest.mark.parametrize('case', CASES)
def test_traces_match_jax(case):
    """The eager chain and the fused trace's plain version (K1's function)
    against JAX ``simulate`` on the achromat and the Cooke triplet, F/C (and
    d) light; the spectrum spreads the foci."""
    js, ts, _, nb = _scenes(case)
    rays, _ = _rays(case, N, 1)
    p_t, _, _, rays_t = _port(js, rays)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0), n_bundles=nb)
    for simulate in (ts.simulate, ts.simulate_fused):
        out_t, sens_t, _ = simulate(p_t, rays_t, nb)
        _assert_trace_close(out_t, sens_t, out_j, sens_j)
    wl = np.asarray(rays.wavelength)
    assert len(set(wl.tolist())) >= 2


@pytest.mark.parametrize('case', CASES)
def test_scene_versions_match_jax(case):
    """The 12-bounce ``Scene`` of each: the eager bounce loop and the fused
    one's plain version (K5's function) against JAX ``Scene.simulate``."""
    js, ts, _, nb = _scenes(case, chip_smoke.DISP_BOUNCES)
    rays, _ = _rays(case, N, 2)
    p_t, _, _, rays_t = _port(js, rays)
    out_j, sens_j, _ = js.simulate(js.init_params(), rays,
                                   jax.random.PRNGKey(0), n_bundles=nb)
    for simulate in (ts.simulate, ts.simulate_fused):
        out_t, sens_t, _ = simulate(p_t, rays_t, nb)
        _assert_trace_close(out_t, sens_t, out_j, sens_j)


def test_achromat_crossings_match_the_anchor():
    """The port's axis crossings of a paraxial ray through the achromat at
    the F, d and C lines (the fused trace's plain version) equal the JAX
    package's (chip_smoke.ACHROMAT_CROSS_REF, tests/dispersion_anchors.py)
    to chip_smoke.CROSS_TOL, and blue focuses shorter than red."""
    for model in ('abbe', 'sellmeier'):
        scene = chip_smoke.achromat_scene(trt, model)
        z = chip_smoke.axis_crossings(trt, torch, scene,
                                      scene.init_params('cpu'), 'cpu')
        ref = chip_smoke.ACHROMAT_CROSS_REF[model]
        _close(z, ref, atol=chip_smoke.CROSS_TOL)
        _close(dispersion_anchors.axis_crossings(model), ref, atol=1e-4)
        assert z[0] > z[2]     # this doublet is not achromatic yet


def test_cooke_anchor_function_runs_small():
    """tests/dispersion_anchors.py's spot RMS at 6,000 rays lies within 5%
    of chip_smoke.COOKE_RMS_REF (1M rays; sampling noise at 1,000 rays a
    bundle is ~2%)."""
    rms = dispersion_anchors.cooke_spot_rms(6000, 0, chunks=2)
    _close(rms, chip_smoke.COOKE_RMS_REF, rtol=0.05)


# ---- gradients ----

def _loss_jax(scene, rays, nb):
    def loss(p):
        out, sens, _ = scene.simulate(p, rays, jax.random.PRNGKey(0),
                                      n_bundles=nb)
        return (jrt.spot_size_loss(sens) + jnp.mean(out.px * out.dx)
                + jnp.mean(out.intensity * out.py))
    return loss


def _loss_torch(simulate, rays, nb):
    def loss(p):
        out, sens, _ = simulate(p, rays, nb)
        return (trt.spot_size_loss(sens) + torch.mean(out.px * out.dx)
                + torch.mean(out.intensity * out.py))
    return loss


def _grads_torch(loss, p, trained):
    for el, k in trained:
        p[el][k] = p[el][k].clone().requires_grad_(True)
    value = loss(p)
    value.backward()
    return float(value.detach()), {(el, k): p[el][k].grad.numpy()
                                   for el, k in trained}


@pytest.mark.parametrize('case', CASES)
def test_gradients_match_jax(case):
    """Gradients of a spot and ray loss in chip_smoke.DISP_TRAINED (the
    curvatures, and the Abbe achromat's glass indices, on which its Cauchy
    B depends) through the fused trace's plain versions (FusedTrace, K2's
    function) and the eager chain, against ``jax.grad``."""
    trained = chip_smoke.DISP_TRAINED[case]
    js, ts, _, nb = _scenes(case)
    rays, _ = _rays(case, N, 3)
    p_t, _, _, rays_t = _port(js, rays)
    val_j, g_j = jax.value_and_grad(_loss_jax(js, rays, nb))(
        js.init_params())
    for simulate in (ts.simulate_fused, ts.simulate):
        p = {el: dict(v) for el, v in p_t.items()}
        val_t, g_t = _grads_torch(_loss_torch(simulate, rays_t, nb), p,
                                  trained)
        _close(val_t, float(val_j), rtol=1e-5)
        for key, gt in g_t.items():
            assert np.isfinite(gt).all() and np.abs(gt).max() > 0
            _close(gt, g_j[key[0]][key[1]], rtol=1e-4, err_msg=key)


def _plate_scene(rt):
    """A 16 x 16 phase plate ahead of a singlet and a sensor: the plate
    reads the wavelength (its kick), the singlet does not."""
    return rt.SequentialScene([
        rt.PhaseGridPlate(half_x=4.0, half_y=4.0, shape=(16, 16),
                          name='plate'),
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       translation=[0.0, 0.0, 5.0], name='lens'),
        rt.SensorElement(radius=10.0, translation=[0.0, 0.0, 25.0],
                         name='sensor')])


@pytest.mark.parametrize('case', ['plate', 'achromat_sellmeier', 'cooke'])
def test_wavelength_gradient_matches_jax(case):
    """d loss / d wavelength per ray through ``simulate_fused`` (FusedTrace:
    K2's function now returns it) and the eager trace, against ``jax.grad``
    with respect to ``rays.wavelength``, on a phase-plate scene (the kick
    reads it) and two dispersive ones."""
    if case == 'plate':
        js, ts, nb = _plate_scene(jrt), _plate_scene(trt), 1
        rng = np.random.default_rng(5)
        p_j = js.init_params()
        p_j['plate']['grid'] = jnp.asarray(
            rng.standard_normal((16, 16)).astype(np.float32) * 0.3)
        base = jrt.CollimatedDisk.make(radius=jnp.float32(3.0),
                                       translation=[0, 0, -3.0],
                                       wavelength=0.55)
        rays = base.sample(jax.random.PRNGKey(5), N)
    else:
        js, ts, _, nb = _scenes(case)
        p_j = js.init_params()
        rays, _ = _rays(case, N, 5)
    p_t = interop.params_from_numpy(_np(p_j), 'cpu')
    rays_t = interop.rays_from_numpy(_np(rays), 'cpu')

    def loss_j(wl):
        out, sens, _ = js.simulate(p_j, rays._replace(wavelength=wl)
                                   if hasattr(rays, '_replace') else
                                   dataclasses.replace(rays, wavelength=wl),
                                   jax.random.PRNGKey(0), n_bundles=nb)
        return jrt.spot_size_loss(sens) + jnp.mean(out.px * out.dx)

    g_j = jax.grad(loss_j)(rays.wavelength)
    for simulate in (ts.simulate_fused, ts.simulate):
        wl = rays_t.wavelength.clone().requires_grad_(True)
        out, sens, _ = simulate(p_t, rays_t.replace(wavelength=wl), nb)
        (trt.spot_size_loss(sens) + torch.mean(out.px * out.dx)).backward()
        _assert_wavelength_grads_close(wl.grad.numpy(), g_j)


# ---- the design loop ----

@pytest.mark.parametrize('model', sorted(chip_smoke.ACHROMAT_DESIGN))
def test_achromat_design_closes_the_focus_gap(model):
    """tests/test_dispersion.py::test_achromat_design_by_grad on the port:
    fit_lbfgs through ``simulate_fused`` (the plain versions of K1 and K2 on
    the CPU) on 800 + 800 rays of F and C light pulls the two foci under
    chip_smoke.ACHROMAT_DESIGN's share of their gap in its steps (the JAX
    test's anchor for the Abbe glasses, 0.25 in 20 steps; 0.3 in 30 for
    the Sellmeier ones, whose loss is 1e-5 after one step: fit_lbfgs must
    not stop there)."""
    steps, share = chip_smoke.ACHROMAT_DESIGN[model]
    scene = chip_smoke.achromat_scene(trt, model, grad=True)
    gen = torch.Generator().manual_seed(0)
    rays = trt.sample_bundles(gen, chip_smoke.achromat_bundles(trt, 800),
                              'cpu')
    loss = chip_smoke.design_loss(torch, scene, rays, chip_smoke.ACHROMAT_Z)

    def gap(p):
        with torch.no_grad():
            z = chip_smoke.axis_crossings(trt, torch, scene, p, 'cpu',
                                          height=2.0)
        return abs(z[0] - z[2])

    p0 = scene.init_params('cpu')
    gap0 = gap(p0)
    p1, losses = trt.fit_lbfgs(loss, p0, trainable=scene.trainable(),
                               steps=steps)
    assert gap(p1) < share * gap0, (gap0, gap(p1))
    assert float(losses[-1]) < float(losses[0])


# ---- the fused dispatch ----

def test_dispersive_scenes_take_the_extended_kinds():
    """A dispersive scene takes the kernels' instantiation with the extended
    kinds (``ext_kinds``), with the wavelength and no map (``plate_maps``
    gives ``()``); the kinds' physics column carries its DispModels; the
    bench scene stays on the main path."""
    for case in CASES:
        meta = chip_smoke.disp_case(trt, case)[0].static_meta()
        assert fused_trace.ext_kinds(meta) and fused_trace.dispersive(meta)
        assert fused_trace.plate_maps(meta, None) == ()
    meta = chip_smoke.bench_scene(trt).static_meta()
    assert not fused_trace.ext_kinds(meta)
    assert not fused_trace.dispersive(meta)
    assert fused_trace.grad_cols((), True, True) == (
        fused_trace.EXT_GRAD_COLS + fused_trace.DISP_GRAD_COLS)
    assert len(fused_trace.DISP_GRAD_COLS) == 12
    assert DispModel.SELLMEIER == 2 and DispModel.CAUCHY == 1
