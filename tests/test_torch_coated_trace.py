"""Thin-film coatings and metal mirrors in the traces of the PyTorch port,
against the JAX package, on the CPU: the tables and static metadata of
every mirror class and of the coated lenses; the eager sequential trace and
K1's plain version on coated FRESNEL_W, REFLECT_W (a ghost) and FRESNEL
rows (fed the JAX package's uniforms), absorbing stacks and metal mirrors
(bare, enhanced, dispersive, a Mangin's back); the plain K1 and K2 against
the JAX kernels in interpret mode once; the eager and plain
non-sequential loops against the JAX XLA loop; gradients in the layer
thicknesses, the curvatures and the wavelength against ``jax.grad`` (the
non-sequential ones through the plain K6, against ``jax.grad`` of the JAX
bounce loop); the gradient at exactly normal incidence on a metal; and
the refusals that remain (rough mirrors, SCATTER and JONES rows).

Metal mirrors and absorbing stacks go through the complex square root,
whose float32 cancellation in the JAX package the port avoids
(utils/coatings.py::_c_sqrt): scenes with them are held to the JAX
package's trace in float64 (``jax.enable_x64``), where both compute the
same function; the others, and FRESNEL rows (whose draws are float32), to
its float32 trace.

Tolerances, each with its reason: positions atol 2e-5 of the scene's
scale, directions atol 2e-6, intensities rtol 1e-5 (float32 rounding of
a chain in another order; tests/test_torch_fresnel.py); moments rtol
1e-4, atol 1e-3 (sums in another order); tables rtol 1e-6 (each package
builds its rows in its own float32 arithmetic); gradients rtol 1e-4 of
the leaf's scale, per-ray and table cotangents rtol 2e-4, atol 1e-5 of the
stream's scale (float32 adjoints summed in another order).  A FRESNEL ray
whose uniform lies within 1e-5 of its R may take the other branch in the
other package: such rays are found by moving the uniforms (``_stable``)
and left out; at most 2 of a test's may be.  On the absorbing FRESNEL
singlet, held to the JAX package's float32 trace, the shift is 3e-4 and
intensities rtol 3e-4: the JAX package's own float32 R and T of that stack
are up to 1.6e-4 off their float64 values (its cancellation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.elements import mirror as jmirror
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu.utils import ghosts as jghosts
from raytracetorch_tpu.utils.glass import glass as jglass
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.static_dispatch import (StaticRowMeta,
                                                          unsupported)
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from raytracetorch_tpu_torch.rays import reference_prng
from raytracetorch_tpu_torch.utils import ghosts

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
COMPS = fused_trace.COMPS
NS, NC, NH = 1.5168, 1.38, 2.35
WL = 0.5876
QW = WL / (4 * NC)
ENHANCED = [(NH, WL / (4 * NH)), (NC, WL / (4 * NC))]
V_COAT = [(NC, 0.1065), (NH, 0.0157)]
EIGHT = [(NH, WL / (4 * NH)), (NC, WL / (4 * NC))] * 4
ABSORBING = [(NC, 0.1), ('Ag', 0.02), (NH, 0.06)]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


class _JaxMirrors:
    """The JAX package's mirror classes under the port's names."""

    def __getattr__(self, name):
        return getattr(jmirror, name)


def _lib(rt):
    return _JaxMirrors() if rt is jrt else rt


def _glass(rt):
    return jglass if rt is jrt else trt.glass


def _to64(tree):
    """A JAX pytree with its float arrays in float64 (inside enable_x64)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _jax64(fn, *trees):
    """``fn(*trees)`` of the JAX package in float64 -> numpy pytree."""
    with enable_x64():
        return _np(fn(*[_to64(t) for t in trees]))


# ---- tables and metadata ----

def _mirrors(rt):
    m = _lib(rt)
    return {
        'spherical_gold': m.SphericalMirror(
            c1=-0.02, d=20., metal='Au', metal_dispersion=True,
            translation=[0, 0, 30], name='m'),
        'cylindrical_silver': m.CylindricalMirror(
            c1=0.01, d=20., metal='Ag', translation=[0, 0, 40], name='m'),
        'cylindrical_ideal': m.CylindricalMirror(c1=0.01, d=0., name='m'),
        'parabolic_enhanced': m.ParabolicMirror(
            c1=-0.001, d=200., metal='Al', coating=ENHANCED,
            coating_grad=True, translation=[0, 0, 500], name='m'),
        'parabolic_xz': m.ParabolicMirrorXZ(c1=0.01, d=30., name='m'),
        'conic_nk_in_water': m.ConicMirror(
            c1=-0.01, k=-1.5, d=30., k_grad=True, metal=(1.0, 5.0),
            ambient_ior=1.33, name='m'),
        'conic_ideal': m.ConicMirror(c1=-0.01, k=-0.5, d=0., name='m'),
        'aspheric_copper_absorbing': m.AsphericMirror(
            c1=-0.01, d=30., k=-0.5, a=[1e-6, -2e-9], metal='Cu',
            coating=[(NC, 0.1), (0.144, 3.6, 0.01)], name='m'),
        'mangin_aluminium': m.ManginMirror(
            c1=-0.02, c2=-0.025, d=30., t=4., ior_glass=NS, metal='Al',
            name='m'),
        'mangin_ideal': m.ManginMirror(c1=-0.02, c2=-0.025, d=30., t=4.,
                                       ior_glass=NS, name='m'),
        'off_axis_parabola': m.ParabolicMirrorOffAxis(
            c1=-0.01, d=10., off_axis=15., metal='Al', name='m'),
    }


def _lenses(rt):
    return {
        'singlet_list': rt.SingletLens(
            c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS, fresnel='weighted',
            coating=V_COAT, coating_grad=True, name='m'),
        'singlet_absorbing': rt.SingletLens(
            c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS, fresnel=True,
            coating=ABSORBING, name='m'),
        'doublet_per_face': rt.DoubletLens(
            c1=0.02, c2=-0.025, c3=-0.004, d=20.0, t1=4.0, t2=2.0,
            ior_glass1=1.5168, ior_glass2=1.6727, abbe_vd1=64.17,
            abbe_vd2=32.21, fresnel='weighted',
            coating={0: [(NC, QW)], 1: [(1.56, 0.05)], 2: ENHANCED},
            coating_grad=True, name='m'),
        'triplet_sellmeier': rt.TripletLens(
            c1=0.03, c2=-0.02, c3=0.01, c4=-0.03, d=20., t1=3., t2=2.,
            t3=3., ior_glass1=1.5168, ior_glass2=1.6727, ior_glass3=1.5168,
            sellmeier1=_glass(rt)('N-BK7', model='sellmeier')['sellmeier'],
            fresnel='weighted', coating=[(NC, QW)], name='m'),
        'asphere': rt.AsphericLens(
            c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS, k1=-0.5,
            a1=[1e-4], fresnel='weighted', coating=EIGHT, name='m'),
    }


def _compare_tables(ej, et):
    pj = ej.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    sj = jrt.SequentialScene([ej])
    st = trt.SequentialScene([et])
    tj, tt = sj.build_table({ej.name: pj}), st.build_table({et.name: pt})
    for f in dataclasses.fields(tt):
        a = np.asarray(getattr(tj, f.name))
        b = getattr(tt, f.name).detach().numpy()
        assert a.shape == b.shape, f.name
        if np.issubdtype(a.dtype, np.floating):
            _close(b, a, rtol=1e-6, atol=1e-6, err_msg=f.name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    mj, mt = sj.static_meta(), st.static_meta()
    assert [interop.meta_from_slots([m])[0] for m in mj] == mt
    return mt


@pytest.mark.parametrize('name', sorted(_mirrors(trt)))
def test_mirror_tables_match_jax(name):
    """Every column of every row, and the static metadata (metal, knots,
    layer count and extinction), equal JAX's; the paraxial matrices too."""
    ej, et = _mirrors(jrt)[name], _mirrors(trt)[name]
    _compare_tables(ej, et)
    pj = ej.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    zj, mj = ej.paraxial(pj)
    zt, mt = et.paraxial(pt)
    for a, b in zip(mj, mt):
        _close(b.numpy(), a, rtol=1e-6, atol=1e-7)
    _close([float(z) for z in zt], [float(z) for z in zj], rtol=1e-6)


@pytest.mark.parametrize('name', sorted(_lenses(trt)))
def test_coated_lens_tables_match_jax(name):
    """Coated lenses: every column (the coat's interleaved indices and
    thicknesses, per face for the doublet's dict, the cemented face
    included), the metadata and the trainable ``coat_d`` tree."""
    ej, et = _lenses(jrt)[name], _lenses(trt)[name]
    meta = _compare_tables(ej, et)
    assert any(m.n_coat for m in meta)
    tj, tt = ej.trainable(), et.trainable()
    assert tt['coat_d'] == tj['coat_d']
    assert jax.tree_util.tree_structure(ej.init_params()['coat_d']) == \
        jax.tree_util.tree_structure(
            _np(et.init_params('cpu')['coat_d']))


def test_cyl_singlet_coating_rows():
    """The port's CylSingletLens takes ``coating=`` as a keyword (the JAX
    class takes none): its faces carry the coat columns and metadata of a
    coated SingletLens's faces, the rest of the rows as JAX's uncoated
    class."""
    kw = dict(c1=0.05, c2=-0.04, t=3., ior_glass=NS, fresnel='weighted')
    cyl = trt.CylSingletLens(height=10., width=8., coating=V_COAT,
                             coating_grad=True, name='c', **kw)
    bare = jrt.CylSingletLens(height=10., width=8., name='c', **kw)
    tt = trt.SequentialScene([cyl]).build_table({'c': cyl.init_params('cpu')})
    tj = jrt.SequentialScene([bare]).build_table({'c': bare.init_params()})
    ref = trt.SequentialScene([trt.SingletLens(
        d=10., coating=V_COAT, name='s', **kw)])
    tr = ref.build_table(ref.init_params('cpu'))
    _close(tt.coat.detach().numpy()[:2], tr.coat.detach().numpy()[:2])
    assert float(tt.coat[2:].abs().max()) == 0.0
    for f in ('q', 'Rw', 'tw', 'sb', 'vb', 'ph'):
        _close(getattr(tt, f).detach().numpy(), np.asarray(getattr(tj, f)),
               rtol=1e-6, atol=1e-6, err_msg=f)
    meta = trt.SequentialScene([cyl]).static_meta()
    assert [m.n_coat for m in meta] == [2, 2, 0, 0, 0, 0]


# ---- sequential traces ----

def _singlet(rt, mode, coating, stop=True):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS,
                       fresnel=mode, coating=coating, coating_grad=True,
                       c1_grad=True, c2_grad=True, name='lens')]
        + ([rt.CircularAperture(radius=5.0, name='stop')] if stop else [])
        + [rt.SensorElement(radius=6.0, translation=[0, 0, 19.322],
                            name='sensor')])


def _metal_seq(rt, kind):
    m = _lib(rt)
    if kind == 'enhanced':
        mirror = m.ParabolicMirror(c1=-0.01, d=40., metal='Al',
                                   coating=ENHANCED, coating_grad=True,
                                   translation=[0, 0, 50.], name='mirror')
    elif kind == 'gold':
        mirror = m.SphericalMirror(c1=-0.01, d=40., metal='Au',
                                   metal_dispersion=True,
                                   translation=[0, 0, 50.], name='mirror')
    else:
        mirror = m.ManginMirror(c1=-0.02, c2=-0.025, d=30., t=4.,
                                ior_glass=NS, metal='Al',
                                translation=[0, 0, 50.], name='mirror')
    return rt.SequentialScene([mirror, rt.SensorElement(
        radius=30., translation=[0, 0, -5.], name='sensor')])


def _bundles(rt, n, radius, z, wavelengths=(None,)):
    """Collimated disks of ``radius`` at z, one per wavelength (ray_id j)."""
    out = []
    for j, wl in enumerate(wavelengths):
        kw = {} if wl is None else dict(wavelength=wl)
        out.append((rt.CollimatedDisk.make(radius=radius, ray_id=j,
                                           translation=[0., 0., z], **kw),
                    n // len(wavelengths)))
    return out


# cases whose reference is the JAX package's float64 trace (module note)
X64 = ('absorbing_w', 'silver_w', 'enhanced_mirror', 'gold_mirror',
       'mangin_mirror')
SEQ_CASES = {
    'quarter_wave_w': (lambda rt: _singlet(rt, 'weighted', [(NC, QW)]),
                       (4.0, -10.0, (None,))),
    'v_coat_w': (lambda rt: _singlet(rt, 'weighted', V_COAT),
                 (4.0, -10.0, (0.48, 0.65))),
    'eight_layer_w': (lambda rt: _singlet(rt, 'weighted', EIGHT),
                      (4.0, -10.0, (None,))),
    'absorbing_w': (lambda rt: _singlet(rt, 'weighted', ABSORBING),
                    (4.0, -10.0, (None,))),
    'silver_w': (lambda rt: _singlet(rt, 'weighted', [('Ag', 0.02)]),
                 (4.0, -10.0, (None,))),
    'quarter_wave_lens': (lambda rt: _singlet(rt, 'weighted', [(NC, QW)],
                                              stop=False),
                          (4.0, -10.0, (None,))),
    'quarter_wave_mc': (lambda rt: _singlet(rt, True, [(NC, QW)]),
                        (4.0, -10.0, (None,))),
    'absorbing_mc': (lambda rt: _singlet(rt, True, ABSORBING),
                     (4.0, -10.0, (None,))),
    'enhanced_mirror': (lambda rt: _metal_seq(rt, 'enhanced'),
                        (15.0, -3.0, (None,))),
    # 0.68 um, not the knot at 0.70, where a float32 wavelength and its
    # float64 copy fall on different segments of the knots
    'gold_mirror': (lambda rt: _metal_seq(rt, 'gold'),
                    (15.0, -3.0, (0.45, 0.68))),
    'mangin_mirror': (lambda rt: _metal_seq(rt, 'mangin'),
                      (10.0, -3.0, (None,))),
}
# one ray count throughout: the JAX package's eager primitives compile once
# per shape, and every test then reuses them
N = 256


def _case(name, n=N, seed=3):
    make, (radius, z, wls) = SEQ_CASES[name]
    js, ts = make(jrt), make(trt)
    pj = js.init_params()
    rays = js.sample_rays(jax.random.PRNGKey(seed),
                          _bundles(jrt, n, radius, z, wls))
    return (js, pj, rays, ts, interop.params_from_numpy(_np(pj), 'cpu'),
            interop.rays_from_numpy(_np(rays), 'cpu'), len(wls))


def _outcome(out):
    return torch.stack([out.px, out.py, out.pz, out.dx, out.dy, out.dz,
                        out.intensity])


def _stable(trace, u, shift=1e-5):
    lo = _outcome(trace(torch.clamp(u - shift, min=0.0)))
    hi = _outcome(trace(torch.clamp(u + shift, max=1.0 - 2 ** -24)))
    return torch.isclose(lo, hi, rtol=1e-4, atol=1e-4).all(0).numpy()


def _assert_rays_close(out_t, out_j, keep=None, scale=20.0, i_rtol=1e-5):
    keep = np.ones(out_t.n, bool) if keep is None else keep
    for c in ('px', 'py', 'pz'):
        _close(getattr(out_t, c).detach().numpy()[keep],
               np.asarray(getattr(out_j, c))[keep], atol=2e-5 * scale,
               err_msg=c)
    for c in ('dx', 'dy', 'dz'):
        _close(getattr(out_t, c).detach().numpy()[keep],
               np.asarray(getattr(out_j, c))[keep], atol=2e-6, err_msg=c)
    _close(out_t.intensity.detach().numpy()[keep],
           np.asarray(out_j.intensity)[keep], rtol=i_rtol, atol=1e-7)


@pytest.mark.parametrize('name', sorted(SEQ_CASES))
def test_sequential_trace_matches_jax(name):
    """The eager ``simulate`` and ``simulate_fused`` (K1's plain version
    here) against the JAX package's ``simulate``; FRESNEL fed JAX's
    uniforms, on the rays whose draws lie more than 1e-5 from R."""
    js, pj, rays, ts, pt, rays_t, nb = _case(name)
    if name in X64:
        out_j, sens_j = _jax64(lambda p, r: js.simulate(
            p, r, KEY, n_bundles=nb)[:2], pj, rays)
    else:
        out_j, sens_j, _ = js.simulate(pj, rays, KEY, n_bundles=nb)
    meta = ts.static_meta()
    assert fused_trace.coating_kinds(meta)
    u = reference_prng.fresnel_uniforms(reference_prng.prng_key(0), meta, N)
    keep, i_rtol = None, 1e-5
    if u.shape[0]:
        shift = 3e-4 if 'absorbing' in name else 1e-5
        i_rtol = shift if 'absorbing' in name else 1e-5
        keep = _stable(lambda v: ts.simulate(pt, rays_t, nb,
                                             uniforms=v)[0], u, shift)
        assert (~keep).sum() <= 2
    for sim in (ts.simulate, ts.simulate_fused):
        out_t, sens_t, _ = sim(pt, rays_t, nb, uniforms=u)
        _assert_rays_close(out_t, out_j, keep, i_rtol=i_rtol)
        if keep is None or keep.all():
            _close(sens_t.moments.detach().numpy(), sens_j.moments,
                   rtol=1e-4, atol=1e-3)
    if name == 'quarter_wave_mc':      # a lossless stack's draw keeps I
        assert float(out_t.intensity.min()) == 1.0
    elif name == 'absorbing_mc':       # transmitted rays carry T / (1 - R)
        assert float(out_t.intensity.min()) < 1.0
    else:
        assert float(out_t.intensity.max()) < 1.0


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
    """K1's and K2's plain versions on the quarter-wave FRESNEL_W singlet
    against ``trace_sequential_pallas_v2`` and its backward in interpret
    mode: the rays, the moments, and the ray and table cotangents (the coat
    columns included) under numpy-seeded cotangents."""
    js, pj, rays, _, _, _, nb = _case('quarter_wave_lens')
    flat, meta, cfg, rays_t = _port_inputs(js, pj, rays, nb)
    table_j = js.build_table(pj)
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        interpret=True, block_rows=2)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps)
    _assert_rays_close(out_t, out_j)
    _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(5)
    g_rays = [rng.standard_normal(rays_t.n).astype(np.float32)
              for _ in range(7)]
    g_mom = rng.standard_normal((1, nb, 7)).astype(np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays, KEY, js.sensor_config(nb), js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id),
                wavelength=np.asarray(rays.wavelength)),
        g_mom, interpret=True, block_rows=2)
    g_flat, g_in = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps)[:2]
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
    thick = g_flat[:, list(fused_trace.COAT_GRAD_COLS)]
    assert float(thick.abs().max()) > 0


GRAD_CASES = {
    'v_coat_w': (('lens', 'coat_d'), ('lens', 'c1'), ('lens', 'c2')),
    'silver_w': (('lens', 'coat_d'), ('lens', 'c2')),
    'enhanced_mirror': (('mirror', 'coat_d'), ('mirror', 'c')),
}


@pytest.mark.parametrize('name', sorted(GRAD_CASES))
def test_sequential_gradients_match_jax(name):
    """The gradient of a spot and transmission loss in the layer
    thicknesses and the curvatures, through the eager trace and
    ``simulate_fused`` (K1's and K2's plain versions), against
    ``jax.grad`` of the JAX trace (rtol 1e-4 of the leaf's scale)."""
    js, pj, rays, ts, pt, rays_t, nb = _case(name)
    trained = GRAD_CASES[name]

    def jax_loss(p, r):
        _, sens, _ = js.simulate(p, r, KEY, n_bundles=nb)
        return (jnp.sum(sens.spot_rms(0))
                + jnp.sum(sens.total_weight(0)) / N)
    if name in X64:
        g = _jax64(lambda p, r: jax.grad(jax_loss)(p, r), pj, rays)
    else:
        g = jax.grad(jax_loss)(pj, rays)
    ref = [np.asarray(g[el][k]) for el, k in trained]
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        for el, k in trained:
            p[el][k] = p[el][k].clone().requires_grad_(True)
        _, sens, _ = sim(p, rays_t, nb)
        (sens.spot_rms(0).sum() + sens.total_weight(0).sum() / N
         ).backward()
        for (el, k), r in zip(trained, ref):
            assert np.abs(r).max() > 0
            _close(p[el][k].grad.numpy(), r, rtol=1e-4,
                   atol=1e-4 * np.abs(r).max(), err_msg=f'{el}.{k}')


@pytest.mark.parametrize('name', ['v_coat_w', 'gold_mirror'])
def test_wavelength_gradient_matches_jax(name):
    """The gradient of the transmitted (or reflected) flux in each ray's
    wavelength: the stack's phase thickness 2 pi n d cos / lambda, and a
    dispersive metal's knots, against ``jax.grad`` (plain K2 and eager)."""
    js, pj, rays, ts, pt, rays_t, nb = _case(name)

    def jax_loss(p, r):
        _, sens, _ = js.simulate(p, r, KEY, n_bundles=nb)
        return jnp.sum(sens.total_weight(0))

    def grad_wl(p, r):
        return jax.grad(lambda wl: jax_loss(p, r.replace(wavelength=wl)))(
            r.wavelength)
    ref = (_jax64(grad_wl, pj, rays) if name in X64
           else np.asarray(grad_wl(pj, rays)))
    assert np.abs(ref).max() > 0
    for sim in (ts.simulate, ts.simulate_fused):
        wl = rays_t.wavelength.clone().requires_grad_(True)
        _, sens, _ = sim(pt, rays_t.replace(wavelength=wl), nb)
        sens.total_weight(0).sum().backward()
        _close(wl.grad.numpy(), ref, rtol=2e-4,
               atol=1e-5 * np.abs(ref).max())


def test_normal_incidence_metal_gradient_matches_jax():
    """Rays exactly on the axis of an enhanced aluminium mirror meet it at
    normal incidence, where 1 - cos_i^2 sits on its clamp and the
    substrate's complex cosine on ``_c_sqrt``'s floor: the gradient of the
    reflected flux in the thicknesses, the ambient index and the rays'
    directions is finite and equal to JAX's."""
    zero = np.zeros(4, np.float32)
    arrays = dict(px=zero, py=zero, pz=np.full(4, -3.0, np.float32),
                  dx=zero, dy=zero, dz=np.ones(4, np.float32),
                  intensity=np.ones(4, np.float32),
                  ray_id=np.zeros(4, np.int32), wavelength=zero + WL)
    js, ts = _metal_seq(jrt, 'enhanced'), _metal_seq(trt, 'enhanced')
    pj = js.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    rays_j = JaxRays(**{k: jnp.asarray(v) for k, v in arrays.items()})

    def jax_loss(p, dx):
        _, sens, _ = js.simulate(p, rays_j.replace(dx=dx), KEY)
        return jnp.sum(sens.total_weight(0))
    gp, gdx = jax.grad(jax_loss, argnums=(0, 1))(pj, rays_j.dx)
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        p['mirror']['coat_d'] = p['mirror']['coat_d'].clone() \
            .requires_grad_(True)
        dx = torch.from_numpy(arrays['dx'].copy()).requires_grad_(True)
        rays = interop.rays_from_numpy(arrays, 'cpu').replace(dx=dx)
        _, sens, _ = sim(p, rays)
        sens.total_weight(0).sum().backward()
        g_coat = p['mirror']['coat_d'].grad.numpy()
        assert np.all(np.isfinite(g_coat)) and np.all(
            np.isfinite(dx.grad.numpy()))
        _close(g_coat, gp['mirror']['coat_d'], rtol=1e-4, atol=1e-6)
        _close(dx.grad.numpy(), gdx, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('coating', ['quarter_wave', 'v_coat'])
def test_coated_ghost_matches_jax(coating):
    """A ghost of a coated singlet (the V-coat's glass-side reflection is
    read in reverse): its REFLECT_W and FRESNEL_W rows take the coated R,
    the metadata copied by ``_meta_with_ph``; the eager ghost trace and
    K1's plain version on the ghost table against the JAX package's, and on
    the quarter-wave coat the flux gradient in the thickness."""
    stack = V_COAT if coating == 'v_coat' else [(NC, QW)]
    js = _singlet(jrt, False, stack)
    ts = _singlet(trt, False, stack)
    pj = js.init_params()
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    rays = js.sample_rays(jax.random.PRNGKey(4),
                          _bundles(jrt, N, 3.0, -10.0))
    rays_t = interop.rays_from_numpy(_np(rays), 'cpu')
    out_j, sens_j, _ = jghosts.ghost_trace(js, pj, rays, KEY, (0, 1))
    out_t, sens_t, _ = ghosts.ghost_trace(ts, pt, rays_t, (0, 1))
    _assert_rays_close(out_t, out_j)
    table, meta = ghosts.ghost_table(ts, pt, (0, 1))
    assert sorted(m.n_coat for m in meta if m.ph in (8, 9)) == \
        [0] + [len(stack)] * 4
    out_f, _ = trt.trace_sequential_fused(table, rays_t, ts.sensor_config(),
                                          meta)
    torch.testing.assert_close(out_f.intensity, out_t.intensity, rtol=0,
                               atol=0)
    if coating == 'v_coat':
        return

    def jax_flux(p):
        out, _, _ = jghosts.ghost_trace(js, p, rays, KEY, (0, 1))
        return jnp.sum(out.intensity)
    ref = np.asarray(jax.grad(jax_flux)(pj)['lens']['coat_d'])
    p = {el: dict(v) for el, v in pt.items()}
    p['lens']['coat_d'] = p['lens']['coat_d'].clone().requires_grad_(True)
    out, _, _ = ghosts.ghost_trace(ts, p, rays_t, (0, 1))
    out.intensity.sum().backward()
    _close(p['lens']['coat_d'].grad.numpy(), ref, rtol=1e-4,
           atol=1e-4 * np.abs(ref).max())


# ---- non-sequential traces ----

def _telescope(rt, coating=ENHANCED, n_bounces=8, corrector=True):
    """examples/11_telescope_metal_optics.py's scene (without its corrector:
    the primary and the sensor, 2 bounces a ray)."""
    return rt.Scene([
        _lib(rt).ParabolicMirror(c1=-0.001, d=200.0,
                                 translation=[0, 0, 500.0], metal='Al',
                                 coating=coating, coating_grad=True,
                                 c1_grad=True, name='primary'),
        rt.SingletLens(c1=0.0004, c2=-0.0004, d=120.0, t=5.0,
                       translation=[0, 0, 100.0], name='corrector',
                       **_glass(rt)('N-BK7', model='sellmeier')),
        rt.SensorElement(radius=40.0, translation=[0, 0, 1.0], name='ccd'),
    ][slice(None) if corrector else slice(0, 3, 2)], n_bounces=n_bounces)


def _nonseq_case(name, n=N, n_bounces=8, corrector=True):
    """A non-sequential case.  The telescope is lit over a 12 mm disk: its
    reflected rays' |A| stays under SOLVER_EPS, where the paraboloid's other
    root is the exact linear one; over example 11's 50 mm, ~5% of rays meet
    a float32 root ~0.01 mm off the mirror, in the JAX package as in the
    port (ROADMAP Queue 3), and diverge on rounding."""
    if name == 'telescope':
        make = lambda rt: _telescope(  # noqa: E731
            rt, n_bounces=n_bounces, corrector=corrector)
        bundles = _bundles(jrt, n, 12.0, 2.0, (WL,))
    elif name == 'mangin':
        make = lambda rt: rt.Scene(  # noqa: E731
            list(_metal_seq(rt, 'mangin').elements), n_bounces=n_bounces)
        bundles = _bundles(jrt, n, 10.0, -3.0)
    else:
        make = lambda rt: rt.Scene(  # noqa: E731
            list(_singlet(rt, 'weighted', V_COAT).elements),
            n_bounces=n_bounces)
        bundles = _bundles(jrt, n, 4.0, -10.0)
    js, ts = make(jrt), make(trt)
    pj = js.init_params()
    rays = js.sample_rays(jax.random.PRNGKey(7), bundles)
    return (js, pj, rays, ts, interop.params_from_numpy(_np(pj), 'cpu'),
            interop.rays_from_numpy(_np(rays), 'cpu'))


@pytest.mark.parametrize('name', ['telescope', 'mangin', 'v_coat_scene'])
def test_nonsequential_matches_jax(name):
    """The eager ``Scene.simulate`` and K5's plain version against the JAX
    XLA bounce loop: the rays and the moments.  On the Mangin mirror the
    repeated front row is geometrically the first, and both packages let
    the first of equal distances win."""
    js, pj, rays, ts, pt, rays_t = _nonseq_case(name)
    if name == 'v_coat_scene':
        out_j, sens_j, _ = js.simulate(pj, rays, KEY)
    else:
        out_j, sens_j = _jax64(lambda p, r: js.simulate(p, r, KEY)[:2], pj,
                               rays)
    meta = ts.static_meta()
    assert fused_trace.coating_kinds(meta)
    flat = trt.flatten_table_rows(ts.build_table(pt)).detach()
    cfg = ts.sensor_config()
    maps = fused_trace.plate_maps(meta, None)
    plain = fused_nonseq.trace_nonseq_fused_plain(flat, rays_t, cfg, meta,
                                                  ts.n_bounces, maps)
    for out_t, sens_t in (ts.simulate(pt, rays_t)[:2], plain):
        _assert_rays_close(out_t, out_j, scale=500.0)
        _close(sens_t.moments.detach().numpy(), sens_j.moments, rtol=1e-4,
               atol=1e-3)


@pytest.mark.parametrize('name', ['telescope', 'mangin'])
def test_nonsequential_gradients_match_jax(name):
    """``Scene.simulate_fused`` (K5's and K6's plain versions) and the
    eager loop: the gradient of the sensor flux and spot in the primary's
    thicknesses and curvature (the telescope without its corrector: 2
    bounces a ray) and in the Mangin's glass index (the metal's ambient)
    and back curvature, against ``jax.grad`` of the JAX XLA loop in
    float64, 4 bounces."""
    js, pj, rays, ts, pt, rays_t = _nonseq_case(name, n_bounces=4,
                                                corrector=False)
    trained = ((('primary', 'coat_d'), ('primary', 'c'))
               if name == 'telescope' else
               (('mirror', 'ior_glass'), ('mirror', 'c2')))

    def jax_loss(p, r):
        _, sens, _ = js.simulate(p, r, KEY)
        return jnp.sum(sens.total_weight(0)) / N + jnp.sum(
            sens.spot_rms(0))
    g = _jax64(lambda p, r: jax.grad(jax_loss)(p, r), pj, rays)
    ref = [np.asarray(g[el][k]) for el, k in trained]
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        for el, k in trained:
            p[el][k] = p[el][k].clone().requires_grad_(True)
        _, sens, _ = sim(p, rays_t)
        (sens.total_weight(0).sum() / N + sens.spot_rms(0).sum()
         ).backward()
        for (el, k), r in zip(trained, ref):
            assert np.abs(r).max() > 0
            _close(p[el][k].grad.numpy(), r, rtol=1e-4,
                   atol=1e-4 * np.abs(r).max(), err_msg=f'{el}.{k}')


# ---- routing and refusals ----

def test_routing_bits_and_side_buffer():
    """``kind_rows`` carries a coated or metal row's layer count and flags
    from COAT_SHIFT on, above the dispersion bits; ``coat_side`` its
    extinction and a dispersive metal's knots; a stack on a SNELL row does
    not act (no bits, no coated instantiation)."""
    sc = trt.Scene([
        trt.SingletLens(c1=0.05, c2=-0.05, d=10., t=3.,
                        fresnel='weighted', coating=ABSORBING, name='a',
                        **trt.glass('N-BK7', model='sellmeier')),
        trt.SphericalMirror(c1=-0.01, d=40., metal='Au',
                            metal_dispersion=True, translation=[0, 0, 50.],
                            name='m'),
        trt.SensorElement(radius=30., translation=[0, 0, -5.], name='s')])
    meta = sc.static_meta()
    rows = fused_trace.kind_rows(meta, sc.sensor_config())
    ph = [r[0] for r in rows]
    shift = fused_trace.COAT_SHIFT
    assert (ph[0] >> shift) == 3 | fused_trace.COAT_ABSORBING
    assert (ph[0] & 0xff) == 8 and ((ph[0] >> 8) & 0xf) != 0
    assert (ph[3] >> shift) == (fused_trace.COAT_METAL
                                | fused_trace.COAT_METAL_NK)
    assert ph[2] >> shift == 0                     # the edge
    side = fused_trace.coat_side(meta, 'cpu')
    assert side.shape == (len(meta), fused_trace.COAT_SIDE)
    _close(side[0, :3].numpy(), [0.0, 3.6, 0.0])
    _close(side[3, 8:].numpy(), np.float32(sum(map(list,
                                                   trt.METAL_NK['AU']), [])))
    snell = trt.SequentialScene([trt.SingletLens(
        c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS, coating=V_COAT,
        name='l')])
    assert not fused_trace.coating_kinds(snell.static_meta())
    assert fused_trace.coat_side(snell.static_meta(), 'cpu') is None
    cols = fused_trace.grad_cols((), True, True, True)
    assert cols[-8:] == fused_trace.COAT_GRAD_COLS
    assert len(set(cols)) == len(cols)


def test_remaining_refusals():
    """Rough mirrors and the SCATTER kind still raise NotImplementedError
    naming their ROADMAP item (JONES traces with the field); a coating on an
    ideal
    reflector and a dispersive unnamed metal raise ValueError, as in the
    JAX package."""
    with pytest.raises(NotImplementedError, match='Queue 1 item 14'):
        trt.SphericalMirror(c1=-0.01, d=10., roughness=0.01)
    with pytest.raises(NotImplementedError):
        trt.ParabolicMirror(c1=-0.01, d=10., metal='Al', roughness=0.01)
    why = unsupported(StaticRowMeta(10, 0, 0))
    assert why is not None and 'ROADMAP Queue 1 item 14' in why
    # JONES traces with the polarized field now (tests/test_torch_field.py)
    assert unsupported(StaticRowMeta(11, 0, 0)) is None
    with pytest.raises(ValueError, match='metal substrate'):
        trt.ConicMirror(c1=-0.01, k=-1.0, d=10., coating=[(NC, 0.1)])
    with pytest.raises(ValueError, match='NAMED metal'):
        trt.ConicMirror(c1=-0.01, k=-1.0, d=10., metal=(1.0, 5.0),
                        metal_dispersion=True)
    with pytest.raises(ValueError, match='at most 8'):
        trt.SingletLens(c1=0.05, c2=-0.05, d=10., t=3., ior_glass=NS,
                        coating=EIGHT + [(NC, 0.1)])


def test_per_face_coat_d_trains_with_fit():
    """A doublet's per-face ``coat_d`` dict trains with ``fit``: each face's
    vector is a leaf, masked by the element's ``coating_grad``."""
    sc = trt.SequentialScene([_lenses(trt)['doublet_per_face'],
                              trt.SensorElement(radius=20., translation=[
                                  0, 0, 80.], name='s')])
    rays = sc.sample_rays(torch.Generator().manual_seed(0), 'cpu',
                          _bundles(trt, 200, 6.0, -10.0))

    def loss(p):
        _, sens, _ = sc.simulate(p, rays)
        return -sens.total_weight(0).sum() / 200
    p0 = sc.init_params('cpu')
    p, losses = trt.fit(loss, p0, trainable=sc.trainable(), steps=3,
                        lr=1e-3)
    assert float(losses[-1]) <= float(losses[0])
    moved = [float((p['m']['coat_d'][f] - p0['m']['coat_d'][f]).abs().max())
             for f in ('0', '1', '2')]
    assert all(m > 0 for m in moved)
    assert torch.equal(p['m']['c1'], p0['m']['c1'])
