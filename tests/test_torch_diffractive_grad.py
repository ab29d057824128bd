"""The diffractive and ideal elements in the PyTorch port against the JAX
package, on the CPU, part two: gradients through the eager traces and the
fused traces' plain versions (K2's and K6's functions) against ``jax.grad``
of the JAX traces (the sequential chain and the XLA bounce loop), the
plain K1 and K2 against the JAX kernels in interpret mode once (a DOE
row's ff columns and the wavelength's cotangent included), the anchors of
tests/test_doe.py, tests/test_grating.py and tests/test_mla.py in the
port, the bundle limits and the kinds still refused.

Scenes and rays as tests/test_torch_diffractive.py.  Tolerances, each with
its reason: parameter gradients rtol 1e-4 of the leaf's scale, the rays'
wavelength gradient rtol 2e-4 / atol 1e-4 of its scale (float32 adjoints
summed in another order); the JAX kernels in interpret mode per ray rtol
2e-4 / atol 1e-5 and the table rtol 1e-4 / atol 1e-5 of the stream's or
field's scale where that exceeds 1, each ff column to its own scale, as
tests/test_torch_fused_grad.py; the anchors the JAX tests' own.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.ops.pallas_trace import (trace_sequential_pallas_v2,
                                               trace_sequential_pallas_v2_bwd)
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.static_dispatch import (StaticRowMeta,
                                                          unsupported)
from raytracetorch_tpu_torch.core.table import ROW_FIELDS, ROW_OFFSETS
from raytracetorch_tpu_torch.ops import fused_trace
from test_torch_diffractive import CASES, KEY, _close, _np, _port

torch.set_num_threads(2)

@pytest.mark.parametrize('case', ['hybrid', 'scene'])
def test_trace_gradients_match_jax(case):
    """The gradient of the spot loss in each element's parameters (the DOE's
    phase, the grating's period, the lenslets' pitch and f, the thin lens's
    P, the singlets' curvatures) and the rays' wavelength, through the
    eager trace and the fused one's plain versions (K2's and K6's
    functions), against ``jax.grad`` of the JAX trace (rtol 1e-4 of the
    leaf's scale)."""
    js, ts, rays, nb = CASES[case]()
    pt, rays_t = _port(js, rays)
    trained = [(el, k) for el, d in js.trainable().items()
               for k, v in d.items() if v is True and k not in ('trans',)]

    def jax_loss(p, wl):
        _, sens, _ = js.simulate(p, rays.replace(wavelength=wl), KEY,
                                 n_bundles=nb)
        return jnp.sum(sens.spot_rms(0) ** 2) + jnp.sum(
            sens.total_weight(0)) / rays.n
    gp, gw = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(js.init_params(),
                                                         rays.wavelength)
    for sim in (ts.simulate, ts.simulate_fused):
        p = {el: dict(v) for el, v in pt.items()}
        for el, k in trained:
            p[el][k] = p[el][k].clone().requires_grad_(True)
        wl = rays_t.wavelength.clone().requires_grad_(True)
        _, sens, _ = sim(p, rays_t.replace(wavelength=wl), nb)
        (sens.spot_rms(0) ** 2).sum().add(
            sens.total_weight(0).sum() / rays_t.n).backward()
        for el, k in trained:
            ref = np.asarray(gp[el][k])
            assert np.abs(ref).max() > 0, (el, k)
            _close(p[el][k].grad.numpy(), ref, rtol=1e-4,
                   atol=1e-4 * np.abs(ref).max(), err_msg=f'{el}.{k}')
        ref = np.asarray(gw)
        _close(wl.grad.numpy(), ref, rtol=2e-4,
               atol=1e-4 * max(np.abs(ref).max(), 1e-12))


def test_plain_k1_k2_match_jax_kernels():
    """K1's and K2's plain versions on tests/test_doe.py's fused-parity DOE
    (two radial terms, its efficiency) against ``trace_sequential_pallas_v2``
    and its backward in interpret mode, on three wavelengths: the rays, the
    moments, and the ray, wavelength and table cotangents (the DOE's ff
    columns included) under numpy-seeded cotangents."""
    js = jrt.SequentialScene([
        jrt.DiffractiveLens(radius=10.0, coeffs=[-8.0, 0.02],
                            efficiency=True, name='doe'),
        jrt.SensorElement(radius=50.0, translation=[0, 0, 40.0], name='s')])
    nb = 3
    rays = js.sample_rays(jax.random.PRNGKey(5), [
        (jrt.CollimatedDisk.make(radius=jnp.float32(6.0), ray_id=j,
                                 translation=[0, 0, -5.0], wavelength=wl), 32)
        for j, wl in enumerate((0.48, 0.5876, 0.65))])
    pt, rays_t = _port(js, rays)
    table_j = js.build_table(js.init_params())
    table = interop.table_from_numpy(_np(table_j), 'cpu')
    meta = interop.meta_from_slots(js.static_meta())
    cfg = trt.SensorConfig(n_sensors=1, n_bundles=nb)
    cfg_j = js.sensor_config(n_bundles=nb)
    flat = trt.flatten_table_rows(table)
    maps = fused_trace.plate_maps(meta, None)
    out_j, sens_j, _ = trace_sequential_pallas_v2(
        table_j, rays, KEY, cfg_j, js.static_meta(), interpret=True,
        block_rows=2)
    out_t, sens_t = fused_trace.trace_sequential_fused_plain(
        flat, rays_t, cfg, meta, maps)
    for c in fused_trace.COMPS:
        _close(getattr(out_t, c).numpy(), getattr(out_j, c), rtol=1e-5,
               atol=2e-5 * 40.0 if c[0] == 'p' else 2e-6, err_msg=c)
    _close(sens_t.moments.numpy(), sens_j.moments, rtol=1e-4, atol=1e-3)
    rng = np.random.default_rng(7)
    n = rays_t.n
    g_rays = [rng.standard_normal(n).astype(np.float32)
              for _ in fused_trace.COMPS]
    g_mom = rng.standard_normal((1, nb, 7)).astype(np.float32)
    ct_table, ct = trace_sequential_pallas_v2_bwd(
        table_j, rays, KEY, cfg_j, js.static_meta(),
        JaxRays(*g_rays, ray_id=np.asarray(rays.ray_id),
                wavelength=np.zeros(n, np.float32)),
        g_mom, interpret=True, block_rows=2)
    g_flat, g_in, _, g_wl = fused_trace.trace_seq_bwd_plain(
        flat, rays_t, cfg, meta, [torch.from_numpy(g) for g in g_rays],
        torch.from_numpy(g_mom), maps=maps, need_wavelength=True)
    for c, g in zip(fused_trace.COMPS, g_in):
        scale = max(1.0, float(np.abs(np.asarray(ct[c])).max()))
        _close(g.numpy(), ct[c], rtol=2e-4, atol=1e-5 * scale, err_msg=c)
    ref = np.asarray(ct['wavelength'])
    assert np.abs(ref).max() > 0
    _close(g_wl.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    k = g_flat.shape[0]
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(ct_table, name))
        if not np.issubdtype(ref.dtype, np.inexact):
            continue
        ref = ref.reshape(k, -1)
        off = ROW_OFFSETS[name]
        got = g_flat[:, off:off + ref.shape[1]].numpy()
        cols = range(ref.shape[1]) if name == 'ff' else [None]
        for j in cols:
            r_, g_ = (ref, got) if j is None else (ref[:, j], got[:, j])
            scale = max(1.0, float(np.abs(r_).max()))
            _close(g_, r_, rtol=1e-4, atol=1e-5 * scale, err_msg=(name, j))
    ff = g_flat[:, list(fused_trace.FF_GRAD_COLS)]
    assert float(ff[:, :2].abs().amax(0).min()) > 0
    outside = [c for c in range(g_flat.shape[1]) if c not in
               fused_trace.grad_cols((), True, False, True, True)]
    assert float(g_flat[:, outside].abs().max()) == 0.0


# ---- the JAX tests' anchors, in the port ----

F0, LAM0 = 100.0, 0.5876


def _rays(pos, d, wl=None):
    pos = torch.tensor(pos, dtype=torch.float32)
    d = torch.tensor(d, dtype=torch.float32)
    kw = {} if wl is None else dict(
        wavelength=torch.full((pos.shape[0],), float(wl)))
    return trt.Rays.create(pos, d, **kw)


def _heights(x0s, wavelength=0.0):
    return _rays([[x, 0.0, -5.0] for x in x0s], [[0.0, 0.0, 1.0]] * len(x0s),
                 wavelength)


def _crossing(out, i=0):
    return float(-out.px[i] / out.dx[i] * out.dz[i] + out.pz[i])


@pytest.mark.parametrize('fused', [False, True])
def test_doe_anchors(fused):
    """tests/test_doe.py: the exact momentum mapping, P(lam) = P0 lam /
    lam0 (Abbe number -3.452), the hybrid split's >20x smaller chromatic
    shift, the kinoform efficiency, the phase gradient 2 m lam_mm x0; on
    the eager and the fused trace (the plain versions here)."""
    def sim(sc, rays, p=None):
        p = sc.init_params('cpu') if p is None else p
        return (sc.simulate_fused if fused else sc.simulate)(p, rays)
    sc = trt.SequentialScene([
        trt.DiffractiveLens(radius=10.0, f=F0, name='doe'),
        trt.SensorElement(radius=50.0, translation=[0, 0, 60.0], name='s')])
    x0s = [0.5, 2.0, -4.0, 8.0]
    out, _, _ = sim(sc, _heights(x0s))
    for i, x0 in enumerate(x0s):
        px = -x0 / F0
        pz = math.sqrt(1.0 - px * px)
        assert float(out.dx[i]) == pytest.approx(px, rel=1e-6)
        assert float(out.px[i]) == pytest.approx(x0 + 60.0 * px / pz,
                                                 rel=1e-5)
    crossings = {}
    for lam in (0.4861, 0.5876, 0.6563):
        sc1 = trt.SequentialScene([trt.DiffractiveLens(radius=10.0, f=F0,
                                                       name='doe')])
        crossings[lam] = _crossing(sim(sc1, _heights([3.0], lam))[0])
    assert crossings[0.5876] == pytest.approx(F0 * math.sqrt(1 - 0.03 ** 2),
                                              rel=1e-4)
    P = {k: 1.0 / v for k, v in crossings.items()}
    assert P[0.5876] / (P[0.4861] - P[0.6563]) == pytest.approx(
        0.5876 / (0.4861 - 0.6563), rel=1e-3)

    v_r, v_d = 64.17, 0.5876 / (0.4861 - 0.6563)

    def singlet(f_r):
        c = 1.0 / (2.0 * (1.5168 - 1.0) * f_r)
        return trt.SingletLens(c1=c, c2=-c, d=16.0, t=0.8, ior_glass=1.5168,
                               abbe_vd=v_r, name='lens')

    def crossing(elements, lam):
        return _crossing(sim(trt.SequentialScene(list(elements)),
                             _heights([1.0], lam))[0])
    shift_singlet = abs(crossing([singlet(80.0)], 0.4861)
                        - crossing([singlet(80.0)], 0.6563))
    assert shift_singlet == pytest.approx(80.0 / v_r, rel=0.05)
    p_ = 1.0 / 80.0
    hybrid = [singlet(1.0 / (p_ * v_r / (v_r - v_d))),
              trt.DiffractiveLens(radius=10.0, f=1.0 / (p_ * v_d / (v_d - v_r)),
                                  translation=[0, 0, 2.0], name='doe')]
    assert abs(crossing(hybrid, 0.4861) - crossing(hybrid, 0.6563)) \
        < shift_singlet / 20.0
    assert crossing(hybrid, 0.5876) == pytest.approx(80.0, rel=0.05)

    sce = trt.SequentialScene([trt.DiffractiveLens(
        radius=10.0, f=F0, efficiency=True, name='doe')])
    assert float(sim(sce, _heights([1.0], LAM0))[0].intensity[0]) == \
        pytest.approx(1.0, abs=1e-6)
    eta = (math.sin(0.2 * math.pi) / (0.2 * math.pi)) ** 2
    assert float(sim(sce, _heights([1.0], LAM0 / 1.2))[0].intensity[0]) == \
        pytest.approx(eta, rel=1e-5)
    assert float(sim(sce, _heights([1.0], LAM0 / 2.0))[0].intensity[0]) == \
        pytest.approx(0.0, abs=1e-6)

    scg = trt.SequentialScene([trt.DiffractiveLens(
        radius=10.0, f=F0, phase_grad=True, name='doe')])
    p = scg.init_params('cpu')
    p['doe']['phase'].requires_grad_(True)
    out, _, _ = sim(scg, _heights([2.0], LAM0), p)
    out.dx[0].backward()
    assert float(p['doe']['phase'].grad[0]) == pytest.approx(
        2.0 * LAM0 * 1e-3 * 2.0, rel=1e-4)


@pytest.mark.parametrize('fused', [False, True])
def test_grating_anchors(fused):
    """tests/test_grating.py: the grating equation at normal and oblique
    incidence and order -2, the reflective fold, the evanescent order's
    zero intensity, order 0 transmitting, d sin / d period = -m lam /
    period^2."""
    def trace(period, order=1, wl=0.55, theta=0.0, refl=False, grad=False):
        sc = trt.SequentialScene([trt.DiffractionGrating(
            period_um=period, order=order, reflective=refl, name='g')])
        d = [math.sin(theta), 0.0, math.cos(theta)]
        p = sc.init_params('cpu')
        if grad:
            p['g']['period_um'].requires_grad_(True)
        r = _rays([[-10.0 * d[0], 0.0, -10.0 * d[2]]], [d], wl)
        out = (sc.simulate_fused if fused else sc.simulate)(p, r)[0]
        return out, p
    for wl in (0.45, 0.55, 0.65):
        out, _ = trace(2.0, wl=wl)
        assert float(out.dx[0]) == pytest.approx(wl / 2.0, rel=1e-5)
        assert float(torch.sqrt(out.dx ** 2 + out.dy ** 2 + out.dz ** 2)[0]) \
            == pytest.approx(1.0, abs=1e-6)
    out, _ = trace(1.6, order=-2, wl=0.5, theta=0.3)
    assert float(out.dx[0]) == pytest.approx(math.sin(0.3) - 2 * 0.5 / 1.6,
                                             rel=1e-5)
    out, _ = trace(2.0, refl=True)
    assert float(out.dz[0]) < 0
    assert float(out.dx[0]) == pytest.approx(0.55 / 2.0, rel=1e-5)
    out, _ = trace(0.4)
    assert float(out.intensity[0]) == 0.0
    out, _ = trace(2.0, order=0, theta=0.2)
    assert float(out.dx[0]) == pytest.approx(math.sin(0.2), abs=1e-6)
    out, p = trace(2.0, wl=0.6, grad=True)
    out.dx[0].backward()
    assert float(p['g']['period_um'].grad) == pytest.approx(-0.6 / 4.0,
                                                           rel=1e-5)


@pytest.mark.parametrize('fused', [False, True])
def test_mla_anchors(fused):
    """tests/test_mla.py: every collimated ray lands on its cell's center
    at z = f, a tilted beam f * s off the centers, d(spot x)/df = (x0 -
    xc) / f; and the non-sequential Scene lands as the sequential one."""
    pitch, f = 1.0, 20.0

    def scene(**kw):
        return trt.SequentialScene([
            trt.MicrolensArray(half_x=5.0, half_y=5.0, pitch=pitch, f=f,
                               name='mla', **kw),
            trt.SensorElement(radius=20.0, translation=[0, 0, f], name='s')])

    def beam(xs, ys, sx=0.0, sy=0.0):
        nrm = 1.0 / math.sqrt(1.0 + sx * sx + sy * sy)
        return _rays([[x - 4.0 * sx, y - 4.0 * sy, -4.0]
                      for x, y in zip(xs, ys)],
                     [[sx * nrm, sy * nrm, nrm]] * len(xs))

    def sim(sc, rays, p=None):
        p = sc.init_params('cpu') if p is None else p
        return (sc.simulate_fused if fused else sc.simulate)(p, rays)
    xs = np.asarray([0.1, 0.44, -0.44, 1.2, 2.49, -3.3, 0.0])
    ys = np.asarray([0.0, 0.2, -1.4, 2.1, -0.3, 1.9, 3.49])
    out = sim(scene(), beam(xs, ys))[0]
    _close(out.px.numpy(), pitch * np.floor(xs / pitch + 0.5), atol=2e-6)
    _close(out.py.numpy(), pitch * np.floor(ys / pitch + 0.5), atol=2e-6)
    sx, sy = 0.012, -0.007
    xs, ys = np.asarray([0.2, 1.1, -2.3]), np.asarray([0.3, -0.9, 1.8])
    out = sim(scene(), beam(xs, ys, sx, sy))[0]
    _close(out.px.numpy(), pitch * np.floor(xs / pitch + 0.5) + f * sx,
           atol=3e-6)
    _close(out.py.numpy(), pitch * np.floor(ys / pitch + 0.5) + f * sy,
           atol=3e-6)
    sc = scene(f_grad=True)
    p = sc.init_params('cpu')
    p['mla']['f'].requires_grad_(True)
    out = sim(sc, beam([0.2], [0.0], sx=0.015), p)[0]
    out.px[0].backward()
    assert float(p['mla']['f'].grad) == pytest.approx(0.2 / f, rel=1e-3)
    ns = trt.Scene([
        trt.MicrolensArray(half_x=5.0, half_y=5.0, pitch=pitch, f=f,
                           translation=[0, 0, 10.0], name='mla'),
        trt.SensorElement(radius=20.0, translation=[0, 0, 10.0 + f],
                          name='s')], n_bounces=3)
    rays = trt.CollimatedDisk.make(radius=4.0, translation=[0, 0, -5.0]) \
        .sample(torch.Generator().manual_seed(0), 700, 'cpu')
    out = (ns.simulate_fused if fused else ns.simulate)(
        ns.init_params('cpu'), rays)[0]
    xc = pitch * torch.floor(rays.px / pitch + 0.5)
    assert float((out.px - xc).abs().max()) < 2e-5


@pytest.mark.parametrize('fused', [False, True])
def test_ideal_element_anchors(fused):
    """tests/test_elements.py: d(zi)/d(zo) = -(zi / zo)^2 through an
    IdealThinLens Scene, the cylindrical lens's power on y alone, the
    IdealMirror's paraxial power -2/R, its LINEAR map leaving towards +z
    (unfolded, as in the JAX package), and the rotated inverted elliptic
    stop passing along its major axis and blocking along its minor."""
    f = 50.0
    sc = trt.Scene([trt.IdealThinLens(focal=f, name='lens')], n_bounces=2)
    p = sc.init_params('cpu')
    sim = sc.simulate_fused if fused else sc.simulate
    zo = torch.tensor(75.0, requires_grad=True)
    pos = torch.stack([torch.zeros(2), torch.zeros(2), -zo.expand(2)], 1)
    rays = trt.Rays.create(pos, torch.tensor([[0.0, 0.0, 1.0],
                                              [0.0, 0.05, 1.0]]))
    out = sim(p, rays)[0]
    t = -out.py[1] / out.dy[1]
    zi = out.pz[1] + t * out.dz[1]
    zi_theory = 1.0 / (1.0 / f - 1.0 / 75.0)
    assert float(zi.detach()) == pytest.approx(zi_theory, rel=1e-4)
    zi.backward()
    assert float(zo.grad) == pytest.approx(-(zi_theory / 75.0) ** 2,
                                           rel=1e-3)
    cyl = trt.Scene([trt.IdealCylThinLens(focal_x=1e9, focal_y=50.0,
                                          name='cl')], n_bounces=2)
    out = (cyl.simulate_fused if fused else cyl.simulate)(
        cyl.init_params('cpu'), _rays([[0.0, 1.0, -10.0], [1.0, 0.0, -10.0]],
                                      [[0.0, 0.0, 1.0]] * 2))[0]
    assert float(out.dy[0] / out.dz[0]) == pytest.approx(-1.0 / 50.0,
                                                         rel=1e-4)
    assert abs(float(out.dx[1])) < 1e-6
    m = trt.IdealMirror(radius_x=100.0, radius_y=100.0, name='im')
    assert float(m.paraxial(m.init_params('cpu'))[1][0][1, 0]) == \
        pytest.approx(-2.0 / 100.0, rel=1e-6)
    ms = trt.SequentialScene([trt.IdealMirror(radius_x=100.0,
                                              radius_y=100.0, name='im')])
    out = (ms.simulate_fused if fused else ms.simulate)(
        ms.init_params('cpu'), _rays([[0.0, 1.0, -10.0]],
                                     [[0.0, 0.0, 1.0]]))[0]
    assert float(out.dz[0]) > 0 and float(out.dy[0]) < 0
    ell = trt.Scene([trt.EllipticAperture(
        r_major=2.0, r_minor=1.0, rot=math.pi / 2, invert=True,
        translation=[0.0, 0.0, 5.0], name='ell')], n_bounces=2)
    out = (ell.simulate_fused if fused else ell.simulate)(
        ell.init_params('cpu'), _rays([[0.0, 1.8, 0.0], [1.8, 0.0, 0.0]],
                                      [[0.0, 0.0, 1.0]] * 2))[0]
    assert out.intensity.tolist() == [1.0, 0.0]


# ---- limits and refusals ----

def test_bundle_limits():
    """The fused kernels take 18 bundles (the JAX kernels' n_bundles * 7 <=
    128) and refuse 19; the non-sequential ones refuse more than 64 (slot,
    bundle) moment sums with their own error, before anything runs."""
    sc = chip_smoke.spectrometer_scene(trt)
    p = sc.init_params('cpu')
    gen = torch.Generator().manual_seed(0)
    bundles = [(trt.CollimatedDisk.make(radius=2.0, ray_id=j,
                                        wavelength=0.45 + 0.01 * j,
                                        translation=[0, 0, -5.0]), 8)
               for j in range(19)]
    rays = trt.sample_bundles(gen, bundles[:18], 'cpu')
    out, sens, _ = sc.simulate_fused(p, rays, 18)
    _, ref, _ = sc.simulate(p, rays, 18)
    assert sens.moments.shape == (1, 18, 7)
    _close(sens.moments.numpy(), ref.moments.numpy(), rtol=1e-5, atol=1e-4)
    assert float(sens.moments[0, :, 0].min()) > 0
    with pytest.raises(NotImplementedError, match='1..18 bundles'):
        sc.simulate_fused(p, trt.sample_bundles(gen, bundles, 'cpu'), 19)
    ns = trt.Scene(list(sc.elements), n_bounces=4)
    ns.simulate_fused(p, rays, 18)            # 1 slot x 18 bundles
    many = trt.Scene(list(sc.elements) + [
        trt.SensorElement(radius=30.0, translation=[0, 0, 100.0 + j],
                          name=f'extra{j}') for j in range(3)], n_bounces=4)
    pm = many.init_params('cpu')
    with pytest.raises(NotImplementedError, match='64'):
        many.simulate_fused(pm, rays, 18)     # 4 slots x 18 bundles
    many.simulate(pm, rays, 18)               # the eager loop has no limit


@pytest.mark.parametrize('meta', [
    dict(ph=12, sb=1, vb=0, plane=True, grin_steps=64),   # GRIN
    dict(ph=10, sb=0, vb=0),                   # SCATTER
    dict(ph=10, sb=6, vb=5),                   # SCATTER on a solid cone
    dict(ph=11, sb=0, vb=0),                   # JONES
])
def test_refused_kinds_name_their_item(meta):
    """SCATTER rows still raise NotImplementedError naming their ROADMAP
    item, eagerly and in the fused traces, whatever their bounds (SCATTER
    scenes: tests/test_torch_coated_trace.py; freeform faces trace now:
    tests/test_torch_freeform.py; the CONE_NAPPE and HALFSPACES bounds:
    tests/test_torch_solids.py).  A JONES row traces with the polarized
    field (tests/test_torch_field.py): the fused trace takes its kinds under
    the field and refuses it without, naming the field.  A GRIN row traces
    (tests/test_torch_grin.py): the fused trace takes its kinds, its RK4
    step count in the last column, under the field too, where a rod's
    fused trace equals its eager one (tests/test_torch_grin_field.py holds
    both to the JAX package)."""
    m = StaticRowMeta(**meta)
    cfg = trt.SensorConfig(n_sensors=0, n_bundles=1)
    if m.ph == trt.PhysKind.GRIN:
        assert unsupported(m) is None
        for field in (False, True):
            meta_t = fused_trace.TraceMeta([m], field=field)
            assert fused_trace.kind_rows(meta_t, cfg)[0] == [
                12, 1, 0, 1, 0, 0, 0, 64]
            assert fused_trace.families(meta_t) == fused_trace.FAM_GRIN
        sc = trt.SequentialScene([trt.GrinRod(radius=5.0, thickness=10.0,
                                              n_steps=8,
                                              translation=[0, 0, 5.0],
                                              name='rod')])
        p = sc.init_params('cpu')
        rays = trt.Rays.create(torch.tensor([[0.5, 0.2, -1.0]] * 4),
                               torch.tensor([[0.0, 0.0, 1.0]] * 4))
        f_f, f_e = (getattr(sc, sim)(p, rays, track_field=True,
                                     E0=[0.0, 1.0, 0.0])[2]['field']
                    for sim in ('simulate_fused', 'simulate'))
        for c in ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz'):
            torch.testing.assert_close(getattr(f_f, c), getattr(f_e, c),
                                       rtol=0, atol=1e-6)
        return
    if m.ph == trt.PhysKind.JONES:
        assert unsupported(m) is None
        assert fused_trace.kind_rows(
            fused_trace.TraceMeta([m], field=True), cfg)[0][0] == m.ph
        sc = trt.SequentialScene([trt.LinearPolarizer(radius=1.0,
                                                      name='p')])
        rays = trt.Rays.create(torch.zeros(4, 3),
                               torch.tensor([[0.0, 0.0, 1.0]] * 4))
        with pytest.raises(NotImplementedError, match='track_field'):
            fused_trace.flat_inputs(sc.build_table(sc.init_params('cpu')),
                                    rays, cfg, sc.static_meta())
        return
    why = unsupported(m)
    assert why is not None and 'ROADMAP' in why
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        fused_trace.kind_rows([m], cfg)


def test_doe_meta_needs_its_terms():
    """A DOE row without its static (terms, efficiency) is refused."""
    assert unsupported(StaticRowMeta(13, 1, 0)) is not None
    assert unsupported(StaticRowMeta(13, 1, 0, doe=(2, True))) is None
    assert unsupported(StaticRowMeta(13, 1, 0, doe=(9, True))) is not None
