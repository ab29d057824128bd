"""The polarized field in the non-sequential scene in the PyTorch port
against the JAX package, on the CPU: the eager ``Scene.simulate`` and the
plain version of the fused trace (``Scene.simulate_fused`` on CPU tensors,
the plain K5; on the FRESNEL scenes ``trace_nonseq_fused_plain`` fed the
JAX package's draws) with ``track_field`` against the JAX package's
``Scene.simulate(track_field=True)`` on the same rays, on the anchor scenes
of tests/test_pallas.py:667 (the mirror fold with a diagonal E0),
tests/test_polarization.py:133 (TIR), :152 (the Scene against the
SequentialScene), :207 and :233 (the polarized Brewster draw and its flux),
tests/test_coatings.py:239, :365 and :576 (a coated singlet, an aluminium
mirror and a dispersive one) and tests/test_polarization_optics.py:230
(JONES rows), the naive scene with a circular E0 and a light guide of
two flat aluminium walls whose rays live 16 bounces (chip_smoke.py
section 19's scenes, ``field_ns_scene``); the gradients in the mirror's c1
and in E0, eager and fused (the plain K6), against ``jax.grad``; the
refusals: the fused trace with the field on diffractive, fuzzy and
freeform rows (ROADMAP Queue 1 position 3c; the eager trace takes them),
a JONES row without the field, K6's shared memory; and an E0 without
``track_field`` changes nothing, sequential or not.

Tolerances, each with its reason: the six field streams and |E|^2 atol
1e-5 (float32 products of unit vectors through a few bounces, another
compiler's contractions); positions rtol 1e-6 + atol 1e-5 and directions
atol 2e-6 (as tests/test_torch_field_coat.py), intensities rtol 1e-5;
moments rtol 1e-4 + atol 1e-4 of their scale (sums in another order);
gradients rtol 1e-4 of the leaf's scale (float32 adjoints).  The aluminium
mirrors are held to the JAX package in float64 (``jax.enable_x64``): its
float32 complex square root cancels where the port's does not
(tests/test_torch_field_coat.py says why).  FRESNEL rows take the JAX
package's draws (rays/reference_prng.py), and a ray whose draw lies within
1e-5 of its R may take the other branch: at most 2 of a case's rays may,
and they are left out, with the moments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import chip_smoke as cs
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.field import FieldState
from raytracetorch_tpu_torch.ops import fused_nonseq
from raytracetorch_tpu_torch.ops import fused_trace as ft
from raytracetorch_tpu_torch.rays import reference_prng as rp

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
N = 600
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')
FRESNEL_FLIPS = 2


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _jax_draws(n, n_bounces, shift=0.0):
    """The JAX bounce loop's draws of FRESNEL row k at bounce b under KEY,
    ``uniform(fold_in(split(key, B)[b], k), (N,))``, moved by ``shift``."""
    keys = rp.split(rp.prng_key(0), n_bounces)

    def fn(b, k):
        u = rp.uniform(rp.fold_in(keys[b], k), n)
        return np.clip(u + shift, 0.0, 1.0 - 2 ** -24).astype(np.float32)
    return fn


def _case(name, n=N):
    """(JAX scene, port scene, JAX params, port params, JAX rays, port
    rays, E0) of a section 19 case on the rays of PRNGKey(3)."""
    js, ts = cs.field_ns_scene(jrt, name), cs.field_ns_scene(trt, name)
    rays_j = cs.field_ns_bundle(jrt, name).sample(jax.random.PRNGKey(3), n)
    pj = js.init_params()
    return (js, ts, pj, interop.params_from_numpy(_np(pj), 'cpu'), rays_j,
            interop.rays_from_numpy(_np(rays_j), 'cpu'),
            cs.field_ns_source(name)[4])


def _port_traces(ts, pt, rays, E0, draws=None):
    """The eager trace and the fused trace's plain version with the field:
    ``simulate_fused`` on the CPU, or with ``draws`` (the JAX package's,
    which K5 cannot take) ``trace_nonseq_fused_plain``."""
    if draws is None:
        return [ts.simulate(pt, rays, track_field=True, E0=E0),
                ts.simulate_fused(pt, rays, track_field=True, E0=E0)]
    meta = ft.TraceMeta(ts.static_meta(), None, True)
    flat = trt.flatten_table_rows(ts.build_table(pt))
    out, sens, aux = fused_nonseq.trace_nonseq_fused_plain(
        flat, rays, ts.sensor_config(), meta, ts.n_bounces,
        ft.plate_maps(meta, {}), draws=draws,
        field=FieldState.init(rays, E0).streams())
    return [ts.simulate(pt, rays, track_field=True, E0=E0, draws=draws),
            (out, sens, ft.field_aux(aux))]


def _stable(ts, pt, rays, E0, n_bounces):
    """The rays whose trace does not move when the JAX draws move by
    1e-5: the others' draws lie within it of their R."""
    def outcome(shift):
        out = ts.simulate(pt, rays, track_field=True, E0=E0,
                          draws=_jax_draws(rays.n, n_bounces, shift))[0]
        return torch.stack([out.pz, out.dz, out.intensity])
    return torch.isclose(outcome(-1e-5), outcome(1e-5), rtol=1e-4,
                         atol=1e-4).all(0).numpy()


def _flux(out, aux, keep=None):
    """Mean intensity * |E|^2 of the rays that leave forward (+z)."""
    w = (out.intensity * aux['field_power']).detach().double()
    fwd = (out.dz > 0) & (out.intensity > 0)
    if keep is not None:
        fwd &= torch.from_numpy(keep)
    return float(w[fwd].sum() / w.shape[0])


@pytest.mark.parametrize('name', ['fold', 'brewster_p', 'brewster_s',
                                  'brewster_45', 'jones', 'coated', 'al',
                                  'al_disp', 'naive', 'guide'])
def test_traces_match_jax(name):
    """The eager and the plain fused traces with the field against the JAX
    package's bounce loop: the rays, the final field, |E|^2 and the
    |E|^2-weighted moments and grid; on the Brewster plane the analytic
    anchors too (p: no ray reflects and Tp = 1; s: Ts = 1 - Rs within 5
    binomial standard errors)."""
    js, ts, pj, pt, rays_j, rays_t, E0 = _case(name)
    x64 = name.startswith('al') or name == 'guide'
    if x64:
        with enable_x64():
            res_j = _np(js.simulate(_to64(pj), _to64(rays_j), KEY,
                                    track_field=True, E0=E0))
    else:
        res_j = _np(js.simulate(pj, rays_j, KEY, track_field=True, E0=E0))
    out_j, s_j, aux_j = res_j
    fresnel = any(m.ph == trt.PhysKind.FRESNEL for m in ts.static_meta())
    draws = _jax_draws(N, ts.n_bounces) if fresnel else None
    keep = np.ones(N, bool)
    if fresnel:
        keep = _stable(ts, pt, rays_t, E0, ts.n_bounces)
        assert (~keep).sum() <= FRESNEL_FLIPS
    for out_t, s_t, aux_t in _port_traces(ts, pt, rays_t, E0, draws):
        for c in ('px', 'py', 'pz'):
            _close(getattr(out_t, c).detach()[keep],
                   getattr(out_j, c)[keep], rtol=1e-6, atol=1e-5,
                   err_msg=c)
        for c in ('dx', 'dy', 'dz'):
            _close(getattr(out_t, c).detach()[keep],
                   getattr(out_j, c)[keep], atol=2e-6, err_msg=c)
        _close(out_t.intensity.detach()[keep], out_j.intensity[keep],
               rtol=1e-5, atol=1e-7)
        for f in FIELDS:
            _close(getattr(aux_t['field'], f).detach()[keep],
                   getattr(aux_j['field'], f)[keep], atol=1e-5, err_msg=f)
        _close(aux_t['field_power'].detach()[keep],
               aux_j['field_power'][keep], atol=1e-5)
        if keep.all():
            scale = max(1.0, float(np.abs(s_j.moments).max()))
            _close(s_t.moments.detach(), s_j.moments, rtol=1e-4,
                   atol=1e-4 * scale)
            if ts.grid_shape:
                _close(s_t.grid.detach(), s_j.grid, rtol=1e-4,
                       atol=1e-4 * max(1.0, float(np.abs(s_j.grid).max())))
        if name == 'brewster_p':
            assert int(((out_t.dz < 0) & (out_t.intensity > 0)).sum()) == 0
            _close(_flux(out_t, aux_t), 1.0, atol=1e-5)
        if name == 'brewster_s':
            rs = cs.brewster_rs()
            _close(_flux(out_t, aux_t), 1.0 - rs,
                   atol=5.0 * math.sqrt(rs * (1.0 - rs) / N))


def test_tir_and_the_sequential_scene():
    """TIR in a 3-bounce Scene keeps unit power and reflects
    (tests/test_polarization.py:133); an ordered lens traced as a Scene
    reports the SequentialScene's transmitted power (:152); both against
    the JAX package."""
    def plane(rt):
        kinds = jrt.PhysKind if rt is jrt else trt.PhysKind
        import importlib
        sh = importlib.import_module(rt.__name__ + '.elements.shapes')
        return rt.Scene([rt.ElementCustom(sh.plane, 1, kinds.SNELL,
                                          ph=(1.0, 1.5), name='iface')],
                        n_bounces=3)
    theta = 0.9
    d = [0.0, math.sin(theta), math.cos(theta)]
    pos, E0 = [[0.0, -5.0 * d[1], -5.0 * d[2]]], [[1.0, 0.0, 0.0]]
    rays_j = jrt.Rays.create(pos, [d])
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    js, ts = plane(jrt), plane(trt)
    _, _, aux_j = js.simulate(js.init_params(), rays_j, KEY,
                              track_field=True, E0=E0)
    for sim in (ts.simulate, ts.simulate_fused):
        out, _, aux = sim(ts.init_params('cpu'), rays_t, track_field=True,
                          E0=E0)
        _close(aux['field_power'], 1.0, rtol=1e-5)
        _close(aux['field_power'], aux_j['field_power'], atol=1e-6)
        assert float(out.dz[0]) < 0

    def lens(rt):
        return rt.SingletLens(c1=0.016667, c2=-0.00283, d=25.4, t=4.0,
                              ior_glass=1.5, name='lens')
    rays_j = jrt.Rays.create([[0.0, 0.5, -10.0]], [[0.0, 0.0, 1.0]])
    rays_t = interop.rays_from_numpy(_np(rays_j), 'cpu')
    jn = jrt.Scene([lens(jrt)], n_bounces=4)
    _, _, aux_j = jn.simulate(jn.init_params(), rays_j, KEY,
                              track_field=True, E0=E0)
    seq = trt.SequentialScene([lens(trt)])
    non = trt.Scene([lens(trt)], n_bounces=4)
    p = seq.init_params('cpu')
    want = seq.simulate(p, rays_t, track_field=True, E0=E0)[2]['field_power']
    for sim in (non.simulate, non.simulate_fused):
        got = sim(p, rays_t, track_field=True, E0=E0)[2]['field_power']
        _close(got, want, rtol=1e-5)
        _close(got, aux_j['field_power'], rtol=1e-5)


def _loss(s, aux):
    """chip_smoke.py::field_ns_loss: tests/test_torch_field.py's grad loss
    (|E|^2, the weight and the first moment, a sum of squares) and the
    final field's x-real and y-imaginary parts, which carry E0's
    polarization past the mirror."""
    return cs.field_ns_loss(s, aux)


@pytest.mark.parametrize('fused', [False, True], ids=['eager', 'fused'])
def test_gradients_match_jax(fused):
    """The mirror fold's gradients in the mirror's curvature c1 (its
    ``c``) and in E0 (real and
    imaginary), eager and through the fused trace's plain K6, against
    ``jax.grad`` of the JAX bounce loop."""
    js, ts, pj, pt, rays_j, rays_t, _ = _case('fold', 400)
    e0 = np.array([[0.6, 0.8 * math.sqrt(0.5), 0.0]]) + 1j * np.array(
        [[0.0, 0.8 * math.sqrt(0.5), 0.0]])

    def jax_loss(p, re, im):
        _, s, aux = js.simulate(p, rays_j, KEY, track_field=True,
                                E0=re + 1j * im)
        return _loss(s, aux)
    g_j, gr_j, gi_j = jax.grad(jax_loss, argnums=(0, 1, 2))(
        pj, jnp.asarray(e0.real, jnp.float32), jnp.asarray(e0.imag,
                                                          jnp.float32))
    pt['mirror']['c'].requires_grad_(True)
    re = torch.tensor(e0.real, dtype=torch.float32, requires_grad=True)
    im = torch.tensor(e0.imag, dtype=torch.float32, requires_grad=True)
    sim = ts.simulate_fused if fused else ts.simulate
    _, s, aux = sim(pt, rays_t, track_field=True,
                    E0=torch.complex(re, im))
    g_c1, g_re, g_im = torch.autograd.grad(_loss(s, aux),
                                           [pt['mirror']['c'], re, im])
    ref = float(g_j['mirror']['c'])
    assert abs(float(g_c1) - ref) <= 1e-4 * max(abs(ref), 1.0)
    for g, want in ((g_re, gr_j), (g_im, gi_j)):
        scale = max(float(np.abs(np.asarray(want)).max()), 1e-3)
        _close(g, want, rtol=0, atol=1e-4 * scale)


def test_refusals_and_the_field_free_path():
    """Under the field the fused trace takes diffractive, fuzzy and freeform
    rows (the field's instantiation compiles every family but GRIN rods)
    and equals the eager trace; a JONES row without the field raises in
    both traces; K6's shared memory of the field is planned (the naive
    scene fits two blocks an SM, a 60-row table raises); an E0 without
    ``track_field`` changes nothing, sequential or not."""
    gen = torch.Generator().manual_seed(0)
    rays = trt.CollimatedDisk.make(radius=1.0, translation=[0, 0, -5.0]) \
        .sample(gen, 32, 'cpu')
    for sc in (cs.diffractive_ns_scene(trt), cs.pupil_scene(trt, 4),
               cs.ex19_scene(trt, n_bounces=4)):
        p = sc.init_params('cpu')
        r = rays.replace(wavelength=torch.full_like(rays.px, 0.5876))
        out_f, s_f, aux_f = sc.simulate_fused(p, r, track_field=True)
        out_e, s_e, aux = sc.simulate(p, r, track_field=True)
        assert bool(torch.isfinite(aux['field_power']).all())
        torch.testing.assert_close(aux_f['field_power'], aux['field_power'],
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(out_f.px, out_e.px, rtol=0, atol=1e-5)
        torch.testing.assert_close(s_f.moments, s_e.moments, rtol=1e-5,
                                   atol=1e-5)
    pol = cs.field_ns_scene(trt, 'jones')
    for sim in (pol.simulate, pol.simulate_fused):
        with pytest.raises(NotImplementedError, match='track_field'):
            sim(pol.init_params('cpu'), rays)
    naive = cs.field_ns_scene(trt, 'naive')
    meta, cfg = naive.static_meta(), naive.sensor_config()
    need = fused_nonseq.field_k6_shared_bytes(meta, cfg, naive.n_bounces)
    assert 2 * (need + 1024) <= 228 * 1024
    fused_nonseq.check_field_shared(meta, cfg, naive.n_bounces)
    with pytest.raises(NotImplementedError, match='MAX_SHARED_BYTES'):
        fused_nonseq.check_field_shared(list(meta) * 20, cfg, 8)
    bench = trt.SequentialScene(naive.elements)
    for sc in (naive, bench):
        p = sc.init_params('cpu')
        for sim in (sc.simulate, sc.simulate_fused):
            out0, s0, aux0 = sim(p, rays)
            out1, s1, aux1 = sim(p, rays, E0=[[0.0, 1.0, 0.0]])
            assert 'field' not in aux0 and 'field' not in aux1
            assert torch.equal(s0.moments, s1.moments)
            assert all(torch.equal(getattr(out0, c), getattr(out1, c))
                       for c in ft.COMPS)
