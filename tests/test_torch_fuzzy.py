"""Fuzzy apodization and the obscured pupil in the PyTorch port against the
JAX package, on the CPU: the pupil's mask and constructor, the eager traces
and the fused traces' plain versions (K1/K2's and K5/K6's functions) of the
obscured pupil (tests/test_obscuration.py's scene), the Gaussian apodizer
and the Lorentzian one (tests/test_pallas.py's), gradients through them,
the traced programs (ops/fuzzy_program.py) against their callables and
autograd, and the refusals.  The plain K1/K2 against the JAX kernels in
interpret mode: tests/test_torch_fuzzy_kernels.py.

The same rays go to both packages, made with numpy from a seed; the same
callable is written in ``jnp`` and in ``torch``.  Tolerances, each with its
reason: intensities atol 1e-6 (float32 arithmetic in another order, on
factors <= 1); moments rtol 1e-5 / atol 1e-3 (sums in another order,
tests/test_pallas.py's); gradients rtol 1e-4 (float32 adjoints);
a program's value rtol 1e-6 / atol 1e-7 of its callable and its partials
rtol 1e-5 / atol 1e-6 of autograd's (the same operations, exp and the
partials' products rounded in another order).  The rays are
collimated along z onto the pupil, so a hit's x and y are the launch's
exactly and no vane edge flips between the packages.
"""

import functools
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.rays.ray import Rays as JaxRays
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.core.table import ROW_FIELDS
from raytracetorch_tpu_torch.ops import fused_nonseq, fused_trace
from raytracetorch_tpu_torch.ops import fuzzy_program as fp

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
R, OBS, NV, VW = 4.0, 0.3, 4, 0.12


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- the callables, in jnp and in torch ----

def gauss_j(x, y, z):
    return jnp.exp(-(x * x + y * y) / 8.0)


def gauss_t(x, y, z):
    return torch.exp(-(x * x + y * y) / 8.0)


def lorentz_j(x, y, z):
    return 1.0 / (1.0 + (x * x + y * y) / 4.0)


def lorentz_t(x, y, z):
    return 1.0 / (1.0 + (x * x + y * y) / 4.0)


def mixed_t(x, y, z):
    """Every operation of the op set once at least."""
    a = torch.where((x < 1.0) | ~(y >= -0.5),
                    torch.sqrt(x * x + 2.0) / (1.0 + torch.abs(y - z)),
                    0.5 * (x - y))
    return a + ((z > 0.1) & (x <= y)).float() * 2.0 - (-z)


def _pupil(rt, **kw):
    return rt.ObscuredAperture(radius=R, obscuration=OBS, n_vanes=NV,
                               vane_width=VW, name='pupil', **kw)


# ---- scenes: (rt) -> scene, the callable row's index ----

def pupil_lens(rt, base=False):
    """tests/test_obscuration.py::test_fused_and_roundtrip's scene."""
    els = [_pupil(rt),
           rt.IdealThinLens(focal=50.0, diameter=12.0,
                            translation=[0, 0, 2.0], name='lens'),
           rt.SensorElement(radius=6.0, translation=[0, 0, 52.0], name='s')]
    return rt.Scene(els, n_bounces=4) if base else rt.SequentialScene(els)


def apodized(rt, base=False, lorentz=False):
    """tests/test_pallas.py's apodized bench singlet: Gaussian
    (test_fused_fuzzy_component_parity) or, as a Scene of 6 bounces,
    Lorentzian (test_nonseq_fused_fuzzy_parity)."""
    fn = ((lorentz_j if lorentz else gauss_j) if rt is jrt
          else (lorentz_t if lorentz else gauss_t))
    els = [rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                          name='lens'),
           rt.FuzzyAperture(fn, components=True, name='apod',
                            translation=[0, 0, 6.0]),
           rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                            name='sensor')]
    return rt.Scene(els, n_bounces=6) if base else rt.SequentialScene(els)


SCENES = {
    'pupil': (lambda rt: pupil_lens(rt), R, -3.0),
    'pupil_scene': (lambda rt: pupil_lens(rt, base=True), R, -3.0),
    'gauss': (lambda rt: apodized(rt), 4.0, -10.0),
    'lorentz_scene': (lambda rt: apodized(rt, base=True, lorentz=True), 3.0,
                      -10.0),
}


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


def _pair(case, n=1500):
    make, radius, z0 = SCENES[case]
    js, ts = make(jrt), make(trt)
    rays_j, rays_t = _disk(n, radius, z0)
    pt = interop.params_from_numpy(_np(js.init_params()), 'cpu')
    return js, ts, rays_j, rays_t, pt


@functools.lru_cache(maxsize=None)
def _jax_trace(case):
    """The JAX package's ``simulate`` of a case's scene (once a case)."""
    js, _, rays_j, _, _ = _pair(case)
    out, sens, _ = js.simulate(js.init_params(), rays_j, KEY)
    return _np(out), np.asarray(sens.moments)


@functools.lru_cache(maxsize=None)
def _jax_grad(case):
    """``jax.grad`` of the spot RMS in the lens's c1 and c2 (once a
    case)."""
    js, _, rays_j, _, _ = _pair(case, n=GRAD_N)

    def loss(p):
        _, s, _ = js.simulate(p, rays_j, KEY)
        return s.spot_rms(0)[0]
    g = jax.jit(jax.grad(loss))(js.init_params())['lens']
    return {k: float(g[k]) for k in ('c1', 'c2')}


GRAD_N = 1000


# ---- the pupil's mask and constructor ----

PUPIL_POINTS = {
    (2.0, 2.0): 1.0,           # open annulus (off every vane)
    (0.5, 0.4): 0.0,           # inside the 1.2-radius obscuration
    (4.2, 0.0): 0.0,           # outside the pupil
    (2.5, 0.03): 0.0,          # on the +x vane (|y| < 0.06)
    (0.0, -2.5): 0.0,          # on the -y vane
    (-2.5, 0.2): 1.0,          # clear of the -x vane (0.2 > 0.06)
}


@pytest.mark.parametrize('path', ['simulate', 'simulate_fused'])
def test_mask_geometry(path):
    """tests/test_obscuration.py::test_mask_geometry's six points, eagerly
    and through K1's plain version, against the expected values and the
    JAX package's trace."""
    xs = np.float32([p[0] for p in PUPIL_POINTS])
    ys = np.float32([p[1] for p in PUPIL_POINTS])
    pos = np.stack([xs, ys, np.full_like(xs, -3.0)], -1)
    d = np.tile(np.float32([0, 0, 1]), (len(xs), 1))
    js, ts = jrt.SequentialScene([_pupil(jrt)]), \
        trt.SequentialScene([_pupil(trt)])
    out_j, _, _ = js.simulate(js.init_params(),
                              JaxRays.create(jnp.asarray(pos),
                                             jnp.asarray(d)), KEY)
    out_t, _, _ = getattr(ts, path)(
        ts.init_params('cpu'),
        trt.Rays.create(torch.from_numpy(pos), torch.from_numpy(d)))
    _close(out_t.intensity, list(PUPIL_POINTS.values()), atol=1e-6)
    _close(out_t.intensity, out_j.intensity, atol=0)


def test_mask_matches_jax_callable():
    """The pupil's torch mask equals the JAX one on 20,000 points around
    the pupil, vanes at an angle included."""
    rng = np.random.default_rng(3)
    x, y, z = (rng.uniform(-5, 5, 20_000).astype(np.float32)
               for _ in range(3))
    for kw in ({}, {'vane_angle': 0.3}):
        mj = _pupil(jrt, **kw).intensity_fn(*map(jnp.asarray, (x, y, z)))
        mt = _pupil(trt, **kw).intensity_fn(*map(torch.from_numpy,
                                                 (x, y, z)))
        _close(mt, mj, atol=0)
        assert 0.3 < float(mt.mean()) < 0.6


@pytest.mark.parametrize('kw,match', [
    (dict(obscuration=1.2), 'obscuration'),
    (dict(vane_width=-0.1), 'vane_width'),
    (dict(n_vanes=-1), 'n_vanes'),
])
def test_ctor_validation(kw, match):
    for rt in (jrt, trt):
        with pytest.raises(ValueError, match=match):
            rt.ObscuredAperture(radius=4.0, **kw)


def test_fuzzy_fns_match_jax():
    """``Scene.fuzzy_fns`` maps the same rows to the callables, and the
    elements build the same TRANSMIT plane rows."""
    js, ts = pupil_lens(jrt), pupil_lens(trt)
    assert sorted(js.fuzzy_fns()) == sorted(ts.fuzzy_fns()) == [0]
    assert ts.fuzzy_fns()[0] is ts.elements[0].intensity_fn
    for j, t in zip(js.static_meta(), ts.static_meta()):
        assert (j.ph, j.sb, j.vb, j.plane) == (t.ph, t.sb, t.vb, t.plane)
    tab_j = _np(js.build_table(js.init_params()))
    tab_t = ts.build_table(ts.init_params('cpu'))
    for name, _ in ROW_FIELDS:
        ref = np.asarray(getattr(tab_j, name))
        if np.issubdtype(ref.dtype, np.inexact):
            _close(getattr(tab_t, name).numpy(), ref, rtol=1e-6, atol=1e-7,
                   err_msg=name)


# ---- the traces against the JAX package ----

@pytest.mark.parametrize('path', ['simulate', 'simulate_fused'])
@pytest.mark.parametrize('case', list(SCENES))
def test_trace_matches_jax(case, path):
    """Intensities and moments of the obscured pupil, the Gaussian apodizer
    and the Lorentzian Scene, eagerly and through the fused traces' plain
    versions (K1's and K5's functions), against the JAX package's
    ``simulate``."""
    _, ts, _, rays_t, pt = _pair(case)
    out_j, mom_j = _jax_trace(case)
    out_t, sens_t, _ = getattr(ts, path)(pt, rays_t)
    _close(out_t.intensity, out_j.intensity, atol=1e-6)
    _close(sens_t.moments, mom_j, rtol=1e-5, atol=1e-3)
    for c in ('px', 'py', 'dx', 'dy'):
        _close(getattr(out_t, c), getattr(out_j, c), atol=2e-5, err_msg=c)
    assert 0.0 < float(out_t.intensity.mean()) < 1.0


def test_energy_fraction():
    """tests/test_obscuration.py::test_energy_fraction in the port: the
    transmitted fraction of a uniform disk is the open area's within
    0.004, eagerly and through K1's plain version."""
    _, rays = _disk(100_000, R, -3.0, seed=1)
    sc = trt.SequentialScene([_pupil(trt)])
    vanes = NV * VW * (R - OBS * R) / (math.pi * R * R)
    expect = (1 - OBS ** 2) - vanes
    for sim in (sc.simulate, sc.simulate_fused):
        out, _, _ = sim(sc.init_params('cpu'), rays)
        assert float(out.intensity.sum()) / rays.n == pytest.approx(
            expect, abs=0.004)


@pytest.mark.parametrize('path', ['simulate', 'simulate_fused'])
@pytest.mark.parametrize('case', ['gauss', 'lorentz_scene'])
def test_gradients_match_jax(case, path):
    """The spot RMS's gradient in c1 and c2 of the apodized singlet through
    the eager trace and the plain K2 / K6 against ``jax.grad`` of the JAX
    trace (rtol 1e-4): the apodizer reweights the moments, so the
    curvatures' gradient carries its chain."""
    _, ts, _, rays_t, pt = _pair(case, n=GRAD_N)
    ref = _jax_grad(case)
    p = {el: dict(v) for el, v in pt.items()}
    for k in ('c1', 'c2'):
        p['lens'][k] = p['lens'][k].clone().requires_grad_(True)
    _, s, _ = getattr(ts, path)(p, rays_t)
    s.spot_rms(0)[0].backward()
    for k in ('c1', 'c2'):
        r = ref[k]
        assert abs(r) > 0
        _close(float(p['lens'][k].grad), r, rtol=1e-4, atol=1e-7,
               err_msg=k)


# ---- the traced programs ----

@pytest.mark.parametrize('name', ['gauss', 'lorentz', 'pupil', 'mixed'])
def test_program_matches_callable(name):
    """The program's plain version (what the kernels compute) against the
    callable itself, and its forward-mode partials against autograd of the
    callable, on 20,000 points."""
    fn = trt.ComponentFuzzy({'gauss': gauss_t, 'lorentz': lorentz_t,
                             'mixed': mixed_t}.get(name)
                            or _pupil(trt).intensity_fn.fn)
    prog = fp.trace(fn)
    assert len(prog.ops) <= fp.MAX_OPS and prog.n_regs <= fp.MAX_REGS
    rng = np.random.default_rng(11)
    x, y, z = (torch.from_numpy(rng.uniform(-5, 5, 20_000)
                                .astype(np.float32)) for _ in range(3))
    w, g = fp.evaluate(prog, x, y, z, partials=True)
    _close(fp.evaluate(prog, x, y, z), w, atol=0)
    _close(w, fn(x, y, z), rtol=1e-6, atol=1e-7)
    xyz = [t.clone().requires_grad_(True) for t in (x, y, z)]
    out = fn(*xyz)
    ref = (torch.autograd.grad(out.sum(), xyz, allow_unused=True)
           if out.requires_grad else (None,) * 3)
    for j, (got, r) in enumerate(zip(g, ref)):
        r = torch.zeros_like(x) if r is None else r
        _close(got, r, rtol=1e-5, atol=1e-6, err_msg=f'd/d{"xyz"[j]}')


def test_pupil_program_size_and_dedup():
    """The 4-vane pupil is one program of 85 operations in 6 registers; one
    callable on two rows packs once."""
    mask = _pupil(trt).intensity_fn
    prog = fp.trace(mask)
    assert (len(prog.ops), prog.n_regs) == (85, 6)
    gauss = trt.ComponentFuzzy(gauss_t)
    words = fp.pack({0: mask, 2: gauss, 3: gauss}, 5)
    assert words[:5] == (5, -1, 5 + len(prog.words), 5 + len(prog.words),
                         -1)
    assert len(words) == 5 + len(prog.words) + len(fp.trace(gauss).words)
    assert fp.pack({}, 3) is None


def _sum_of(n_terms):
    def fn(x, y, z):
        vals = [x * float(k + 1) for k in range(n_terms)]
        return sum(vals[1:], vals[0])
    return fn


def _chain_of(n_ops):
    def fn(x, y, z):
        for _ in range(n_ops):
            x = x + 1.0
        return x
    return fn


def _branchy(x, y, z):
    if x > 0:
        return x
    return y


REFUSALS = {
    'sin': (lambda x, y, z: torch.sin(x), 'op sin'),
    'pow': (lambda x, y, z: x ** 0.5, 'op pow with exponent 0.5'),
    'log': (lambda x, y, z: torch.log(x * x + 1.0), 'op log'),
    'python_if': (_branchy, 'Python if'),
    'float': (lambda x, y, z: x * math.exp(float(y)), r'float\(\)'),
    'kwargs': (lambda x, y, z: torch.div(x, y, rounding_mode='floor'),
               'rounding_mode'),
    'mask_arith': (lambda x, y, z: (x > 0) + (y > 0), 'add of two masks'),
    'ops_limit': (_chain_of(70), 'MAX_OPS = 128'),
    'regs_limit': (_sum_of(20), 'MAX_REGS = 16'),
}


@pytest.mark.parametrize('name', list(REFUSALS))
def test_refusals_name_op_or_limit(name):
    """A callable outside the op set or the limits raises
    NotImplementedError naming what it met, on the fused path (either
    device: the programs are traced on the host), while the eager trace
    runs it."""
    fn, match = REFUSALS[name]
    sc = trt.SequentialScene([
        trt.FuzzyAperture(fn, components=True, name='apod'),
        trt.SensorElement(radius=6.0, translation=[0, 0, 5.0], name='s')])
    p = sc.init_params('cpu')
    _, rays = _disk(64, 2.0, -1.0)
    with pytest.raises(NotImplementedError, match=match):
        sc.simulate_fused(p, rays)
    with pytest.raises(NotImplementedError, match=match):
        sc.to_base().simulate_fused(p, rays)
    if name not in ('python_if', 'float', 'kwargs', 'mask_arith'):
        sc.simulate(p, rays)    # torch runs what the kernels do not


def test_buffer_limit():
    """Twelve distinct programs of ~90 operations overflow the table's
    buffer (MAX_WORDS)."""
    fns = {k: trt.ComponentFuzzy(_chain_of(44 + k)) for k in range(12)}
    with pytest.raises(NotImplementedError, match='MAX_WORDS = 2048'):
        fp.pack(fns, 12)


def test_legacy_callable_refused_on_fused_path():
    """tests/test_pallas.py::test_fused_fuzzy_legacy_asserts in the port: a
    legacy [N, 3] callable runs eagerly (as the JAX XLA driver does) and
    raises on the fused path, pointing back to simulate."""
    sc = trt.SequentialScene([
        trt.FuzzyAperture(lambda h: torch.exp(-h[:, 0] ** 2), name='apod'),
        trt.SensorElement(radius=6.0, translation=[0, 0, 10.0], name='s')])
    p = sc.init_params('cpu')
    _, rays = _disk(512, 2.0, -5.0)
    out, _, _ = sc.simulate(p, rays)
    _close(out.intensity, torch.exp(-rays.px ** 2), rtol=1e-6)
    for scene in (sc, sc.to_base()):
        with pytest.raises(NotImplementedError, match='component-style'):
            scene.simulate_fused(p, rays)


def test_kernel_source_constants():
    """csrc/fuzzy.cuh's op codes and limits are ops/fuzzy_program.py's."""
    src = (pathlib.Path(trt.__file__).parent / 'csrc' / 'fuzzy.cuh') \
        .read_text()
    codes = dict((m.group(1).lower(), int(m.group(2)))
                 for m in re.finditer(r'kFz(\w+) = (\d+),', src))
    assert codes == {k: v for k, v in fp.CODE.items()}
    for name, value in (('kFuzzyMaxOps', fp.MAX_OPS),
                        ('kFuzzyMaxRegs', fp.MAX_REGS),
                        ('kFuzzyMaxWords', fp.MAX_WORDS)):
        assert re.search(rf'{name} = {value};', src), name


def test_nonseq_plain_bwd_equals_autograd_of_eager():
    """K6's plain version on the Lorentzian Scene equals autograd of the
    eager bounce loop (``Scene.simulate``) in the ray streams, and its
    table cotangent reaches the apodizer's row (through the hit, the only
    way a row without parameters of its own gets one)."""
    _, ts, _, rays_t, pt = _pair('lorentz_scene', n=400)
    meta = fused_trace.TraceMeta(ts.static_meta(), ts.fuzzy_fns())
    table = ts.build_table(pt)
    cfg = ts.sensor_config()
    flat, _ = fused_trace.flat_inputs(table, rays_t, cfg, meta)
    rng = np.random.default_rng(5)
    g_rays = [torch.from_numpy(rng.standard_normal(rays_t.n)
                               .astype(np.float32)) for _ in range(7)]
    g_mom = torch.from_numpy(rng.standard_normal((1, 1, 7))
                             .astype(np.float32))
    g_flat, g_in, _ = fused_nonseq.trace_nonseq_bwd_plain(
        flat, rays_t, cfg, meta, ts.n_bounces, g_rays, g_mom, maps=())
    comps = [getattr(rays_t, c).clone().requires_grad_(True)
             for c in fused_trace.COMPS]
    rays = rays_t.replace(**dict(zip(fused_trace.COMPS, comps)))
    out, sens, _ = ts.simulate(pt, rays)
    outs = [getattr(out, c) for c in fused_trace.COMPS] + [sens.moments]
    ref = torch.autograd.grad(outs, comps, g_rays + [g_mom])
    for c, g, r in zip(fused_trace.COMPS, g_in, ref):
        _close(g, r, rtol=1e-5, atol=1e-6, err_msg=c)
    assert float(g_flat[min(meta.fuzzy)].abs().max()) > 0
