"""The polarized field through coated interfaces and metal mirrors on the
sequential path in the PyTorch port against the JAX package, on the CPU:
the stacks' complex amplitudes (``coating_amplitudes``,
``metal_reflection_amplitudes``: 0, 1, 2 and 8 layers, s and p, absorbing
films, fixed and dispersive metals); ``polarized_RT`` and the coated and
metal branches of ``transport_field`` (transmitted, reflected, TIR, both
orders of a stack and a cemented interface of equal indices); the eager
``trace_sequential(track_field=True)`` and the fused trace's plain version
on the coated bench singlet (FRESNEL_W and FRESNEL), the stress rows
(stack8, gold, mangin), the absorbing silver-film beamsplitter of
tests/test_coatings.py:779-800 and the aluminium mirrors of :362-385 and
:573-595 against the JAX package's ``simulate(track_field=True)`` on the
same rays and draws; and ``JonesPupil``/``jones_pupil`` against the JAX
package's and the analytic anchors of tests/test_polarization.py:293-345
and tests/test_polarization_optics.py:200-228.  The plain K1 and K2
against the JAX kernel and ``jax.grad``: tests/test_torch_field_coat_kernels
.py; the kernels' adjoints on the host: tests/test_torch_field_coat_host
.py.

Tolerances, each with its reason: dielectric stacks in float32 within
atol 2e-6 of the JAX package (the same float32 arithmetic, another
compiler's contractions); metals and absorbing films go through the
complex square root, whose float32 cancellation in the JAX package the
port avoids (utils/coatings.py::_c_sqrt, ROADMAP Queue 3), so scenes and
functions with them are held to the JAX package in float64
(``jax.enable_x64``), where both compute the same function: within 1e-9
for the pure functions, and the traces (float32 rays, float64 JAX
reference) within the float32 rounding of the port's own chain: the field
atol 2e-5, intensities rtol 2e-5 (10x the float32 atol of
tests/test_torch_field.py: an 8-layer stack's amplitudes are a few hundred
float32 roundings); positions rtol 1e-6 + atol 1e-5, directions atol
2e-6, moments rtol 1e-4 + atol 1e-4 of their scale; gradients rtol 2e-3
of the leaf's scale (tests/test_torch_field_coat_kernels.py); FRESNEL rows
take the JAX package's uniforms (rays/reference_prng.py), and a ray whose
draw lies within 1e-5 of its R may take the other branch: at most
FRESNEL_FLIPS of a case's rays may, and they are left out.  The FRESNEL
silver-film splitter draws JAX's float32 uniforms, which enable_x64 would
make float64: it is held to the JAX package's float32 trace, whose R and T
of the film are up to 1.6e-4 off their float64 values (the cancelling
square root), within 3e-4 (field, intensities and the draws' margin), as
tests/test_torch_coated_trace.py holds its absorbing FRESNEL singlet.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu.core import field as jfield
from raytracetorch_tpu.core import static_dispatch as jsd
from raytracetorch_tpu.elements import mirror as jmirror
from raytracetorch_tpu.elements import shapes as jshapes
from raytracetorch_tpu.utils import coatings as jc
from raytracetorch_tpu.utils import polarization as jpol
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import PhysKind
from raytracetorch_tpu_torch.core import field as tfield
from raytracetorch_tpu_torch.core import static_dispatch as tsd
from raytracetorch_tpu_torch.elements import mirror as tmirror
from raytracetorch_tpu_torch.elements import shapes as tshapes
from raytracetorch_tpu_torch.ops import fused_trace as ft
from raytracetorch_tpu_torch.rays import reference_prng as rp
from raytracetorch_tpu_torch.utils import coatings as tc
from raytracetorch_tpu_torch.utils import polarization as tpol

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
NS, NC, NH = 1.5168, 1.38, 2.35
WL = 0.5876
QW = WL / (4 * NC)
STACK8 = [(NH, WL / (4 * NH)), (NC, WL / (4 * NC))] * 3 + [
    (NH, WL / (4 * NH)), ('Ag', 0.01)]
FIELDS = ('erx', 'ery', 'erz', 'eix', 'eiy', 'eiz')
FRESNEL_FLIPS = 2
N = 256


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


# ---- the amplitudes ----

def _layers(count, absorbing):
    """(ns, ks, ds) of a stack of ``count`` layers (an absorbing one ends
    on a silver film)."""
    ns, ks, ds = [], [], []
    for j in range(count):
        n = NH if j % 2 == 0 else NC
        ns.append(n), ks.append(0.0), ds.append(WL / (4 * n) * (1 + 0.1 * j))
    if absorbing and count:
        ns[-1], ks[-1] = tc.METALS['AG']
        ds[-1] = 0.02
    return ns, ks, ds


AMP_CASES = [(c, a, p) for c in (0, 1, 2, 8) for a in (False, True)
             if c or not a for p in ('s', 'p')]


@pytest.mark.parametrize('count,absorbing,pol', AMP_CASES)
def test_coating_amplitudes_match_jax(count, absorbing, pol):
    """coating_amplitudes against the JAX package's on seeded inputs, from
    the low and the high index and at equal indices: float32 for dielectric
    stacks (atol 2e-6), float64 for absorbing ones (atol 1e-9); its bare
    limit is fresnel_amplitudes."""
    ns, ks, ds = _layers(count, absorbing)
    rng = np.random.default_rng(count * 4 + absorbing * 2 + (pol == 'p'))
    cos_i = rng.uniform(0.3, 1.0, 64)
    lam = rng.uniform(0.45, 0.7, 64)
    for n_in, n_out in ((1.0, NS), (NS, 1.0), (1.6, 1.6)):
        sin2 = (n_in / n_out) ** 2 * (1 - cos_i ** 2)
        keep = sin2 <= 1.0
        kst = ks if absorbing else None
        if absorbing:
            with enable_x64():
                ref = _np(jc.coating_amplitudes(
                    ns, [jnp.float64(d) for d in ds], n_in, n_out,
                    jnp.asarray(cos_i), jnp.asarray(lam), pol=pol,
                    k_stack=kst))
            dt, tol = torch.float64, 1e-9
        else:
            ref = _np(jc.coating_amplitudes(
                ns, [jnp.float32(d) for d in ds], jnp.float32(n_in),
                jnp.float32(n_out), jnp.asarray(cos_i, jnp.float32),
                jnp.asarray(lam, jnp.float32), pol=pol))
            dt, tol = torch.float32, 2e-6
        got = tc.coating_amplitudes(
            ns, [torch.tensor(d, dtype=dt) for d in ds],
            torch.tensor(n_in, dtype=dt), torch.tensor(n_out, dtype=dt),
            torch.tensor(cos_i, dtype=dt), torch.tensor(lam, dtype=dt),
            pol=pol, k_stack=kst)
        for g, r in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
            _close(g[keep], r[keep], atol=tol)
        if count == 0:
            # the bare limit, both in float64 (near the critical angle a
            # float32 cos_t moves the amplitudes by ~1e-5)
            d64 = torch.float64
            bare = tc.coating_amplitudes(
                [], [], torch.tensor(n_in, dtype=d64),
                torch.tensor(n_out, dtype=d64), torch.tensor(cos_i),
                torch.tensor(lam), pol=pol)
            ts, tp, rs, rp_, _ = tfield.fresnel_amplitudes(
                *(torch.tensor(v, dtype=d64)
                  for v in (n_in, n_out, cos_i, sin2)))
            t, r = (ts, rs) if pol == 's' else (tp, rp_)
            _close(bare[0][0][keep], t[keep], atol=1e-9)
            _close(bare[1][0][keep], r[0][keep], atol=1e-9)


@pytest.mark.parametrize('metal', ['AL', 'AU', 'AG_coated', 'AL_disp'])
def test_metal_reflection_amplitudes_match_jax(metal):
    """metal_reflection_amplitudes (fixed and dispersive metals, bare and
    under a dielectric-plus-silver stack) against the JAX package's in
    float64, s and p (atol 1e-9)."""
    rng = np.random.default_rng(len(metal))
    cos_i = rng.uniform(0.2, 1.0, 64)
    lam = rng.uniform(0.42, 0.95, 64)
    n_amb = 1.0 if metal != 'AL' else NS
    ns, ks, ds = (([NC, tc.METALS['AG'][0]], [0.0, tc.METALS['AG'][1]],
                   [0.1, 0.02]) if metal == 'AG_coated' else ([], [], []))
    kst = ks if ks else None
    name = metal.split('_')[0]
    for pol in ('s', 'p'):
        with enable_x64():
            lam_j = jnp.asarray(lam)
            nk = (jc.metal_nk_at(*jc.METAL_NK[name], lam_j)
                  if metal.endswith('disp') else jc.METALS[name])
            ref = _np(jc.metal_reflection_amplitudes(
                ns, [jnp.float64(d) for d in ds], n_amb, nk[0], nk[1],
                jnp.asarray(cos_i), lam_j, pol=pol, k_stack=kst))
        lam_t = torch.tensor(lam, dtype=torch.float64)
        nk = (tc.metal_nk_at(*tc.METAL_NK[name], lam_t)
              if metal.endswith('disp') else tc.METALS[name])
        got = tc.metal_reflection_amplitudes(
            ns, [torch.tensor(d, dtype=torch.float64) for d in ds],
            torch.tensor(n_amb, dtype=torch.float64),
            *(torch.as_tensor(v, dtype=torch.float64) for v in nk),
            torch.tensor(cos_i, dtype=torch.float64), lam_t, pol=pol,
            k_stack=kst)
        for g, r in zip(got, ref):
            _close(g, r, atol=1e-9)


# ---- polarized_RT and transport_field ----

def _metas(ph, n_coat=0, coat_k=None, metal=False, metal_nk=None):
    return (jsd.StaticRowMeta(ph, 0, 0, n_coat=n_coat, coat_k=coat_k,
                              metal=metal, metal_nk=metal_nk),
            tsd.StaticRowMeta(ph, 0, 0, n_coat=n_coat, coat_k=coat_k,
                              metal=metal, metal_nk=metal_nk))


def _rows(ph, coat):
    """(JAX row, port row): float64 ph [N, 6] and coat [N, 16] (the JAX
    row's made under enable_x64, as it is read)."""
    with enable_x64():
        rj = types.SimpleNamespace(ph=jnp.asarray(ph), coat=jnp.asarray(coat))
    return rj, types.SimpleNamespace(ph=torch.tensor(ph),
                                     coat=torch.tensor(coat))


def _directions(rng, n, theta_max=1.2, flip=0.5):
    """Unit d (towards +z, a share ``flip`` towards -z) and the normal -z
    tilted a little."""
    th = rng.uniform(0.0, theta_max, n)
    phi = rng.uniform(0.0, 2 * math.pi, n)
    sgn = np.where(rng.uniform(size=n) < flip, -1.0, 1.0)
    d = np.stack([np.sin(th) * np.cos(phi), np.sin(th) * np.sin(phi),
                  sgn * np.cos(th)])
    nw = np.stack([0.03 + 0 * th, -0.02 + 0 * th, -np.ones_like(th)])
    nw /= np.linalg.norm(nw, axis=0)
    return d, nw


def _stack_row(count, absorbing, n_in, n_out, n):
    ns, ks, ds = _layers(count, absorbing)
    coat = np.zeros((n, 16))
    for j, (nl, dl) in enumerate(zip(ns, ds)):
        coat[:, 2 * j], coat[:, 2 * j + 1] = nl, dl
    ph = np.zeros((n, 6))
    ph[:, 0], ph[:, 1] = n_in, n_out
    return coat, ph, (ks if absorbing else None)


ROW_CASES = {
    # kind, layers, absorbing, (n_in, n_out)
    'snell_qw': (PhysKind.SNELL, 1, False, (1.0, NS)),
    'snell_pair_tir': (PhysKind.SNELL, 2, False, (1.0, 1.7)),
    'fresnel_w_eight': (PhysKind.FRESNEL_W, 8, False, (1.0, NS)),
    'fresnel_w_silver': (PhysKind.FRESNEL_W, 2, True, (1.0, NS)),
    'fresnel_pair': (PhysKind.FRESNEL, 2, False, (1.0, NS)),
    'reflect_w_pair': (PhysKind.REFLECT_W, 2, False, (1.0, NS)),
    'cemented_equal': (PhysKind.FRESNEL_W, 2, False, (1.6, 1.6)),
}


@pytest.mark.parametrize('name', sorted(ROW_CASES))
def test_polarized_rt_and_transport_match_jax(name):
    """polarized_RT and transport_field on a coated row against the JAX
    package's in float64 (atol 1e-9): transmitted and reflected branches
    (FRESNEL's from its draw), TIR (the bare TIR phase), the stack read in
    reverse from the higher index and, at equal indices, in the order JAX
    picks."""
    kind, count, absorbing, (n_in, n_out) = ROW_CASES[name]
    n = 96
    rng = np.random.default_rng(sum(map(ord, name)))
    coat, ph, ks = _stack_row(count, absorbing, n_in, n_out, n)
    mj, mt = _metas(kind, count, ks)
    rj, rt_ = _rows(ph, coat)
    d, nw = _directions(rng, n)
    e = rng.normal(size=(6, n))
    wl = rng.uniform(0.45, 0.7, n)
    u = torch.tensor(rng.uniform(size=n))
    dt, nt = (tuple(torch.tensor(c) for c in v) for v in (d, nw))
    ft_ = tfield.FieldState(*(torch.tensor(c) for c in e))
    R_t, T_t = tsd.polarized_RT(mt, rt_, dt, nt, rt_.ph[..., 0],
                                rt_.ph[..., 1], ft_, torch.tensor(wl))
    nd, imod = tsd.apply_physics_one(mt, rt_, None, dt, nt, torch.tensor(wl),
                                     u=u, field=ft_)
    Er, Ei = tfield.transport_field(mt, rt_, dt, nd, nt, imod, ft_.r_c,
                                    ft_.i_c, torch.tensor(wl))
    with enable_x64():
        fj = jfield.FieldState(*(jnp.asarray(c) for c in e))
        dj, nj = (tuple(jnp.asarray(c) for c in v) for v in (d, nw))
        R_j, T_j = jsd.polarized_RT(mj, rj, dj, nj, rj.ph[..., 0],
                                    rj.ph[..., 1], fj, jnp.asarray(wl))
        nd_j, imod_j = jsd.apply_physics_one(
            mj, rj, None, dj, nj, jnp.asarray(u.numpy()), jnp.asarray(wl),
            field=fj)
        Erj, Eij = jfield.transport_field(
            mj, rj, dj, nd_j, nj, imod_j, fj.r_c, fj.i_c, jnp.asarray(wl))
        ref = _np((R_j, T_j, nd_j, imod_j, Erj, Eij))
    _close(R_t, ref[0], atol=1e-9)
    _close(T_t, ref[1], atol=1e-9)
    for a, b in zip(nd, ref[2]):
        _close(a, b, atol=1e-9)
    _close(imod, ref[3], atol=1e-9)
    for a, b in zip((*Er, *Ei), (*ref[4], *ref[5])):
        _close(a, b, atol=1e-9)
    refl = (np.asarray(ref[2][2]) * d[2]) < 0
    if name in ('snell_pair_tir', 'fresnel_pair', 'reflect_w_pair'):
        assert refl.any()
    if name != 'reflect_w_pair':
        assert (~refl).any()
    if absorbing:     # the film absorbs (away from TIR, where R = 1)
        assert float((R_t + T_t)[R_t < 1.0].max()) < 1.0


@pytest.mark.parametrize('metal', ['AL', 'AU_disp', 'AL_enhanced'])
def test_metal_transport_matches_jax(metal):
    """A metal mirror's polarized R (apply_physics_one under the field) and
    transport (its amplitudes, renormalized) against the JAX package's in
    float64 (atol 1e-9): fixed and dispersive metals, bare and enhanced,
    the ambient ph[2] behind glass."""
    n = 96
    rng = np.random.default_rng(len(metal))
    name = metal.split('_')[0]
    nk = tc.METALS[name]
    ph = np.zeros((n, 6))
    ph[:, 0], ph[:, 1], ph[:, 2] = nk[0], nk[1], 1.5168
    count = 2 if metal.endswith('enhanced') else 0
    coat, _, _ = _stack_row(count, False, 1.0, 1.0, n)
    knots = jc.METAL_NK[name] if metal.endswith('disp') else None
    mj, mt = _metas(PhysKind.REFLECT, count, metal=True, metal_nk=knots)
    rj, rt_ = _rows(ph, coat)
    d, nw = _directions(rng, n, 1.0, 0.0)
    e = rng.normal(size=(6, n))
    wl = np.where(rng.uniform(size=n) < 0.2, 0.0, rng.uniform(0.42, 0.95, n))
    dt, nt = (tuple(torch.tensor(c) for c in v) for v in (d, nw))
    ft_ = tfield.FieldState(*(torch.tensor(c) for c in e))
    nd, imod = tsd.apply_physics_one(mt, rt_, None, dt, nt, torch.tensor(wl),
                                     field=ft_)
    Er, Ei = tfield.transport_field(mt, rt_, dt, nd, nt, imod, ft_.r_c,
                                    ft_.i_c, torch.tensor(wl))
    with enable_x64():
        fj = jfield.FieldState(*(jnp.asarray(c) for c in e))
        dj, nj = (tuple(jnp.asarray(c) for c in v) for v in (d, nw))
        nd_j, imod_j = jsd.apply_physics_one(mj, rj, None, dj, nj, None,
                                             jnp.asarray(wl), field=fj)
        ref = _np((imod_j, jfield.transport_field(
            mj, rj, dj, nd_j, nj, imod_j, fj.r_c, fj.i_c, jnp.asarray(wl))))
    _close(imod, ref[0], atol=1e-9)
    for a, b in zip((*Er, *Ei), (*ref[1][0], *ref[1][1])):
        _close(a, b, atol=1e-9)
    # renormalized: |E|^2 kept
    _close(sum(c * c for c in (*Er, *Ei)), (e ** 2).sum(0), rtol=1e-12)


# ---- the traces ----

def _scene(rt, name):
    sh = jshapes if rt is jrt else tshapes
    mir = jmirror if rt is jrt else tmirror
    if name in ('coated_w', 'coated_mc'):
        return rt.SequentialScene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           fresnel='weighted' if name == 'coated_w' else True,
                           coating=[(NC, QW)], coating_grad=True,
                           c1_grad=True, c2_grad=True, name='lens'),
            rt.CircularAperture(radius=5.0, name='stop'),
            rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                             name='sensor')])
    if name == 'stack8':
        return rt.SequentialScene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           fresnel='weighted', coating=list(STACK8),
                           coating_grad=True, name='lens'),
            rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                             name='sensor')])
    if name == 'gold':
        return rt.SequentialScene([
            mir.SphericalMirror(c1=-0.01, d=40.0, metal='Au',
                                metal_dispersion=True,
                                translation=[0, 0, 50.0], name='mirror'),
            rt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                             name='sensor')])
    if name == 'mangin':
        return rt.SequentialScene([
            mir.ManginMirror(c1=-0.02, c2=-0.025, d=30.0, t=4.0,
                             ior_glass=NS, metal='Al',
                             translation=[0, 0, 60.0], name='mirror'),
            rt.SensorElement(radius=30.0, translation=[0, 0, -5.0],
                             name='sensor')])
    if name.startswith('splitter'):
        kind = PhysKind.FRESNEL_W if name == 'splitter_w' else \
            PhysKind.FRESNEL
        return rt.SequentialScene([
            rt.ElementCustom(sh.plane, 1, kind, ph=(NS, 1.0),
                             coating=[('Ag', 0.04)], name='bs'),
            rt.SensorElement(radius=100.0, translation=[0, 0, 20.0],
                             name='sensor')])
    return rt.SequentialScene([
        mir.ParabolicMirror(c1=-0.001, d=30.0, translation=[0, 0, 50.0],
                            metal='Al', metal_dispersion=name == 'al_disp',
                            name='m'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 0.5], name='s')])


s2 = math.sqrt(0.5)
# name: (radius, z, wavelengths, rotation, E0, float64 reference)
TRACE_CASES = {
    'coated_w': (4.0, -10.0, (None,), None,
                 np.array([[1.0, 1.0j, 0.0]]) / math.sqrt(2), False),
    'coated_mc': (4.0, -10.0, (None,), None, [[1.0, 0.0, 0.0]], False),
    'stack8': (4.0, -10.0, (None,), None, [[s2, s2, 0.0]], True),
    'gold': (15.0, -3.0, (0.45, 0.68), None, [[1.0, 0.0, 0.0]], True),
    'mangin': (10.0, -3.0, (None,), None, [[0.0, 1.0, 0.0]], True),
    'splitter_w': (0.5, -5.0, (None,), [math.pi / 4, 0.0, 0.0],
                   [[1.0, 0.0, 0.0]], True),
    # FRESNEL with JAX's float32 draws (enable_x64 would draw float64
    # uniforms): held to its float32 trace within its cancellation's 3e-4
    'splitter_mc': (0.5, -5.0, (None,), [math.pi / 4, 0.0, 0.0],
                    [[1.0, 0.0, 0.0]], 'float32'),
    'al': (1.0, 1.0, (None,), None, [[1.0, 0.0, 0.0]], True),
    'al_disp': (1.0, 1.0, (0.80,), None, [[0.6, 0.8, 0.0]], True),
}


def _trace_case(name, n=N):
    radius, z, wls, rot, E0, x64 = TRACE_CASES[name]
    js, ts = _scene(jrt, name), _scene(trt, name)
    bundles = []
    for j, wl in enumerate(wls):
        kw = {} if wl is None else dict(wavelength=wl)
        if rot is not None:
            kw['rotation'] = rot
        bundles.append((jrt.CollimatedDisk.make(
            radius=jnp.float32(radius), ray_id=j, translation=[0., 0., z],
            **kw), n // len(wls)))
    rays_j = js.sample_rays(jax.random.PRNGKey(3), bundles)
    pj = js.init_params()
    return (js, ts, pj, interop.params_from_numpy(_np(pj), 'cpu'), rays_j,
            interop.rays_from_numpy(_np(rays_j), 'cpu'), E0, x64, len(wls))


def _stable(trace, u, shift=1e-5):
    """The rays whose outcome does not move when the uniforms move by
    ``shift``: the others' draws lie within it of their R."""
    def outcome(v):
        out = trace(v)
        return torch.stack([out.pz, out.dz, out.intensity])
    lo = outcome(torch.clamp(u - shift, min=0.0))
    hi = outcome(torch.clamp(u + shift, max=1.0 - 2 ** -24))
    return torch.isclose(lo, hi, rtol=1e-4, atol=1e-4).all(0).numpy()


@pytest.mark.parametrize('name', sorted(TRACE_CASES))
def test_traces_match_jax(name):
    """The eager trace and the fused trace's plain version with the field
    against the JAX package's ``simulate(track_field=True)`` (float64 where
    a metal or an absorbing film is on the path): the rays, the final
    field, |E|^2 and the |E|^2-weighted moments; FRESNEL rows on the JAX
    package's uniforms."""
    js, ts, pj, pt, rays_j, rays_t, E0, x64, nb = _trace_case(name)

    def jax_sim(p, r):
        return js.simulate(p, r, KEY, n_bundles=nb, track_field=True, E0=E0)
    if x64 is True:
        with enable_x64():
            res_j = _np(jax_sim(_to64(pj), _to64(rays_j)))
    else:
        res_j = _np(jax_sim(pj, rays_j))
    out_j, s_j, aux_j = res_j
    meta = ts.static_meta()
    u = rp.fresnel_uniforms(rp.prng_key(0), meta, rays_t.n)
    kw = dict(uniforms=u) if u.shape[0] else {}
    keep = np.ones(rays_t.n, bool)
    f_atol, i_rtol = {True: (2e-5, 2e-5), False: (2e-6, 1e-5),
                      'float32': (3e-4, 3e-4)}[x64]
    if u.shape[0]:
        keep = _stable(lambda v: ts.simulate(pt, rays_t, nb, uniforms=v,
                                             track_field=True, E0=E0)[0], u,
                       3e-4 if x64 == 'float32' else 1e-5)
        assert (~keep).sum() <= FRESNEL_FLIPS
    for sim in (ts.simulate, ts.simulate_fused):
        out_t, s_t, aux_t = sim(pt, rays_t, nb, track_field=True, E0=E0,
                                **kw)
        for c in ('px', 'py', 'pz'):
            _close(getattr(out_t, c).detach()[keep],
                   getattr(out_j, c)[keep], rtol=1e-6, atol=1e-5,
                   err_msg=c)
        for c in ('dx', 'dy', 'dz'):
            _close(getattr(out_t, c).detach()[keep],
                   getattr(out_j, c)[keep], atol=2e-6, err_msg=c)
        _close(out_t.intensity.detach()[keep], out_j.intensity[keep],
               rtol=i_rtol, atol=1e-7)
        for f in FIELDS:
            _close(getattr(aux_t['field'], f).detach()[keep],
                   getattr(aux_j['field'], f)[keep], atol=f_atol, err_msg=f)
        _close(aux_t['field_power'].detach()[keep],
               aux_j['field_power'][keep], atol=f_atol)
        if keep.all():
            scale = max(1.0, float(np.abs(s_j.moments).max()))
            _close(s_t.moments.detach(), s_j.moments, rtol=1e-4,
                   atol=1e-4 * scale)


def test_splitter_and_mirror_anchors():
    """The analytic anchors: the absorbing silver film at 45 degrees with
    pure s (tests/test_coatings.py:779-800) transmits the polarized Ts
    (FRESNEL_W, rtol 1e-4) with |E|^2 = 1, its FRESNEL draw's transmitted
    rays carry Ts / (1 - Rs); the aluminium mirrors (:362-385, :573-595)
    reflect intensity * |E|^2 = R (rtol 2e-3) with |E|^2 = 1 (rtol 1e-4)."""
    cos45 = torch.tensor(s2, dtype=torch.float64)
    rs, ts = tc.coating_rt([tc.METALS['AG'][0]], [torch.tensor(0.04)], 1.0,
                           NS, cos45, WL, pol='s',
                           k_stack=[tc.METALS['AG'][1]])
    for name in ('splitter_w', 'splitter_mc'):
        ts_, pt = _scene(trt, name), None
        pt = ts_.init_params('cpu')
        rays = trt.CollimatedDisk.make(
            radius=0.5, translation=[0, 0, -5.0],
            rotation=[math.pi / 4, 0.0, 0.0]).sample(
                torch.Generator().manual_seed(0), 4096, 'cpu')
        kw = {} if name == 'splitter_w' else dict(
            generator=torch.Generator().manual_seed(1))
        out, _, aux = ts_.simulate(pt, rays, track_field=True,
                                   E0=[[1.0, 0.0, 0.0]], **kw)
        _close(aux['field_power'], 1.0, rtol=1e-4)
        through = out.dz > 0
        want = float(ts) if name == 'splitter_w' else float(ts / (1 - rs))
        _close(out.intensity[through], want, rtol=1e-4)
        if name == 'splitter_mc':
            share = float((~through).double().mean())
            assert abs(share - float(rs)) < 5 * math.sqrt(
                float(rs * (1 - rs)) / rays.n)
    for name, wl in (('al', 0.0), ('al_disp', 0.80)):
        sc = _scene(trt, name)
        rays = trt.CollimatedDisk.make(
            radius=1.0, translation=[0, 0, 1.0], wavelength=wl).sample(
                torch.Generator().manual_seed(0), 500, 'cpu')
        out, _, aux = sc.simulate(sc.init_params('cpu'), rays,
                                  track_field=True)
        n_m, k_m = (tc.metal_nk_at(*tc.METAL_NK['AL'], torch.tensor(wl))
                    if wl else tc.METALS['AL'])
        n_m, k_m = float(n_m), float(k_m)
        r_bare = ((n_m - 1) ** 2 + k_m ** 2) / ((n_m + 1) ** 2 + k_m ** 2)
        alive = out.intensity > 0
        _close(aux['field_power'][alive], 1.0, rtol=1e-4)
        _close(float((out.intensity * aux['field_power'])[alive].mean()),
               r_bare, rtol=2e-3)


# ---- the Jones pupil ----

def _tilted(rt, coated=True):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       fresnel='weighted' if coated else False,
                       coating=[(NC, QW)] if coated else None,
                       rotation=[0.3, 0.0, 0.0], name='lens'),
        rt.SensorElement(radius=20.0, translation=[0, 0, 19.0],
                         name='sensor')])


def test_jones_pupil_matches_jax():
    """``jones_pupil`` on the coated singlet tilted 0.3 rad against the
    JAX package's at n = 16: the Jones matrices and mask, and the
    transmittance, diattenuation, retardance and Mueller maps (atol
    2e-6); the pupil traced by the fused trace's plain version gives the
    same Jones matrices."""
    js, ts = _tilted(jrt), _tilted(trt)
    pj = js.init_params()
    jp = jpol.jones_pupil(js, pj, KEY, pupil_radius=3.0, n=16)
    pt = interop.params_from_numpy(_np(pj), 'cpu')
    tp = tpol.jones_pupil(ts, pt, pupil_radius=3.0, n=16)
    np.testing.assert_array_equal(tp.mask.numpy(), jp.mask)
    _close(tp.j_re, jp.j_re, atol=2e-6)
    _close(tp.j_im, jp.j_im, atol=2e-6)
    for k in ('transmittance', 'diattenuation', 'retardance', 'mueller'):
        _close(getattr(tp, k), getattr(jp, k), atol=2e-6, err_msg=k)
    assert float(tp.diattenuation.max()) > 1e-3
    rays, xs, inside = tpol.pupil_rays(3.0, 16)
    cols = []
    for E0 in ([[1.0, 0.0, 0.0]], [[0.0, 1.0, 0.0]]):
        out, _, aux = ts.simulate_fused(pt, rays, track_field=True, E0=E0)
        cols.append((out, aux['field']))
    fp = tpol.pupil_of(cols, inside, xs)
    _close(fp.j_re, tp.j_re, atol=1e-7)
    _close(fp.j_im, tp.j_im, atol=1e-7)


def test_jones_pupil_anchors():
    """The analytic anchors of tests/test_polarization.py:293-345 (an axial
    plate: J = t I, no diattenuation or retardance; a plate tilted 0.9 rad:
    the two-face Fresnel diattenuation at the pupil's centre) and
    tests/test_polarization_optics.py:200-228 (a polarizer's Mueller matrix,
    a QWP at 45 degrees turning x-linear into circular)."""
    n = 1.5168
    sc = trt.SequentialScene([
        trt.SingletLens(c1=0.0, c2=0.0, d=30.0, t=3.0, ior_glass=n,
                        name='plate'),
        trt.SensorElement(radius=40.0, translation=[0, 0, 30.0], name='s')])
    jp = tpol.jones_pupil(sc, sc.init_params('cpu'), pupil_radius=3.0, n=8)
    J = jp.jones[jp.mask]
    t = (2.0 / (1 + n)) * (2 * n / (1 + n))
    _close(J[:, 0, 0].abs(), t, atol=2e-4)
    _close(J[:, 1, 1].abs(), t, atol=2e-4)
    _close(J[:, 0, 1].abs(), 0.0, atol=1e-5)
    _close(J[:, 1, 0].abs(), 0.0, atol=1e-5)
    assert float(jp.diattenuation[jp.mask].max()) < 1e-4
    assert float(jp.retardance[jp.mask].max()) < 1e-4
    _close(jp.transmittance[jp.mask], t * t, atol=5e-4)
    th = 0.9
    sc = trt.SequentialScene([
        trt.SingletLens(c1=0.0, c2=0.0, d=30.0, t=3.0, ior_glass=n,
                        rotation=[th, 0.0, 0.0], name='plate'),
        trt.SensorElement(radius=40.0, translation=[0, 0, 30.0], name='s')])
    jp = tpol.jones_pupil(sc, sc.init_params('cpu'), pupil_radius=4.0, n=16)
    c = 8
    assert bool(jp.mask[c, c])
    Jc = jp.jones[c, c]
    assert float(Jc[1, 1].abs()) > float(Jc[0, 0].abs())
    thp = math.asin(math.sin(th) / n)
    ts_ = (2 * math.cos(th) / (math.cos(th) + n * math.cos(thp))) * \
        (2 * n * math.cos(thp) / (n * math.cos(thp) + math.cos(th)))
    tp_ = (2 * math.cos(th) / (n * math.cos(th) + math.cos(thp))) * \
        (2 * n * math.cos(thp) / (math.cos(thp) + n * math.cos(th)))
    Ts, Tp = ts_ ** 2, tp_ ** 2
    _close(jp.diattenuation[c, c], (Tp - Ts) / (Tp + Ts), atol=2e-3)
    assert float(jp.retardance[c, c]) < 1e-3
    theta = 0.3

    def plate(el):
        return trt.SequentialScene([el, trt.SensorElement(
            radius=50.0, translation=[0, 0, 30.0], name='sens')])
    sc = plate(trt.LinearPolarizer(radius=10.0, angle=theta, name='pol'))
    M = tpol.jones_pupil(sc, sc.init_params('cpu'), pupil_radius=3.0,
                         n=8).mueller[4, 4]
    c2, s2_ = math.cos(2 * theta), math.sin(2 * theta)
    expect = 0.5 * np.array([[1.0, c2, s2_, 0.0],
                             [c2, c2 * c2, c2 * s2_, 0.0],
                             [s2_, c2 * s2_, s2_ * s2_, 0.0],
                             [0.0, 0.0, 0.0, 0.0]])
    _close(M, expect, atol=1e-5)
    sc = plate(trt.QuarterWaveplate(radius=10.0, angle=math.pi / 4,
                                    name='q'))
    M2 = tpol.jones_pupil(sc, sc.init_params('cpu'), pupil_radius=3.0,
                          n=8).mueller[4, 4]
    s_out = M2 @ torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=M2.dtype)
    _close(s_out[0], 1.0, atol=1e-5)
    _close(abs(float(s_out[3])), 1.0, atol=1e-5)
    _close(s_out[1], 0.0, atol=1e-5)


# ---- routing ----

def test_kinds_and_side_buffer_under_the_field():
    """A trace with the field gives a coated SNELL row its coating bits
    (its stack acts on the field alone; a trace without the field keeps
    them off, so the coated instantiation's tables do not move) and fills
    the side buffer of an absorbing stack and a dispersive metal."""
    sc = trt.SequentialScene([
        trt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                        coating=[(NC, QW), ('Ag', 0.01)], name='lens'),
        tmirror.SphericalMirror(c1=-0.01, d=40.0, metal='Au',
                                metal_dispersion=True,
                                translation=[0, 0, 50.0], name='m'),
        trt.SensorElement(radius=30.0, translation=[0, 0, -5.0], name='s')])
    meta = sc.static_meta()
    cfg = sc.sensor_config()
    plain = ft.kind_rows(meta, cfg)
    field = ft.kind_rows(ft.TraceMeta(meta, None, field=True), cfg)
    assert [r[0] >> ft.COAT_SHIFT for r in plain][:2] == [0, 0]
    bits = [(r[0] >> ft.COAT_SHIFT) & 0x7f for r in field]
    mirror = [m.metal for m in meta].index(True)
    assert bits[0] == bits[1] == 2 | ft.COAT_ABSORBING
    assert bits[mirror] == ft.COAT_METAL | ft.COAT_METAL_NK
    side = ft.coat_side(ft.TraceMeta(meta, None, field=True), 'cpu')
    assert float(side[0, 1]) == pytest.approx(tc.METALS['AG'][1])
    assert float(side[mirror, 8]) == pytest.approx(tc.METAL_NK['AU'][0][0])
