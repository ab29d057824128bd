"""The hand-written adjoints of the coated and metal field against torch
autograd, on the host: tests/field_coat_harness.cpp, built with g++ from
csrc/thin_film.cuh and csrc/field.cuh (both __host__ __device__ and free of
CUDA types), holds a stack's R, T and complex amplitudes from one
evaluation (thin_film.cuh::stack_field) and their adjoint through one
reverse sweep (stack_field_ct), the field's transport through a coated
interface and a metal mirror (field.cuh::field_transport and its adjoint,
with the stack taken back through as the kernels do) and the polarized
reflectance and transmittance (polarized_rt and its adjoint) to the plain
versions, which evaluate R, T and the amplitudes apart
(utils/coatings.py::coating_rt, coating_amplitudes, metal_reflectance,
metal_reflection_amplitudes, core/field.py::transport_field,
core/static_dispatch.py::polarized_RT's weighing) in float64, on seeded
random inputs: 0, 1, 2 and 8 layers, both orders, dielectric and absorbing
stacks, bare and coated metals.

Tolerances, each with its reason: the harness runs in float32 and the
reference in float64, so values within AMP_ATOL (a stack's amplitudes are
a few dozen float32 roundings of O(1) numbers per layer: ~1e-6, the 10 nm
silver film's complex path ~1e-5); a cotangent within GRAD_RTOL of the
float64 one plus GRAD_RTOL of the largest of its group (the same float32
roundings, through the reverse sweep's divisions by |eta0 B + C|^2).
Skipped only where no g++ is found.
"""

import ctypes
import math
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracetorch_tpu_torch.constants import PhysKind
from raytracetorch_tpu_torch.core import field as tfield
from raytracetorch_tpu_torch.core.static_dispatch import StaticRowMeta
from raytracetorch_tpu_torch.utils import coatings as tc

HARNESS = Path(__file__).with_name('field_coat_harness.cpp')
AMP_ATOL = 3e-5
GRAD_RTOL = 2e-3
D64 = torch.float64
NH, NL = 2.35, 1.38
QW = 0.5876 / 4

_P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ on this machine to build the host harness of '
                    'csrc/field.cuh and csrc/thin_film.cuh')
    out = tmp_path_factory.mktemp('harness') / 'field_coat_harness.so'
    subprocess.run([gxx, '-O2', '-std=c++17', '-shared', '-fPIC',
                    '-o', str(out), str(HARNESS)], check=True)
    return ctypes.CDLL(str(out))


def _f(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return a, a.ctypes.data_as(_P)


def _i(a):
    a = np.ascontiguousarray(a, dtype=np.int32)
    return a, a.ctypes.data_as(_I)


def _call(fn, *args, n_out):
    keep, cargs = [], []
    for a in args:
        if isinstance(a, int):
            cargs.append(ctypes.c_int(a))
        else:
            kind, arr = a
            arr, ptr = (_i if kind == 'i' else _f)(arr)
            keep.append(arr)
            cargs.append(ptr)
    out, optr = _f(np.zeros(n_out))
    fn(*cargs, optr)
    return out.astype(np.float64)


def _close_grads(got, want, err_msg=''):
    want = np.asarray(want, dtype=np.float64)
    if want.size == 0:
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * scale, err_msg=err_msg)


# ---- stacks ----

def _stacks():
    """(name, layers [(n, k, d)], metal (n, k) or None) of the cases."""
    silver = tc.METALS['AG']
    return [
        ('bare', [], None),
        ('qw', [(NL, 0.0, QW / NL)], None),
        ('pair', [(NH, 0.0, QW / NH), (NL, 0.0, QW / NL)], None),
        ('eight', [(NH, 0.0, QW / NH), (NL, 0.0, QW / NL)] * 3
         + [(NH, 0.0, QW / NH), (NL, 0.0, 0.07)], None),
        ('silver_film', [(silver[0], silver[1], 0.04)], None),
        ('stack8_ag', [(NH, 0.0, QW / NH), (NL, 0.0, QW / NL)] * 3
         + [(NH, 0.0, QW / NH), (silver[0], silver[1], 0.01)], None),
        ('al', [], tc.METALS['AL']),
        ('enhanced_al', [(NL, 0.0, QW / NL), (NH, 0.0, QW / NH)],
         tc.METALS['AL']),
        ('ag_over_al', [(silver[0], silver[1], 0.02)], tc.METALS['AL']),
    ]


STACK_NAMES = [s[0] for s in _stacks()]


def _stack_arrays(layers, metal, n_in, n_out, cos_i, lam, rev):
    coat = np.zeros(16)
    k = np.zeros(8)
    for j, (n, kk, d) in enumerate(layers):
        coat[2 * j], coat[2 * j + 1], k[j] = n, d, kk
    absorbing = any(kk != 0.0 for _, kk, _ in layers)
    f = [n_in, metal[0] if metal else n_out, metal[1] if metal else 0.0,
         cos_i, lam]
    ints = [len(layers), int(rev), int(absorbing), int(metal is not None)]
    return coat, k, ints, f


def _ref_amps(layers, metal, f, rev, p):
    """The plain version's (R, T, t, r) in float64, each evaluated apart (a
    metal's T and t zero: not read), and its leaves: n_in, n_out, k_out,
    cos_i, lam and the thicknesses (in storage order)."""
    leaves = [torch.tensor(v, dtype=D64, requires_grad=True) for v in f]
    ds = [torch.tensor(d, dtype=D64, requires_grad=True)
          for _, _, d in layers]
    order = list(range(len(layers)))[::-1] if rev else list(range(len(layers)))
    ns = [layers[j][0] for j in order]
    ks = [layers[j][1] for j in order]
    dl = [ds[j] for j in order]
    k_stack = ks if any(ks) else None
    pol = 'p' if p else 's'
    n_in, n_out, k_out, cos_i, lam = leaves
    zero = torch.zeros((), dtype=D64)
    if metal is not None:
        r = tc.metal_reflection_amplitudes(ns, dl, n_in, n_out, k_out, cos_i,
                                           lam, pol=pol, k_stack=k_stack)
        R = tc.metal_reflectance(ns, dl, n_in, n_out, k_out, cos_i, lam,
                                 pol=pol, k_stack=k_stack)
        T, t = zero, (zero, zero)
    else:
        t, r = tc.coating_amplitudes(ns, dl, n_in, n_out, cos_i, lam,
                                     pol=pol, k_stack=k_stack)
        R, T = tc.coating_rt(ns, dl, n_in, n_out, cos_i, lam, pol=pol,
                             k_stack=k_stack)
    return (R, T, *t, *r), leaves, ds


def _stack_inputs(rng, layers, metal):
    cos_i = float(rng.uniform(0.55, 0.99))
    lam = float(rng.uniform(0.45, 0.7))
    n_in, n_out = (1.0, 1.52) if rng.uniform() < 0.5 else (1.52, 1.0)
    if metal is not None:
        n_in = float(rng.uniform(1.0, 1.6))
    return n_in, n_out, cos_i, lam


@pytest.mark.parametrize('name', STACK_NAMES)
def test_stack_amplitudes_and_adjoint(lib, name):
    """stack_field and stack_field_ct (R, T and the amplitudes from one
    (B, C)) against coating_rt and coating_amplitudes (a metal's
    metal_reflectance and metal_reflection_amplitudes), which evaluate them
    apart, and their autograd under cotangents of all four at once, s and
    p, in the order the ray meets the layers (reversed from the higher
    index, as the kernels and the plain version read them)."""
    layers, metal = {s[0]: s[1:] for s in _stacks()}[name]
    rng = np.random.default_rng(len(name) * 7 + 3)
    for trial in range(6):
        n_in, n_out, cos_i, lam = _stack_inputs(rng, layers, metal)
        rev = len(layers) > 1 and metal is None and not n_in < n_out
        coat, k, ints, f = _stack_arrays(layers, metal, n_in, n_out, cos_i,
                                         lam, rev)
        args = (('f', coat), ('f', k), ('i', ints), ('f', f))
        for p in (0, 1):
            got = _call(lib.h_stack_field, *args, p, n_out=6)
            vals, leaves, ds = _ref_amps(layers, metal, f, rev, p)
            want = [float(x.detach()) for x in vals]
            if metal is not None:
                got[1:4] = 0.0
            np.testing.assert_allclose(got, want, atol=AMP_ATOL,
                                       err_msg=f'{name} {trial} p={p}')
            g = rng.normal(size=6)
            if metal is not None:
                g[1:4] = 0.0
            g_k = _call(lib.h_stack_field_ct, *args, p, ('f', g), n_out=13)
            out = sum(gg * o for gg, o in zip(g, vals))
            wrt = leaves + ds
            grads = torch.autograd.grad(out, wrt, allow_unused=True)
            grads = [0.0 if gr is None else float(gr) for gr in grads]
            want_g = grads[:5] + [0.0] * 8
            for j in range(len(ds)):
                want_g[5 + j] = grads[5 + j]
            if metal is None:
                want_g[2] = g_k[2]      # no substrate extinction
            _close_grads(g_k, want_g, f'{name} {trial} p={p}')


def test_bare_limit_equals_fresnel_amplitudes(lib):
    """An empty stack and one of zero thickness give the bare interface's
    Fresnel amplitudes (core/field.py::fresnel_amplitudes) on the host, in
    both directions, s and p."""
    for n_in, n_out in ((1.0, 1.5168), (1.5168, 1.0), (1.5, 1.5)):
        for cos_i in (1.0, 0.9, 0.7):
            sin2 = (n_in / n_out) ** 2 * (1 - cos_i ** 2)
            if sin2 > 1:
                continue
            ts, tp, rs, rp, _ = tfield.fresnel_amplitudes(
                *(torch.tensor(v, dtype=D64)
                  for v in (n_in, n_out, cos_i, sin2)))
            for layers in ([], [(1.38, 0.0, 0.0)]):
                coat, k, ints, f = _stack_arrays(layers, None, n_in, n_out,
                                                 cos_i, 0.55, False)
                args = (('f', coat), ('f', k), ('i', ints), ('f', f))
                for p, (t, r) in ((0, (ts, rs)), (1, (tp, rp))):
                    got = _call(lib.h_stack_field, *args, p, n_out=6)[2:]
                    np.testing.assert_allclose(
                        got, [float(t), 0.0, float(r[0]), float(r[1])],
                        atol=2e-6)


# ---- the transport ----

def _transport_case(rng, kind, stack, reflect):
    """One ray meeting a plane with normal nw: (ph, row floats, stack kind,
    meta, the row's ph and coat, the incoming field, new direction)."""
    theta = float(rng.uniform(0.1, 0.6))
    phi = float(rng.uniform(0, 2 * math.pi))
    d = np.array([math.sin(theta) * math.cos(phi),
                  math.sin(theta) * math.sin(phi), math.cos(theta)])
    nw = np.array([0.05, -0.03, -1.0])
    nw /= np.linalg.norm(nw)
    dn = d @ nw
    if reflect:
        nd = d - 2 * dn * nw
    else:
        mu = 1.0 / 1.52
        ci = abs(dn)
        ct = math.sqrt(1 - mu * mu * (1 - ci * ci))
        nd = mu * d + (mu * ci - ct) * nw    # from_in: dn < 0
    e = rng.normal(size=6)
    layers, metal = {s[0]: s[1:] for s in _stacks()}[stack]
    ks = [kk for _, kk, _ in layers]
    meta = StaticRowMeta(kind, 0, 0, n_coat=len(layers),
                         coat_k=ks if any(ks) else None,
                         metal=metal is not None)
    coat = np.zeros(16)
    for j, (n, _, dd) in enumerate(layers):
        coat[2 * j], coat[2 * j + 1] = n, dd
    ph = (np.array([metal[0], metal[1], 1.0, 0, 0, 0]) if metal is not None
          else np.array([1.0, 1.52, 0, 0, 0, 0]))
    return d, nd, nw, e, meta, ph, coat, layers, metal


TRANSPORT_CASES = [
    ('snell_qw', PhysKind.SNELL, 'qw', False),
    ('snell_eight', PhysKind.SNELL, 'eight', False),
    ('fresnel_w_pair', PhysKind.FRESNEL_W, 'pair', False),
    ('fresnel_w_silver', PhysKind.FRESNEL_W, 'silver_film', False),
    ('fresnel_reflect_pair', PhysKind.FRESNEL, 'pair', True),
    ('reflect_w_stack8_ag', PhysKind.REFLECT_W, 'stack8_ag', True),
    ('metal_al', PhysKind.REFLECT, 'al', True),
    ('metal_enhanced', PhysKind.REFLECT, 'enhanced_al', True),
    ('metal_ag_over_al', PhysKind.REFLECT, 'ag_over_al', True),
]


@pytest.mark.parametrize('case', TRANSPORT_CASES, ids=lambda c: c[0])
def test_transport_and_adjoint(lib, case):
    """field_transport and field_transport_ct through a coated interface
    (transmitted and reflected, the Fresnel kinds renormalized, SNELL not)
    and a metal mirror against core/field.py::transport_field and its
    autograd: the new field; the cotangents of the incoming field, the
    directions, the normal, the media (or a metal's ambient and (n, k)),
    the wavelength and the thicknesses."""
    name, kind, stack, reflect = case
    rng = np.random.default_rng(sum(map(ord, name)))
    for trial in range(4):
        d, nd, nw, e, meta, ph, coat, layers, metal = _transport_case(
            rng, kind, stack, reflect)
        lam = float(rng.uniform(0.45, 0.7))
        from_in = d @ nw < 0
        n1, n2 = (ph[0], ph[1]) if from_in else (ph[1], ph[0])
        row = np.concatenate([d, nd, nw, [n1, n2, 1.0]])
        stack_kind = 2 if metal is not None else 1
        if metal is not None:
            f = [ph[2], ph[0], ph[1], 0.0, lam]
        else:
            f = [n1, n2, 0.0, 0.0, lam]
        ints = [len(layers), int(len(layers) > 1 and metal is None
                                 and not n1 < n2),
                int(meta.coat_k is not None), int(metal is not None)]
        kvec = np.zeros(8)
        for j, (_, kk, _) in enumerate(layers):
            kvec[j] = kk
        args = (int(kind), ('f', row), stack_kind, ('f', coat), ('f', kvec),
                ('i', ints), ('f', f), ('f', e))
        got = _call(lib.h_transport, *args, n_out=6)
        # the plain version in float64
        leaf = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                      requires_grad=True)
        d_t, nd_t, nw_t, e_t = leaf(d), leaf(nd), leaf(nw), leaf(e)
        ph_t, coat_t, wl_t = leaf(ph), leaf(coat), leaf([lam])
        row_ns = types.SimpleNamespace(ph=ph_t[None], coat=coat_t[None])
        col = lambda v: tuple(v[j][None] for j in range(3))
        Er, Ei = tfield.transport_field(
            meta, row_ns, col(d_t), col(nd_t), col(nw_t),
            torch.ones(1, dtype=D64), col(e_t[:3]), col(e_t[3:]), wl_t)
        want = torch.cat([*Er, *Ei])
        np.testing.assert_allclose(got, want.detach().numpy(),
                                   atol=AMP_ATOL, err_msg=f'{name} {trial}')
        g = rng.normal(size=6)
        g_k = _call(lib.h_transport_ct, *args, ('f', g), n_out=31)
        grads = torch.autograd.grad(
            (want * torch.tensor(g)).sum(),
            [e_t, d_t, nd_t, nw_t, ph_t, coat_t, wl_t], allow_unused=True)
        g_e, g_d, g_nd, g_nw, g_ph, g_coat, g_wl = [
            np.zeros(1) if gr is None else gr.numpy() for gr in grads]
        _close_grads(g_k[0:6], g_e, f'{name} {trial} field')
        _close_grads(np.concatenate([g_k[6:9], g_k[9:12], g_k[12:15]]),
                     np.concatenate([g_d, g_nd, g_nw]),
                     f'{name} {trial} directions')
        st = g_k[18:31]
        if metal is not None:
            g_ph_k = np.array([st[1], st[2], st[0]])
            want_ph = g_ph[:3]
        else:
            g_n1, g_n2 = g_k[15], g_k[16]
            g_ph_k = np.array([g_n1, g_n2] if from_in else [g_n2, g_n1])
            want_ph = g_ph[:2]
        g_d_k = np.array([st[5 + j] for j in range(len(layers))])
        want_d = np.array([g_coat[2 * j + 1] for j in range(len(layers))])
        _close_grads(g_ph_k, want_ph, f'{name} {trial} media')
        _close_grads(g_d_k, want_d, f'{name} {trial} thicknesses')
        _close_grads([st[4]], g_wl, f'{name} {trial} wavelength')


def test_polarized_rt_and_adjoint(lib):
    """polarized_rt and its adjoint (through the s/p basis) against the
    weighing of core/static_dispatch.py::polarized_RT and its autograd, on
    random fields, directions and (Rs, Rp, Ts, Tp)."""
    rng = np.random.default_rng(7)
    for trial in range(12):
        e = rng.normal(size=6)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        nw = rng.normal(size=3)
        nw /= np.linalg.norm(nw)
        rt = rng.uniform(0.0, 1.0, size=4)
        args = (('f', e), ('f', d), ('f', nw), ('f', rt))
        got = _call(lib.h_polarized_rt, *args, n_out=2)
        leaf = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                      requires_grad=True)
        e_t, d_t, nw_t, rt_t = leaf(e), leaf(d), leaf(nw), leaf(rt)
        fs, fp = tfield.sp_power_fractions(
            tuple(e_t[:3]), tuple(e_t[3:]), tuple(d_t), tuple(nw_t))
        frac = torch.clamp(fs + fp, min=1e-20)
        R = (rt_t[0] * fs + rt_t[1] * fp) / frac
        T = (rt_t[2] * fs + rt_t[3] * fp) / frac
        np.testing.assert_allclose(got, [float(R), float(T)], atol=2e-6)
        g = rng.normal(size=2)
        g_k = _call(lib.h_polarized_rt_ct, *args, ('f', g), n_out=16)
        grads = torch.autograd.grad(g[0] * R + g[1] * T,
                                    [e_t, d_t, nw_t, rt_t])
        want = np.concatenate([gr.numpy() for gr in grads])
        _close_grads(g_k, want, f'trial {trial}')
