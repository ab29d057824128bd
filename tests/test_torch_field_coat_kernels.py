"""The plain versions of K1's and K2's instantiation with the field in the
PyTorch port, through coated interfaces and metal mirrors, against the JAX
package on the CPU: K1's plain version on the coated FRESNEL_W bench
singlet against the JAX package's ``simulate_fused`` in interpret mode (its
kernel K1 with the coated field); K2's plain version (the fused trace's
backward) and the eager trace's autograd against ``jax.grad`` of the JAX
package's trace, where its fused backward routes under interpret mode, in
the curvatures, the coat thicknesses and E0 (the absorbing silver-film
splitter against the JAX package in float64).  The scenes and rays are
tests/test_torch_field_coat.py's.

Tolerances, each with its reason: the field's streams atol 2e-6 (float32,
another compilation's contractions); positions rtol 1e-6 + atol 1e-5,
directions and intensities atol 2e-6; moments rtol 1e-5 + atol 1e-5 of
their scale (sums in another order); gradients rtol 2e-3 of the leaf's
scale (float32 adjoints of sums over the rays in another order; the JAX
test's own rtol for E0, tests/test_torch_field_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from test_torch_field_coat import (FIELDS, KEY, N, _close, _np, _to64,
                                   _trace_case)

torch.set_num_threads(2)


def test_plain_k1_vs_jax_kernel():
    """K1's plain version with the field on the coated FRESNEL_W singlet
    against the JAX package's ``simulate_fused`` in interpret mode (its
    kernel K1 with the coated field): the final field, |E|^2, the rays and
    the moments."""
    js, ts, pj, pt, rays_j, rays_t, E0, _, nb = _trace_case('coated_w')
    out_j, s_j, aux_j = js.simulate_fused(pj, rays_j, KEY, track_field=True,
                                          E0=E0, interpret=True,
                                          block_rows=4)
    out_t, s_t, aux_t = ts.simulate_fused(pt, rays_t, track_field=True,
                                          E0=E0)
    for f in FIELDS:
        _close(getattr(aux_t['field'], f), getattr(aux_j['field'], f),
               atol=2e-6, err_msg=f)
    for c in ('px', 'py', 'pz'):
        _close(getattr(out_t, c), getattr(out_j, c), rtol=1e-6, atol=1e-5)
    for c in ('dx', 'dy', 'dz', 'intensity'):
        _close(getattr(out_t, c), getattr(out_j, c), atol=2e-6)
    ref = np.asarray(s_j.moments)
    _close(s_t.moments, ref, rtol=1e-5,
           atol=1e-5 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize('name', ['coated_w', 'splitter_w'])
def test_plain_k2_vs_jax_grad(name):
    """K2's plain version (the fused trace's backward with the field)
    against ``jax.grad`` of the JAX package's trace (where its fused
    backward routes under interpret mode): the flux intensity * |E|^2 on
    the sensor plus the spot, in the curvatures, the coat thicknesses and
    E0 (the silver-film splitter in float64 on the JAX side)."""
    js, ts, pj, pt, rays_j, rays_t, E0, x64, nb = _trace_case(name)
    e0 = np.array([[0.8, 0.6, 0.0]], np.float32)
    leaves = {'coated_w': ('c1', 'c2', 'coat_d'),
              'splitter_w': ('coat_d',)}[name]
    el = 'lens' if name == 'coated_w' else 'bs'

    def loss_j(p, e):
        _, sens, _ = js.simulate(p, rays_j if not x64 else _to64(rays_j),
                                 KEY, track_field=True, E0=e)
        return sens.total_weight(0)[0] / N + sens.spot_rms(0)[0]
    if x64:
        with enable_x64():
            g_j, ge_j = _np(jax.grad(loss_j, argnums=(0, 1))(
                _to64(pj), jnp.asarray(e0, jnp.float64)))
    else:
        g_j, ge_j = jax.grad(loss_j, argnums=(0, 1))(pj, jnp.asarray(e0))
    for sim in (ts.simulate, ts.simulate_fused):
        p = {e: dict(v) for e, v in pt.items()}
        for k in leaves:
            p[el][k] = p[el][k].clone().requires_grad_(True)
        e_t = torch.from_numpy(e0).requires_grad_(True)
        _, sens, _ = sim(p, rays_t, track_field=True, E0=e_t)
        loss = sens.total_weight(0)[0] / N + sens.spot_rms(0)[0]
        grads = torch.autograd.grad(loss, [p[el][k] for k in leaves]
                                    + [e_t])
        for k, g in zip(leaves, grads):
            ref = np.asarray(g_j[el][k])
            assert np.abs(ref).max() > 0
            _close(g, ref, rtol=2e-3, atol=2e-3 * np.abs(ref).max(),
                   err_msg=k)
        _close(grads[-1], ge_j, rtol=2e-3, atol=1e-5)
