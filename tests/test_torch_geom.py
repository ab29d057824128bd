"""Parity of the PyTorch port's geometry with the JAX package.

The same float32 inputs, drawn with numpy from a fixed seed, go through
``raytracetorch_tpu.geom`` and ``raytracetorch_tpu_torch.geom``.  Tolerance:
rtol 1e-6 with atol 1e-6 on O(1) values (a few float32 ulps: the two
packages evaluate sin/cos/sqrt in different libraries), unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracetorch_tpu.geom import surfaces as jsurf
from raytracetorch_tpu.geom import transform as jtr
from raytracetorch_tpu_torch.geom import surfaces as tsurf
from raytracetorch_tpu_torch.geom import transform as ttr

torch.set_num_threads(2)

N = 4096
RTOL = 1e-6
ATOL = 1e-6


def _rot_vecs(seed):
    r = np.random.default_rng(seed).normal(size=(N, 3)).astype(np.float32)
    r[:64] *= 1e-7            # the small-angle (Taylor) branch
    r[64:128] = 0.0           # exactly zero rotation
    return r


def _quadric_case(seed):
    """Random quadrics (planes, spheres, conics, cylinders) and rays."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.2, 0.2, N)
    k = rng.uniform(-1.5, 1.0, N)
    q = np.stack([c, c, c * (1 + k), np.full(N, -2.0), np.zeros(N)], 1)
    q[: N // 8] = [0.0, 0.0, 0.0, -2.0, 0.0]                   # planes
    r = rng.uniform(1.0, 10.0, N // 8)
    q[N // 8: N // 4] = np.stack([np.ones_like(r), np.ones_like(r),
                                  np.zeros_like(r), np.zeros_like(r),
                                  -r * r], 1)                 # cylinders
    o = rng.normal(0.0, 4.0, (N, 3))
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:16] = 0.0                                              # degenerate
    return q.astype(np.float32), o.astype(np.float32), d.astype(np.float32)


def _tuple(a, lib):
    return tuple(lib(a[:, i]) for i in range(3))


def _rodrigues_f64(r):
    """Rodrigues in float64 numpy: the yardstick that says which package
    is off when the two disagree (ROADMAP Queue 3: a flake of this test)."""
    r = r.astype(np.float64)
    t2 = (r * r).sum(-1)
    small = t2 < 1e-12
    t = np.sqrt(np.where(small, 1.0, t2))
    a = np.where(small, 1.0 - t2 / 6.0, np.sin(t) / t)
    b = np.where(small, 0.5 - t2 / 24.0, (1.0 - np.cos(t)) / np.where(
        small, 1.0, t2))
    z = np.zeros_like(t2)
    k = np.stack([z, -r[:, 2], r[:, 1], r[:, 2], z, -r[:, 0], -r[:, 1],
                  r[:, 0], z], -1).reshape(-1, 3, 3)
    return np.eye(3) + a[:, None, None] * k + b[:, None, None] * (k @ k)


def test_rodrigues_matches_jax():
    r = _rot_vecs(0)
    ref = np.asarray(jtr.rodrigues(jnp.asarray(r)))
    got = ttr.rodrigues(torch.from_numpy(r)).numpy()
    f64 = _rodrigues_f64(r)
    np.testing.assert_allclose(
        got, ref, rtol=RTOL, atol=ATOL,
        err_msg=f'max |torch - f64| {np.abs(got - f64).max():.3e}, '
                f'max |jax - f64| {np.abs(ref - f64).max():.3e}, '
                f'torch threads {torch.get_num_threads()}')


def test_rodrigues_gradient_matches_jax():
    """d/d rot_vec of sum(W * R(rot_vec)), including the r = 0 branch:
    rtol 1e-5 (the gradient chains sin, cos and a division)."""
    r = _rot_vecs(1)
    w = np.random.default_rng(2).normal(size=(N, 3, 3)).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda x: jnp.sum(jtr.rodrigues(x) * w))(jnp.asarray(r)))
    rt = torch.from_numpy(r).requires_grad_(True)
    torch.sum(ttr.rodrigues(rt) * torch.from_numpy(w)).backward()
    assert np.isfinite(rt.grad.numpy()).all()
    np.testing.assert_allclose(rt.grad.numpy(), ref, rtol=1e-5, atol=1e-5)


def _root_scale(q, o, d):
    """Magnitude of the operands each root is formed from: (|B| + sqrt|disc|)
    / |2A| for the quadratic roots, |C / B| for the linear one.  A float32
    rounding of the discriminant moves a root by ~1e-7 of this, even where
    -B -+ sqrt(disc) cancels and the root itself is small."""
    q, o, d = (x.astype(np.float64) for x in (q, o, d))
    A = (q[:, :3] * d * d).sum(1)
    B = 2.0 * (q[:, :3] * o * d).sum(1) + q[:, 3] * d[:, 2]
    C = (q[:, :3] * o * o).sum(1) + q[:, 3] * o[:, 2] + q[:, 4]
    linear = np.abs(A) < 1e-6
    quad = (np.abs(B) + np.sqrt(np.abs(B * B - 4 * A * C))) / np.abs(
        2 * np.where(linear, 1.0, A))
    lin = np.abs(C) / np.maximum(np.abs(B), 1e-6)
    return np.where(linear, lin, quad)


def test_solve_roots_matches_jax():
    """Both roots and their validity, the sanitized values of misses
    included.  Roots agree to rtol 1e-6 of the operand scale
    (``_root_scale``): the two compilers round B*B - 4AC differently."""
    q, o, d = _quadric_case(3)
    tol = RTOL * _root_scale(q, o, d) + ATOL
    (jt1, jv1), (jt2, jv2) = jsurf.solve_roots(
        jnp.asarray(q), _tuple(o, jnp.asarray), _tuple(d, jnp.asarray))
    (tt1, tv1), (tt2, tv2) = tsurf.solve_roots(
        torch.from_numpy(q), _tuple(o, torch.from_numpy),
        _tuple(d, torch.from_numpy))
    np.testing.assert_array_equal(tv1.numpy(), np.asarray(jv1))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))
    assert np.isfinite(tt1.numpy()).all() and np.isfinite(tt2.numpy()).all()
    for t_port, t_ref in ((tt1, jt1), (tt2, jt2)):
        err = np.abs(t_port.numpy() - np.asarray(t_ref))
        assert (err <= tol).all(), (err / tol).max()


@pytest.mark.parametrize('with_scale', [False, True])
def test_min_positive_matches_jax(with_scale):
    rng = np.random.default_rng(4)
    t1, t2 = (rng.normal(0.0, 5.0, N).astype(np.float32) for _ in range(2))
    t1[:64] = 1e-7                      # inside the self-intersection eps
    v1, v2 = rng.random(N) > 0.2, rng.random(N) > 0.2
    scale = rng.uniform(0.0, 50.0, N).astype(np.float32)
    jroots = [(jnp.asarray(t1), jnp.asarray(v1)),
              (jnp.asarray(t2), jnp.asarray(v2))]
    troots = [(torch.from_numpy(t1), torch.from_numpy(v1)),
              (torch.from_numpy(t2), torch.from_numpy(v2))]
    jt, jv = jsurf.min_positive(
        jroots, scale=jnp.asarray(scale) if with_scale else None)
    tt, tv = tsurf.min_positive(
        troots, scale=torch.from_numpy(scale) if with_scale else None)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=0.0)
    assert (tt.numpy()[~tv.numpy()] == 0.0).all()


def test_surface_normal_matches_jax():
    q, p, _ = _quadric_case(5)
    p[:8] = 0.0                               # degenerate gradients
    q[:8] = 0.0
    sign = np.where(np.random.default_rng(6).random(N) < 0.5, -1.0,
                    1.0).astype(np.float32)
    jn = jsurf.surface_normal(jnp.asarray(q), jnp.asarray(sign),
                              _tuple(p, jnp.asarray))
    tn = tsurf.surface_normal(torch.from_numpy(q), torch.from_numpy(sign),
                              _tuple(p, torch.from_numpy))
    for a, b in zip(tn, jn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_sag_and_frame_paraxial_match_jax():
    rng = np.random.default_rng(7)
    c = rng.uniform(-0.2, 0.2, N).astype(np.float32)
    r = rng.uniform(0.0, 8.0, N).astype(np.float32)
    np.testing.assert_allclose(
        tsurf.sag_z(torch.from_numpy(c), torch.from_numpy(r)).numpy(),
        np.asarray(jsurf.sag_z(jnp.asarray(c), jnp.asarray(r))),
        rtol=RTOL, atol=ATOL)
    rot, trans = rng.normal(size=(2, 3)).astype(np.float32)
    jf = jtr.Frame(rot_vec=jnp.asarray(rot), trans=jnp.asarray(trans))
    tf = ttr.Frame(rot_vec=torch.from_numpy(rot),
                   trans=torch.from_numpy(trans))
    np.testing.assert_array_equal(tf.paraxial().numpy(),
                                  np.asarray(jf.paraxial()))
    np.testing.assert_array_equal(tf.paraxial_inv().numpy(),
                                  np.asarray(jf.paraxial_inv()))
    pts = rng.normal(size=(N, 3)).astype(np.float32)
    for jres, tres in zip(jf.to_local(jnp.asarray(pts), jnp.asarray(pts)),
                          tf.to_local(torch.from_numpy(pts),
                                      torch.from_numpy(pts))):
        np.testing.assert_allclose(tres.numpy(), np.asarray(jres),
                                   rtol=RTOL, atol=1e-5)
