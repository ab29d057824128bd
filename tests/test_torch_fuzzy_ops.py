"""The fuzzy programs' lowered operations (``**``, ``clamp``, ``==``,
``!=``, ``minimum``, ``maximum``: ops/fuzzy_program.py) on the CPU: an
apodizer written with them traces into a program of the existing op set,
whose value and partials equal the callable's and autograd's, and goes
through the port's fused path (K1's and K2's plain versions) as the JAX
fused kernel in interpret mode runs the same callable written with
``jnp``.

Tolerances as tests/test_torch_fuzzy_kernels.py's (the helper
``_kernels_vs_plain`` of tests/test_torch_freeform_kernels.py); the
program's value rtol 1e-6 / atol 1e-7 and partials rtol 1e-5 / atol 1e-6
against autograd (float32 operations in another order).
"""

import jax.numpy as jnp
import numpy as np
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch.ops import fuzzy_program as fp
from test_torch_freeform import _close, _disk
from test_torch_freeform_kernels import _kernels_vs_plain

torch.set_num_threads(2)


def apod_j(x, y, z):
    r2 = x ** 2 + y ** 2
    w = jnp.clip(1.0 - r2 / 20.0, 0.0, 1.0) ** 2
    w = jnp.maximum(w, 0.05) * jnp.minimum(1.0 + 0.1 * x, 1.2)
    return jnp.where((x == 0.0) | (y != y), 0.0, w)


def apod_t(x, y, z):
    r2 = x ** 2 + y ** 2
    w = torch.clamp(1.0 - r2 / 20.0, 0.0, 1.0) ** 2
    w = torch.maximum(w, torch.tensor(0.05)) * torch.minimum(
        1.0 + 0.1 * x, torch.tensor(1.2))
    return torch.where((x == 0.0) | (y != y), 0.0, w)


def powers_t(x, y, z):
    # a negative and a zero exponent beside the positive ones
    return 1.0 / (4.0 + x ** 2) + (1.0 + y * y) ** -3 + z ** 0


def test_lowered_fuzzy_ops_match_jax_kernel():
    """An apodizer written with ``**``, ``clamp``, ``minimum``,
    ``maximum``, ``==`` and ``!=`` traces into a program of the existing op
    set (no new op code), whose value and partials equal the callable's and
    autograd's, and goes through the port's fused path (K1's and K2's plain
    versions) as the JAX fused kernel in interpret mode runs the ``jnp``
    callable: intensities, moments and cotangents with the tolerances of
    tests/test_torch_fuzzy.py."""
    def scene(rt, fn):
        return rt.SequentialScene([
            rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                           name='lens'),
            rt.FuzzyAperture(fn, components=True, name='apod',
                             translation=[0, 0, 6.0]),
            rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                             name='sensor')])
    js, ts = scene(jrt, apod_j), scene(trt, apod_t)
    prog = fp.trace(ts.fuzzy_fns()[min(ts.fuzzy_fns())])
    assert max(code for code, *_ in prog.ops) < len(fp.OPS)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-4, 4, 300), dtype=torch.float32)
    y = torch.tensor(rng.uniform(-4, 4, 300), dtype=torch.float32)
    z = torch.zeros(300)
    for fn, p_ in ((apod_t, prog),
                   (powers_t, fp.trace(trt.ComponentFuzzy(powers_t)))):
        xg = x.clone().requires_grad_(True)
        yg = y.clone().requires_grad_(True)
        ref = fn(xg, yg, z)
        w, (gx, gy, _) = fp.evaluate(p_, x, y, z, partials=True)
        _close(w, ref.detach(), rtol=1e-6, atol=1e-7)
        ax, ay = torch.autograd.grad(ref.sum(), (xg, yg))
        _close(gx, ax, rtol=1e-5, atol=1e-6)
        _close(gy, ay, rtol=1e-5, atol=1e-6)
    rays_j, rays_t = _disk(128, 4.0, -10.0)
    _kernels_vs_plain(js, ts, rays_j, rays_t, 19.0, js.fuzzy_fns(),
                      ts.fuzzy_fns())
    out = ts.simulate_fused(ts.init_params('cpu'), rays_t)[0]
    assert 0.0 < float(out.intensity.sum()) < rays_t.n
