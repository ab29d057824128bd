"""The PyTorch port's first slice end to end: ``SequentialScene.
simulate_fused`` against the JAX package's ``simulate_fused`` on the bench
scene, the ``CollimatedDisk`` sampler drawn from a ``torch.Generator``, and
the package boundary (no jax anywhere in the port)."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.ops import fused_trace

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _bench(rt):
    return rt.SequentialScene([
        rt.SingletLens(c1=0.05, c2=-0.05, d=10.0, t=3.0, ior_glass=1.5,
                       name='lens'),
        rt.CircularAperture(radius=5.0, name='stop'),
        rt.SensorElement(radius=6.0, translation=[0, 0, 19.0],
                         name='sensor'),
    ])


def test_simulate_fused_matches_jax_end_to_end():
    """Both packages build their own scene, params and table; the rays are
    the JAX package's, carried over.  Bounds of tests/test_pallas.py:
    positions atol 1e-5, intensity atol 1e-6, moments rtol 1e-5 atol 1e-3;
    spot RMS and centroid of the moments rtol 1e-5 / atol 1e-6."""
    js, ts = _bench(jrt), _bench(trt)
    rays = jrt.CollimatedDisk.make(
        radius=jnp.float32(4.0),
        translation=[0, 0, -10.0]).sample(jax.random.PRNGKey(42), 4096)
    out_j, sens_j, _ = js.simulate_fused(js.init_params(), rays,
                                         jax.random.PRNGKey(0))
    rays_t = interop.rays_from_numpy(
        jax.tree_util.tree_map(np.asarray, rays), 'cpu')
    out_t, sens_t, aux = ts.simulate_fused(ts.init_params('cpu'), rays_t)
    assert aux == {}
    np.testing.assert_allclose(out_t.pos.numpy(), np.asarray(out_j.pos),
                               atol=1e-5)
    np.testing.assert_allclose(out_t.intensity.numpy(),
                               np.asarray(out_j.intensity), atol=1e-6)
    np.testing.assert_allclose(sens_t.moments.numpy(),
                               np.asarray(sens_j.moments), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(sens_t.spot_rms(0).numpy(),
                               np.asarray(sens_j.spot_rms(0)), rtol=1e-5)
    np.testing.assert_allclose(sens_t.centroid(0).numpy(),
                               np.asarray(sens_j.centroid(0)), atol=1e-6)
    assert float(sens_t.moments[0, 0, 0]) == 4096.0


def test_simulate_fused_refuses_gradients():
    """Forward only until the backward kernel lands: a table that requires
    grad raises instead of routing to simulate."""
    ts = _bench(trt)
    p = ts.init_params('cpu')
    p['lens']['c1'].requires_grad_(True)
    gen = torch.Generator('cpu').manual_seed(0)
    rays = trt.CollimatedDisk.make(radius=4.0,
                                   translation=[0, 0, -10.0]).sample(
        gen, 256, 'cpu')
    with pytest.raises(NotImplementedError, match='K2'):
        ts.simulate_fused(p, rays)
    # the eager path takes the same call and differentiates
    _, sens, _ = ts.simulate(p, rays)
    trt.spot_size_loss(sens).backward()
    assert torch.isfinite(p['lens']['c1'].grad)


def test_main_path_on_cpu_counts_no_launch():
    """The main path at a small N on the CPU: the plain version runs, the
    kernel counter does not move, and the result keeps the bench anchors
    within sampling noise (spot RMS 0.1691 at 1M rays, centroid 0)."""
    ts = _bench(trt)
    gen = torch.Generator('cpu').manual_seed(3)
    rays = trt.CollimatedDisk.make(radius=4.0,
                                   translation=[0, 0, -10.0]).sample(
        gen, 50_000, 'cpu')
    before = fused_trace.LAUNCHES
    out, sens, _ = ts.simulate_fused(ts.init_params('cpu'), rays)
    assert fused_trace.LAUNCHES == before
    assert out.pos.shape == (50_000, 3)
    assert torch.isfinite(out.pos).all()
    assert abs(float(sens.spot_rms(0)[0]) - 0.1691) < 0.002
    assert float(sens.centroid(0).abs().max()) < 5e-3


def _disk_rays(n, seed):
    gen = torch.Generator('cpu').manual_seed(seed)
    return trt.CollimatedDisk.make(radius=4.0,
                                   translation=[0.0, 0.0, -10.0]).sample(
        gen, n, 'cpu')


def test_collimated_disk_support_and_mean():
    rays = _disk_rays(100_000, 0)
    r = torch.sqrt(rays.px ** 2 + rays.py ** 2)
    assert float(r.max()) <= 4.0 + 1e-5
    assert abs(float(rays.px.mean())) < 0.05
    assert abs(float(rays.py.mean())) < 0.05
    assert torch.all(rays.pz == -10.0)
    torch.testing.assert_close(rays.dz, torch.ones_like(rays.dz))
    assert rays.ray_id.dtype == torch.int32 and int(rays.ray_id.max()) == 0


def test_collimated_disk_area_uniform():
    """Radial CDF F(r) = (r/4)^2: Kolmogorov-Smirnov distance below the 1%
    critical value 1.63/sqrt(N); angles uniform the same way."""
    n = 100_000
    rays = _disk_rays(n, 1)
    r = np.sort(np.sqrt(rays.px.numpy() ** 2 + rays.py.numpy() ** 2))
    ecdf = np.arange(1, n + 1) / n
    assert np.abs(ecdf - (r / 4.0) ** 2).max() < 1.63 / np.sqrt(n)
    th = np.sort(np.arctan2(rays.py.numpy(), rays.px.numpy()) + np.pi)
    assert np.abs(ecdf - th / (2 * np.pi)).max() < 1.63 / np.sqrt(n)


def test_sampling_is_reproducible_per_generator():
    a, b = _disk_rays(1000, 9), _disk_rays(1000, 9)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)
    assert not torch.equal(a.pos, _disk_rays(1000, 10).pos)


def test_import_leaves_jax_out():
    code = ('import sys, raytracetorch_tpu_torch, '
            'raytracetorch_tpu_torch.interop; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("jax", "flax", "optax", "raytracetorch_tpu")]; '
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_sources_import_no_jax():
    """The package's own sources (not what is built or unpacked into its
    ignored ``_build/`` directory) import no JAX."""
    pkg = REPO / 'raytracetorch_tpu_torch'
    pat = re.compile(
        r'^\s*(import|from) (jax|flax|optax|raytracetorch_tpu)\b')
    sources = [p for p in pkg.rglob('*.py')
               if '_build' not in p.relative_to(pkg).parts]
    assert len(sources) > 20
    hits = [f'{p}:{i}' for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
    assert hits == []
