"""Families of kinds together in one table, in the PyTorch port against the
JAX package's fused kernels, on the CPU.

The port's fused trace runs every family of kinds in one instantiation of
K1, K2, K5 and K6 (the family instantiation; csrc/trace_seq_common.cuh),
so a table may mix them as the JAX kernels take them.  Each case here runs
the port's ``simulate_fused`` (on CPU tensors the plain versions of the
kernels) and the JAX package's ``simulate_fused`` (its Pallas kernels in
interpret mode, as tests/test_grin.py:328 and :367 run them) on the same
rays (the JAX package's ``CollimatedDisk`` draws, moved into the port by
``interop``) and compares the rays, the moments and the intensities, and
the gradients of a spot loss against ``jax.grad``:

- K1 and K2: a GRIN rod (16 RK4 steps, away from its turning point)
  followed by tests/test_grin.py:283's FRESNEL_W plate (without the field),
  a FRESNEL window (the JAX package's own uniforms, injected), a coated
  singlet, tests/test_doe.py:133's DiffractiveLens, a fuzzy apodizer and a
  FreeformLens (chip_smoke.py section 21's ``mix_scene``);
- K5 and K6: the rod as a Scene beside a coated window and a grating;
- K5 and K6 under ``track_field``: Scenes of tests/test_doe.py:133's
  DiffractiveLens, a MicrolensArray, an apodized pupil before a singlet and
  example 19's freeform corrector (3 or 4 bounces), with the final field's
  |E|^2.

The gradients of a spot loss are held to ``jax.grad`` of the JAX
package's ``simulate`` (its eager trace: the JAX kernels' own backward
equals it, tests/test_grin.py:328).

Tolerances, each the family's own and none wider (ROADMAP Queue 3 records
the divergences they allow): positions atol 2e-5, directions 2e-6 and
intensities 1e-6 (tests/test_torch_grin.py's: float32 through the rod's RK4
steps in another compiler's order), and behind a weighting Fresnel row
(FRESNEL_W, a coated face) intensities rtol 1e-5 beside it
(tests/test_torch_fresnel.py's: float32 rounding of R); moments rtol
1e-5 + atol 1e-5 of their scale (the same file's); |E|^2 atol 1e-5 (tests/test_torch_field_nonseq.py
's); gradients rtol 2e-3 of the leaf's scale (tests/test_torch_grin.py's:
float32 adjoints of the rod's steps summed over the rays in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import raytracetorch_tpu as jrt
import raytracetorch_tpu_torch as trt
from raytracetorch_tpu_torch import interop
from raytracetorch_tpu_torch.constants import PhysKind
from raytracetorch_tpu_torch.ops import fused_trace as ft
from raytracetorch_tpu_torch.rays import reference_prng as rp

torch.set_num_threads(2)

N = 192
COMPS = ('px', 'py', 'pz', 'dx', 'dy', 'dz', 'intensity')
TOL = dict(px=2e-5, py=2e-5, pz=2e-5, dx=2e-6, dy=2e-6, dz=2e-6,
           intensity=1e-6)
def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(name):
    """(JAX scene, port scene, JAX params, port params, JAX rays, port
    rays, the port's simulate_fused keywords) of a section 21 case."""
    js, ts = cs.mix_scene(jrt, name, jnp), cs.mix_scene(trt, name, torch)
    pj = js.init_params()
    radius, trans, wl = cs.mix_source(name)
    rj = jrt.CollimatedDisk.make(radius=jnp.float32(radius),
                                 translation=list(trans),
                                 wavelength=wl).sample(
                                     jax.random.PRNGKey(cs.MIX_SEED), N)
    rt_ = interop.rays_from_numpy(_np(rj), 'cpu')
    kw = {}
    if name == 'fresnel_mc':
        kw['uniforms'] = rp.fresnel_uniforms(rp.prng_key(cs.MIX_SEED),
                                             ts.static_meta(), N)
    if name.startswith('field'):
        kw.update(track_field=True, E0=list(cs.MIX_E0))
    return js, ts, pj, interop.params_from_numpy(_np(pj), 'cpu'), rj, rt_, kw


def _jax_fused(js, p, rj, name):
    kw = dict(block_rows=4, interpret=True)
    if not js.sequential:
        kw['block_rows'] = 2
    else:
        kw['auto_dispatch'] = False
    if name.startswith('field'):
        kw.update(track_field=True, E0=jnp.asarray(cs.MIX_E0, jnp.float32))
    return js.simulate_fused(p, rj, jax.random.PRNGKey(cs.MIX_SEED), **kw)


def _loss(sens):
    return sens.spot_rms(0)[0] ** 2 + 1e-3 * sens.total_weight(0)[0]


CASES = cs.MIX_SEQ_CASES + cs.MIX_NS_CASES + cs.MIX_FIELD_CASES


def test_mix_scenes_take_the_family_instantiation():
    """Each case's table mixes the families the issue names (a rod beside
    another family, or the field beside a diffractive, fuzzy or freeform
    row), and the port's CollimatedDisk draws (reference_prng) are the JAX
    package's, to float32 rounding of the disk's sine and cosine."""
    for name in CASES:
        ts = cs.mix_scene(trt, name, torch)
        meta = ft.TraceMeta(ts.static_meta(), ts.fuzzy_fns(),
                            name.startswith('field'))
        fam = ft.families(meta)
        if name.startswith('field'):
            assert fam & (ft.FAM_DIFF | ft.FAM_FUZZY | ft.FAM_FREEFORM), name
            assert not fam & ft.FAM_GRIN
        else:
            assert fam & ft.FAM_GRIN and fam != ft.FAM_GRIN, name
    _, _, _, _, rj, _, _ = _case('coated')
    rp_rays = cs.mix_rays(trt, torch, 'coated', N, 'cpu')
    for c in ('px', 'py', 'pz', 'wavelength'):
        _close(getattr(rp_rays, c), getattr(rj, c), rtol=0, atol=1e-6)


@pytest.mark.parametrize('name', CASES)
def test_forward_matches_jax_kernels(name):
    """The port's fused forward (plain K1 or K5) against the JAX package's
    fused kernel: rays, moments, intensities (and |E|^2 under the
    field)."""
    js, ts, pj, pt, rj, rt_, kw = _case(name)
    oj, sj, aj = _jax_fused(js, pj, rj, name)
    ot, st, *at = ts.simulate_fused(pt, rt_, **kw)
    weighted = any(m.ph in (PhysKind.FRESNEL_W, PhysKind.REFLECT_W)
                   for m in ts.static_meta())
    for c in COMPS:
        rtol = 1e-5 if c == 'intensity' and weighted else 0.0
        _close(getattr(ot, c), getattr(oj, c), rtol=rtol, atol=TOL[c],
               err_msg=(name, c))
    mj = np.asarray(sj.moments)
    _close(st.moments, mj, rtol=1e-5, atol=1e-5 * max(np.abs(mj).max(), 1.0))
    if name.startswith('field'):
        _close(at[0]['field_power'], aj['field_power'], rtol=0, atol=1e-5)
    assert float(st.moments[0, 0, 0]) > 0.1 * N, name  # the sensor is lit


@pytest.mark.parametrize('name', CASES)
def test_gradients_match_jax(name):
    """The port's fused backward (plain K2 or K6) against jax.grad of the
    JAX package's trace, in the case's leaves.  The apodized pupil and the
    freeform corrector under the field are held to jax.grad of the JAX
    package's SequentialScene of the same elements (their rays cross them
    in order, so the function is the Scene's: the non-sequential
    reverse-mode trace of the freeform rows takes minutes on the CPU)."""
    js, ts, pj, pt, rj, rt_, kw = _case(name)
    leaves = cs.MIX_LEAVES[name]
    if name in ('field_pupil', 'field_ff'):
        js = jrt.SequentialScene(js.elements)

    def jloss(p):
        kw_j = (dict(track_field=True,
                     E0=jnp.asarray(cs.MIX_E0, jnp.float32))
                if name.startswith('field') else {})
        return _loss(js.simulate(p, rj, jax.random.PRNGKey(cs.MIX_SEED),
                                 **kw_j)[1])
    gj = jax.grad(jloss)(pj)
    p = {k: dict(v) for k, v in pt.items()}
    for el, k in leaves:
        p[el][k] = p[el][k].clone().requires_grad_(True)
    g = torch.autograd.grad(_loss(ts.simulate_fused(p, rt_, **kw)[1]),
                            [p[el][k] for el, k in leaves])
    for (el, k), a in zip(leaves, g):
        b = np.asarray(gj[el][k])
        assert np.abs(b).max() > 0, (name, el, k)
        _close(a, b, rtol=2e-3, atol=2e-3 * np.abs(b).max(),
               err_msg=(name, el, k))
