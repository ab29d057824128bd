"""The reference package's counter-based ray draws, in numpy.

The JAX package draws its rays from threefry-2x32 keys (``jax.random`` with
partitionable threefry, the default of JAX 0.5 and later).  The port's
sources draw from a ``torch.Generator`` instead, so the same seed gives other
rays.  Where a run must trace the very rays of a reference example (its
published setting), this module reproduces those draws bit for bit:
``prng_key``, ``split``, ``fold_in`` and ``uniform`` follow
``jax.random.PRNGKey``, ``split``, ``fold_in`` and ``uniform``,
``collimated_disk`` follows ``CollimatedDisk.make(radius,
translation).sample(key, n)``, ``point_source`` follows
``PointSource.make(na, translation).sample(key, n)`` (its directions, and a
disk's positions, to an ulp: numpy's float32 cos, sin and arccos against
XLA's), and ``fresnel_uniforms`` rebuilds the uniform streams that the JAX
package's ``trace_sequential`` (and its fused kernel) draws for the FRESNEL
rows of a table under a key, so that a run can realize the reference's very
Fresnel branches.
tests/test_torch_phase_grid.py and tests/test_torch_fresnel.py hold them
equal to ``jax.random``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import PhysKind
from .ray import Rays

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The threefry-2x32 block cipher (20 rounds) of the counters (x0, x1)
    (uint32 arrays) under ``key`` (two uint32) -> two uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over='ignore'):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def prng_key(seed):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): the words
    (0, seed)."""
    if not 0 <= int(seed) < 2 ** 32:
        raise ValueError(f'seed {seed} outside [0, 2**32)')
    return np.array([0, seed], np.uint32)


def _counters(n):
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num=2):
    """``jax.random.split(key, num)`` -> [num, 2] uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for an int data in [0, 2**32): the
    cipher of the counter words (0, data)."""
    b0, b1 = threefry2x32(key, np.array([0], np.uint32),
                          np.array([int(data)], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def fresnel_uniforms(key, static_meta, n, device=None):
    """The ``[F, N]`` float32 streams of the FRESNEL rows of a table, in
    row order, as the JAX package's ``trace_sequential(table, rays, key)``
    draws them: ``uniform(split(key, K)[k], (N,))`` for FRESNEL row k of the
    K rows -> a tensor on ``device`` (the port's ``uniforms=``)."""
    keys = split(key, max(len(static_meta), 1))
    rows = [uniform(keys[k], n) for k, m in enumerate(static_meta)
            if m.ph == PhysKind.FRESNEL]
    out = np.stack(rows) if rows else np.zeros((0, n), np.float32)
    return torch.from_numpy(out.astype(np.float32)).to(device)


def uniform(key, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: 23 random
    mantissa bits of each 32-bit draw make a float in [1, 2), less 1."""
    b0, b1 = threefry2x32(key, *_counters(n))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def collimated_disk(key, n, radius, translation=(0.0, 0.0, 0.0),
                    wavelength=0.0, device=None):
    """The rays of the reference's ``CollimatedDisk.make(radius,
    translation, wavelength).sample(key, n)`` (no rotation): +z rays over
    the disk, drawn as ``disk_sample`` draws them -> Rays on ``device``."""
    kp, _ = split(key)
    ku, kt = split(kp)
    r = np.sqrt(uniform(ku, n, 0.0, np.float32(radius) ** 2))
    theta = uniform(kt, n, 0.0, 2.0 * np.pi)
    pos = np.stack([r * np.cos(theta), r * np.sin(theta),
                    np.zeros_like(r)], -1) + np.float32(translation)
    direction = np.zeros((n, 3), np.float32)
    direction[:, 2] = 1.0
    return Rays.create(torch.from_numpy(pos.astype(np.float32)),
                       torch.from_numpy(direction), device=device,
                       wavelength=torch.full((n,), float(wavelength)))


def point_source(key, n, na, translation=(0.0, 0.0, 0.0), wavelength=0.0,
                 device=None):
    """The rays of the reference's ``PointSource.make(na,
    translation).sample(key, n)`` (no rotation): a cone of half angle
    asin(na) from ``translation``, its directions drawn as
    ``solid_angle_dirs`` draws them (F ~ U(0, cdf_phi(asin(na))), phi =
    acos(1 - 2F), theta ~ U(0, 2 pi)), in float32 -> Rays on ``device``."""
    _, kd = split(key)
    kf, kt = split(kd)
    na = np.float32(na)
    cap = (np.float32(1.0) - np.cos(np.arcsin(na))) / np.float32(2.0)
    F = uniform(kf, n, 0.0, cap)
    phi = np.arccos(np.clip(np.float32(1.0) - np.float32(2.0) * F,
                            np.float32(-1.0), np.float32(1.0)))
    theta = uniform(kt, n, 0.0, 2.0 * np.pi)
    dr = np.sin(phi)
    direction = np.stack([np.cos(theta) * dr, np.sin(theta) * dr,
                          np.cos(phi)], -1)
    pos = np.zeros((n, 3), np.float32) + np.float32(translation)
    return Rays.create(torch.from_numpy(pos.astype(np.float32)),
                       torch.from_numpy(direction.astype(np.float32)),
                       device=device,
                       wavelength=torch.full((n,), float(wavelength)))


def collimated_bundles(keys, n, radius, translation, wavelengths,
                       device=None):
    """Collimated disks of ``n`` rays each, bundle j drawn under ``keys[j]``
    at ``wavelengths[j]`` and tagged ray_id j, concatenated: the reference's
    ``sample_bundles(key, ...)`` of such disks with ``keys = split(key,
    len(wavelengths))``, or its separately sampled beams of one key."""
    batches = []
    for j, (k, wl) in enumerate(zip(keys, wavelengths)):
        r = collimated_disk(k, n, radius, translation, wl, device)
        batches.append(r.replace(ray_id=torch.full_like(r.ray_id, j)))
    return Rays.concatenate(batches)
