"""The uniform draws of the stochastic physics kinds.

The JAX package threads a PRNG key through its trace loops; the port draws
from the caller's ``torch.Generator`` and never from a default seed.  Two
schedules, one per trace type:

- Sequential traces pre-draw one ``[N]`` float32 stream per drawing row, in
  row order, laid out ``[F, N]`` (``row_uniforms``): FRESNEL takes one
  stream, SCATTER (with its element, ROADMAP Queue 1 item 14) would take
  two (``row_draws``), as the JAX package's fused kernel lays its streams
  out (``_row_draws``).  The eager chain, kernels K1 and K2 and their plain
  versions read the same streams, so the eager and fused paths realize the
  same branches from the same generator state.
- Non-sequential traces draw a pure function of (seed, ray, bounce, row):
  counter-based Philox4x32-10 (``philox4x32``, Salmon et al., SC'11) with
  counter ``(n, b, k, 0)`` and the two seed words as its key; a draw is
  ``(word0 >> 8) * 2^-24``, and ``word1`` is kept for SCATTER's second draw.
  The eager bounce loop, kernel K5, K6's replay and their plain versions
  evaluate this one function (K5 and K6 in ``csrc/trace_seq_common.cuh``),
  so all of them realize the same branches, and K6 replays a draw by its
  counter instead of storing it.  The TPU kernel's in-kernel generator
  (``pltpu.prng_seed``) cannot be reproduced off the TPU, so the fused
  non-sequential draws differ from the JAX package's by design and are
  compared with them statistically.

Philox is written here in int64 tensor arithmetic on 32-bit words (the
CUDA kernels use ``__umulhi``); both are held to the generator's
published known-answer vectors (tests/test_torch_fresnel.py, the card
tests).
"""

from __future__ import annotations

import torch

from ..constants import PhysKind

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK = 0xFFFFFFFF
ROUNDS = 10


def row_draws(meta):
    """The per-ray uniforms a row consumes per interaction: FRESNEL 1,
    SCATTER 2 (with its element), else 0."""
    return 1 if meta.ph == PhysKind.FRESNEL else (
        2 if meta.ph == PhysKind.SCATTER else 0)


def draws_per_ray(static_meta):
    """The number of pre-drawn streams F of a sequential table."""
    return sum(row_draws(m) for m in static_meta)


def needs_draws(static_meta):
    """Whether any row of the table draws."""
    return draws_per_ray(static_meta) > 0


def stream_index(static_meta):
    """{row: its first stream in the ``[F, N]`` layout} of the drawing
    rows."""
    out, f = {}, 0
    for k, m in enumerate(static_meta):
        if row_draws(m):
            out[k] = f
            f += row_draws(m)
    return out


def _generator_device(generator):
    return generator.device if generator is not None else None


def row_uniforms(static_meta, n, generator, device=None):
    """``[F, N]`` float32 uniforms in [0, 1) from ``generator`` (a
    ``torch.Generator``), one stream of N per drawn value, in row order,
    drawn on the generator's device and moved to ``device`` (the rays').
    ``[0, N]`` when no row draws; raises ValueError when a row draws and
    no generator is given."""
    f = draws_per_ray(static_meta)
    if f == 0:
        return torch.zeros(0, n, dtype=torch.float32,
                           device=device or _generator_device(generator))
    if generator is None:
        raise ValueError(_missing(static_meta))
    u = torch.rand(f, n, generator=generator,
                   device=_generator_device(generator), dtype=torch.float32)
    return u.to(device) if device is not None else u


def check_uniforms(uniforms, static_meta, n, device):
    """Raise unless ``uniforms`` is a float32 ``[F, N]`` tensor on
    ``device`` for this table -> it, contiguous."""
    f = draws_per_ray(static_meta)
    shape = (f, n)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f'uniforms has shape {tuple(uniforms.shape)}, '
                         f'expected {shape}: one stream of N per drawing '
                         f'row, in row order')
    if uniforms.dtype != torch.float32 or uniforms.device != device:
        raise ValueError(f'uniforms must be float32 on {device}, got '
                         f'{uniforms.dtype} on {uniforms.device}')
    return uniforms.contiguous()


def sequential_uniforms(static_meta, n, device, generator=None,
                        uniforms=None):
    """The ``[F, N]`` streams of a sequential trace: ``uniforms`` when
    given (checked), else drawn from ``generator`` (``row_uniforms``);
    ``[0, N]`` on ``device`` when no row draws."""
    if draws_per_ray(static_meta) == 0:
        return torch.zeros(0, n, dtype=torch.float32, device=device)
    if uniforms is not None:
        return check_uniforms(uniforms, static_meta, n, device)
    return row_uniforms(static_meta, n, generator, device)


def _missing(static_meta):
    rows = [k for k, m in enumerate(static_meta) if row_draws(m)]
    return (f'rows {rows} draw random numbers (FRESNEL): pass '
            f'generator=torch.Generator(...) (or the draws themselves); the '
            f'trace never draws from a default seed')


def seed_words(generator):
    """The Philox key of a non-sequential trace: two 32-bit words drawn
    once from ``generator`` -> a tuple of two ints in [0, 2^32)."""
    w = torch.randint(0, 2 ** 32, (2,), generator=generator,
                      device=_generator_device(generator), dtype=torch.int64)
    return tuple(int(v) for v in w.tolist())


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the int64 tensor ``b`` of 32-bit words: split ``b`` into 16-bit
    halves so that no partial product leaves int64."""
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    hi = (t_hi + (t_lo >> 16)) >> 16
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK
    return hi & _MASK, lo


def philox4x32(c0, c1, c2, c3, key):
    """Philox4x32-10 of the counter words (int64 tensors of 32-bit values,
    broadcast together) under ``key`` (two ints) -> four int64 tensors of
    32-bit words."""
    device = next((x.device for x in (c0, c1, c2, c3)
                   if isinstance(x, torch.Tensor)), None)
    c = [torch.as_tensor(x, dtype=torch.int64, device=device)
         for x in (c0, c1, c2, c3)]
    c = list(torch.broadcast_tensors(*c))
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for r in range(ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c[0])
        hi1, lo1 = _mulhilo(_M1, c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return tuple(c)


def philox_uniform(n_index, bounce, row, key):
    """The non-sequential draw of rays ``n_index`` (an int64 tensor of ray
    indices) at bounce ``bounce`` for row ``row``: ``(word0 >> 8) * 2^-24``
    of Philox4x32-10 with counter ``(n, b, k, 0)`` -> float32 in [0, 1)."""
    w0 = philox4x32(n_index, bounce, row, 0, key)[0]
    return (w0 >> 8).to(torch.float32) * (2.0 ** -24)


class NonseqDraws:
    """The draws of a non-sequential trace, ``(bounce, row) -> [N]``:
    Philox under ``key`` (``seed_words`` of the caller's generator) for the
    rays' indices 0..N-1, or the caller's own ``fn(bounce, row)`` (the
    tests inject the JAX package's draws).  ``key`` is None for an
    injected function: such draws have no counter, so the fused kernels
    cannot take them."""

    def __init__(self, n, device, key=None, fn=None):
        self.n, self.device, self.key, self.fn = n, device, key, fn
        self._index = None

    def __call__(self, bounce, row):
        if self.fn is not None:
            u = torch.as_tensor(self.fn(bounce, row), dtype=torch.float32,
                                device=self.device)
            if tuple(u.shape) != (self.n,):
                raise ValueError(f'draws({bounce}, {row}) has shape '
                                 f'{tuple(u.shape)}, expected ({self.n},)')
            return u
        if self._index is None:
            self._index = torch.arange(self.n, dtype=torch.int64,
                                       device=self.device)
        return philox_uniform(self._index, bounce, row, self.key)


def nonseq_draws(static_meta, n, device, generator=None, draws=None):
    """The draws of a non-sequential trace (``NonseqDraws``), or None when
    no row draws.  ``draws`` (a callable ``(bounce, row) -> [N]``) takes
    precedence over ``generator``, from which the Philox key is drawn once;
    a drawing table with neither raises ValueError."""
    if not needs_draws(static_meta):
        return None
    if draws is not None:
        return NonseqDraws(n, device, fn=draws)
    if generator is None:
        raise ValueError(_missing(static_meta))
    return NonseqDraws(n, device, key=seed_words(generator))
