"""Counter-based threefry2x32 random numbers in PyTorch, bit for bit with
``jax.random`` under its default ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the rescue ladder's random restarts
draw from it, so a restarted lane starts where the JAX package's does).

A key is a tensor ``[..., 2]`` of uint32 values held in int64 (torch has
no uint32 arithmetic on every device); every function works on a batch
of keys, one per lane, as ``jax.vmap`` over keys does:

- :func:`prng_key` is ``jax.random.PRNGKey(seed)``;
- :func:`split` ``(key [..., 2], num) -> [..., num, 2]`` is
  ``jax.random.split``: new key ``i`` is the threefry hash of the 64-bit
  counter ``i`` (high word, low word) under ``key``, so the first keys
  of a split do not depend on how many are asked for;
- :func:`uniform` ``(key [..., 2], shape) -> [..., *shape]`` float64 in
  [0, 1) is ``jax.random.uniform``: element ``j`` hashes the counter
  ``j``, the two words make 64 random bits, and the top 52 of them are
  the mantissa of a number in [1, 2), less 1.

Plain integer arithmetic on tensors: it runs on the device of its key.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of the counter words ``(x1,
    x2)`` under the key words ``(k1, k2)``; all int64 tensors of uint32
    values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[seed >> 32, seed &
    0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash_counters(key, count: int):
    """Hash the counters ``0 .. count - 1`` under every key of ``key [...,
    2]``; returns the two words, each ``[..., count]``."""
    c = torch.arange(count, dtype=torch.int64, device=key.device)
    hi, lo = (c >> 32) & _MASK, c & _MASK
    return threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of every key in ``key [..., 2]``:
    ``[..., num, 2]``."""
    b1, b2 = _hash_counters(key, num)
    return torch.stack([b1, b2], dim=-1)


def uniform(key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float64)`` (in [0, 1)) of
    every key in ``key [..., 2]``: ``[..., *shape]``."""
    shape = tuple(shape)
    b1, b2 = _hash_counters(key, math.prod(shape))
    mantissa = (b1 << 20) | (b2 >> 12)          # the top 52 of 64 bits
    u = mantissa.to(torch.float64) * 2.0 ** -52
    return u.reshape(key.shape[:-1] + shape)
