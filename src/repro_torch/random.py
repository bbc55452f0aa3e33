"""Threefry-2x32 keys and bits, bit-equal to ``jax.random`` (jax 0.9.0 with
``jax_threefry_partitionable=True``, its default).

Counterpart of the ``jax.random`` calls the port's slices make (dropout in
``models.cnn``): ``PRNGKey``, ``fold_in``, ``bits``, ``uniform`` and
``bernoulli``. Reproduced from ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``threefry_fold_in`` — which hashes the
2-word count ``[0, data]`` — and the partitionable ``random_bits``, which
hashes the (hi, lo) words of the flat 64-bit index and XORs the two
outputs) and ``jax/_src/random.py`` (``_uniform``: mantissa bits under
the exponent of 1.0, minus 1; ``_bernoulli``: ``uniform < p``).

A key is a pair of Python ints (the two uint32 words), so folding costs
no device round trip. ``bits`` evaluates the hash on tensors in int64
with explicit 32-bit masks, because PyTorch has no uint32 shift or add on
the CPU; the same code runs on the card. Torch's own Philox gives
different numbers and is not used.
"""
from __future__ import annotations

import math

import torch

Key = tuple[int, int]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _hash(k1, k2, x0, x1, rotl, mask):
    """Threefry-2x32, 20 rounds (the unrolled lowering), on ints or int64
    tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & mask
    x1 = (x1 + ks[1]) & mask
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & mask
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & mask
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & mask
    return x0, x1


def _rotl_int(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def _rotl_tensor(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M) | (x >> (32 - r))


def PRNGKey(seed: int) -> Key:  # noqa: N802 — jax's name
    """Key from an integer seed (``jax.random.PRNGKey`` without x64: the
    seed is an int32, its high word is 0)."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit an int32")
    return (0, seed & _M)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: hash the count ``[0, data]`` under ``key``."""
    return _hash(key[0], key[1], 0, int(data) & _M, _rotl_int, _M)


def bits(key: Key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bits`` (uint32), as int64 values in ``[0, 2**32)``."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _hash(key[0], key[1], idx >> 32, idx & _M, _rotl_tensor, _M)
    return (b1 ^ b2).reshape(shape)


def uniform(key: Key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[0, 1)`` (the only range the
    port draws; other ranges would depend on the backend's FMA fusion)."""
    mant = (bits(key, shape, device=device) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low') with a float32 ``p``."""
    pf = torch.tensor(p, dtype=torch.float32, device=device)
    return uniform(key, shape, device=device) < pf
