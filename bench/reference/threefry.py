"""Threefry-2x32 dropout masks for the reference, written from the
published algorithm (Salmon et al., SC'11: 20 rounds, rotations
13 15 26 6 / 17 29 16 24, key parity 0x1BD11BDA) in the layout of
``jax.random``'s partitionable bits: a key is two uint32 words,
``fold_in(key, d)`` hashes the count ``[0, d]``, element ``i`` of a draw
hashes ``[i >> 32, i & mask]`` and XORs the two outputs, and a uniform is
the top 23 bits under the exponent of 1.0, minus 1. The program's masks
must come out bit-equal to these.
"""
from __future__ import annotations

import math

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rounds(k1, k2, x0, x1, rotl):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M, (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    return (0, int(seed) & _M)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    return _rounds(k[0], k[1], 0, int(data) & _M,
                   lambda x, r: ((x << r) | (x >> (32 - r))) & _M)


def keep_mask(k: tuple[int, int], p_keep: float, shape, device) -> torch.Tensor:
    """``uniform(k, shape) < p_keep`` (float32 compare)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _rounds(k[0], k[1], idx >> 32, idx & _M,
                     lambda x, r: ((x << r) & _M) | (x >> (32 - r)))
    mant = ((b1 ^ b2) >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    return (u < torch.tensor(p_keep, dtype=torch.float32, device=device)).reshape(shape)
