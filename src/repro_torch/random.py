"""Threefry-2x32 keys and bits, bit-equal to ``jax.random`` (jax 0.9.0 with
``jax_threefry_partitionable=True``, its default).

Counterpart of the ``jax.random`` calls the port's slices make (dropout in
``models.cnn``, stochastic rounding in ``kernels.ref``): ``PRNGKey``,
``fold_in``, ``split``, ``bits``, ``randint``, ``uniform`` and
``bernoulli``. Reproduced from ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``threefry_fold_in`` — which hashes the
2-word count ``[0, data]`` — and the partitionable ``random_bits``, which
hashes the (hi, lo) words of the flat 64-bit index and XORs the two
outputs; the partitionable ``threefry_split``, which hashes ``[0, i]``
for key ``i`` and so equals ``fold_in(key, i)``) and
``jax/_src/random.py`` (``_uniform``: mantissa bits under the exponent of
1.0, minus 1; ``_bernoulli``: ``uniform < p``; ``_randint``: two draws of
bits, the higher under ``split(key)[0]`` and the lower under
``split(key)[1]``, combined modulo the span).

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


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split``: key ``i`` hashes the count ``[0, i]``, which
    is ``fold_in(key, i)``."""
    return [fold_in(key, i) for i in range(int(num))]


def bits(key: Key, shape, *, device="cpu", index=None) -> torch.Tensor:
    """``jax.random.bits`` (uint32), as int64 values in ``[0, 2**32)``.
    Element ``i`` of the flat result is the hash of flat index ``i``;
    ``index`` (an int64 tensor of ``shape``) draws each element at the
    flat index it holds instead (the element's place in another layout)."""
    shape = tuple(int(s) for s in shape)
    if index is None:
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    else:
        idx = index.to(device=device, dtype=torch.int64).reshape(-1)
    b1, b2 = _hash(key[0], key[1], idx >> 32, idx & _M, _rotl_tensor, _M)
    return (b1 ^ b2).reshape(shape)


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for int64 tensors ``a`` and an int ``b``, both
    in ``[0, 2**32)``, without leaving int64: ``b`` is taken 16 bits at a
    time."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M


def randint(key: Key, shape, minval: int, maxval: int, *, device="cpu",
            index=None) -> torch.Tensor:
    """``jax.random.randint`` with ``dtype=uint32``, as int64 values in
    ``[minval, maxval)``, for int bounds ``0 <= minval`` and ``maxval <
    2**31`` (jax without x64 takes a Python bound as an int32).

    jax draws twice the bits the dtype needs: ``higher`` under
    ``split(key)[0]`` and ``lower`` under ``split(key)[1]``, and returns
    ``minval + ((higher % span) * m + lower % span) % span`` in uint32
    arithmetic, with ``m = (2**16 % span)**2 % span``. Where ``m`` is 0 —
    every power-of-two span, among them the spans ``2**8``,
    ``2**16`` and ``2**24`` that stochastic rounding draws — the result is
    ``minval + lower % span``, and ``higher`` is not drawn. ``index``: as
    in :func:`bits`."""
    minval, maxval = int(minval), int(maxval)
    if not 0 <= minval < 2**31 or not 0 <= maxval < 2**31:
        raise ValueError(f"randint bounds [{minval}, {maxval}) outside [0, 2**31)")
    span = max(maxval - minval, 1)  # maxval <= minval returns minval
    k_hi, k_lo = split(key)
    lower = bits(k_lo, shape, device=device, index=index)
    mult = ((2**16 % span) ** 2 & _M) % span
    if mult == 0:
        return minval + lower % span
    higher = bits(k_hi, shape, device=device, index=index)
    offset = (_mul_u32(higher % span, mult) + lower % span) & _M
    return minval + offset % span


def uniform(key: Key, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in float32 on ``[0, 1)`` (the only range the
    port draws; other ranges would depend on the backend's FMA fusion)."""
    mant = (bits(key, shape, device=device) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, shape, *, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli`` (mode 'low') with a float32 ``p``."""
    pf = torch.tensor(p, dtype=torch.float32, device=device)
    return uniform(key, shape, device=device) < pf
