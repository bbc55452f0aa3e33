"""Per-request sampling for the serve engine (counterpart of
``repro.serve.sampling``).

The id sampled for the n-th emitted token of a request (0-based: the
token emitted from the prefill is n = 0) depends only on ``(logits_row,
seed, n)``. Its uniform draw is the reference's

    ``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), n))``

on the threefry of :mod:`repro_torch.random`, with the seed taken as a
uint32 as the reference takes it (its key is ``(0, seed)``): a Python int
outside ``[0, 2**32)`` raises ``OverflowError``, as numpy's conversion to
``uint32`` does in the reference, while a wider numpy array wraps modulo
2**32, as its cast does. The draws are bit-equal to the reference's.

Every op of :func:`sample_tokens` reduces along the vocabulary axis only
(a stable argsort, a softmax and prefix sums accumulated in fp64, and a
count), so a row's token does not depend on the rows beside it: the engine's slot batch, the
static run's group and the ``(B, k + 1)`` verify block agree. Where the
logits are bit-equal to the reference's the token is too, except where a
draw lands within rounding of a cumulative boundary: XLA's and PyTorch's
``exp`` and ``cumsum`` differ in their last bits.

``temperature <= 0`` rows short-circuit to ``argmax``, so ballast slots
and greedy requests in a mixed batch match the greedy path exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.plan.plan import SamplingParams

__all__ = ["SamplingParams", "fold_key", "sample_tokens", "seed_words", "uniform_for"]


def fold_key(seed: int, step: int) -> R.Key:
    """The per-token key: the 0-based emitted-token index folded into the
    request's seed key (a scalar; the samplers build the same keys row by
    row)."""
    return R.fold_in((0, int(seed) & R._M), int(step))


def _words(x) -> np.ndarray:
    """Steps as int32 words on the host, held as uint32 (ints, lists, numpy
    or tensors on any device; wider ints wrap modulo 2**32)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return (np.asarray(x).astype(np.int64) & R._M).astype(np.uint32)


def seed_words(seed) -> np.ndarray:
    """Seeds as the reference's ``np.uint32`` / ``jnp.uint32`` conversion
    takes them: Python ints (alone or in lists) outside ``[0, 2**32)``
    raise ``OverflowError``; numpy arrays and tensors are cast, wider
    words wrapping modulo 2**32."""
    if torch.is_tensor(seed):
        seed = seed.detach().cpu().numpy()
    if isinstance(seed, (np.ndarray, np.generic)):
        return np.asarray(seed).astype(np.uint32)
    ints = np.asarray(seed, dtype=object).reshape(-1)
    bad = [int(x) for x in ints if not 0 <= int(x) <= R._M]
    if bad:
        raise OverflowError(f"Python integer {bad[0]} out of bounds for uint32")
    return np.asarray(seed, dtype=np.int64).astype(np.uint32)


def _rotl_words(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def uniform_for(seed, step) -> torch.Tensor:
    """One float32 uniform draw on [0, 1) per (seed, step) pair, broadcast
    to a common shape, on the host: ``uniform(fold_key(seed, step), ())``
    for every pair, bit-equal to the reference's. Seeds are uint32 and
    steps int32 words, as in the reference (:func:`seed_words`: a Python
    int seed outside ``[0, 2**32)`` raises ``OverflowError``); the hash
    runs on numpy uint32 words, whose adds wrap as threefry's do."""
    seed, step = np.broadcast_arrays(seed_words(seed), _words(step))
    zero = np.zeros_like(seed)
    k0, k1 = R._hash(zero, seed, zero, step, _rotl_words, R._M)  # fold_in: count [0, step]
    b0, b1 = R._hash(k0, k1, zero, zero, _rotl_words, R._M)  # bits(key, ()): count [0, 0]
    mant = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return torch.from_numpy(mant.view(np.float32) - np.float32(1.0))


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """fp32 prefix sums along the last axis, accumulated in fp64."""
    return torch.cumsum(x.to(torch.float64), dim=-1).to(torch.float32)


def sample_tokens(logits, vocab: int, temperature, top_p, top_k, seed, step) -> torch.Tensor:
    """One id per row of ``logits (..., Vpad)`` as int64.

    ``temperature`` / ``top_p`` / ``top_k`` / ``seed`` / ``step`` carry the
    row shape ``(...)``. Rows with ``temperature <= 0`` return ``argmax``.
    The sampler is inverse-CDF over the descending (stable) sort of the
    temperature softmax, restricted to the ``top_k`` best ids (0 = all)
    and to ids whose *preceding* cumulative mass is below ``top_p`` (the
    best id always survives)."""
    dev = logits.device
    lg = logits[..., :vocab].to(torch.float32)
    greedy = torch.argmax(lg, dim=-1)

    temp = torch.as_tensor(np.asarray(temperature, np.float32), device=dev)
    scaled = lg / torch.clamp(temp, min=1e-6)[..., None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    ranked = torch.gather(scaled, -1, order)
    # jax.nn.softmax's formula, exp(x - max) / sum; the sum and the prefix
    # sums of 151,936 fp32 terms are taken in fp64 and rounded once, so
    # their bits depend on the row alone, not on the order a device sums in
    e = torch.exp(ranked - ranked.amax(dim=-1, keepdim=True))
    probs = e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)

    ranks = torch.arange(vocab, device=dev)
    k = torch.as_tensor(np.asarray(top_k, np.int64), device=dev)[..., None]
    keep = (k <= 0) | (ranks < k)
    cum = _cumsum(probs)
    p = torch.as_tensor(np.asarray(top_p, np.float32), device=dev)[..., None]
    keep &= (cum - probs) < p

    cw = _cumsum(probs * keep)
    u = uniform_for(seed, step).to(dev)
    target = u * cw[..., -1]
    # the first index with cw > target; zero-weight entries repeat their
    # predecessor's cw, so the landing index always has weight > 0
    idx = (cw <= target[..., None]).sum(dim=-1)
    idx = torch.clamp(idx, max=vocab - 1)
    tok = torch.gather(order, -1, idx[..., None])[..., 0]
    return torch.where(temp <= 0.0, greedy, tok)
