"""Synthetic data (counterpart of ``repro.data.pipeline``).

``SyntheticImageNet`` draws class prototypes + noise + a random shift from
numpy ``SeedSequence`` streams, the reference's exact recipe, so both
packages see identical batches; they are returned as tensors on the
requested device (images NHWC float32, labels int64).
``synthetic_lm_batch`` is the reference's k-gram token stream, drawn with
the same numpy calls, so tokens and labels equal the reference's (int32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _step_rng(seed: int, step: int) -> np.random.Generator:
    """Collision-free per-(seed, step) stream: both ints map bijectively to
    non-negative entropy words (the validation set uses ``step=-1``)."""
    ent = [int(np.uint64(np.int64(seed))), int(np.uint64(np.int64(step)))]
    return np.random.default_rng(ent)


@dataclasses.dataclass
class SyntheticImageNet:
    num_classes: int = 200
    hw: int = 32
    channels: int = 3
    noise: float = 0.35
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        rng = np.random.default_rng(int(np.uint64(np.int64(self.seed))))
        self.prototypes = rng.normal(
            0, 1, (self.num_classes, self.hw, self.hw, self.channels)
        ).astype(np.float32)

    def batch(self, batch_size: int, step: int):
        """(images (B, H, W, C) float32, labels (B,) int64) on ``device``."""
        rng = _step_rng(self.seed, step)
        labels = rng.integers(0, self.num_classes, batch_size)
        base = self.prototypes[labels]
        shift = rng.integers(-2, 3, (batch_size, 2))
        imgs = np.stack(
            [
                np.roll(np.roll(b, s[0], axis=0), s[1], axis=1)
                for b, s in zip(base, shift)
            ]
        )
        imgs = imgs + self.noise * rng.normal(0, 1, imgs.shape)
        return (
            torch.from_numpy(imgs.astype(np.float32)).to(self.device),
            torch.from_numpy(labels.astype(np.int64)).to(self.device),
        )

    def validation(self, size: int = 512):
        return self.batch(size, step=-1)


def synthetic_lm_batch(
    vocab: int, batch: int, seq: int, step: int, *, seed: int = 0, order: int = 3,
    device="cuda",
):
    """Deterministic k-gram stream: next = (a·t1 + b·t2 + c·t3 + t0) mod
    vocab with 10 % noise tokens. Returns ``(tokens, labels)``, ``(batch,
    seq)`` int32 tensors on ``device``; labels are tokens shifted by one."""
    rng = _step_rng(seed, step)
    coef = np.array([3, 5, 7])
    toks = rng.integers(0, vocab, (batch, order + seq + 1))
    for t in range(order, order + seq + 1):
        nxt = (toks[:, t - 3] * coef[0] + toks[:, t - 2] * coef[1]
               + toks[:, t - 1] * coef[2] + toks[:, 0]) % vocab
        noise = rng.random(batch) < 0.1
        toks[:, t] = np.where(noise, toks[:, t], nxt)
    stream = toks[:, order:]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return put(stream[:, :-1]), put(stream[:, 1:])
