"""Pieces both plain references share: the weight transfer as the
configuration states it, momentum SGD, the arithmetic precision, and the
readings a run hands to the comparison."""
from __future__ import annotations

import contextlib

import torch

# the bits a weight keeps at round_to bytes: its top bytes, the rest zero
_KEEP = {1: -0x01000000, 2: -0x00010000, 3: -0x00000100}


class _Keep(torch.autograd.Function):
    """Forward: the top ``round_to`` bytes of each fp32 weight (truncation).
    Backward: the gradient as it comes (straight through)."""

    @staticmethod
    def forward(ctx, w, mask):
        return (w.view(torch.int32) & mask).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


def transfer(w: torch.Tensor, round_to: int) -> torch.Tensor:
    """The weight as the step uses it after a transfer at ``round_to``."""
    if round_to >= 4:
        return w
    return _Keep.apply(w.contiguous(), _KEEP[round_to])


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products and convolutions with TF32 off (the configuration's
    arithmetic), or on (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@torch.no_grad()
def sgd(params: dict, grads: dict, moms: dict, decayed, opt: dict, lr: float) -> None:
    """``g += wd p`` on decayed leaves; ``m = mu m + g``; ``p -= lr m``."""
    for k, p in params.items():
        g = grads[k]
        if decayed(k):
            g = g + opt["weight_decay"] * p
        moms[k].mul_(opt["momentum"]).add_(g)
        p.sub_(lr * moms[k])


def norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v, dtype=torch.float64)) for k, v in tensors.items()}


def new_readings() -> dict:
    """``losses``: each step's loss; ``monitor``: each step's per-group
    sums of squares after the update; ``grad1``: each leaf's gradient norm
    at step 1 (before weight decay); ``update3``: each leaf's change after
    the checked steps."""
    return {"losses": [], "monitor": [], "grad1": {}, "update3": {}}
