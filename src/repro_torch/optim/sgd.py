"""Momentum SGD — the paper's optimizer (§IV-B: momentum 0.9, weight decay
5e-4, exponential LR decay); counterpart of ``repro.optim.sgd``.

The update is elementwise on the master weights, so layout is irrelevant.
Unlike the reference's pure functions it updates params and momentum in
place (no second copy of either tree on the card).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 5e-4
    # paper §IV-B: LR decays by 0.16 every `decay_every` batches
    lr_decay_rate: float = 0.16
    lr_decay_every: int = 0  # 0 = no decay


def lr_at(cfg: SGDConfig, step: int) -> float:
    if not cfg.lr_decay_every:
        return cfg.lr
    return cfg.lr * (cfg.lr_decay_rate ** (step // cfg.lr_decay_every))


def init_momentum(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def sgd_update(params, grads, momentum, wd_mask, cfg: SGDConfig, lr):
    """One momentum-SGD step, in place; returns ``(params, momentum)``.
    ``wd_mask``: tree of {0., 1.} selecting the leaves that get weight
    decay (weights yes, biases and norm scales no).

    Same arithmetic as the reference: ``g += wd·p; m = μ·m + g;
    p -= lr·m``."""
    for p, g, m, wd in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(momentum),
        tree_leaves(wd_mask),
    ):
        if wd:
            g = g + (cfg.weight_decay * wd) * p
        m.mul_(cfg.momentum).add_(g)
        p.sub_(lr * m)
    return params, momentum
