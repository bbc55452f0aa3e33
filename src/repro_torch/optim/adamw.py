"""AdamW (counterpart of ``repro.optim.adamw``): the LM example drivers'
optimizer; the paper's CNN recipe stays on momentum SGD.

Elementwise on the storage leaves, like SGD, and in place: the moments
``mu`` and ``nu`` are updated where they lie, and so are the parameters.
The arithmetic is the reference's, in fp32: the step count ``t`` is an
int32 and the bias corrections ``1 - b ** t`` are taken with ``t`` as an
fp32 tensor, as the reference's ``b1 ** tf`` is (a Python float would
give the fp64 power, rounded once, which is not always the same fp32).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.trees import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def init_adamw(params):
    """``{"mu", "nu"}`` zeros beside every leaf and the step count ``t``
    (0-d int32, on the first leaf's device)."""
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params, grads, state, wd_mask, cfg: AdamWConfig, lr):
    """One AdamW step, in place; returns ``(params, state)``. ``wd_mask``:
    a tree of {0., 1.} beside the parameters (weights decay, norms do not).

    Per leaf, as the reference: ``mu = b1 mu + (1 - b1) g``; ``nu = b2 nu +
    (1 - b2) g g``; ``p -= lr ((mu / c1) / (sqrt(nu / c2) + eps) + wd p)``
    with ``c = 1 - b ** t`` in fp32."""
    t = state["t"] + 1
    tf = t.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=tf.device), tf)
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=tf.device), tf)
    for p, g, mu, nu, wd in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                                tree_leaves(wd_mask)):
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        step = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        p.sub_(lr * (step + cfg.weight_decay * wd * p))
    state["t"] = t
    return params, state
