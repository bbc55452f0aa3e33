"""Dense channel mixers (counterpart of ``repro.models.mlp``): SwiGLU
(llama family) and the GeLU MLP (hubert)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w: dict, env) -> torch.Tensor:
    """Column-parallel gate/up, row-parallel down: ``env.enter`` /
    ``env.exit`` carry the region's model-group collectives (the identity
    with no model axis)."""
    xin = env.enter(x)
    g = F.silu(xin @ w["w_gate"])
    u = xin @ w["w_up"]
    return env.exit((g * u) @ w["w_down"])


def gelu_mlp(x: torch.Tensor, w: dict, env) -> torch.Tensor:
    """Column-parallel up, row-parallel down, the tanh-approximated GeLU
    between them (the reference's ``jax.nn.gelu(approximate=True)``)."""
    xin = env.enter(x)
    h = F.gelu(xin @ w["w_up"], approximate="tanh")
    return env.exit(h @ w["w_down"])
