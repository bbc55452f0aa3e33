"""Channel mixers (counterpart of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, w: dict, env) -> torch.Tensor:
    """Column-parallel gate/up, row-parallel down (one model-axis psum in
    the reference; the identity at tp = 1)."""
    xin = env.enter(x)
    g = F.silu(xin @ w["w_gate"])
    u = xin @ w["w_up"]
    return env.exit((g * u) @ w["w_down"])
