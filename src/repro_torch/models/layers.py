"""Shared primitive layers: RMSNorm, rotary embeddings, embedding lookup
(counterpart of ``repro.models.layers``)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(dtype)


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (qwen3): RMSNorm over the trailing head_dim."""
    return rms_norm(x, scale, eps)


def rope_frequencies(head_dim: int, rotary_pct: float, theta: float, device) -> torch.Tensor:
    """Inverse frequencies for the rotated fraction of head_dim."""
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    rotary_pct: float = 1.0,
    theta: float = 1e4,
) -> torch.Tensor:
    """Rotary embedding on ``x: (..., S, H, head_dim)`` at ``positions``,
    ``(S,)`` (shared by the batch) or ``(B, S)`` (per-request positions:
    the serve engine's slotted decode). Pairs are interleaved
    (``x[..., 0::2]``, ``x[..., 1::2]``) as in the reference."""
    head_dim = x.shape[-1]
    inv_freq = rope_frequencies(head_dim, rotary_pct, theta, x.device)
    rot = 2 * inv_freq.shape[0]
    if rot == 0:
        return x
    dtype = x.dtype
    ang = positions.to(torch.float32)[..., None] * inv_freq  # (..., S, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    cos = cos[..., None, :]  # (..., S, 1, rot/2)
    sin = sin[..., None, :]
    x_rot, x_pass = x[..., :rot].to(torch.float32), x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(dtype)
    return torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y


def embed_lookup_vp(
    tokens: torch.Tensor,
    table_local: torch.Tensor,
    vocab_start: int,
    env,
) -> torch.Tensor:
    """Vocab-parallel embedding: each model rank holds a vocab slice;
    out-of-slice tokens contribute zero and ``env.exit`` (a model-axis
    psum in the reference, the identity at tp = 1) restores the rows."""
    vloc = table_local.shape[0]
    local_ids = tokens.to(torch.int64) - vocab_start
    in_range = (local_ids >= 0) & (local_ids < vloc)
    safe = torch.clamp(local_ids, 0, vloc - 1)
    out = table_local[safe]
    out = torch.where(in_range[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return env.exit(out)
