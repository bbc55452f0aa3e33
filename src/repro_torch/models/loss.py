"""Cross-entropy over the vocabulary (counterpart of ``repro.models.loss``,
the trivial mesh).

The reference shards the vocabulary over the model axis and joins the
partial max and sums with collectives; on one device the logits hold the
whole vocabulary, ``vocab_start`` is 0 and those joins (``env.psum_exit``,
``lax.pmax``) are the identity. The arithmetic is the reference's: padded
vocabulary rows score ``-1e30``, the max is taken without a gradient, and
negative labels are ignored.
"""
from __future__ import annotations

import torch

from repro_torch.models.env import Env

NEG_INF = -1e30


def lm_loss(
    logits: torch.Tensor,   # (B, S, V)
    labels: torch.Tensor,   # (B, S) integer; negative = ignore
    env: Env,
    vocab_start: int,
    real_vocab: int,        # unpadded vocab size
) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed token NLL and the count of valid tokens (both 0-d fp32)."""
    vloc = logits.shape[-1]
    logits = logits.to(torch.float32)
    if vocab_start + vloc > real_vocab:  # padded rows never win the softmax
        gidx = vocab_start + torch.arange(vloc, device=logits.device)
        logits = torch.where((gidx < real_vocab)[None, None, :], logits, NEG_INF)
    m = logits.detach().amax(dim=-1)
    s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    lse = torch.log(s) + m

    labels = labels.to(torch.int64)
    local_ids = labels - vocab_start
    in_range = (local_ids >= 0) & (local_ids < vloc)
    safe = torch.clamp(local_ids, 0, vloc - 1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    tgt = torch.where(in_range, tgt, torch.zeros((), dtype=tgt.dtype, device=tgt.device))

    valid = (labels >= 0).to(torch.float32)
    nll = (lse - tgt) * valid
    return torch.sum(nll), torch.sum(valid)
