"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427;
counterpart of ``repro.models.rglru``).

Block: RMSNorm -> two branches:
  y-branch: linear -> GeLU (tanh approximation)
  x-branch: linear -> causal depthwise conv1d (width ``conv1d_width``) -> RG-LRU
merge: y ⊙ h -> down projection.

RG-LRU recurrence (elementwise over the recurrence width r):
  r_t = σ(x_t W_a + b_a)          (recurrence gate)
  i_t = σ(x_t W_i + b_i)          (input gate)
  log a_t = −c · softplus(Λ) · r_t            (c = 8)
  h_t = a_t · h_{t−1} + √(1 − a_t²) · (i_t ⊙ x̃_t)

Training and prefill run the linear recurrence as the reference's
``lax.associative_scan`` does it (:func:`associative_scan`, the same
odd/even reduction tree, so the products are taken in the same order);
decode is the O(1) state update. The recurrence is elementwise over r, so
it shards over the model group with ``w_x`` / ``w_y`` / ``w_a`` / ``w_i``
column-parallel and ``w_down`` row-parallel. A state passed in is updated
in place when the block returns, as the mLSTM's
(:mod:`repro_torch.models.ssm`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.env import Env
from repro_torch.models.layers import rms_norm

_C = 8.0


@dataclasses.dataclass
class RGLRUState:
    h: torch.Tensor     # (B, r_local)
    conv: torch.Tensor  # (B, W - 1, r_local)

    def rep(self, r: int) -> "RGLRUState":
        return RGLRUState(self.h[r], self.conv[r])


def init_rglru_state(batch, r_local, width, dtype, device="cpu"):
    return RGLRUState(torch.zeros((batch, r_local), dtype=dtype, device=device),
                      torch.zeros((batch, width - 1, r_local), dtype=dtype, device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    switches to ``x`` above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv1d(x, conv_w, conv_b, conv_state):
    """Causal depthwise temporal conv. x: (B, S, r); conv_w: (W, r).
    Returns (y, new conv state (B, W - 1, r))."""
    B, S, r = x.shape
    W = conv_w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, W - 1, r), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)  # (B, S + W - 1, r)
    y = 0
    for i in range(W):
        y = y + xp[:, i:i + S] * conv_w[i][None, None, :]
    y = y + conv_b[None, None, :]
    return y, (xp[:, -(W - 1):] if W > 1 else conv_state)


def _combine(e1, e2):
    """The recurrence's monoid: ``(a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2)``."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of :func:`_combine` along dim 1, by the reduction
    tree of ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    halved sequence recursively (the odd outputs), combine those with the
    remaining even inputs, and interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]), (a[:, 1::2], b[:, 1::2]))
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


def sequential_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same recurrence one step at a time, ``h_t = a_t h_{t-1} + b_t``
    from ``h_{-1} = 0``: what :func:`associative_scan` is held to."""
    h, hs = torch.zeros_like(b[:, 0]), []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rglru_block(x, w, cfg, env: Env, *, mode="train", state=None):
    """x: (B, S, d) -> (y, state'), ``state`` a :class:`RGLRUState` of the
    rank's ``r / tp`` channels (``h (B, r_l)``, ``conv (B, W - 1, r_l)``).

    w keys: ln, w_x (d, r_l), w_y (d, r_l), conv_w (W, r_l), conv_b (r_l,),
    w_a (d, r_l), b_a, w_i (d, r_l), b_i, lam (r_l,), w_down (r_l, d).

    Under ``env.seq_parallel`` the incoming ``x`` is a sequence shard;
    ``env.enter`` gathers the full sequence (the recurrence scans time)
    and ``env.exit`` reduce-scatters the partial outputs."""
    xn = rms_norm(x, w["ln"], cfg.norm_eps)
    xin = env.enter(xn)
    B, S = xin.shape[:2]

    yb = F.gelu(xin @ w["w_y"], approximate="tanh")
    xb = xin @ w["w_x"]
    h_prev, conv_state = (state.h, state.conv) if state is not None else (None, None)
    xb, conv_state = _conv1d(xb, w["conv_w"], w["conv_b"], conv_state)

    r_gate = torch.sigmoid(xin @ w["w_a"] + w["b_a"])
    i_gate = torch.sigmoid(xin @ w["w_i"] + w["b_i"])
    log_a = -_C * softplus(w["lam"])[None, None, :] * r_gate  # (B, S, r)
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_gate * xb)

    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode expects a single token, got S={S}")
        if h_prev is None:
            h_prev = torch.zeros((B, a.shape[-1]), dtype=x.dtype, device=x.device)
        hs = (a[:, 0] * h_prev + gated_x[:, 0])[:, None]
    else:
        if h_prev is not None:  # fold the carried state into the first step
            gated_x = torch.cat([gated_x[:, :1] + a[:, :1] * h_prev[:, None], gated_x[:, 1:]],
                                dim=1)
        _, hs = associative_scan(a, gated_x)
    new = RGLRUState(hs[:, -1], conv_state)
    if state is not None:
        state.h.copy_(new.h)
        state.conv.copy_(new.conv)
        new = state
    y = env.exit((yb[:, : hs.shape[1]] * hs) @ w["w_down"])
    return y, new
