"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
(counterpart of ``repro.models.ssm``, arXiv:2405.04517), with the
exponential-gating stabilizer ``m``:

mLSTM (per head, d_k = d_v = head width):
    m_t   = max(f̃_t + m_{t-1}, ĩ_t)
    i'_t  = exp(ĩ_t − m_t);  f'_t = exp(f̃_t + m_{t-1} − m_t)
    C_t   = f'_t C_{t-1} + i'_t k_t v_tᵀ
    n_t   = f'_t n_{t-1} + i'_t k_t
    h_t   = C_tᵀ q_t / max(|n_tᵀ q_t|, 1)

sLSTM (per unit, heads mix through block-diagonal recurrent matrices):
    c_t = f'_t c_{t-1} + i'_t z_t ;  n_t = f'_t n_{t-1} + i'_t
    h_t = o_t · c_t / max(n_t, 1e-6)

Both have a training path over the whole sequence and an O(1)-state
one-token decode. The reference scans time with ``lax.scan``; the port
runs the same steps as a Python loop (plain PyTorch, no kernel: the
reference has none). The chunkwise mLSTM (``Env.mlstm_chunk``) keeps the
state once a chunk and computes the positions inside a chunk as masked
matmuls.

TP mapping (as the reference's): the mLSTM shards the value dimension
(and the down projection) over the model group in a ``(dvh, H)`` column
layout, so every rank keeps all heads; q / k / gate projections are
replicated. The sLSTM runs replicated over the model group, its input
re-replicated under ``seq_parallel`` (``env.seq_unshard``) and its output
sliced back (``env.seq_shard``).

A state passed in is updated in place when the block returns (the serve
caches' contract, :mod:`repro_torch.models.model`); the block also
returns the new state.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.env import Env
from repro_torch.models.layers import rms_norm


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor  # (B, H, dk, dv_local / H)
    n: torch.Tensor  # (B, H, dk)
    m: torch.Tensor  # (B, H)

    def rep(self, r: int) -> "MLSTMState":
        return MLSTMState(self.C[r], self.n[r], self.m[r])


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor  # (B, d)
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)

    def rep(self, r: int) -> "SLSTMState":
        return SLSTMState(self.c[r], self.n[r], self.h[r], self.m[r])


def state_leaves(state) -> tuple:
    """The tensors of a recurrent state node, in field order."""
    return tuple(getattr(state, f.name) for f in dataclasses.fields(state))


def _store(into, new):
    """Write ``new``'s leaves into ``into``'s (in place) when a state was
    passed in; returns the state the block hands back."""
    if into is None:
        return new
    for a, b in zip(state_leaves(into), state_leaves(new)):
        a.copy_(b)
    return into


def init_mlstm_state(batch, heads, dk, dv_local, dtype, device="cpu"):
    return MLSTMState(
        torch.zeros((batch, heads, dk, dv_local), dtype=dtype, device=device),
        torch.zeros((batch, heads, dk), dtype=dtype, device=device),
        torch.full((batch, heads), -1e30, dtype=dtype, device=device),
    )


def init_slstm_state(batch, d, dtype, device="cpu"):
    def z():
        return torch.zeros((batch, d), dtype=dtype, device=device)

    return SLSTMState(z(), z(), z(), torch.full((batch, d), -1e30, dtype=dtype, device=device))


def _mlstm_step(C, n, m, q, k, v, i_t, f_t):
    """One mLSTM step. q, k (B, H, dk); v (B, H, dvl); i_t, f_t (B, H).
    Returns (C, n, m, h)."""
    dk = q.shape[-1]
    m_new = torch.maximum(f_t + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(f_t + m - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = fp[..., None] * n + ip[..., None] * k
    qs = q * (dk ** -0.5)
    num = torch.einsum("bhkv,bhk->bhv", C, qs)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, qs))
    h = num / torch.clamp(den, min=1.0)[..., None]
    return C, n, m_new, h


def mlstm_chunkwise(q, k, v, i_t, f_t, state: MLSTMState, chunk: int):
    """Chunkwise-parallel mLSTM (xLSTM appendix / GLA-style): the state is
    materialized once per ``chunk`` steps and the positions inside a chunk
    interact through masked matmuls. Exact up to the reassociation of fp
    sums (held to the sequential form in the tests).

    Shapes: q, k (B, S, H, dk); v (B, S, H, dv); i_t, f_t (B, S, H), f_t in
    log space. Returns (h (B, S, H, dv), final state)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    if S % chunk:
        raise ValueError(f"chunkwise mLSTM needs S divisible by chunk, got S={S} "
                         f"chunk={chunk}")
    scale = dk ** -0.5
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    C_in, n_in, m_in = state.C, state.n, state.m
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qq, kk, vv, ii, ff = q[:, sl], k[:, sl], v[:, sl], i_t[:, sl], f_t[:, sl]
        b = torch.cumsum(ff, dim=1)               # (B, chunk, H) log decay 1..t
        btot = b[:, -1:]                          # (B, 1, H)
        m_inter = b + m_in[:, None]               # (B, chunk, H)
        g = ii - b                                # i_s - b_s
        g_run = torch.cummax(g, dim=1).values     # max over s <= t
        m_t = torch.maximum(m_inter, b + g_run)
        # intra-chunk: D_ts = exp(b_t - b_s + i_s - m_t), s <= t. The mask
        # goes in before the exp (the reference's goes after): the same
        # values, but an s > t entry that overflows no longer turns its zero
        # cotangent into 0 · inf = NaN in the backward (ROADMAP F4)
        wmat = b[:, :, None] - b[:, None, :] + ii[:, None, :] - m_t[:, :, None]  # (B, t, s, H)
        d = torch.exp(torch.where(mask[None, :, :, None], wmat,
                                  torch.full((), -torch.inf, dtype=wmat.dtype,
                                             device=wmat.device)))
        s_qk = torch.einsum("bthd,bshd->btsh", qq, kk) * scale
        h_intra = torch.einsum("btsh,bshv->bthv", s_qk * d, vv)
        n_intra = torch.einsum("btsh,bshd->bthd", d, kk)
        # inter-chunk
        dec = torch.exp(m_inter - m_t)            # (B, chunk, H)
        h_inter = torch.einsum("bthd,bhdv->bthv", qq * scale, C_in) * dec[..., None]
        n_tot = n_intra + n_in[:, None] * dec[..., None]
        num = h_intra + h_inter
        den = torch.abs(torch.einsum("bthd,bthd->bth", qq * scale, n_tot))
        hs.append((num / torch.clamp(den, min=1.0)[..., None]).to(q.dtype))
        # the state handed to the next chunk
        m_out = torch.maximum(btot[:, 0] + m_in, torch.amax(g, dim=1) + btot[:, 0])
        wst = torch.exp(btot - b + ii - m_out[:, None])  # (B, chunk, H)
        carry = torch.exp(btot[:, 0] + m_in - m_out)
        C_out = (carry[..., None, None] * C_in
                 + torch.einsum("bshd,bshv->bhdv", kk * wst[..., None], vv))
        n_out = carry[..., None] * n_in + torch.einsum("bshd,bsh->bhd", kk, wst)
        C_in, n_in, m_in = C_out.to(C_in.dtype), n_out.to(n_in.dtype), m_out
    return torch.cat(hs, dim=1), MLSTMState(C_in, n_in, m_in)


def mlstm_block(x, w, cfg, env: Env, *, mode="train", state=None):
    """x: (B, S, d) -> (y, state'). w keys: ln, wq, wk, wv, wi, wf, wog,
    w_down (the rank's TP slices of wv, wog and w_down).

    Under ``env.seq_parallel`` the incoming ``x`` is a sequence shard;
    ``env.enter`` gathers the full sequence (the recurrence is sequential
    in time) and ``env.exit`` reduce-scatters the partial outputs. The
    chunkwise form runs when ``env.mlstm_chunk`` divides a sequence longer
    than one chunk, as in the reference."""
    d = x.shape[-1]
    H = cfg.num_heads
    dv = int(cfg.mlstm_proj_factor * d)
    dv_l = env.ff_local(dv)
    dkh = dv // H  # key width per head (= value width before sharding)

    xn = rms_norm(x, w["ln"], cfg.norm_eps)
    xin = env.enter(xn)
    B, S = xin.shape[:2]
    # value columns in the (dvh, H) layout: a contiguous TP slice of
    # wv / wog / w_down shards the within-head value dim, all heads stay
    dvh_l = dv_l // H
    q = (xin @ w["wq"]).reshape(B, S, H, dkh)
    k = (xin @ w["wk"]).reshape(B, S, H, dkh)
    v = (xin @ w["wv"]).reshape(B, S, dvh_l, H).transpose(2, 3)
    i_t = (xin @ w["wi"]).reshape(B, S, H)
    f_t = F.logsigmoid((xin @ w["wf"]).reshape(B, S, H))
    og = torch.sigmoid(xin @ w["wog"])  # (B, S, dv_l) in the (dvh, H) layout

    st = state if state is not None else init_mlstm_state(B, H, dkh, dvh_l, x.dtype,
                                                          device=x.device)
    if mode == "decode":
        if S != 1:
            raise ValueError(f"decode expects a single token, got S={S}")
        C, n, m, h = _mlstm_step(st.C, st.n, st.m, q[:, 0], k[:, 0], v[:, 0], i_t[:, 0],
                                 f_t[:, 0])
        new = MLSTMState(C, n, m)
        h = h[:, None]
    elif env.mlstm_chunk and S % env.mlstm_chunk == 0 and S > env.mlstm_chunk:
        h, new = mlstm_chunkwise(q, k, v, i_t, f_t, st, env.mlstm_chunk)
    else:
        C, n, m = st.C, st.n, st.m
        hs = []
        for t in range(S):
            C, n, m, h_t = _mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t], i_t[:, t],
                                       f_t[:, t])
            hs.append(h_t)
        new = MLSTMState(C, n, m)
        h = torch.stack(hs, dim=1)  # (B, S, H, dvl / H)

    # back to the flat (dvh, H) column layout before the gate and down-proj
    h = h.transpose(2, 3).reshape(B, h.shape[1], dv_l)
    h = h * og[:, : h.shape[1]]
    y = env.exit(h @ w["w_down"])
    return y, _store(state, new)


def _slstm_step(c, n, h_prev, m, wx, r, b, num_heads):
    """One sLSTM step. wx: (B, 4d) precomputed input contributions; r the
    block-diagonal recurrent weights (H, dh, 4 dh). Returns (c, n, h, m)."""
    B, d4 = wx.shape
    d = d4 // 4
    H = num_heads
    dh = d // H
    rec = torch.einsum("bhi,hio->bho", h_prev.reshape(B, H, dh), r)  # (B, H, 4 dh)
    # regroup the per-head gate quarters into the (z|i|f|o) layout of wx
    rec = rec.reshape(B, H, 4, dh).transpose(1, 2).reshape(B, 4 * d)
    pre = wx + rec + b
    z_t, i_t, f_t, o_t = torch.split(pre, d, dim=-1)
    z_t = torch.tanh(z_t)
    o_t = torch.sigmoid(o_t)
    f_log = F.logsigmoid(f_t)
    m_new = torch.maximum(f_log + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(f_log + m - m_new)
    c = fp * c + ip * z_t
    n = fp * n + ip
    h = o_t * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def slstm_block(x, w, cfg, env: Env, *, mode="train", state=None):
    """x: (B, S, d) -> (y, state'), replicated over the model group.

    w keys: ln, w_in (d, 4d), r (H, dh, 4dh), b (4d,), w_out (d, d). Under
    ``env.seq_parallel`` the shard is re-replicated for the recurrence
    (forward all-gather, backward slice) and the output sliced back onto
    the shards."""
    x = env.seq_unshard(x)
    B, S, d = x.shape
    xn = rms_norm(x, w["ln"], cfg.norm_eps)
    wx = xn @ w["w_in"]  # (B, S, 4d)
    st = state if state is not None else init_slstm_state(B, d, x.dtype, device=x.device)
    c, n, h, m = st.c, st.n, st.h, st.m
    if mode == "decode" and S != 1:
        raise ValueError(f"decode expects a single token, got S={S}")
    hs = []
    for t in range(S):
        c, n, h, m = _slstm_step(c, n, h, m, wx[:, t], w["r"], w["b"], cfg.num_heads)
        hs.append(h)
    y = torch.stack(hs, dim=1) @ w["w_out"]
    return env.seq_shard(y), _store(state, SLSTMState(c, n, h, m))
