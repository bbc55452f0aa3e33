"""Mixture-of-Experts channel mixer: top-k router + two sharding layouts
(counterpart of ``repro.models.moe``).

* ``tp``  — every expert's ``d_ff`` is sliced over the model group;
  dispatch is local to the rank and the only collective is the block's
  exit all-reduce, which also carries arctic's dense residual. Used when
  the expert count does not divide the TP degree (mixtral), and always on
  one device.
* ``ep``  — whole experts are split over the model group (arctic: ``E /
  tp`` a rank); the tokens are split over the model group, exchanged with
  their experts' owners by an ``all_to_all`` of ``(E, C, d)`` buffers,
  processed, returned by the mirrored ``all_to_all`` and gathered back.
  Decode steps, whose few tokens do not split over the group, run
  "replicated EP": every rank dispatches the whole token set. Under the
  sequence-parallel layout the sequence shards are the token split.

Dispatch is sort-based with a static capacity ``max(8, round_up(int(cf ·
T · k / E), 8))`` (no ``(T, E, C)`` one-hot): tokens are ranked within
their expert by ``searchsorted`` over the stably sorted expert ids and
written into an ``(E · C + 1, d)`` buffer whose last row takes the
dropped ones and is cut away. Top-k ties break to the lower expert
index, as ``lax.top_k`` does (a stable descending sort, of which the
first ``k``).

Gradients follow the port's TP convention: every model rank holds the
whole gradient of a replicated activation, and the router's gradient, a
partial sum on each rank, is summed by the step's gradient sync. The
token split is a slice with an all-gather backward and the merge the
inverse pair (``core.collectives.seq_split`` / ``seq_merge`` along the
token dim); an ``all_to_all``'s backward is the inverse exchange. The
split's backward already gives every rank the whole input gradient, so no
``psum_enter`` precedes it. Where every model rank computes the same value
the cotangent is shared out (``1 / tp`` a rank) and the sums of the
backward add the shares up: replicated EP's expert branch, and the aux
loss at tp > 1 (the whole batch's on every rank in the ``tp`` layout; the
chunks' sum, an all-reduce whose backward is an all-reduce too, in the
``ep`` layout). The reference shares out nothing and has the
``psum_enter`` before the split, so those gradients come out ``tp`` times
the one-device ones there (ROADMAP Queue 3). All collectives go through
``dist.comm``: the split, the merge and the exchanges logged as
``relayout``, the aux sum as ``metrics``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.dist import comm
from repro_torch.models.env import Env
from repro_torch.utils.trees import round_up


class _Exchange(torch.autograd.Function):
    """The all-to-all over the model group along dim 0 (of size ``tp``):
    block ``j`` afterwards holds what rank ``j`` had in block ``rank``.
    The exchange is its own inverse, so its backward is the same call."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_to_all(x, group, axis=0, traffic="relayout")

    @staticmethod
    def backward(ctx, g):
        return comm.all_to_all(g.contiguous(), ctx.group, axis=0, traffic="relayout"), None


class _ShareCotangent(torch.autograd.Function):
    """Identity forward; the backward divides the cotangent by ``tp``, so
    that ``tp`` ranks computing the same value each take their share."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.tp, None


class _AuxSum(torch.autograd.Function):
    """The aux loss summed over the model group; the backward sums the
    cotangent over the group too, as the reference's ``psum`` transposes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_reduce(x, group, traffic="metrics")

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.group, traffic="metrics"), None


def _route(x, router_w, num_experts: int, top_k: int):
    """Top-k routing in fp32. Returns ``(probs (T, k), experts (T, k),
    aux)``: the top probabilities renormalized, their experts (ties to the
    lower index), and the switch load-balance loss ``E · Σ(me · ce)``."""
    logits = x.float() @ router_w.float()
    probs_full = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties to the lower index; torch.topk makes no such
    # promise, a stable descending sort does
    top = torch.sort(probs_full, dim=-1, descending=True, stable=True)
    top_p, top_e = top.values[:, :top_k], top.indices[:, :top_k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    me = probs_full.mean(dim=0)
    ce = F.one_hot(top_e[:, 0], num_experts).float().mean(dim=0)
    aux = num_experts * (me * ce).sum()
    return top_p, top_e, aux


def _dispatch_indices(top_e: torch.Tensor, num_experts: int, capacity: int):
    """Sort-based capacity dispatch. Returns ``(src_token (N,), dest_slot
    (N,), keep (N,), order (N,))``, ``N = T · k``, in the order of the
    stable sort of the flat expert ids; ``dest_slot`` indexes an ``(E · C
    + 1,)`` buffer whose last slot takes the dropped entries."""
    T, k = top_e.shape
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(num_experts, device=top_e.device))
    rank = torch.arange(T * k, device=top_e.device) - starts[sorted_e]
    keep = rank < capacity
    dest = torch.where(keep, sorted_e * capacity + rank,
                       torch.full_like(rank, num_experts * capacity))
    src = order // k
    return src, dest, keep, order


def _expert_ffn(buf, w_gate, w_up, w_down):
    """``(E, C, d)`` through each expert's SwiGLU -> ``(E, C, d)``."""
    g = F.silu(torch.bmm(buf, w_gate))
    u = torch.bmm(buf, w_up)
    return torch.bmm(g * u, w_down)


def _dense(x, w):
    """Arctic's dense residual SwiGLU on ``(T, d)`` rows."""
    return (F.silu(x @ w["dense_gate"]) * (x @ w["dense_up"])) @ w["dense_down"]


def capacity(cfg, tokens: int) -> int:
    """Slots an expert takes for ``tokens`` routed tokens."""
    return max(8, round_up(int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts), 8))


def moe_block(x: torch.Tensor, w: dict, cfg, env: Env):
    """MoE mixer on ``(B, S, d)`` -> ``(out, aux)``, dispatched per
    ``cfg.moe_impl`` (``tp`` on one device).

    Under ``env.seq_parallel`` the incoming ``x`` is a sequence shard. The
    ``tp`` layout gathers it at the block's entry (``env.enter``) and
    reduce-scatters the partial outputs back (``env.exit``), as the dense
    mixer does; the ``ep`` layout dispatches the shard's tokens directly,
    and its combined output already is the shard."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    impl = cfg.moe_impl if env.tp > 1 else "tp"
    sp = env.seq_parallel_active
    group = env.model_group

    dense_y = None
    if cfg.moe_dense_ff and impl == "ep":
        # the dense residual in the TP layout, on the replicated tokens: its
        # weights are sliced over the model group and need the exit's sum
        xr = env.enter(x).reshape(-1, d)
        dense_y = env.exit(_dense(xr, w).reshape(B, -1, d))

    # EP needs the token count to split over the model group; a decode
    # step's few tokens run replicated (every rank dispatches all of them)
    ep_split = impl == "ep" and (B * S) % env.tp == 0 and (B * S) >= env.tp

    if impl == "ep" and sp:
        xf = x.reshape(B * S, d)  # the sequence shards are the token split
    elif impl == "ep" and ep_split:
        # a slice, an all-gather backward: the rank's tokens get their whole
        # gradient here, so nothing sums them afterwards
        xf = C.seq_split(x.reshape(B * S, d), group, axis=0)
    elif impl == "ep":
        xf = env.psum_enter(x.reshape(B * S, d))
    else:  # tp layout: the block's boundary collectives at (B, S, d)
        xf = env.enter(x).reshape(-1, d)
    T = xf.shape[0]

    top_p, top_e, aux = _route(xf, w["router"], E, k)
    if env.tp > 1:
        aux = _ShareCotangent.apply(aux, env.tp)
    cap = capacity(cfg, T)
    src, dest, keep, order = _dispatch_indices(top_e, E, cap)

    # kept entries have distinct slots, so the adds below write each slot
    # once (exact under atomics); the dropped ones all land in the last
    # slot, which is cut away
    rows = xf[src] * keep[:, None].to(xf.dtype)
    buf = torch.zeros(E * cap + 1, d, dtype=xf.dtype, device=xf.device).index_add(0, dest, rows)
    buf = buf[:-1].reshape(E, cap, d)

    if impl == "ep":
        M = env.tp
        e_loc = E // M
        # (E, C, d) -> (e_loc, M·C, d): every rank keeps its experts' slots
        # from every rank (the reference's tiled split 0 / concat 1)
        sent = _Exchange.apply(buf.reshape(M, e_loc, cap, d).contiguous(), group)
        sent = sent.transpose(0, 1).reshape(e_loc, M * cap, d)
        out_loc = _expert_ffn(sent, w["w_gate"], w["w_up"], w["w_down"])
        back = out_loc.reshape(e_loc, M, cap, d).transpose(0, 1).contiguous()
        buf_out = _Exchange.apply(back, group).reshape(E, cap, d)
    else:
        buf_out = _expert_ffn(buf, w["w_gate"], w["w_up"], w["w_down"])  # partial at tp > 1

    flat_out = torch.cat([buf_out.reshape(E * cap, d),
                          torch.zeros(1, d, dtype=xf.dtype, device=xf.device)])
    # combine: each token gathers its k slots in token order and sums them
    # (the reference scatter-adds them into zeros; with k = 2 either order is
    # exact, and a gather keeps the sum deterministic on the card, where
    # index_add_ would add through atomics)
    slot, kept = torch.empty_like(dest), torch.empty_like(keep)
    slot[order], kept[order] = dest, keep
    weight = (top_p.reshape(-1) * kept).to(xf.dtype)
    y = (flat_out[slot] * weight[:, None]).reshape(T, k, d).sum(dim=1)

    if cfg.moe_dense_ff and impl != "ep":
        y = y + _dense(xf, w)  # shares the block's exit all-reduce

    if impl == "ep" and sp:
        aux = _AuxSum.apply(aux, group) / env.tp
        y = y.reshape(B, S, d)
    elif impl == "ep" and ep_split:
        # the reference's _token_merge: an all-gather, a slice backward
        y = C.seq_merge(y, group, axis=0).reshape(B, S, d)
        aux = _AuxSum.apply(aux, group) / env.tp
    elif impl == "ep":
        # replicated EP: whole on every rank, each rank's copy a share
        y = _ShareCotangent.apply(y.reshape(B, S, d), env.tp)
    else:
        # (B, S_full, d) under seq_parallel: the exit scatters to the shards
        y = env.exit(y.reshape(B, -1, d))
    if dense_y is not None:
        y = y + dense_y
    return y, aux
