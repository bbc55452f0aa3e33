"""Model assembly: embedding -> layer groups -> head / loss (counterpart
of ``repro.models.model``): attention blocks (``attn``, and ``local``
with the config's sliding window) with a SwiGLU or a mixture of experts
(:mod:`repro_torch.models.moe`) as the channel mixer, and the recurrent
blocks of the block pattern: xLSTM's ``mlstm`` / ``slstm``
(:mod:`repro_torch.models.ssm`) and RecurrentGemma's ``rglru``
(:mod:`repro_torch.models.rglru`, followed by the SwiGLU); the vision
archs' gated ``cross`` blocks (attention over the image embeddings
``image_features @ img_proj``, no channel mixer) and the hubert encoder
(bidirectional attention with a GeLU MLP, its inputs ``features @
embed_in`` through the input stub).
Under tensor parallelism (``env.model_group``) every weight a function
sees is the rank's TP slice: heads, ``d_ff`` (each expert's under the
MoE ``tp`` layout, whole experts under ``ep``) and the vocabulary are
split over the model group, and ``env``'s boundaries carry the
collectives. Every block returns the MoE auxiliary loss beside its
output (0 for a SwiGLU); :func:`run_group` sums it over a group's layers
and :func:`forward_loss` over the groups, in the reference's order. Prefill and
decode run on every rank of the model group alike, each on its heads and
its vocabulary slice: the logits they return are the rank's ``(B, 1, V /
tp)`` slice (``serve.step`` gathers them). A decode step has one token,
nothing to split over the sequence: it runs the replicated psum layout
under a ``seq_parallel`` env too, as the reference does.

Every forward routes through :func:`run_group`, whose loop over a group's
layer repetitions materializes each layer's weights through the caller's
``mat_fn`` (the ADT pack∘unpack of every ``DIST`` leaf, or the resident
weights under weight-stationary serving) just before that layer runs, so
only one layer's materialized weights are alive at a time. The
reference scans the repetitions; PyTorch runs them as a Python loop.

Training (:func:`forward_loss`) under ``cfg.remat`` wraps each
repetition, materialization included, in
``torch.utils.checkpoint.checkpoint`` (as the reference wraps its scan
body in ``jax.checkpoint``): the backward keeps only the layer inputs and
runs the repetition again, so its weights are packed and unpacked a
second time there. The recomputation stops once it has every tensor the
backward saved (early stop, pinned), so the layer's last TP-region exit is
not run again (``train.step.remat_tp_collectives``).

Caches are stacked per group (leading repetition dim) and updated in
place; the returned caches are the same tensors; ``env.int8_kv`` makes
the attention KV int8 with fp32 scales. A recurrent block's cache is its
state (``MLSTMState``, ``SLSTMState``, ``RGLRUState``, O(1) per slot,
never int8), also updated in place. The serve engine's paged layout
(:func:`init_paged_caches`) gives every attention block a page pool
instead, read through the ``page_table`` a decode step carries. A
decode's ``window_override`` (the serve engine's sliding window, merged
with the config's ``sliding_window``) masks the attention and makes a
cache whose capacity is at most the window a ring; a prefill attends
without it, as the reference's does, and only its cache geometry check
sees it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm
from repro_torch.models.attention import (
    check_cache_geometry,
    init_cache,
    init_paged_cache,
    leaves,
    mha,
)
from repro_torch.models.env import Env
from repro_torch.models.layers import embed_lookup_vp, rms_norm
from repro_torch.models.loss import lm_loss
from repro_torch.models.mlp import gelu_mlp, swiglu
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import RGLRUState, init_rglru_state, rglru_block
from repro_torch.utils import spans

RECURRENT_STATES = (ssm.MLSTMState, ssm.SLSTMState, RGLRUState)


def _window(cfg: ModelConfig, window_override, kind: str = "attn"):
    """The attention window: the config's ``sliding_window`` merged with
    an override, as the reference's ``apply_block`` merges them (a
    ``local`` block always carries the config's window)."""
    window = cfg.sliding_window or None
    if kind == "local":
        window = cfg.sliding_window
    if window_override is not None:
        window = window_override if window is None else min(window, window_override)
    return window


def _channel_mix(x, w, cfg: ModelConfig, env: Env):
    """Post-attention channel mixer -> ``(delta, aux)``: the experts
    (``num_experts``), an ``audio`` arch's GeLU MLP or a SwiGLU (aux 0.0);
    none when ``d_ff == 0``."""
    if "mix" not in w:
        return torch.zeros_like(x), 0.0
    wm = w["mix"]
    xn = rms_norm(x, wm["ln"], cfg.norm_eps)
    if cfg.num_experts:
        return moe_block(xn, wm, cfg, env)
    if cfg.arch_type == "audio":
        return gelu_mlp(xn, wm, env), 0.0
    return swiglu(xn, wm, env), 0.0


def apply_block(
    kind: str,
    x: torch.Tensor,
    w: dict,
    cfg: ModelConfig,
    env: Env,
    *,
    mode: str,
    cache: Any = None,
    img_kv=None,
    window_override=None,
    pos_offset=0,
    page_table=None,
):
    """One block of the pattern. Returns (x', cache', aux), ``aux`` the
    MoE auxiliary loss (0.0 for a SwiGLU and the recurrent blocks). A
    ``cross`` block attends over ``img_kv`` (``(B, N, d)``; ``None`` in
    decode, which reads the cache) and takes no window."""
    if kind == "cross":
        wa = w["attn"]
        xn = rms_norm(x, wa["ln"], cfg.norm_eps)
        y, cache = mha(xn, wa, cfg, env, mode=mode, cache=cache, kv_ext=img_kv,
                       is_cross=True, pos_offset=pos_offset)
        return x + y, cache, 0.0  # no channel mixer
    if kind in ("attn", "local"):
        wa = w["attn"]
        xn = rms_norm(x, wa["ln"], cfg.norm_eps)
        y, cache = mha(xn, wa, cfg, env, mode=mode, cache=cache,
                       window=_window(cfg, window_override, kind),
                       pos_offset=pos_offset, page_table=page_table)
        x = x + y
        dy, aux = _channel_mix(x, w, cfg, env)
        return x + dy, cache, aux
    if kind == "mlstm":
        y, cache = ssm.mlstm_block(x, w["mlstm"], cfg, env, mode=mode, state=cache)
        return x + y, cache, 0.0
    if kind == "slstm":
        y, cache = ssm.slstm_block(x, w["slstm"], cfg, env, mode=mode, state=cache)
        return x + y, cache, 0.0
    if kind == "rglru":
        y, cache = rglru_block(x, w["rglru"], cfg, env, mode=mode, state=cache)
        x = x + y
        dy, _ = _channel_mix(x, w, cfg, env)
        return x + dy, cache, 0.0
    raise ValueError(kind)


def run_group(
    x: torch.Tensor,
    group_params: dict,      # {p<i>: stacked (R, ...) param trees}
    cfg: ModelConfig,
    env: Env,
    *,
    mode: str,
    mat_fn: Callable[..., dict],  # (pattern key, rep storage, rep=) -> weights
    caches: Any = None,      # {p<i>: stacked cache nodes} or None
    img_kv=None,             # (B, N, d) image KV source of the cross blocks
    window_override=None,
    pos_offset=0,
    page_table=None,         # (B, n_pages) int32 — paged decode only
):
    """Run the group's pattern repetitions. Returns (x, caches', aux),
    ``aux`` the blocks' auxiliary losses summed in order from 0.0.
    ``mat_fn(key, storage, rep=rep)`` materializes a repetition's weights
    (``rep`` names the layer's stochastic-rounding site).

    ``group_params`` leaves are stacked ``(R, ...)`` tensors, or lists of
    ``R`` per-repetition tensors (the train step's leaves, so that each
    repetition's gradient is its own tensor)."""

    def body(x, rep):
        aux_rep = 0.0
        for pi, kind in enumerate(cfg.pattern):
            key = f"p{pi}"
            w = mat_fn(key, _index(group_params[key], rep), rep=rep)
            c_in = caches[key].rep(rep) if caches is not None else None
            x, _, aux = apply_block(
                kind, x, w, cfg, env, mode=mode, cache=c_in, img_kv=img_kv,
                window_override=window_override, pos_offset=pos_offset,
                page_table=page_table,
            )
            aux_rep = aux_rep + aux
            del w  # one layer's materialized weights alive at a time
        return x, aux_rep

    remat = cfg.remat and mode == "train"
    aux_total = 0.0
    for rep in range(cfg.layers_per_group // len(cfg.pattern)):
        if remat:
            # early stop pinned: the recomputation ends once the backward has
            # every tensor it saved, so a layer's last TP-region exit (whose
            # output nothing in the layer reads) is not run again
            with set_checkpoint_early_stop(True):
                x, aux = checkpoint(body, x, rep, use_reentrant=False)
        else:
            x, aux = body(x, rep)
        aux_total = aux_total + aux
    return x, caches, aux_total


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# end-to-end forwards
# ---------------------------------------------------------------------------


def _embed(params, batch, cfg: ModelConfig, env: Env, mat_top):
    """Token or feature embedding in the env's activation layout. Tokens:
    each model rank looks up its vocabulary slice, and ``env.exit`` sums
    the rows over the model group (under ``seq_parallel`` a
    reduce-scatter onto this rank's sequence shard). The input stub:
    ``features @ embed_in``, replicated, then sliced to the rank's
    sequence shard under ``seq_parallel``."""
    if cfg.embed_is_input_stub:
        return env.seq_shard(batch["features"] @ mat_top("embed_in"))
    table = mat_top("embed")  # (V / tp, d)
    vocab_start = env.model_rank() * table.shape[0]
    return embed_lookup_vp(batch["tokens"], table, vocab_start, env)


def _img_kv(params, batch, cfg: ModelConfig, env: Env, mat_top):
    """The cross blocks' image KV source ``image_features @ img_proj``
    ``(B, N, d)``, replicated over the model group; ``None`` without
    image tokens."""
    if not cfg.num_image_tokens:
        return None
    return batch["image_features"] @ mat_top("img_proj")


def _logits(x, params, cfg: ModelConfig, env: Env, mat_top):
    """Final norm + vocab-parallel logits entry: ``env.enter`` takes the
    activations into the region (gathering the sequence shards under
    ``seq_parallel``); the logits are ``(B, S, V / tp)``."""
    x = rms_norm(x, mat_top("final_norm"), cfg.norm_eps)
    if cfg.tie_embeddings:
        return env.enter(x) @ mat_top("embed").T
    return env.enter(x) @ mat_top("head")


def forward_loss(params, batch: dict, cfg: ModelConfig, env: Env, *,
                 mat_group: Callable[[int, str, dict], dict],
                 mat_top: Callable[[str], Any]):
    """Training forward: summed token NLL. Returns ``(nll_sum, metrics)``
    with ``metrics = {"nll_sum", "token_count", "aux"}``; the train step
    divides by the token count and adds the MoE auxiliary loss ``aux``
    (summed over every layer; 0.0 for a dense model)."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    img_kv = _img_kv(params, batch, cfg, env, mat_top)
    aux_total = 0.0
    for g, gp in enumerate(params["groups"]):
        x, _, aux = run_group(x, gp, cfg, env, mode="train",
                              mat_fn=functools.partial(mat_group, g), img_kv=img_kv)
        aux_total = aux_total + aux
    logits = _logits(x, params, cfg, env, mat_top)
    vocab_start = env.model_rank() * logits.shape[-1]
    with spans.span("model.loss"):
        nll_sum, count = lm_loss(logits, batch["labels"], env, vocab_start, cfg.vocab_size)
    return nll_sum, {"nll_sum": nll_sum, "token_count": count, "aux": aux_total}


def forward_prefill(params, batch, cfg, env, *, mat_group, mat_top,
                    cache_capacity, window_override=None):
    """Prefill: returns (last-token logits (B, 1, V), caches per group).
    A prompt longer than ``cache_capacity`` keeps its trailing tokens in a
    ring, which the geometry check allows only under a window (the
    config's or ``window_override``); the attention itself is the full
    causal one, as in the reference.

    ``batch["last"]`` (an int or a 0-d integer tensor, optional) marks the
    last *real* token when the prompt is right-padded to a page-bucket
    length: the logits are read there instead of at ``S - 1``. Padding is
    causal-safe for pure-attention patterns without experts: the serve
    engine pads MoE prompts no more than the reference's does."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    img_kv = _img_kv(params, batch, cfg, env, mat_top)
    B, S = x.shape[:2]
    caches = init_caches(cfg, env, B, cache_capacity, env.dtype, device=x.device, context=S,
                         window_override=window_override)
    for g, gp in enumerate(params["groups"]):
        x, _, _ = run_group(
            x, gp, cfg, env, mode="prefill",
            mat_fn=functools.partial(mat_group, g), caches=caches[g], img_kv=img_kv,
        )
    if env.seq_parallel_active:
        if "last" in batch:
            raise ValueError("batch['last'] (a page-padded prompt) needs the replicated "
                             "layout: turn seq_parallel off for padded prompts")
        # gather each shard's last token (B, tp, d) — the global last token
        # is the last rank's — and run the logits entry replicated
        x = env.seq_unshard(x[:, -1:])
        env = env.without_seq_parallel()
        x_last = x[:, -1:]
    elif "last" in batch:
        last = torch.as_tensor(batch["last"], device=x.device).reshape(1)
        x_last = x.index_select(1, last.to(torch.int64))
    else:
        x_last = x[:, -1:]
    logits = _logits(x_last, params, cfg, env, mat_top)
    return logits, caches


def forward_decode(params, batch, caches, cfg, env, *, mat_group, mat_top,
                   window_override=None):
    """Decode step. ``batch["tokens"]`` (B, 1), or (B, k + 1) for the
    speculative verify block over per-slot caches; ``batch["pos"]``
    is a scalar (uniform batch) or ``(B,)`` (per-slot); the paged engine's
    batches also carry ``batch["page_table"]`` (B, n_pages). Returns
    (logits (B, T, V), caches') — the caches are updated in place.

    One token has no sequence dim to shard: a ``seq_parallel`` env falls
    back to the replicated psum layout here (the caches are whole
    sequences either way, so a sequence-parallel prefill hands over to
    it as it is)."""
    env = env.without_seq_parallel()
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    pos = batch["pos"]
    page_table = batch.get("page_table")
    for g, gp in enumerate(params["groups"]):
        x, _, _ = run_group(
            x, gp, cfg, env, mode="decode",
            mat_fn=functools.partial(mat_group, g), caches=caches[g],
            window_override=window_override, pos_offset=pos, page_table=page_table,
        )
    return _logits(x, params, cfg, env, mat_top), caches


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def node_leaves(node) -> tuple:
    """The data leaves of any cache node: an attention cache's
    (:func:`~repro_torch.models.attention.leaves`, no ``pos``) or every
    leaf of a recurrent state."""
    if isinstance(node, RECURRENT_STATES):
        return ssm.state_leaves(node)
    return leaves(node)


def _stack(one, reps: int):
    """A cache node with every leaf repeated ``reps`` times along a new
    leading dim (fresh storage)."""
    return type(one)(*(t.expand(reps, *t.shape).clone() for t in (
        getattr(one, f.name) for f in dataclasses.fields(one))))


def _block_cache(kind, cfg: ModelConfig, env: Env, batch, capacity, dtype, *, per_slot,
                 device, kv_l, tp, context=None, window_override=None):
    """One block's cache: the attention KV (a ``local`` block's capacity
    capped at the config's window, where it rings; a ``cross`` block's
    the ``max(N, 1)`` image tokens, in ``dtype`` under int8 KV too, with a
    scalar ``pos``), or the recurrent state at the rank's widths (``tp``:
    the mLSTM's value columns and the RG-LRU's channels split over the
    model group)."""
    if kind == "cross":
        return init_cache(batch, max(cfg.num_image_tokens, 1), kv_l, cfg.head_dim, dtype,
                          device=device)
    if kind in ("attn", "local"):
        cap = min(capacity, cfg.sliding_window) if kind == "local" else capacity
        if context is not None:
            check_cache_geometry(cap, _window(cfg, window_override), context)
        return init_cache(batch, cap, kv_l, cfg.head_dim,
                          torch.int8 if env.int8_kv else dtype,
                          per_slot=per_slot, device=device)
    if kind == "mlstm":
        dv = int(cfg.mlstm_proj_factor * cfg.d_model)
        H = cfg.num_heads
        return ssm.init_mlstm_state(batch, H, dv // H, max(1, dv // tp) // H, dtype,
                                    device=device)
    if kind == "slstm":
        return ssm.init_slstm_state(batch, cfg.d_model, dtype, device=device)
    if kind == "rglru":
        r_l = max(1, (cfg.lru_dim or cfg.d_model) // tp)
        return init_rglru_state(batch, r_l, cfg.conv1d_width, dtype, device=device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, env: Env, batch: int, capacity: int, dtype,
                per_slot: bool = False, *, device="cpu", kv_heads: int | None = None,
                tp: int | None = None, context: int | None = None, window_override=None):
    """Stacked caches per group: ``groups[g]["p<i>"]`` is, for an attention
    block, a :class:`KVCache` (a :class:`QuantKVCache` under
    ``env.int8_kv``) with leading dim = repetitions (``k (R, B, C, Kv,
    hd)``; ``pos (R,)``, or ``(R, B)`` with ``per_slot=True`` — the serve
    engine's slotted layout, where every slot tracks its own
    absorbed-token count), and for a recurrent block its state, stacked
    alike (``MLSTMState``, ``SLSTMState``, ``RGLRUState``; no position:
    the state has absorbed every token it was fed). ``Kv`` is
    ``kv_heads``, by default the env's rank-local count; ``tp`` (default
    the env's) sizes the recurrent states' rank-local widths.
    ``context`` (the tokens the caches will absorb, when known) runs
    :func:`check_cache_geometry` on each attention block against its
    window (``window_override`` merged as :func:`apply_block` merges it),
    as the reference's construction does."""
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = kv_heads or env.heads_local(cfg.num_kv_heads)
    tp = tp or env.tp
    groups = []
    for _ in range(cfg.num_groups):
        groups.append({
            f"p{pi}": _stack(_block_cache(kind, cfg, env, batch, capacity, dtype,
                                          per_slot=per_slot, device=device, kv_l=kv_l, tp=tp,
                                          context=context, window_override=window_override),
                             reps)
            for pi, kind in enumerate(cfg.pattern)})
    return groups


def init_paged_caches(cfg: ModelConfig, env: Env, batch: int, num_pages: int,
                      page_size: int, dtype, *, device="cpu", kv_heads: int | None = None,
                      tp: int | None = None):
    """Paged twin of ``init_caches(per_slot=True)``: every "attn" block
    gets a page pool (:func:`~repro_torch.models.attention.init_paged_cache`,
    ``num_pages`` allocatable rows plus the trash row) instead of per-slot
    contiguous arrays, stacked per group (``k (R, P, page, Kv, hd)``,
    ``pos (R, B)``; ``Kv`` as in :func:`init_caches`). Recurrent blocks
    keep their slotted state (O(1) a slot: nothing to page), so an
    attention-free pattern (xLSTM) has no pool at all, as in the
    reference. ``local`` blocks have no paged layout (their rings stay
    contiguous): ``ValueError``, as the reference raises."""
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = kv_heads or env.heads_local(cfg.num_kv_heads)
    tp = tp or env.tp
    groups = []
    for _ in range(cfg.num_groups):
        entry = {}
        for pi, kind in enumerate(cfg.pattern):
            if kind == "attn":
                if cfg.sliding_window:
                    raise ValueError("sliding-window blocks have no paged layout")
                one = init_paged_cache(batch, num_pages, page_size, kv_l, cfg.head_dim,
                                       torch.int8 if env.int8_kv else dtype, device=device)
            elif kind in ("local", "cross"):
                raise ValueError(f"{kind!r} blocks have no paged layout (sliding-window "
                                 "rings and image KV stay contiguous)")
            else:
                one = _block_cache(kind, cfg, env, batch, 1, dtype, per_slot=True,
                                   device=device, kv_l=kv_l, tp=tp)
            entry[f"p{pi}"] = _stack(one, reps)
        groups.append(entry)
    return groups
