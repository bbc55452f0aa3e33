"""Model assembly: embedding -> layer groups -> head / loss (counterpart
of ``repro.models.model``, the ``attn`` pattern). Under tensor
parallelism (``env.model_group``) every weight a function sees is the
rank's TP slice: heads, ``d_ff`` and the vocabulary are split over the
model group, and ``env``'s boundaries carry the collectives. Prefill and
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
them int8 with fp32 scales. The serve engine's paged layout
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
from repro_torch.models.attention import (
    check_cache_geometry,
    init_cache,
    init_paged_cache,
    mha,
)
from repro_torch.models.env import Env
from repro_torch.models.layers import embed_lookup_vp, rms_norm
from repro_torch.models.loss import lm_loss
from repro_torch.models.mlp import swiglu


def _window(cfg: ModelConfig, window_override):
    """The attention window: the config's ``sliding_window`` merged with
    an override, as the reference's ``apply_block`` merges them."""
    window = cfg.sliding_window or None
    if window_override is not None:
        window = window_override if window is None else min(window, window_override)
    return window


def _channel_mix(x, w, cfg: ModelConfig, env: Env):
    """Post-attention channel mixer (SwiGLU; none when ``d_ff == 0``)."""
    if "mix" not in w:
        return torch.zeros_like(x)
    wm = w["mix"]
    return swiglu(rms_norm(x, wm["ln"], cfg.norm_eps), wm, env)


def apply_block(
    kind: str,
    x: torch.Tensor,
    w: dict,
    cfg: ModelConfig,
    env: Env,
    *,
    mode: str,
    cache: Any = None,
    window_override=None,
    pos_offset=0,
    page_table=None,
):
    """One block of the pattern. Returns (x', cache'); the reference's
    third value, the MoE auxiliary loss, has no counterpart here."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported (attn only; ROADMAP "
                                  "item 11)")
    window = _window(cfg, window_override)
    wa = w["attn"]
    xn = rms_norm(x, wa["ln"], cfg.norm_eps)
    y, cache = mha(xn, wa, cfg, env, mode=mode, cache=cache, window=window,
                   pos_offset=pos_offset, page_table=page_table)
    x = x + y
    return x + _channel_mix(x, w, cfg, env), cache


def run_group(
    x: torch.Tensor,
    group_params: dict,      # {p<i>: stacked (R, ...) param trees}
    cfg: ModelConfig,
    env: Env,
    *,
    mode: str,
    mat_fn: Callable[..., dict],  # (pattern key, rep storage, rep=) -> weights
    caches: Any = None,      # {p<i>: stacked cache nodes} or None
    window_override=None,
    pos_offset=0,
    page_table=None,         # (B, n_pages) int32 — paged decode only
):
    """Run the group's pattern repetitions. Returns (x, caches').
    ``mat_fn(key, storage, rep=rep)`` materializes a repetition's weights
    (``rep`` names the layer's stochastic-rounding site).

    ``group_params`` leaves are stacked ``(R, ...)`` tensors, or lists of
    ``R`` per-repetition tensors (the train step's leaves, so that each
    repetition's gradient is its own tensor)."""

    def body(x, rep):
        for pi, kind in enumerate(cfg.pattern):
            key = f"p{pi}"
            w = mat_fn(key, _index(group_params[key], rep), rep=rep)
            c_in = caches[key].rep(rep) if caches is not None else None
            x, _ = apply_block(
                kind, x, w, cfg, env, mode=mode, cache=c_in,
                window_override=window_override, pos_offset=pos_offset,
                page_table=page_table,
            )
            del w  # one layer's materialized weights alive at a time
        return x

    remat = cfg.remat and mode == "train"
    for rep in range(cfg.layers_per_group // len(cfg.pattern)):
        if remat:
            # early stop pinned: the recomputation ends once the backward has
            # every tensor it saved, so a layer's last TP-region exit (whose
            # output nothing in the layer reads) is not run again
            with set_checkpoint_early_stop(True):
                x = checkpoint(body, x, rep, use_reentrant=False)
        else:
            x = body(x, rep)
    return x, caches


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# end-to-end forwards
# ---------------------------------------------------------------------------


def _embed(params, batch, cfg: ModelConfig, env: Env, mat_top):
    """Vocab-parallel token embedding in the env's activation layout:
    each model rank looks up its vocabulary slice, and ``env.exit`` sums
    the rows over the model group (under ``seq_parallel`` a
    reduce-scatter onto this rank's sequence shard)."""
    table = mat_top("embed")  # (V / tp, d)
    vocab_start = env.model_rank() * table.shape[0]
    return embed_lookup_vp(batch["tokens"], table, vocab_start, env)


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
    divides by the token count (``aux``, the reference's MoE loss, is 0 for
    the dense model)."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    for g, gp in enumerate(params["groups"]):
        x, _ = run_group(x, gp, cfg, env, mode="train",
                         mat_fn=functools.partial(mat_group, g))
    logits = _logits(x, params, cfg, env, mat_top)
    vocab_start = env.model_rank() * logits.shape[-1]
    nll_sum, count = lm_loss(logits, batch["labels"], env, vocab_start, cfg.vocab_size)
    return nll_sum, {"nll_sum": nll_sum, "token_count": count, "aux": 0.0}


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
    causal-safe for pure-attention patterns, the only ones ported."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    B, S = x.shape[:2]
    check_cache_geometry(cache_capacity, _window(cfg, window_override), S)
    caches = init_caches(cfg, env, B, cache_capacity, env.dtype, device=x.device)
    for g, gp in enumerate(params["groups"]):
        x, _ = run_group(
            x, gp, cfg, env, mode="prefill",
            mat_fn=functools.partial(mat_group, g), caches=caches[g],
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
        x, _ = run_group(
            x, gp, cfg, env, mode="decode",
            mat_fn=functools.partial(mat_group, g), caches=caches[g],
            window_override=window_override, pos_offset=pos, page_table=page_table,
        )
    return _logits(x, params, cfg, env, mat_top), caches


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def _stack(one, reps: int):
    """A cache node with every leaf repeated ``reps`` times along a new
    leading dim (fresh storage)."""
    return type(one)(*(t.expand(reps, *t.shape).clone() for t in (
        getattr(one, f.name) for f in dataclasses.fields(one))))


def init_caches(cfg: ModelConfig, env: Env, batch: int, capacity: int, dtype,
                per_slot: bool = False, *, device="cpu", kv_heads: int | None = None):
    """Stacked caches per group: ``groups[g]["p0"]`` is a :class:`KVCache`
    (a :class:`QuantKVCache` under ``env.int8_kv``) with leading dim =
    repetitions (``k (R, B, C, Kv, hd)``; ``pos (R,)``, or ``(R, B)`` with
    ``per_slot=True`` — the serve engine's slotted layout, where every
    slot tracks its own absorbed-token count). ``Kv`` is ``kv_heads``, by
    default the env's rank-local count."""
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = kv_heads or env.heads_local(cfg.num_kv_heads)
    groups = []
    for _ in range(cfg.num_groups):
        entry = {}
        for pi, kind in enumerate(cfg.pattern):
            if kind != "attn":
                raise NotImplementedError(f"block kind {kind!r} is not ported (ROADMAP item 11)")
            one = init_cache(batch, capacity, kv_l, cfg.head_dim,
                             torch.int8 if env.int8_kv else dtype,
                             per_slot=per_slot, device=device)
            entry[f"p{pi}"] = _stack(one, reps)
        groups.append(entry)
    return groups


def init_paged_caches(cfg: ModelConfig, env: Env, batch: int, num_pages: int,
                      page_size: int, dtype, *, device="cpu", kv_heads: int | None = None):
    """Paged twin of ``init_caches(per_slot=True)``: every "attn" block
    gets a page pool (:func:`~repro_torch.models.attention.init_paged_cache`,
    ``num_pages`` allocatable rows plus the trash row) instead of per-slot
    contiguous arrays, stacked per group (``k (R, P, page, Kv, hd)``,
    ``pos (R, B)``; ``Kv`` as in :func:`init_caches`). The reference's
    recurrent kinds keep their slotted state there; the port has only
    "attn" blocks."""
    if cfg.sliding_window:
        raise ValueError("sliding-window blocks have no paged layout")
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = kv_heads or env.heads_local(cfg.num_kv_heads)
    groups = []
    for _ in range(cfg.num_groups):
        entry = {}
        for pi, kind in enumerate(cfg.pattern):
            if kind != "attn":
                raise NotImplementedError(f"block kind {kind!r} is not ported (ROADMAP item 11)")
            one = init_paged_cache(batch, num_pages, page_size, kv_l, cfg.head_dim,
                                   torch.int8 if env.int8_kv else dtype, device=device)
            entry[f"p{pi}"] = _stack(one, reps)
        groups.append(entry)
    return groups
