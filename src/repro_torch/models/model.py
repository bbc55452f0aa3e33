"""Model assembly for serving: embedding -> layer groups -> head
(counterpart of ``repro.models.model``, the ``attn`` pattern).

Every forward routes through :func:`run_group`, whose loop over a group's
layer repetitions materializes each layer's weights through the caller's
``mat_fn`` (the ADT pack∘unpack of every ``DIST`` leaf, or the resident
weights under weight-stationary serving) just before that layer runs, so
only one layer's materialized weights are alive at a time. The
reference scans the repetitions; PyTorch runs them as a Python loop.

Caches are stacked per group (leading repetition dim) and updated in
place; the returned caches are the same tensors. The serve engine's
paged layout (:func:`init_paged_caches`) gives every attention block a
page pool instead, read through the ``page_table`` a decode step carries.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (
    KVCache,
    PagedKVCache,
    check_cache_geometry,
    init_cache,
    init_paged_cache,
    mha,
)
from repro_torch.models.env import Env
from repro_torch.models.layers import embed_lookup_vp, rms_norm
from repro_torch.models.mlp import swiglu


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
    pos_offset=0,
    page_table=None,
):
    """One block of the pattern. Returns (x', cache'); the reference's
    third value, the MoE auxiliary loss, has no counterpart here."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported (attn only)")
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window attention is not ported")
    wa = w["attn"]
    xn = rms_norm(x, wa["ln"], cfg.norm_eps)
    y, cache = mha(xn, wa, cfg, env, mode=mode, cache=cache, pos_offset=pos_offset,
                   page_table=page_table)
    x = x + y
    return x + _channel_mix(x, w, cfg, env), cache


def run_group(
    x: torch.Tensor,
    group_params: dict,      # {p<i>: stacked (R, ...) param trees}
    cfg: ModelConfig,
    env: Env,
    *,
    mode: str,
    mat_fn: Callable[[str, dict], dict],  # (pattern key, rep storage) -> weights
    caches: Any = None,      # {p<i>: stacked KVCache | PagedKVCache} or None
    pos_offset=0,
    page_table=None,         # (B, n_pages) int32 — paged decode only
):
    """Run the group's pattern repetitions. Returns (x, caches')."""
    for rep in range(cfg.layers_per_group // len(cfg.pattern)):
        for pi, kind in enumerate(cfg.pattern):
            key = f"p{pi}"
            w = mat_fn(key, _index(group_params[key], rep))
            c_in = caches[key].rep(rep) if caches is not None else None
            x, _ = apply_block(
                kind, x, w, cfg, env, mode=mode, cache=c_in, pos_offset=pos_offset,
                page_table=page_table,
            )
            del w  # one layer's materialized weights alive at a time
    return x, caches


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# end-to-end forwards
# ---------------------------------------------------------------------------


def _embed(params, batch, cfg: ModelConfig, env: Env, mat_top):
    table = mat_top("embed")  # (V, d)
    return embed_lookup_vp(batch["tokens"], table, 0, env)


def _logits(x, params, cfg: ModelConfig, env: Env, mat_top):
    """Final norm + logits entry (vocab-sharded in the reference at tp > 1)."""
    x = rms_norm(x, mat_top("final_norm"), cfg.norm_eps)
    if cfg.tie_embeddings:
        return env.enter(x) @ mat_top("embed").T
    return env.enter(x) @ mat_top("head")


def forward_prefill(params, batch, cfg, env, *, mat_group, mat_top,
                    cache_capacity):
    """Prefill: returns (last-token logits (B, 1, V), caches per group).

    ``batch["last"]`` (an int or a 0-d integer tensor, optional) marks the
    last *real* token when the prompt is right-padded to a page-bucket
    length: the logits are read there instead of at ``S - 1``. Padding is
    causal-safe for pure-attention patterns, the only ones ported."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    B, S = x.shape[:2]
    check_cache_geometry(cache_capacity, S)
    caches = init_caches(cfg, env, B, cache_capacity, env.dtype, device=x.device)
    for g, gp in enumerate(params["groups"]):
        x, _ = run_group(
            x, gp, cfg, env, mode="prefill",
            mat_fn=functools.partial(mat_group, g), caches=caches[g],
        )
    if "last" in batch:
        last = torch.as_tensor(batch["last"], device=x.device).reshape(1)
        x_last = x.index_select(1, last.to(torch.int64))
    else:
        x_last = x[:, -1:]
    logits = _logits(x_last, params, cfg, env, mat_top)
    return logits, caches


def forward_decode(params, batch, caches, cfg, env, *, mat_group, mat_top):
    """One-token decode step. ``batch["tokens"]`` (B, 1); ``batch["pos"]``
    is a scalar (uniform batch) or ``(B,)`` (per-slot); the paged engine's
    batches also carry ``batch["page_table"]`` (B, n_pages). Returns
    (logits (B, 1, V), caches') — the caches are updated in place."""
    x = _embed(params, batch, cfg, env, mat_top).to(env.dtype)
    pos = batch["pos"]
    page_table = batch.get("page_table")
    for g, gp in enumerate(params["groups"]):
        x, _ = run_group(
            x, gp, cfg, env, mode="decode",
            mat_fn=functools.partial(mat_group, g), caches=caches[g],
            pos_offset=pos, page_table=page_table,
        )
    return _logits(x, params, cfg, env, mat_top), caches


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, env: Env, batch: int, capacity: int, dtype,
                per_slot: bool = False, *, device="cpu"):
    """Stacked caches per group: ``groups[g]["p0"]`` is a :class:`KVCache`
    with leading dim = repetitions (``k (R, B, C, Kv, hd)``; ``pos (R,)``,
    or ``(R, B)`` with ``per_slot=True`` — the serve engine's slotted
    layout, where every slot tracks its own absorbed-token count)."""
    if cfg.sliding_window:
        raise NotImplementedError("sliding-window caches are not ported")
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = env.heads_local(cfg.num_kv_heads)
    groups = []
    for _ in range(cfg.num_groups):
        entry = {}
        for pi, kind in enumerate(cfg.pattern):
            if kind != "attn":
                raise NotImplementedError(f"block kind {kind!r} is not ported")
            one = init_cache(batch, capacity, kv_l, cfg.head_dim, dtype,
                             per_slot=per_slot, device=device)
            entry[f"p{pi}"] = KVCache(*(
                t.expand(reps, *t.shape).clone() for t in (one.k, one.v, one.pos)
            ))
        groups.append(entry)
    return groups


def init_paged_caches(cfg: ModelConfig, env: Env, batch: int, num_pages: int,
                      page_size: int, dtype, *, device="cpu"):
    """Paged twin of ``init_caches(per_slot=True)``: every "attn" block
    gets a page pool (:func:`~repro_torch.models.attention.init_paged_cache`,
    ``num_pages`` allocatable rows plus the trash row) instead of per-slot
    contiguous arrays, stacked per group (``k (R, P, page, Kv, hd)``,
    ``pos (R, B)``). The reference's recurrent kinds keep their slotted
    state there; the port has only "attn" blocks."""
    if cfg.sliding_window:
        raise ValueError("sliding-window blocks have no paged layout")
    reps = cfg.layers_per_group // len(cfg.pattern)
    kv_l = env.heads_local(cfg.num_kv_heads)
    groups = []
    for _ in range(cfg.num_groups):
        entry = {}
        for pi, kind in enumerate(cfg.pattern):
            if kind != "attn":
                raise NotImplementedError(f"block kind {kind!r} is not ported")
            one = init_paged_cache(batch, num_pages, page_size, kv_l, cfg.head_dim,
                                   dtype, device=device)
            entry[f"p{pi}"] = PagedKVCache(*(
                t.expand(reps, *t.shape).clone() for t in (one.k, one.v, one.pos)
            ))
        groups.append(entry)
    return groups
