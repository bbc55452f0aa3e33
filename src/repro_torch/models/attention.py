"""GQA attention for serving: tiled prefill, one-token decode, contiguous
KV caches (counterpart of ``repro.models.attention``, the serving part).

Covered: causal GQA with qk-norm and rotary embeddings, ``attend_tiled``
(with the reference's pad of a short kv to a chunk multiple), the fused
flash prefill kernel behind the reference's ``_flash_prefill_viable``
rule, decode over a contiguous :class:`KVCache` with a scalar (uniform
batch) or a ``(B,)`` per-slot position, and one-token decode over the
block-paged pool :class:`PagedKVCache` through a page table. int8 KV
(contiguous or paged), cross-attention, sliding windows / ring caches,
the multi-token verify block (contiguous or paged) and the training mode
raise ``NotImplementedError``.

Viability of the kernels: where the reference asks for a TPU backend
(``jax.default_backend() == "tpu"``), the port asks for a tensor on a
CUDA device; the rest of each rule is the reference's. Flash prefill:
causal, no window, not cross, a scalar offset, ``hd % 128 == 0``, Sq and
Sk multiples of 128. Paged decode (``attend_decode_paged``): an fp pool,
no window, one token. So on the CPU prefill runs ``attend_tiled`` and
paged decode the dense gather, as the reference does on the CPU, and on
the card each kernel runs exactly where the reference would run its
Pallas kernel on its chip.

KV caches are updated in place (the reference returns new arrays): a
prefill or decode step writes its keys and values into the cache's
tensors and advances ``cache.pos`` in place, and returns that cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.paged_attend import paged_attend
from repro_torch.models.env import Env
from repro_torch.models.layers import apply_rope, head_rms_norm

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    """Uniform-length KV cache. ``pos`` = number of tokens already absorbed:
    a scalar (uniform batch) or ``(B,)`` (the serve engine's slots).

    Capacity ``C = k.shape[1]``. Stacked per layer group, the leaves carry
    a leading repetition dim (``k (R, B, C, Kv, hd)``, ``pos (R,)`` or
    ``(R, B)``); :meth:`rep` gives one repetition's views."""

    k: torch.Tensor  # (B, C, Kv_local, head_dim)
    v: torch.Tensor
    pos: torch.Tensor  # () or (B,) int32

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    def rep(self, r: int) -> "KVCache":
        """Views of repetition ``r`` of a stacked cache (writes go through)."""
        return KVCache(self.k[r], self.v[r], self.pos[r])


@dataclasses.dataclass
class PagedKVCache:
    """Block-paged KV cache: one page *pool* shared by every slot instead
    of per-slot contiguous arrays. Which pool rows a slot owns is the
    host's page table (``(B, n_pages)`` int32, staged into each decode step
    as ``batch["page_table"]``; scheduler state, not cache state). The last
    pool row is the **trash page**: retired slots' ballast writes and
    unused table entries point there, so resident bytes track the tokens
    written, not ``max_slots * capacity``.

    ``pos`` is the per-slot absorbed-token count, as in the slotted
    :class:`KVCache`. Stacked per layer group, the leaves carry a leading
    repetition dim (``k (R, P, page, Kv, hd)``, ``pos (R, B)``)."""

    k: torch.Tensor    # (P, page, Kv_local, head_dim) — row P-1 is trash
    v: torch.Tensor
    pos: torch.Tensor  # (B,) int32

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    def rep(self, r: int) -> "PagedKVCache":
        """Views of repetition ``r`` of a stacked cache (writes go through)."""
        return PagedKVCache(self.k[r], self.v[r], self.pos[r])


def check_cache_geometry(capacity: int, context: int, *, label: str = ""):
    """Guard against a KV cache that would drop live tokens: without a
    sliding window (the only caches ported) a linear cache must hold the
    whole context, as the reference's rule asks."""
    if context > capacity:
        raise ValueError(
            f"{label}context {context} exceeds cache capacity {capacity} "
            "(no sliding window)"
        )


def init_cache(batch: int, capacity: int, kv_heads: int, head_dim: int, dtype,
               per_slot: bool = False, *, device="cpu"):
    """Zeroed cache; ``per_slot=True`` gives it a ``(batch,)`` position
    vector (the serve engine's slotted layout)."""
    if dtype == torch.int8:
        raise NotImplementedError("int8 KV (QuantKVCache) is not ported")
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device)
    shape = (batch, capacity, kv_heads, head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        pos,
    )


def init_paged_cache(batch: int, num_pages: int, page_size: int, kv_heads: int,
                     head_dim: int, dtype, *, device="cpu"):
    """Zeroed pool + per-slot positions. ``num_pages`` counts *allocatable*
    pages; one extra trash row (index ``num_pages``) is appended for
    ballast writes and unused page-table entries."""
    if dtype == torch.int8:
        raise NotImplementedError("int8 paged KV (PagedQuantKVCache) is not ported")
    shape = (num_pages + 1, page_size, kv_heads, head_dim)
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# core softmax-attention tiles
# ---------------------------------------------------------------------------


def _attend_tile(q, k, v, mask):
    """Dense tile: q (B,Kv,G,Sq,hd), k/v (B,Sk,Kv,hd), mask (Sq,Sk) or None.
    Returns (scores_max, sumexp, acc) in fp32 for online combination."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bkgqh,bskh->bkgqs", q, k).to(torch.float32) * scale
    if mask is not None:
        s = torch.where(mask[None, None, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskh->bkgqh", p, v.to(torch.float32))
    return m, l, acc


def _combine(m1, l1, a1, m2, l2, a2):
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def attend_tiled(
    q: torch.Tensor,  # (B, Sq, Kv, G, hd)
    k: torch.Tensor,  # (B, Sk, Kv, hd)
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    q_offset: int = 0,
    chunk: int = 1024,
    causal_skip: bool = True,
) -> torch.Tensor:
    """Flash-style tiled attention; returns (B, Sq, Kv, G, hd).

    ``q_offset``: absolute position of q[0] relative to k[0]. q chunks run
    over exact kv ranges (unless ``causal_skip=False``). A short kv
    (``Sk % chunk != 0``) is padded up to a chunk multiple and its tail
    masked, as in the reference."""
    B, Sq, Kv, G, hd = q.shape
    Sk = k.shape[1]
    cq = min(chunk, Sq)
    if Sq % cq:
        raise ValueError(f"Sq={Sq} not divisible by chunk={cq}")
    sk_pad = ((Sk + cq - 1) // cq) * cq if Sk else 0
    if sk_pad != Sk:
        pad = torch.zeros((B, sk_pad - Sk, *k.shape[2:]), dtype=k.dtype, device=k.device)
        k = torch.cat([k, pad], dim=1)
        v = torch.cat([v, pad.to(v.dtype)], dim=1)
    dev = q.device
    outs = []
    for i in range(Sq // cq):
        q_i = q[:, i * cq:(i + 1) * cq].permute(0, 2, 3, 1, 4)  # B,Kv,G,cq,hd
        q_pos_lo = q_offset + i * cq
        k_hi = min(Sk, q_pos_lo + cq) if (causal and causal_skip) else Sk
        k_lo = 0
        if window is not None and causal_skip:
            k_lo = max(0, q_pos_lo - window + 1)
        k_lo = (k_lo // cq) * cq
        k_hi = min(sk_pad, ((k_hi + cq - 1) // cq) * cq)
        nk = (k_hi - k_lo) // cq if k_hi > k_lo else 0
        if nk == 0:
            outs.append(torch.zeros((B, cq, Kv, G, hd), dtype=q.dtype, device=dev))
            continue
        q_pos = q_pos_lo + torch.arange(cq, device=dev)
        m = torch.full((B, Kv, G, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kv, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kv, G, cq, hd), dtype=torch.float32, device=dev)
        for j in range(nk):
            lo = k_lo + j * cq
            k_pos = lo + torch.arange(cq, device=dev)
            mask = torch.ones((cq, cq), dtype=torch.bool, device=dev)
            if sk_pad != Sk:
                mask &= k_pos[None, :] < Sk
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            m2, l2, a2 = _attend_tile(q_i, k[:, lo:lo + cq], v[:, lo:lo + cq], mask)
            m, l, acc = _combine(m, l, acc, m2, l2, a2)
        out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))  # B,cq,Kv,G,hd
    return torch.cat(outs, dim=1)


def attend_decode(
    q: torch.Tensor,  # (B, T, Kv, G, hd) — T = 1
    cache: KVCache,
    *,
    ring: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Single-token attention over the (already updated) linear cache.

    ``cache.pos`` may be a scalar (uniform batch) or a ``(B,)`` vector
    (per-slot positions from the continuous-batching engine): every slot
    then attends exactly its own prefix. Ring caches, windows and the
    ``T > 1`` verify block are not ported."""
    B, T, Kv, G, hd = q.shape
    if T > 1:
        raise NotImplementedError("multi-token decode (speculative verify) is not ported")
    if ring or window is not None:
        raise NotImplementedError("sliding-window / ring decode is not ported")
    C = cache.capacity
    pos = cache.pos - 1  # absolute position of the current token
    slots = torch.arange(C, device=q.device)
    if pos.ndim:
        valid = slots[None, :] <= pos[:, None].to(torch.int64)  # (B, C)
        vmask = valid[:, None, None, :]
    else:
        vmask = (slots <= pos.to(torch.int64))[None, None, None, :]
    scale = hd ** -0.5
    qh = q[:, 0]  # B,Kv,G,hd
    s = torch.einsum("bkgh,bskh->bkgs", qh, cache.k).to(torch.float32) * scale
    s = torch.where(vmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, cache.v.to(torch.float32)).to(q.dtype)
    return out[:, None]


def attend_decode_paged(
    q: torch.Tensor,  # (B, 1, Kv, G, hd)
    cache: PagedKVCache,  # already updated
    page_table: torch.Tensor,  # (B, n_pages) int32
) -> torch.Tensor:
    """Single-token attention over the paged pool.

    Dispatch is the reference's, with "on a TPU" read as "on a CUDA
    device": the page-walking kernel for a CUDA tensor, an fp pool and one
    token; otherwise the dense gather, which collects each slot's pages
    into a contiguous view and runs the exact :func:`attend_decode` ops, so
    positions past ``pos`` score ``-1e30`` and weigh exactly 0.0: paged
    streams are then bit-identical to the contiguous engine's. (The
    reference's ``window`` and ``impl`` arguments have no caller here:
    paged windows raise in :func:`mha`.)"""
    if q.device.type == "cuda" and cache.k.dtype.is_floating_point and q.shape[1] == 1:
        out = paged_attend(q[:, 0].contiguous(), cache.k, cache.v, page_table, cache.pos)
        return out[:, None]
    B = q.shape[0]
    cap = page_table.shape[1] * cache.page_size
    idx = page_table.to(torch.int64)
    gk = cache.k[idx].reshape(B, cap, *cache.k.shape[2:])
    gv = cache.v[idx].reshape(B, cap, *cache.v.shape[2:])
    return attend_decode(q, KVCache(gk, gv, cache.pos), ring=False, window=None)


def _paged_write(cache: PagedKVCache, k, v, page_table) -> PagedKVCache:
    """Scatter the decoded token into each slot's page, in place, and
    advance ``pos``. ``k/v (B, T, Kv, hd)``; only ``T = 1`` (the ordinary
    decode step) is ported. Logical page ``pos // page`` is clamped to the
    table width: retired-ballast slots (table all trash, ``pos`` still
    advancing) then keep writing into the trash page."""
    if k.shape[1] != 1:
        raise NotImplementedError(
            f"the paged write of a {k.shape[1]}-token block (speculative verify) "
            "is not ported"
        )
    B = page_table.shape[0]
    page = cache.page_size
    pos = cache.pos.to(torch.int64)  # tokens absorbed BEFORE this one
    pi = torch.clamp(pos // page, max=page_table.shape[1] - 1)
    phys = page_table[torch.arange(B, device=pos.device), pi].to(torch.int64)
    off = pos % page
    cache.k[phys, off] = k[:, 0].to(cache.k.dtype)
    cache.v[phys, off] = v[:, 0].to(cache.v.dtype)
    cache.pos.add_(1)
    return cache


def _flash_prefill_viable(causal, window, is_cross, pos_offset, qg, k):
    """The fused kernel serves the plain causal prefill shape on the card;
    everything else (CPU runs, windows, cross, per-slot offsets, untiled
    lengths) keeps ``attend_tiled`` — the reference's rule with "on a
    TPU" read as "on a CUDA device"."""
    if qg.device.type != "cuda":
        return False
    if not causal or window is not None or is_cross:
        return False
    if torch.is_tensor(pos_offset) and pos_offset.ndim:
        return False
    B, Sq, Kv, G, hd = qg.shape
    Sk = k.shape[1]
    if hd % 128:
        return False
    return Sq % 128 == 0 and Sk % 128 == 0


def _flash_prefill_call(qg, k, v, *, q_offset):
    """(B,S,Kv,G,hd) q / (B,Sk,Kv,hd) kv -> the kernel's layouts and back:
    q head ``h = kv * G + g``."""
    B, Sq, Kv, G, hd = qg.shape
    qf = qg.permute(0, 2, 3, 1, 4).reshape(B, Kv * G, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).contiguous()
    vf = v.permute(0, 2, 1, 3).contiguous()
    out = flash_prefill(qf, kf, vf, q_offset=q_offset)
    return out.reshape(B, Kv, G, Sq, hd).permute(0, 3, 1, 2, 4)


# ---------------------------------------------------------------------------
# full attention layer (projections + rope + cache plumbing)
# ---------------------------------------------------------------------------


def _positions(pos_offset, length: int, device) -> torch.Tensor:
    """``pos_offset + arange(length)``: ``(S,)`` for a scalar offset,
    ``(B, S)`` for per-slot offsets."""
    ar = torch.arange(length, device=device)
    if torch.is_tensor(pos_offset):
        off = pos_offset.to(device=device, dtype=torch.int64)
        return off[:, None] + ar if off.ndim else off + ar
    return int(pos_offset) + ar


def mha(
    x: torch.Tensor,  # (B, S, d)
    w: dict,
    cfg,
    env: Env,
    *,
    mode: str = "prefill",  # prefill | decode
    cache: Optional[KVCache] = None,
    window: Optional[int] = None,
    kv_ext=None,
    is_cross: bool = False,
    pos_offset=0,
    page_table=None,
):
    """One attention layer. Returns (out (B,S,d), cache) — the cache is
    updated in place (see the module docstring)."""
    if mode not in ("prefill", "decode"):
        raise NotImplementedError(f"mha mode={mode!r} is not ported (prefill, decode)")
    if is_cross or kv_ext is not None:
        raise NotImplementedError("cross-attention is not ported")
    paged = isinstance(cache, PagedKVCache)
    if paged and mode != "decode":
        raise ValueError(
            "paged caches are decode-only: prefill runs on contiguous "
            "caches and the serve engine scatters them into pages"
        )
    if paged and page_table is None:
        raise ValueError(
            "paged decode needs a page_table (S=1 ordinary decode, "
            "S=k+1 the speculative verify block)"
        )
    if paged and window is not None:
        raise ValueError(
            "paged KV keeps the full context: sliding-window decode "
            "stays on the contiguous ring layout"
        )
    if window is not None:
        raise NotImplementedError("sliding-window attention is not ported")
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported")
    if cache is None:
        raise ValueError(f"{mode} needs a pre-allocated KV cache")
    hd = cfg.head_dim
    Hq_l = w["wq"].shape[1] // hd
    Kv_l = w["wk"].shape[1] // hd
    G = Hq_l // Kv_l

    xin = env.enter(x)
    B, S, _ = xin.shape
    q = (xin @ w["wq"]).reshape(B, S, Hq_l, hd)
    k = (xin @ w["wk"]).reshape(B, S, Kv_l, hd)
    v = (xin @ w["wv"]).reshape(B, S, Kv_l, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, w["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, w["k_norm"], cfg.norm_eps)
    positions = _positions(pos_offset, S, xin.device)
    q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    qg = q.reshape(B, S, Kv_l, G, hd)

    if paged:
        _paged_write(cache, k, v, page_table)
        out = attend_decode_paged(qg, cache, page_table)
    elif mode == "decode":
        C = cache.capacity
        per_slot = cache.pos.ndim > 0
        if S != 1:
            raise NotImplementedError(
                f"multi-token decode (S={S}, speculative verify) is not ported"
            )
        kn, vn = k[:, 0].to(cache.k.dtype), v[:, 0].to(cache.v.dtype)
        if per_slot:
            # per-request write positions (continuous batching); a slot
            # whose linear cache is full (a retired slot decoded as
            # ballast) keeps its last row, as the reference's mode="drop"
            bi = torch.arange(B, device=xin.device)
            idx = cache.pos.to(torch.int64)
            idx_c = torch.clamp(idx, max=C - 1)
            keep = (idx < C)[:, None, None]
            cache.k[bi, idx_c] = torch.where(keep, kn, cache.k[bi, idx_c])
            cache.v[bi, idx_c] = torch.where(keep, vn, cache.v[bi, idx_c])
        else:
            # dynamic_update_slice semantics: the start index is clamped
            idx = torch.clamp(cache.pos.to(torch.int64), 0, C - 1).reshape(1)
            cache.k.index_copy_(1, idx, kn[:, None])
            cache.v.index_copy_(1, idx, vn[:, None])
        cache.pos.add_(1)
        out = attend_decode(qg, cache, ring=False, window=None)
    else:
        C = cache.capacity
        causal = cfg.causal
        q_off = int(pos_offset) if isinstance(pos_offset, int) else 0
        if _flash_prefill_viable(causal, window, False, pos_offset, qg, k):
            out = _flash_prefill_call(qg, k, v, q_offset=q_off)
        else:
            out = attend_tiled(
                qg, k, v, causal=causal, window=window, q_offset=q_off,
                chunk=min(env.attn_chunk, S), causal_skip=env.causal_skip,
            )
        if C < S:
            raise NotImplementedError(
                f"prefill of {S} tokens into a {C}-slot cache needs the ring "
                "layout (sliding windows), which is not ported"
            )
        cache.k[:, :S] = k.to(cache.k.dtype)
        cache.v[:, :S] = v.to(cache.v.dtype)
        cache.pos.fill_(S)

    out = out.reshape(B, S, Hq_l * hd)
    y = out @ w["wo"]
    return env.exit(y), cache
