"""GQA attention: training, tiled prefill, decode, contiguous, ring and
paged KV caches in fp32 or int8 (counterpart of
``repro.models.attention``, the self-attention part).

Covered: causal GQA with qk-norm and rotary embeddings, ``attend_tiled``
(with the reference's pad of a short kv to a chunk multiple and its
sliding-window mask), the fused flash prefill kernel behind the
reference's ``_flash_prefill_viable`` rule, decode over a contiguous
cache with a scalar (uniform batch) or a ``(B,)`` per-slot position, as a
linear cache or a ring (``window`` set and capacity <= window), the
multi-token verify block of speculative decoding over per-slot linear
caches, one-token and verify-block decode over the block-paged pool
through a page table, and the int8 variants of both layouts
(:class:`QuantKVCache`, :class:`PagedQuantKVCache`: per-(token, head)
fp32 scales, ``_quantize_kv``). Cross-attention raises
``NotImplementedError`` (ROADMAP item 11).

Training (``mode="train"``) runs the prefill's projections, qk-norm and
RoPE with no cache, and always attends through :func:`attend_tiled`,
whose plain PyTorch ops autograd differentiates. The reference's rule
would send a TPU to the flash kernel in train mode too, but that kernel
has no backward (neither the Pallas one nor the port's), so the port
keeps train mode off it on every device; on the CPU the two packages take
the same branch.

Viability of the kernels: where the reference asks for a TPU backend
(``jax.default_backend() == "tpu"``), the port asks for a tensor on a
CUDA device; the rest of each rule is the reference's. Flash prefill:
causal, no window, not cross, a scalar offset, ``hd % 128 == 0``, Sq and
Sk multiples of 128 (a serve prefill attends without a window even when
the engine decodes with one: the reference's ``forward_prefill`` passes
no window down, only its cache geometry sees it). Paged decode
(``attend_decode_paged``): an fp pool, no window, one token; an int8 pool
and the verify block take the dense gather. So on the CPU prefill runs
``attend_tiled`` and paged decode the dense gather, as the reference does
on the CPU, and on the card each kernel runs exactly where the reference
would run its Pallas kernel on its chip.

KV caches are updated in place (the reference returns new arrays): a
prefill or decode step writes its keys and values into the cache's
tensors and advances ``cache.pos`` in place, and returns that cache.
Writes the reference drops (``mode="drop"``: past a linear cache's end)
leave the cache as it was.
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
class QuantKVCache:
    """int8 twin of :class:`KVCache` with per-(slot, position, head) fp32
    scales: ``x ≈ k * k_scale`` row by row (decode reads the whole cache
    every step; int8 moves a quarter of fp32's bytes)."""

    k: torch.Tensor        # (B, C, Kv_local, head_dim) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (B, C, Kv_local) fp32
    v_scale: torch.Tensor
    pos: torch.Tensor      # () or (B,) int32

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    def rep(self, r: int) -> "QuantKVCache":
        """Views of repetition ``r`` of a stacked cache (writes go through)."""
        return QuantKVCache(self.k[r], self.v[r], self.k_scale[r], self.v_scale[r],
                            self.pos[r])


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


@dataclasses.dataclass
class PagedQuantKVCache:
    """int8 twin of :class:`PagedKVCache`: code pools plus per-(page row,
    offset, head) fp32 scale pools."""

    k: torch.Tensor        # (P, page, Kv_local, head_dim) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (P, page, Kv_local) fp32
    v_scale: torch.Tensor
    pos: torch.Tensor      # (B,) int32

    @property
    def page_size(self) -> int:
        return self.k.shape[1]

    def rep(self, r: int) -> "PagedQuantKVCache":
        """Views of repetition ``r`` of a stacked cache (writes go through)."""
        return PagedQuantKVCache(self.k[r], self.v[r], self.k_scale[r], self.v_scale[r],
                                 self.pos[r])


QUANT = (QuantKVCache, PagedQuantKVCache)
PAGED = (PagedKVCache, PagedQuantKVCache)


def _quantize_kv(x):
    """(..., hd) fp -> (int8 codes, (...) fp32 scales), the reference's op
    order: fp32 amax, ``max(amax, 1e-6) / 127``, round half to even, clip
    to ±127."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def check_cache_geometry(capacity: int, window: Optional[int], context: int,
                         *, label: str = ""):
    """Guard against a KV cache that silently drops or evicts live tokens
    (the reference's rule and wording): a cache rings iff ``window`` is set
    and ``capacity <= window``; a linear cache must hold the whole
    ``context``; a ring narrower than the window would evict tokens the
    mask still wants. ``capacity == window`` rings exactly (wrapping is
    the window's eviction)."""
    if context <= capacity:
        return
    ring = window is not None and capacity <= window
    if not ring:
        hint = (
            " (no sliding window)" if window is None else
            f" (window={window} does not ring: capacity "
            f"{capacity} > window — shrink the cache capacity to the "
            "window)"
        )
        raise ValueError(f"{label}context {context} exceeds cache capacity {capacity}{hint}")
    if capacity < window:
        raise ValueError(
            f"{label}context {context} wraps a ring cache of "
            f"{capacity} slots that is smaller than window={window}: "
            "live tokens would be evicted — set the cache capacity == "
            "window"
        )


def init_cache(batch: int, capacity: int, kv_heads: int, head_dim: int, dtype,
               per_slot: bool = False, *, window: Optional[int] = None,
               context: Optional[int] = None, device="cpu"):
    """Zeroed cache: ``dtype=torch.int8`` gives a :class:`QuantKVCache`;
    ``per_slot=True`` a ``(batch,)`` position vector (the serve engine's
    slotted layout). ``context`` (the tokens the cache will absorb, when
    known) runs :func:`check_cache_geometry` against ``window``."""
    if context is not None:
        check_cache_geometry(capacity, window, context)
    pos = torch.zeros((batch,) if per_slot else (), dtype=torch.int32, device=device)
    shape = (batch, capacity, kv_heads, head_dim)
    if dtype == torch.int8:
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:3], dtype=torch.float32, device=device),
            torch.zeros(shape[:3], dtype=torch.float32, device=device),
            pos,
        )
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        pos,
    )


def init_paged_cache(batch: int, num_pages: int, page_size: int, kv_heads: int,
                     head_dim: int, dtype, *, device="cpu"):
    """Zeroed pool + per-slot positions (int8 codes and fp32 scale pools
    for ``dtype=torch.int8``). ``num_pages`` counts *allocatable* pages;
    one extra trash row (index ``num_pages``) is appended for ballast
    writes and unused page-table entries."""
    shape = (num_pages + 1, page_size, kv_heads, head_dim)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if dtype == torch.int8:
        return PagedQuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:3], dtype=torch.float32, device=device),
            torch.zeros(shape[:3], dtype=torch.float32, device=device),
            pos,
        )
    return PagedKVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        pos,
    )


def leaves(cache) -> tuple:
    """The data leaves of a cache node: ``(k, v)``, plus ``(k_scale,
    v_scale)`` for an int8 one."""
    if isinstance(cache, QUANT):
        return cache.k, cache.v, cache.k_scale, cache.v_scale
    return cache.k, cache.v


def _values(cache, k, v) -> tuple:
    """What a write of ``k`` / ``v`` stores, leaf for leaf as
    :func:`leaves`: k and v in the cache's dtype, or their int8 codes and
    scales."""
    if isinstance(cache, QUANT):
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        return kq, vq, ks, vs
    return k.to(cache.k.dtype), v.to(cache.v.dtype)



# ---------------------------------------------------------------------------
# core softmax-attention tiles
# ---------------------------------------------------------------------------


def _attend_tile(q, k, v, mask):
    """Dense tile: q (B,Kv,G,Sq,hd), k/v (B,Sk,Kv,hd), mask (Sq,Sk) or None.
    Returns (scores_max, sumexp, acc) in fp32 for online combination: the
    scores come from exact fp32 copies of bf16 inputs, as the reference's
    ``preferred_element_type=float32`` (no-op casts on fp32 inputs)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bkgqh,bskh->bkgqs", q.to(torch.float32), k.to(torch.float32)) * scale
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


def _decode_mask(cache_pos, C: int, *, ring: bool, window: Optional[int], device):
    """Which cache slots the current token sees: ``(B, 1, 1, C)`` for a
    ``(B,)`` position, ``(1, 1, 1, C)`` for a scalar one. A ring's slot
    ``j`` holds absolute position ``pos - ((pos - j) mod C)``."""
    pos = cache_pos.to(torch.int64) - 1  # absolute position of the current token
    slots = torch.arange(C, device=device)
    if pos.ndim:
        pos = pos[:, None]  # (B, 1)
    slot_pos = pos - torch.remainder(pos - slots, C) if ring else slots
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        valid &= (pos - slot_pos) < window
    valid = valid.reshape(-1, C)
    return valid[:, None, None, :]


def _attend_one(qh, cache, vmask) -> torch.Tensor:
    """One token's attention: ``qh (B, Kv, G, hd)`` over the cache's ``C``
    slots under ``vmask``. int8 codes score against q and take their
    per-slot scales after, as in the reference."""
    scale = qh.shape[-1] ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", qh.to(torch.float32),
                     cache.k.to(torch.float32)) * scale
    quant = isinstance(cache, QuantKVCache)
    if quant:
        s = s * cache.k_scale.permute(0, 2, 1)[:, :, None, :]
    s = torch.where(vmask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * cache.v_scale.permute(0, 2, 1)[:, :, None, :]
    return torch.einsum("bkgs,bskh->bkgh", p, cache.v.to(torch.float32)).to(qh.dtype)


def _attend_decode_multi(q, cache, *, ring: bool, window: Optional[int]):
    """T-token block attention (the speculative verify step) over the
    already updated per-slot linear cache: block token ``j`` sits at
    absolute position ``pos - T + j`` and attends its own prefix, the
    block's earlier tokens included. Each block row runs the one-token
    step's ops at the one-token step's shapes, so a T-block is bitwise the
    T successive single-token steps (slots past a row's position weigh
    exactly 0.0 whatever they hold)."""
    B, T, Kv, G, hd = q.shape
    if ring or window is not None or not cache.pos.ndim:
        raise ValueError(
            "multi-token decode (speculative verify) needs per-slot "
            "linear caches (no ring/window)"
        )
    C = cache.capacity
    rows = []
    for j in range(T):
        vmask = _decode_mask(cache.pos - (T - 1 - j), C, ring=False, window=None,
                             device=q.device)
        rows.append(_attend_one(q[:, j], cache, vmask))
    return torch.stack(rows, dim=1)


def attend_decode(
    q: torch.Tensor,  # (B, T, Kv, G, hd) — T = 1 outside speculative verify
    cache,
    *,
    ring: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Single-token attention over the (already updated) cache, fp
    (:class:`KVCache`) or int8 (:class:`QuantKVCache`), linear or ring
    (slots past the window masked); ``T > 1`` (the speculative verify
    block) goes to :func:`_attend_decode_multi`.

    ``cache.pos`` may be a scalar (uniform batch) or a ``(B,)`` vector
    (per-slot positions from the continuous-batching engine): every slot
    then attends exactly its own prefix."""
    if q.shape[1] > 1:
        return _attend_decode_multi(q, cache, ring=ring, window=window)
    vmask = _decode_mask(cache.pos, cache.capacity, ring=ring, window=window,
                         device=q.device)
    return _attend_one(q[:, 0], cache, vmask)[:, None]


def attend_decode_paged(
    q: torch.Tensor,  # (B, T, Kv, G, hd)
    cache,            # PagedKVCache | PagedQuantKVCache, already updated
    page_table: torch.Tensor,  # (B, n_pages) int32
) -> torch.Tensor:
    """Decode attention over the paged pool.

    Dispatch is the reference's, with "on a TPU" read as "on a CUDA
    device": the page-walking kernel for a CUDA tensor, an fp pool and one
    token; otherwise (an int8 pool, the verify block, the CPU) the dense
    gather, which collects each slot's pages into a contiguous view and
    runs the exact :func:`attend_decode` ops, so positions past ``pos``
    score ``-1e30`` and weigh exactly 0.0: paged streams are then
    bit-identical to the contiguous engine's. (The reference's ``window``
    and ``impl`` arguments have no caller here: paged windows raise in
    :func:`mha`.)"""
    quant = isinstance(cache, PagedQuantKVCache)
    if q.device.type == "cuda" and not quant and q.shape[1] == 1:
        out = paged_attend(q[:, 0].contiguous(), cache.k, cache.v, page_table, cache.pos)
        return out[:, None]
    B = q.shape[0]
    cap = page_table.shape[1] * cache.page_size
    idx = page_table.to(torch.int64)
    gathered = [x[idx].reshape(B, cap, *x.shape[2:]) for x in leaves(cache)]
    dense = QuantKVCache(*gathered, cache.pos) if quant else KVCache(*gathered, cache.pos)
    return attend_decode(q, dense, ring=False, window=None)


def _paged_write(cache, k, v, page_table):
    """Scatter the decoded token block into each slot's pages, in place,
    and advance ``pos``. ``k/v (B, T, Kv, hd)``: T = 1 is the ordinary
    decode step, T = k + 1 the speculative verify block. Logical page
    ``pos // page`` is clamped to the table width: retired-ballast slots
    (table all trash, ``pos`` still advancing) then keep writing into the
    trash page, and under speculative decoding the engine widens the table
    so that a verify block near the end of capacity lands in unallocated
    (trash) entries, never a live page. Ballast rows may hit the same
    trash row in one write; nothing reads it."""
    B, T = page_table.shape[0], k.shape[1]
    page = cache.page_size
    tpos = cache.pos.to(torch.int64)[:, None] + torch.arange(T, device=k.device)  # (B, T)
    pi = torch.clamp(tpos // page, max=page_table.shape[1] - 1)
    phys = torch.gather(page_table.to(torch.int64), 1, pi)
    off = tpos % page
    for leaf, val in zip(leaves(cache), _values(cache, k, v)):
        leaf[phys, off] = val
    cache.pos.add_(T)
    return cache


def _slot_write(cache, k, v, idx):
    """Per-slot write of one token a slot at ``idx (B,)``, in place: a slot
    whose linear cache is full (``idx >= C``, a retired slot decoded as
    ballast, or a verify block's tail) keeps what it holds, as the
    reference's ``mode="drop"`` scatter."""
    C = cache.capacity
    bi = torch.arange(k.shape[0], device=k.device)
    idx_c = torch.clamp(idx, max=C - 1)
    keep = idx < C
    for leaf, val in zip(leaves(cache), _values(cache, k, v)):
        mask = keep.reshape(-1, *([1] * (val.ndim - 1)))
        leaf[bi, idx_c] = torch.where(mask, val, leaf[bi, idx_c])


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
    mode: str = "prefill",  # train | prefill | decode
    cache=None,
    window: Optional[int] = None,
    kv_ext=None,
    is_cross: bool = False,
    pos_offset=0,
    page_table=None,
):
    """One attention layer. Returns (out (B,S,d), cache) — the cache is
    updated in place (see the module docstring); train mode takes and
    returns no cache."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mha mode={mode!r} (train, prefill, decode)")
    if is_cross or kv_ext is not None:
        raise NotImplementedError("cross-attention is not ported (ROADMAP item 11)")
    paged = isinstance(cache, PAGED)
    if mode == "train" and cache is not None:
        raise ValueError("train mode takes no KV cache")
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
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported (ROADMAP item 11)")
    if cache is None and mode != "train":
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

    if mode == "train":  # no backward kernel: never the flash branch
        out = attend_tiled(
            qg, k, v, causal=cfg.causal, window=window, q_offset=0,  # q and k: one sequence
            chunk=min(env.attn_chunk, S), causal_skip=env.causal_skip,
        )
    elif paged:
        _paged_write(cache, k, v, page_table)
        out = attend_decode_paged(qg, cache, page_table)
    elif mode == "decode":
        C = cache.capacity
        ring = window is not None and C <= window
        per_slot = cache.pos.ndim > 0
        if S != 1 and (not per_slot or window is not None):
            raise ValueError(
                f"multi-token decode (S={S}) needs per-slot linear "
                "caches (no ring/window)"
            )
        pos = cache.pos.to(torch.int64)
        idx = torch.remainder(pos, C) if ring else pos
        if per_slot:
            # per-request write positions (continuous batching), block
            # token j of a verify block at pos + j; writes past a linear
            # cache's end (retired ballast slots, block tails past the stop
            # position, both never attended) are dropped, as in the reference
            for j in range(S):
                _slot_write(cache, k[:, j], v[:, j], idx + j)
        else:
            # dynamic_update_slice semantics: the start index is clamped
            idx = torch.clamp(idx, 0, C - 1).reshape(1)
            for leaf, val in zip(leaves(cache), _values(cache, k, v)):
                leaf.index_copy_(1, idx, val)
        cache.pos.add_(S)
        out = attend_decode(qg, cache, ring=ring, window=window)
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
        # C < S keeps the trailing C tokens, ROLLED so that absolute
        # position p sits at slot p % C: the layout of the ring decode's
        # mask and of its write index pos % C
        if C >= S:
            for leaf, val in zip(leaves(cache), _values(cache, k, v)):
                leaf[:, :S] = val
        else:
            for leaf, val in zip(leaves(cache), _values(cache, k[:, S - C:], v[:, S - C:])):
                leaf.copy_(torch.roll(val, S % C, dims=1))
        cache.pos.fill_(S)

    out = out.reshape(B, S, Hq_l * hd)
    y = out @ w["wo"]
    return env.exit(y), cache
