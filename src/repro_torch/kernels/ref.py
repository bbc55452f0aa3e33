"""Plain PyTorch versions of the ADT transfer kernels (counterpart of
``repro.kernels.ref``).

An IEEE-754 fp32 weight is viewed as a 32-bit word and only its most
significant ``round_to`` bytes are kept, as a struct-of-arrays of byte
planes: plane ``k`` holds byte ``k`` (MSB first) of every weight. This is
the wire format, so these functions are the bar every kernel is held to
(byte-equal planes, bit-equal unpack).

PyTorch has no uint32 shift or add on the CPU, so the word is handled as
an int32 view: ``(u >> s) & 0xFF`` is the same byte whether the shift is
arithmetic or logical. Rebuilding goes through int64 and wraps back to
int32 before the bitcast to fp32; nearest rounding's saturating bump
needs the int64 range too.

Rounding modes:
  * ``truncate``   — the paper's mode: drop the low bytes.
  * ``nearest``    — add half an ULP of the kept format first (saturating).
  * ``stochastic`` — not ported yet (needs ``jax.random.randint``'s bits).
"""
from __future__ import annotations

import torch

VALID_ROUND_TO = (1, 2, 3, 4)

_SHIFTS = (24, 16, 8, 0)  # MSB-first byte shifts within a 32-bit word
_U32 = 0xFFFFFFFF


def _as_i32(w: torch.Tensor) -> torch.Tensor:
    if w.dtype != torch.float32:
        raise ValueError(f"bitpack expects float32, got {w.dtype}")
    return w.view(torch.int32)


def _wrap_i32(u64: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> the int32 with the same bits."""
    return torch.where(u64 >= 2**31, u64 - 2**32, u64).to(torch.int32)


def _round_bits(u: torch.Tensor, round_to: int, mode: str, key=None) -> torch.Tensor:
    """Apply rounding to the (int32-viewed) word before truncation."""
    drop = 8 * (4 - round_to)
    if drop == 0 or mode == "truncate":
        return u
    if mode == "nearest":
        # add half of the dropped range; saturate at 0xFFFFFFFF so the
        # word never wraps (same as the reference's `bumped < u` check)
        bumped = (u.to(torch.int64) & _U32) + (1 << (drop - 1))
        return _wrap_i32(torch.clamp(bumped, max=_U32))
    if mode == "stochastic":
        raise NotImplementedError(
            "stochastic rounding is not ported yet (needs a bit-exact "
            "jax.random.randint)"
        )
    raise ValueError(f"unknown rounding mode {mode!r}")


def bitpack_ref(
    w: torch.Tensor, round_to: int, *, mode: str = "truncate", key=None
) -> torch.Tensor:
    """fp32 tensor -> uint8 byte planes, shape ``(round_to, *w.shape)``.

    Plane 0 is the most significant byte (sign + 7 exponent bits).
    """
    if round_to not in VALID_ROUND_TO:
        raise ValueError(f"round_to must be in {VALID_ROUND_TO}")
    u = _round_bits(_as_i32(w), round_to, mode, key)
    planes = [
        ((u >> _SHIFTS[k]) & 0xFF).to(torch.uint8) for k in range(round_to)
    ]
    return torch.stack(planes, dim=0)


def bitunpack_ref(planes: torch.Tensor) -> torch.Tensor:
    """uint8 byte planes ``(round_to, ...)`` -> fp32 (low bytes zero-filled)."""
    if planes.dtype != torch.uint8:
        raise ValueError(f"bitunpack expects uint8 planes, got {planes.dtype}")
    round_to = planes.shape[0]
    if round_to not in VALID_ROUND_TO:
        raise ValueError(f"leading plane dim must be in {VALID_ROUND_TO}")
    u = torch.zeros(planes.shape[1:], dtype=torch.int64, device=planes.device)
    for k in range(round_to):
        u = u | (planes[k].to(torch.int64) << _SHIFTS[k])
    return _wrap_i32(u).view(torch.float32)


def quantize_ref(
    w: torch.Tensor, round_to: int, *, mode: str = "truncate", key=None
) -> torch.Tensor:
    """pack∘unpack — the value actually seen by the compute side."""
    return bitunpack_ref(bitpack_ref(w, round_to, mode=mode, key=key))



# ---------------------------------------------------------------------------
# flash prefill attention
# ---------------------------------------------------------------------------

NEG_INF = -1e30  # masked score: exp() underflows to exactly 0.0
FLASH_BLOCK_Q = 128
FLASH_BLOCK_K = 128


def _resolve_blocks(Sq: int, Sk: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(
            f"Sq={Sq}/Sk={Sk} must divide into blocks ({block_q}, {block_k})"
        )
    return block_q, block_k


def flash_prefill_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    block_q: int = FLASH_BLOCK_Q,
    block_k: int = FLASH_BLOCK_K,
) -> torch.Tensor:
    """Plain version of the causal flash prefill kernel (counterpart of
    ``repro.kernels.flash_prefill.flash_prefill_ref`` at ``causal=True``,
    the kernel's one mask): the reference's
    tile schedule (128 x 128 tiles, every k-block) and its tile update
    ``_flash_tile``, batched over (b, h).

    ``q (B, H, Sq, hd)``, ``k/v (B, Kv, Sk, hd)``, ``G = H // Kv`` query
    heads per kv head (head ``h`` reads kv head ``h // G``); ``q_offset``
    is the absolute position of ``q[..., 0, :]`` relative to ``k[..., 0,
    :]``. Scores and the running ``(m, l, acc)`` are fp32; the output is
    ``acc / max(l, 1e-30)`` in q's dtype.
    """
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if H % Kv:
        raise ValueError(f"H={H} not a multiple of Kv={Kv}")
    G = H // Kv
    block_q, block_k = _resolve_blocks(Sq, Sk, block_q, block_k)
    kh = k.repeat_interleave(G, dim=1)
    vh = v.repeat_interleave(G, dim=1).to(torch.float32)
    scale = hd ** -0.5
    dev = q.device
    out = torch.empty_like(q)
    for i in range(Sq // block_q):
        qb = q[:, :, i * block_q:(i + 1) * block_q]
        q_pos = q_offset + i * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, block_q, hd), dtype=torch.float32, device=dev)
        for j in range(Sk // block_k):
            kb = kh[:, :, j * block_k:(j + 1) * block_k]
            vb = vh[:, :, j * block_k:(j + 1) * block_k]
            s = torch.matmul(qb, kb.transpose(-1, -2)).to(torch.float32) * scale
            k_pos = j * block_k + torch.arange(block_k, device=dev)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vb)
            m = m_new
        out[:, :, i * block_q:(i + 1) * block_q] = (
            acc / torch.clamp(l, min=1e-30)[..., None]
        ).to(q.dtype)
    return out


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def paged_attend_ref(
    q: torch.Tensor,           # (B, Kv, G, hd)
    k_pool: torch.Tensor,      # (P, page, Kv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pages) int32 pool rows
    lengths: torch.Tensor,     # (B,) int32 live tokens per slot
) -> torch.Tensor:
    """Plain version of the paged decode kernel (counterpart of
    ``repro.kernels.paged_attention.paged_attend_ref``): the reference's
    walk over every logical page ``j`` in order, through its page update
    ``_page_update`` and mask ``_page_valid``, batched over the rows.

    Page ``j`` of row ``b`` is pool row ``page_table[b, j]``; its rows at
    ``j * page + offset >= lengths[b]`` score ``-1e30``. Scores are
    ``(q . k) * hd^-0.5`` in fp32 with the running ``(m, l, acc)``; the
    output is ``acc / max(l, 1e-30)`` in q's dtype. Every page is walked,
    so a row of length 0 (all masked) gets the mean of V over its
    ``n_pages * page`` table rows, as in the reference.
    """
    B, Kv, G, hd = q.shape
    page = k_pool.shape[1]
    n_pages = page_table.shape[1]
    scale = hd ** -0.5
    dev = q.device
    offs = torch.arange(page, device=dev)
    m = torch.full((B, Kv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Kv, G, hd), dtype=torch.float32, device=dev)
    table = page_table.to(torch.int64)
    for j in range(n_pages):
        pid = table[:, j]
        k_pg, v_pg = k_pool[pid], v_pool[pid]  # (B, page, Kv, hd)
        valid = (j * page + offs)[None, :] < lengths.to(torch.int64)[:, None]  # (B, page)
        s = torch.einsum("bkgh,bpkh->bkgp", q, k_pg).to(torch.float32) * scale
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgp,bpkh->bkgh", p, v_pg.to(torch.float32)
        )
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
