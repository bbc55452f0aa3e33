"""Paged decode attention, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.paged_attention.paged_attend``: one decode
token per slot attends over its KV pages, read from the pools through the
page table; online softmax across pages with an fp32 running max, sum and
accumulator, rows at or past ``lengths[b]`` scored ``-1e30``, output
``acc / max(l, 1e-30)``. The kernel is ``csrc/paged_attend.cu``, split
over pages (flash-decoding): one CTA per (slot, kv head, split of
contiguous logical pages) writes a partial ``(m, l, acc)``, and the last
split of a (slot, kv head) to finish merges the partials in split order;
fp32 FMAs on the CUDA cores. :func:`paged_splits` picks the splits on the
host from the shapes and the SM count; the partials and the zeroed merge
counters live in a per-stream ``workspace``.
On a CPU tensor the wrapper runs the plain version ``ref.paged_attend_ref``;
on a CUDA tensor it launches the kernel or raises.

Every table entry the slot's live pages use must be a pool row (the
engine points unused entries at its trash row); the kernel writes NaN for
a slot whose walk meets an entry outside ``[0, P)``.

``paged_attend.launches`` counts kernel launches (never plain-version
calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library, workspace

HEAD_DIM = 128  # the one head width the kernel takes (as the flash kernel)
MAX_G = 16      # query heads per kv head the kernel holds
MAX_PAGE = 128  # rows per page the kernel takes
CTAS_PER_SM = 2  # the split kernel's occupancy (shared memory: 107 KB a CTA)


def paged_splits(B: int, Kv: int, n_pages: int, sm_count: int) -> tuple[int, int]:
    """``(n_splits, pages_per_split)`` of the split over pages: as many
    splits as one wave of ``CTAS_PER_SM`` CTAs an SM holds over the ``B *
    Kv * n_splits`` grid (a second, partial wave would double the time), at
    most one split a page. Split ``s`` takes logical pages ``[s * pps, (s +
    1) * pps)``; every split holds at least one page of the table."""
    want = CTAS_PER_SM * sm_count // max(B * Kv, 1)
    pps = -(-n_pages // max(1, min(n_pages, want)))
    return -(-n_pages // pps), pps


def paged_attend(
    q: torch.Tensor,           # (B, Kv, G, hd) — one decode step of queries
    k_pool: torch.Tensor,      # (P, page, Kv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pages) int32 pool rows
    lengths: torch.Tensor,     # (B,) int32 live tokens per slot
) -> torch.Tensor:
    """Paged decode attention; returns ``(B, Kv, G, hd)``."""
    if q.ndim != 4 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"need q (B,Kv,G,hd), pools (P,page,Kv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    B, Kv, G, hd = q.shape
    P, page = k_pool.shape[0], k_pool.shape[1]
    if k_pool.shape[2:] != (Kv, hd):
        raise ValueError(f"q {tuple(q.shape)} does not match pools {tuple(k_pool.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"need page_table (B, n_pages) and lengths (B,) for B={B}; got "
                         f"{tuple(page_table.shape)}, {tuple(lengths.shape)}")
    if q.device.type == "cpu":
        return ref.paged_attend_ref(q, k_pool, v_pool, page_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attend runs on cuda or cpu, got {q.device}")
    if any(t.dtype != torch.float32 for t in (q, k_pool, v_pool)):
        raise ValueError(f"paged_attend kernel takes float32 only, got "
                         f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"page_table and lengths must be int32, got "
                         f"{page_table.dtype}/{lengths.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"paged_attend kernel takes head_dim {HEAD_DIM}, got {hd}")
    if not 1 <= page <= MAX_PAGE:
        raise ValueError(f"page_size must be in 1..{MAX_PAGE}, got {page}")
    if not 1 <= G <= MAX_G:
        raise ValueError(f"paged_attend kernel takes 1..{MAX_G} query heads per kv "
                         f"head, got {G}")
    if page_table.shape[1] < 1:
        raise ValueError("page_table needs at least one page per slot")
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if not all(t.is_contiguous() and t.device == q.device for t in tensors):
        raise ValueError("paged_attend kernel needs contiguous inputs on one device")
    # q and the pools are read as float4s: a view at an odd storage offset
    # would fault on the card, so refuse it here
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attend kernel needs q and the pools 16-byte aligned")
    out = torch.empty_like(q)
    if B:
        n_pages = page_table.shape[1]
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        n_splits, pps = paged_splits(B, Kv, n_pages, sms)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = workspace("paged_attend.counters", q.device, stream, B * Kv, torch.int32)
        parts = B * Kv * n_splits * G if n_splits > 1 else 0
        # partials: acc (parts, 128), then m and l (parts each)
        scratch = workspace("paged_attend.partials", q.device, stream, parts * (hd + 2),
                            torch.float32)
        with torch.cuda.device(q.device):
            rc = library().repro_paged_attend(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * parts * hd, counters.data_ptr(),
                B, Kv, G, P, page, n_pages, n_splits, pps, hd ** -0.5, stream,
            )
        check_launch(rc, "paged_attend")
        paged_attend.launches += 1
    return out


paged_attend.launches = 0
