"""Paged decode attention, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.paged_attention.paged_attend``: one decode
token per slot attends over its KV pages, read from the pools through the
page table; online softmax across pages with an fp32 running max, sum and
accumulator, rows at or past ``lengths[b]`` scored ``-1e30``, output
``acc / max(l, 1e-30)`` in q's dtype, for fp32 or bf16 q and pools (all
of one type; bf16 inputs are taken as their exact fp32 values). The
kernel is ``csrc/paged_attend.cu``, split
over pages (flash-decoding): one CTA per (slot, kv head, split of
contiguous logical pages) writes a partial ``(m, l, acc)``, and the last
split of a (slot, kv head) to finish merges the partials in split order;
fp32 FMAs on the CUDA cores. :func:`paged_splits` cuts the splits at fixed
logical row ranges, from the page size alone, so a slot's partials and
their merge order are the same whatever the batch, the table width or the
card. A page of more than 128 rows is walked in 32-row chunks of its pool
row like any other. The partials and the zeroed merge counters live in a
per-stream ``workspace``.
On a CPU tensor the wrapper runs the plain version ``ref.paged_attend_ref``;
on a CUDA tensor it launches the kernel or raises.

Every table entry the slot's live pages use must be a pool row (the
engine points unused entries at its trash row); the kernel writes NaN for
a slot whose walk meets an entry outside ``[0, P)``.

``paged_attend.launches`` counts launches of the fp32 kernel,
``paged_attend.launches_bf16`` of the bf16 one (never plain-version
calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library, workspace

HEAD_DIM = 128  # the one head width the kernel takes (as the flash kernel)
MAX_G = 16      # query heads per kv head the kernel holds
# logical rows a split covers (at least one page): split s takes pages
# [s * pps, (s + 1) * pps) with pps = max(1, SPLIT_ROWS // page)
SPLIT_ROWS = 64


def paged_splits(n_pages: int, page: int) -> tuple[int, int]:
    """``(n_splits, pages_per_split)`` of the split over pages, from the
    table width and the page size alone. Split ``s`` takes logical pages
    ``[s * pps, (s + 1) * pps)`` with ``pps = max(1, SPLIT_ROWS // page)``;
    every split holds at least one page of the table. A slot's live pages
    fall in the same splits whatever the batch, the table width (splits
    past its length are empty and weigh 0 in the merge) or the card."""
    pps = max(1, SPLIT_ROWS // page)
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
    if q.dtype not in (torch.float32, torch.bfloat16) or k_pool.dtype != q.dtype or \
            v_pool.dtype != q.dtype:
        raise ValueError(f"paged_attend kernel takes q and the pools all float32 or all "
                         f"bfloat16, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError(f"page_table and lengths must be int32, got "
                         f"{page_table.dtype}/{lengths.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"paged_attend kernel takes head_dim {HEAD_DIM}, got {hd}")
    if page < 1 or page * page_table.shape[1] >= 1 << 31:
        raise ValueError(f"page_size must be >= 1 with page * n_pages < 2**31, got page "
                         f"{page} and {page_table.shape[1]} pages")
    if not 1 <= G <= MAX_G:
        raise ValueError(f"paged_attend kernel takes 1..{MAX_G} query heads per kv "
                         f"head, got {G}")
    if page_table.shape[1] < 1:
        raise ValueError("page_table needs at least one page per slot")
    tensors = (q, k_pool, v_pool, page_table, lengths)
    if not all(t.is_contiguous() and t.device == q.device for t in tensors):
        raise ValueError("paged_attend kernel needs contiguous inputs on one device")
    # q and the pools are read 16 B at a time: a view at an odd storage
    # offset would fault on the card, so refuse it here
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attend kernel needs q and the pools 16-byte aligned")
    out = torch.empty_like(q)
    if B:
        n_pages = page_table.shape[1]
        n_splits, pps = paged_splits(n_pages, page)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = workspace("paged_attend.counters", q.device, stream, B * Kv, torch.int32)
        parts = B * Kv * n_splits * G if n_splits > 1 else 0
        # partials: acc (parts, 128), then m and l (parts each)
        scratch = workspace("paged_attend.partials", q.device, stream, parts * (hd + 2),
                            torch.float32)
        bf16 = q.dtype == torch.bfloat16
        lib = library()
        fn = lib.repro_paged_attend_bf16 if bf16 else lib.repro_paged_attend
        with torch.cuda.device(q.device):
            rc = fn(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * parts * hd, counters.data_ptr(),
                B, Kv, G, P, page, n_pages, n_splits, pps, hd ** -0.5, stream,
            )
        check_launch(rc, "paged_attend")
        if bf16:
            paged_attend.launches_bf16 += 1
        else:
            paged_attend.launches += 1
    return out


paged_attend.launches = 0
paged_attend.launches_bf16 = 0
