"""Flash prefill attention, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.flash_prefill.flash_prefill``: causal
online-softmax GQA attention with ``q_offset``, fp32 running max, sum and
accumulator, masked scores ``-1e30``, output ``acc / max(l, 1e-30)`` in
q's dtype, for fp32 or bf16 q, k and v (all of one type; bf16 inputs are
taken as their exact fp32 values). Two kernels walk one kind of work list,
which :func:`flash_work` builds on the host: each item 64 query rows of
``Gc`` heads sharing a kv head and a range of their unmasked 64-key tiles;
a long unit's tiles are cut into pieces whose partials the unit's last
piece to finish merges in a fixed order. ``csrc/flash_prefill.cu`` takes
fp32, in fp32 FMAs on the CUDA cores; ``csrc/flash_prefill_bf16.cu`` takes
bf16, its two products on the bf16 tensor cores (``wgmma``, p · v as three
bf16 terms of each fp32 p, every product exact). On a CPU tensor the
wrapper runs the plain version ``ref.flash_prefill_ref``; on a CUDA tensor
it launches the kernel or raises.

With ``return_lse`` (the training forward, fp32 only) the call also
returns each row's log-sum-exp ``(B, H, Sq)``, which the backward
(``kernels.flash_attn_bwd``) recomputes the probabilities from; without
it the fp32 kernel gets a null pointer and gives the same bits as before
the option existed.

``flash_prefill.launches`` counts launches of the fp32 kernel (serving and
training), ``flash_prefill.launches_bf16`` launches of the bf16 one (never
plain-version calls).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library, workspace

HEAD_DIM = 128  # the one head width the kernel takes (the viability rule's)
TILE = 64       # Sq and Sk must be multiples of this
UNIT_ROWS = 64  # query rows a work item holds: 64 / Gc positions x Gc heads
KEY_TILE = 64   # keys the kernel takes a step
# CTAs resident at once on an H100: 132 SMs x 2 (the kernel's occupancy).
# A constant, so that the work list, and with it the bits of the result,
# depend on one sequence's shape alone (not on the card, nor on the batch).
SLOTS = 264
# The bf16 kernel's: one CTA an SM, whose two warpgroups take the first and
# the second half of an item's tiles and merge in shared memory, and a merge
# of pieces costs about two tiles; so it cuts pieces only where a batch
# row's units would leave most of the card idle, and never below a tile for
# each warpgroup
SLOTS_BF16 = 48
MIN_TILES_BF16 = 2


def flash_work(B: int, H: int, Kv: int, Sq: int, Sk: int, q_offset: int,
               slots: int = SLOTS, min_tiles: int = 1):
    """The kernel's work list, a pure function of the shapes.

    A unit is 64 query rows: ``Gc = gcd(H / Kv, 4)`` heads of one kv head
    at ``64 / Gc`` positions each; unit ``u`` is ``((b * H / Gc + hg) *
    nqb + qb)`` with ``nqb = Sq / (64 / Gc)``. Its unmasked keys are the
    first ``min(Sk, q_offset + (qb + 1) * 64 / Gc)``, in ``n`` 64-key tiles.
    A unit whose ``n`` exceeds ``kmax = max(min_tiles, ceil(tiles of one
    batch row / slots))`` (the tiles of its ``H / Gc`` head groups; no ``B``
    in it) is
    cut into ``ceil(n / kmax)`` near-equal pieces of consecutive tiles,
    each with its own partial slot. So a row's items, pieces and merge
    order are the same alone or in any batch, and its bits do not depend
    on the other rows. Returns ``(Gc, items, merges, n_parts)``:
    ``items`` are ``(unit, first tile, end tile, slot, merge)``, longest
    first, with slot and merge -1 for a unit of one piece; ``merges`` are
    ``(first slot, pieces)``, a split unit's slots being consecutive."""
    Gc = math.gcd(H // Kv, 4)
    bq = UNIT_ROWS // Gc
    nqb, groups = Sq // bq, B * (H // Gc)
    need = [-(-min(Sk, q_offset + (qb + 1) * bq) // KEY_TILE) for qb in range(nqb)]
    kmax = max(min_tiles, -(-sum(need) * (H // Gc) // slots))
    items, merges, n_parts = [], [], 0
    for unit in range(groups * nqb):
        n = need[unit % nqb]
        pieces = max(1, -(-n // kmax))
        if pieces == 1:
            items.append((unit, 0, n, -1, -1))
            continue
        items += [(unit, n * p // pieces, n * (p + 1) // pieces, n_parts + p, len(merges))
                  for p in range(pieces)]
        merges.append((n_parts, pieces))
        n_parts += pieces
    items.sort(key=lambda it: it[1] - it[2])  # longest first; stable
    return Gc, items, merges, n_parts


@functools.lru_cache(maxsize=64)
def _device_work(B, H, Kv, Sq, Sk, q_offset, bf16, device):
    """:func:`flash_work` packed as the kernel (fp32, or ``bf16``) reads it,
    int32 ``(n, 4)`` tensors on ``device``, built once per shape (the copy
    to the card is the only host-device traffic)."""
    tiling = (SLOTS_BF16, MIN_TILES_BF16) if bf16 else (SLOTS, 1)
    Gc, items, merges, n_parts = flash_work(B, H, Kv, Sq, Sk, q_offset, *tiling)
    packed = [(u, lo | hi << 16, slot, merge) for u, lo, hi, slot, merge in items]
    as_dev = lambda rows: torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device)
    return Gc, as_dev(packed), as_dev([(a, n, 0, 0) for a, n in merges]), n_parts


def flash_prefill(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, Kv, Sk, hd)
    v: torch.Tensor,
    *,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Fused causal flash prefill attention; returns ``(B, H, Sq, hd)``, or
    with ``return_lse`` ``(out, lse)``, ``lse (B, H, Sq)`` fp32 (natural
    log). The reference's ``causal=False`` is not taken: no path asks for
    it."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"need q (B,H,Sq,hd), k/v (B,Kv,Sk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kv:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)}")
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if q.device.type == "cpu":
        return ref.flash_prefill_ref(q, k, v, q_offset=int(q_offset), return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"flash_prefill kernel takes q/k/v all float32 or all bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if return_lse and q.dtype != torch.float32:
        raise ValueError(f"the log-sum-exp comes from the fp32 kernel; got {q.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"flash_prefill kernel takes head_dim {HEAD_DIM}, got {hd}")
    if Sq % TILE or Sk % TILE:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of {TILE}")
    if Sk // KEY_TILE >= 1 << 16:  # a work item packs its tile range in 16 bits each
        raise ValueError(f"Sk={Sk} must be below {KEY_TILE << 16}")
    if not all(t.is_contiguous() and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs contiguous q/k/v on one device")
    # loads and stores are 16 B (fp32) or 8 B (bf16): a view at an odd
    # storage offset would fault on the card, so refuse it here
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs q/k/v 16-byte aligned")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    bf16 = q.dtype == torch.bfloat16
    if Sq:
        Gc, items, merges, n_parts = _device_work(B, H, Kv, Sq, Sk, int(q_offset), bf16,
                                                  q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters = workspace("flash_prefill.counters", q.device, stream, merges.shape[0],
                             torch.int32)
        # partials: acc (n_parts, 64, 128), then m and l (n_parts, 2, 64)
        scratch = workspace("flash_prefill.partials", q.device, stream,
                            n_parts * UNIT_ROWS * (hd + 2), torch.float32)
        lib = library()
        # the fp32 entry point takes the log-sum-exp's pointer (or null) after out
        fn, ptrs = ((lib.repro_flash_prefill_bf16, ()) if bf16 else
                    (lib.repro_flash_prefill, (None if lse is None else lse.data_ptr(),)))
        with torch.cuda.device(q.device):
            rc = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs,
                items.data_ptr(), items.shape[0], merges.data_ptr(), counters.data_ptr(),
                scratch.data_ptr(), scratch.data_ptr() + 4 * n_parts * UNIT_ROWS * hd,
                B, H, Kv, Gc, Sq, Sk, int(q_offset), hd ** -0.5, stream,
            )
        check_launch(rc, "flash_prefill")
        if bf16:
            flash_prefill.launches_bf16 += 1
        else:
            flash_prefill.launches += 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0
flash_prefill.launches_bf16 = 0
