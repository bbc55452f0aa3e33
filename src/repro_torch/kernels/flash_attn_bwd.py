"""Flash attention's backward, by CUDA kernels on the card, and the
differentiable causal attention that training takes through it.

Replaces no function of the JAX package (its flash kernel has no
backward; its training attends through ``attend_tiled``).
:func:`flash_attention` is a ``torch.autograd.Function``: its forward is
``flash_prefill``'s fp32 kernel, which also writes each row's
log-sum-exp; its backward, :func:`flash_attn_bwd`, is
``csrc/flash_attn_bwd.cu``: a pre-pass for ``D = rowsum(dO o O)``, one
kernel that recomputes ``P`` tile by tile from the log-sum-exp and sums
dK and dV of a 64-key tile over every query row and head that sees it,
and a pass that sums each q-block's dQ contributions in a fixed order (no
float atomics: two calls give the same bits). The host builds the main
kernel's work list (:func:`bwd_work`). On a CPU tensor both directions
run their plain versions (``ref.flash_prefill_ref``,
``ref.flash_attn_bwd_ref``); on a CUDA tensor the kernels run or the call
raises.

``flash_attn_bwd.launches`` counts calls of the backward on the card (each
launches the three kernels), never plain-version calls.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library, workspace
from repro_torch.kernels.flash_prefill import HEAD_DIM, KEY_TILE, TILE, flash_prefill

Q_ROWS = 64  # query rows a step of the main kernel
# CTAs resident at once: the main kernel runs one an SM on the H100's 132.
# A constant, so that the work list, and with it the bits of the result,
# depend on the shapes alone
SLOTS = 132


def bwd_work(B: int, H: int, Kv: int, Sq: int, Sk: int, q_offset: int, slots: int = SLOTS):
    """The main kernel's work list, a pure function of the shapes.

    A unit is one 64-key tile ``j`` of one kv head of one batch row: unit
    ``(b * Kv + kv) * (Sk / 64) + j``. Its steps are the ``(query head,
    64-row q-block)`` pairs that see the tile: the ``G = H / Kv`` heads of
    the kv head, one after another, each over the q-blocks ``imin(j) ..
    Sq / 64 - 1`` (``imin``: the first whose last row, at ``q_offset + 64 i
    + 63``, reaches key ``64 j``). A unit of more than ``kmax = ceil(steps
    of one batch row / slots)`` steps is cut into ``ceil(n / kmax)``
    near-equal pieces of consecutive steps, each with its own partial slot
    of dK and dV. Returns ``(items, merges, n_parts, qoff)``: ``items`` are
    ``(unit, first step, end step, slot, merge)``, longest first, slot and
    merge -1 for a unit of one piece; ``merges`` are ``(first slot,
    pieces)``; ``qoff[i]`` is the first of q-block ``i``'s dQ slots, one a
    kv tile ``0 .. jmax(i)``, and ``qoff[Sq / 64]`` the slots of one ``(b,
    h)``."""
    G = H // Kv
    nqb, nkt = Sq // Q_ROWS, Sk // KEY_TILE

    def imin(j):
        first = KEY_TILE * j - q_offset - (Q_ROWS - 1)
        return -(-first // Q_ROWS) if first > 0 else 0

    steps = [G * max(0, nqb - imin(j)) for j in range(nkt)]
    kmax = max(1, -(-sum(steps) * Kv // slots))
    items, merges, n_parts = [], [], 0
    for unit in range(B * Kv * nkt):
        n = steps[unit % nkt]
        pieces = max(1, -(-n // kmax))
        if pieces == 1:
            items.append((unit, 0, n, -1, -1))
            continue
        items += [(unit, n * p // pieces, n * (p + 1) // pieces, n_parts + p, len(merges))
                  for p in range(pieces)]
        merges.append((n_parts, pieces))
        n_parts += pieces
    items.sort(key=lambda it: it[1] - it[2])  # longest first; stable
    qoff = [0]
    for i in range(nqb):
        qoff.append(qoff[-1] + min(nkt - 1, (q_offset + Q_ROWS * i + Q_ROWS - 1) // KEY_TILE) + 1)
    return items, merges, n_parts, qoff


@functools.lru_cache(maxsize=64)
def _device_work(B, H, Kv, Sq, Sk, q_offset, device):
    """:func:`bwd_work` as the kernel reads it: int32 tensors on ``device``,
    built once per shape, and the dQ slots of one ``(b, h)``."""
    items, merges, n_parts, qoff = bwd_work(B, H, Kv, Sq, Sk, q_offset)
    packed = [(u, lo | hi << 16, slot, merge) for u, lo, hi, slot, merge in items]
    def as_dev(rows):
        return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device)

    return (as_dev(packed), as_dev([(a, n, 0, 0) for a, n in merges]), n_parts,
            torch.tensor(qoff, dtype=torch.int32, device=device), qoff[-1])


def flash_attn_bwd(q, k, v, out, lse, dout, *, q_offset: int = 0):
    """Gradients ``(dq, dk, dv)`` of causal flash attention (``q (B, H, Sq,
    hd)``, ``k / v (B, Kv, Sk, hd)``) from its output ``out``, its
    log-sum-exp ``lse (B, H, Sq)`` and the output's gradient ``dout``."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or out.shape != q.shape or \
            dout.shape != q.shape:
        raise ValueError(f"need q/out/dout (B,H,Sq,hd), k/v (B,Kv,Sk,hd); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)}")
    B, H, Sq, hd = q.shape
    Kv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kv or lse.shape != (B, H, Sq):
        raise ValueError(f"q {tuple(q.shape)} does not match k/v {tuple(k.shape)} "
                         f"or lse {tuple(lse.shape)}")
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if q.device.type == "cpu":
        return ref.flash_attn_bwd_ref(q, k, v, out, lse, dout, q_offset=int(q_offset))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attn_bwd runs on cuda or cpu, got {q.device}")
    ts = (q, k, v, out, lse, dout)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"flash_attn_bwd kernel takes float32, got "
                         f"{[str(t.dtype) for t in ts]}")
    if hd != HEAD_DIM:
        raise ValueError(f"flash_attn_bwd kernel takes head_dim {HEAD_DIM}, got {hd}")
    if Sq % TILE or Sk % TILE:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of {TILE}")
    if H // Kv * (Sq // Q_ROWS) >= 1 << 16:  # a work item packs its step range in 16 bits each
        raise ValueError(f"H / Kv * Sq / {Q_ROWS} must be below {1 << 16}")
    if not all(t.is_contiguous() and t.device == q.device for t in ts):
        raise ValueError("flash_attn_bwd kernel needs contiguous tensors on one device")
    if any(t.data_ptr() % 16 for t in ts):  # 16 B loads
        raise ValueError("flash_attn_bwd kernel needs 16-byte aligned tensors")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq:
        items, merges, n_parts, qoff, slots = _device_work(B, H, Kv, Sq, Sk, int(q_offset),
                                                           q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tile = Q_ROWS * hd
        delta = workspace("flash_attn_bwd.delta", q.device, stream, B * H * Sq, torch.float32)
        dq_part = workspace("flash_attn_bwd.dq_part", q.device, stream,
                            B * H * slots * tile, torch.float32)
        kv_part = workspace("flash_attn_bwd.kv_part", q.device, stream, n_parts * 2 * tile,
                            torch.float32)
        counters = workspace("flash_attn_bwd.counters", q.device, stream, merges.shape[0],
                             torch.int32)
        with torch.cuda.device(q.device):
            rc = library().repro_flash_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                dq_part.data_ptr(), qoff.data_ptr(), items.data_ptr(), items.shape[0],
                merges.data_ptr(), counters.data_ptr(), kv_part.data_ptr(),
                B, H, Kv, Sq, Sk, int(q_offset), hd ** -0.5, stream,
            )
        check_launch(rc, "flash_attn_bwd")
        flash_attn_bwd.launches += 1
    return dq, dk, dv


flash_attn_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Causal attention whose forward is the flash kernel with its
    log-sum-exp and whose backward is :func:`flash_attn_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_prefill(q, k, v, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        return flash_attn_bwd(*ctx.saved_tensors, dout.contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable causal GQA attention of one sequence (``q (B, H, S,
    hd)``, ``k / v (B, Kv, S, hd)``, fp32, contiguous): ``(B, H, S, hd)``."""
    return _FlashAttention.apply(q, k, v)
