"""Flash prefill attention, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.flash_prefill.flash_prefill``: causal
online-softmax GQA attention with ``q_offset``, fp32 running max, sum and
accumulator, masked scores ``-1e30``, output ``acc / max(l, 1e-30)``. The
kernel is ``csrc/flash_prefill.cu`` (fp32 FMAs on the CUDA cores, k/v
streamed through shared memory in 64-row tiles, k-blocks above the
diagonal skipped). On a CPU tensor the wrapper runs the plain version
``ref.flash_prefill_ref``; on a CUDA tensor it launches the kernel or
raises.

``flash_prefill.launches`` counts kernel launches (never plain-version
calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library

HEAD_DIM = 128  # the one head width the kernel takes (the viability rule's)
TILE = 64       # the kernel's q and k tile rows


def flash_prefill(
    q: torch.Tensor,  # (B, H, Sq, hd)
    k: torch.Tensor,  # (B, Kv, Sk, hd)
    v: torch.Tensor,
    *,
    q_offset: int = 0,
) -> torch.Tensor:
    """Fused causal flash prefill attention; returns ``(B, H, Sq, hd)``.
    The reference's ``causal=False`` is not taken: no path asks for it."""
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
        return ref.flash_prefill_ref(q, k, v, q_offset=int(q_offset))
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cuda or cpu, got {q.device}")
    if any(t.dtype != torch.float32 for t in (q, k, v)):
        raise ValueError(f"flash_prefill kernel takes float32 only, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"flash_prefill kernel takes head_dim {HEAD_DIM}, got {hd}")
    if Sq % TILE or Sk % TILE:
        raise ValueError(f"Sq={Sq} and Sk={Sk} must be multiples of {TILE}")
    if not all(t.is_contiguous() and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs contiguous q/k/v on one device")
    # every load and store is a float4: a view at an odd storage offset
    # would fault on the card, so refuse it here
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel needs q/k/v 16-byte aligned")
    out = torch.empty_like(q)
    if Sq:
        with torch.cuda.device(q.device):
            rc = library().repro_flash_prefill(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, H, Kv, Sq, Sk, int(q_offset), hd ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        check_launch(rc, "flash_prefill")
        flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
