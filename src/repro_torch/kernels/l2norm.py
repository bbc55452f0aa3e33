"""AWP monitor: Σw² of an fp32 tensor, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.l2norm.l2norm_sq_2d``; the kernel is
``csrc/l2norm.cu`` (memory-bound: a deterministic two-stage reduction, a
grid sized by the length alone and one CTA over its partials, no float
atomics, so two calls on the same tensor give the same bits). It takes
any length, so the reference's pad to ``(rows, 128)`` tiles of 512 rows has
no counterpart. On a CPU tensor the wrapper runs the plain version
``ref.l2norm_sq_ref``; on a CUDA tensor it launches the kernel or raises.

``l2norm_sq.launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library

MAX_PARTS = 1024  # the kernel's largest stage-1 grid (kMaxBlocks)


def l2norm_sq(w: torch.Tensor) -> torch.Tensor:
    """Σw² of a contiguous fp32 tensor (any shape) -> 0-d fp32 tensor."""
    if w.dtype != torch.float32:
        raise ValueError(f"l2norm_sq expects float32, got {w.dtype}")
    if w.device.type == "cpu":
        return ref.l2norm_sq_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"l2norm_sq runs on cuda or cpu, got {w.device}")
    if not w.is_contiguous():
        raise ValueError("l2norm_sq kernel needs a contiguous tensor")
    out = torch.empty((), dtype=torch.float32, device=w.device)
    n = w.numel()
    if not n:
        return out.zero_()
    partials = torch.empty(MAX_PARTS, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        rc = library().repro_l2norm_sq(
            w.data_ptr(), partials.data_ptr(), MAX_PARTS, out.data_ptr(), n,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
    check_launch(rc, "l2norm_sq")
    l2norm_sq.launches += 1
    return out


l2norm_sq.launches = 0
