"""ADT Bitpack: fp32 -> uint8 byte planes, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.bitpack.bitpack_2d``; the kernel is
``csrc/bitpack.cu`` (memory-bound: one float4 load and one uchar4 store
per kept plane per thread, any length, no padding to tiles). On a CPU
tensor the wrapper runs the plain version ``ref.bitpack_ref``; on a CUDA
tensor it launches the kernel or raises.

``bitpack.launches`` counts kernel launches (never plain-version calls),
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library


def bitpack(w: torch.Tensor, round_to: int) -> torch.Tensor:
    """fp32 tensor (any shape, contiguous) -> ``(round_to, *w.shape)`` u8."""
    if w.dtype != torch.float32:
        raise ValueError(f"bitpack expects float32, got {w.dtype}")
    if round_to not in ref.VALID_ROUND_TO:
        raise ValueError(f"round_to must be in {ref.VALID_ROUND_TO}")
    if w.device.type == "cpu":
        return ref.bitpack_ref(w, round_to)
    if w.device.type != "cuda":
        raise ValueError(f"bitpack runs on cuda or cpu, got {w.device}")
    if not w.is_contiguous():
        raise ValueError("bitpack kernel needs a contiguous tensor")
    planes = torch.empty(
        (round_to, *w.shape), dtype=torch.uint8, device=w.device
    )
    n = w.numel()
    if n:
        rc = library().repro_bitpack(
            w.data_ptr(), planes.data_ptr(), n, round_to,
            torch.cuda.current_stream(w.device).cuda_stream,
        )
        check_launch(rc, "bitpack")
        bitpack.launches += 1
    return planes


bitpack.launches = 0
