"""ADT Bitunpack: uint8 byte planes -> fp32, by a CUDA kernel on the card.

Counterpart of ``repro.kernels.bitunpack.bitunpack_2d``; the kernel is
``csrc/bitunpack.cu`` (memory-bound: one uchar4 load per kept plane and
one float4 store per thread). On a CPU tensor the wrapper runs the plain
version ``ref.bitunpack_ref``; on a CUDA tensor it launches the kernel or
raises.

``bitunpack.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import check_launch, library


def bitunpack(planes: torch.Tensor) -> torch.Tensor:
    """``(round_to, *shape)`` u8 planes (contiguous) -> fp32 ``shape``."""
    if planes.dtype != torch.uint8:
        raise ValueError(f"bitunpack expects uint8 planes, got {planes.dtype}")
    round_to = planes.shape[0]
    if round_to not in ref.VALID_ROUND_TO:
        raise ValueError(f"leading plane dim must be in {ref.VALID_ROUND_TO}")
    if planes.device.type == "cpu":
        return ref.bitunpack_ref(planes)
    if planes.device.type != "cuda":
        raise ValueError(f"bitunpack runs on cuda or cpu, got {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("bitunpack kernel needs contiguous planes")
    out = torch.empty(planes.shape[1:], dtype=torch.float32, device=planes.device)
    n = out.numel()
    if n:
        rc = library().repro_bitunpack(
            planes.data_ptr(), out.data_ptr(), n, round_to,
            torch.cuda.current_stream(planes.device).cuda_stream,
        )
        check_launch(rc, "bitunpack")
        bitunpack.launches += 1
    return out


bitunpack.launches = 0
