"""Kernel dispatch for the ADT transfer path (counterpart of
``repro.kernels.ops`` and of ``repro.transport.transport.resolve_impl``).

``impl="auto"`` picks the hand-written CUDA kernel for a CUDA tensor in
truncate mode and the plain PyTorch version otherwise (rounding modes
other than truncation live in the plain version, as in the reference);
``"cuda"`` forces the kernel and raises for a CPU tensor; ``"ref"``
forces the plain version. The kernels take any length, so the
reference's pad-to-(rows, 128)-tiles plumbing has no counterpart here:
planes are always exact-shape ``(round_to, *w.shape)``, and
:func:`l2norm_sq` reads the tensor as it is (zero padding adds nothing to
Σw² in the reference either).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bitpack import bitpack as _bitpack_kernel
from repro_torch.kernels.bitunpack import bitunpack as _bitunpack_kernel
from repro_torch.kernels.l2norm import l2norm_sq as _l2norm_kernel
from repro_torch.transport.policy import VALID_IMPLS
from repro_torch.utils import spans


def resolve_impl(impl: str, mode: str, device: torch.device) -> str:
    """auto -> cuda for a CUDA tensor in truncate mode, ref otherwise."""
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be in {VALID_IMPLS}, got {impl!r}")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA tensor, got {device}")
    if mode != "truncate":
        return "ref"
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "ref"
    return impl


def bitpack(
    w: torch.Tensor, round_to: int, *, impl: str = "auto",
    mode: str = "truncate", key=None, index=None,
) -> torch.Tensor:
    """fp32 (any shape) -> ``(round_to, *w.shape)`` u8 planes (``key`` and
    ``index``: stochastic rounding's, :func:`~repro_torch.kernels.ref.bitpack_ref`).
    Counts ``n × (4 + round_to)`` bytes read and written (``transport.bytes``)."""
    spans.add("transport.bytes", w.numel() * (4 + round_to))
    if resolve_impl(impl, mode, w.device) == "ref":
        return ref.bitpack_ref(w, round_to, mode=mode, key=key, index=index)
    return _bitpack_kernel(w.contiguous(), round_to)


def bitunpack(planes: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """``(round_to, *shape)`` u8 planes -> fp32 ``shape``. Counts ``n ×
    (round_to + 4)`` bytes read and written (``transport.bytes``)."""
    spans.add("transport.bytes", planes.numel() // planes.shape[0] * (planes.shape[0] + 4))
    if resolve_impl(impl, "truncate", planes.device) == "ref":
        return ref.bitunpack_ref(planes)
    return _bitunpack_kernel(planes.contiguous())


def quantize(
    w: torch.Tensor, round_to: int, *, impl: str = "auto",
    mode: str = "truncate", key=None,
) -> torch.Tensor:
    """pack∘unpack at the original shape — what the compute side sees."""
    if round_to == 4 and mode == "truncate":
        return w
    return bitunpack(bitpack(w, round_to, impl=impl, mode=mode, key=key), impl=impl)


def l2norm_sq(w: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Σw² over a tensor of any shape -> 0-d float32 (the AWP monitor)."""
    if resolve_impl(impl, "truncate", w.device) == "ref":
        return ref.l2norm_sq_ref(w)
    return _l2norm_kernel(w.to(torch.float32).contiguous())
