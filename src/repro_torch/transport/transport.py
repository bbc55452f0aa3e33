"""Single-device compression transport: pack / unpack / straight-through
quantize (the trivial-mesh part of ``repro.transport.transport``).

On one device the paper's weight path is: cut the fp32 master weights to
their top ``round_to`` bytes as MSB-first planes (Bitpack), move the
planes, rebuild fp32 (Bitunpack). :func:`quantize` runs exactly that,
through the CUDA kernels for CUDA tensors (``impl="auto"``), with a
straight-through gradient: the format is not differentiated, like the
paper's fp32 master-weight update.

Planes are always exact-shape ``(round_to, *w.shape)`` u8.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import bitpack, bitunpack, resolve_impl
from repro_torch.transport.policy import CompressionPolicy

__all__ = ["pack_planes", "quantize", "resolve_impl", "unpack_planes"]


def pack_planes(
    w: torch.Tensor,
    round_to: int,
    *,
    mode: str = "truncate",
    impl: str = "auto",
    key=None,
) -> torch.Tensor:
    """fp32 tensor (any shape) -> uint8 byte planes ``(round_to, *w.shape)``.
    Plane 0 is the most significant byte."""
    return bitpack(w, round_to, impl=impl, mode=mode, key=key)


def unpack_planes(planes: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """uint8 byte planes ``(round_to, *shape)`` -> fp32 ``shape``."""
    return bitunpack(planes, impl=impl)


def _quantize_impl(w, policy: CompressionPolicy, key=None):
    planes = pack_planes(
        w, policy.round_to, mode=policy.mode, impl=policy.impl, key=key
    )
    return unpack_planes(planes, impl=policy.impl)


class _Quantize(torch.autograd.Function):
    """pack∘unpack forward, identity backward (straight-through)."""

    @staticmethod
    def forward(ctx, w, policy, key):
        return _quantize_impl(w, policy, key)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def quantize(w: torch.Tensor, policy: CompressionPolicy, key=None) -> torch.Tensor:
    """Format truncation (pack∘unpack) with a straight-through gradient."""
    if not policy.compresses:
        # rt=4 keeps every byte: rounding is a no-op regardless of mode
        return w
    return _Quantize.apply(w, policy, key)
