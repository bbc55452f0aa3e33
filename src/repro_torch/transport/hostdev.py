"""Host<->device staging of integer token payloads (counterpart of
``repro.transport.hostdev``).

Prompts arrive on the host and sampled ids return to it, so every serve
step moves token ids across the host<->device link. An int32 id is split
into byte planes (most significant first, like the weight planes) and
only the planes a ``vocab_size`` id can populate are staged —
:meth:`~repro_torch.transport.CompressionPolicy.token_wire_width` is the
one width formula shared by this module, the engine's measured wire log
and :func:`repro_torch.roofline.analysis.serve_host_device_bytes`. The
packing is lossless: ``unpack ∘ pack`` is the identity for any id in
``[0, 2**(8*width))``.

  * :func:`pack_tokens_host` / :func:`unpack_tokens_host` — numpy, on the
    host side of the boundary (the engine's scheduler);
  * :func:`pack_tokens` / :func:`unpack_tokens` — torch, on the device
    (the sampler's pack, the prompt's unpack).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_tokens",
    "unpack_tokens",
    "pack_tokens_host",
    "unpack_tokens_host",
    "stage",
]


def stage(x: np.ndarray, device) -> torch.Tensor:
    """The one host->device staging entry (the priced h2d boundary):
    every array the serve engine moves onto the device crosses here, and
    the engine adds ``x.nbytes`` to its wire log at each call site."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _shifts(width: int):
    """Bit shifts per plane, most-significant plane first."""
    return [8 * (width - 1 - i) for i in range(width)]


def pack_tokens(tokens: torch.Tensor, width: int) -> torch.Tensor:
    """Token ids (any shape, non-negative) -> uint8 planes ``(width, *shape)``
    on the tokens' device. The shifts run on int64: PyTorch has no uint32
    shift on the CPU."""
    t = tokens.to(torch.int64)
    return torch.stack([((t >> s) & 0xFF).to(torch.uint8) for s in _shifts(width)], dim=0)


def unpack_tokens(planes: torch.Tensor) -> torch.Tensor:
    """uint8 planes ``(width, *shape)`` -> int32 ids ``shape``."""
    width = planes.shape[0]
    t = torch.zeros(planes.shape[1:], dtype=torch.int64, device=planes.device)
    for i, s in enumerate(_shifts(width)):
        t = t | (planes[i].to(torch.int64) << s)
    return t.to(torch.int32)


def pack_tokens_host(tokens, width: int) -> np.ndarray:
    """Host-side (numpy) twin of :func:`pack_tokens`; ``result.nbytes`` is
    the measured h2d wire contribution."""
    t = np.asarray(tokens, np.uint32)
    return np.stack(
        [((t >> s) & 0xFF).astype(np.uint8) for s in _shifts(width)], axis=0
    )


def unpack_tokens_host(planes) -> np.ndarray:
    """Host-side twin of :func:`unpack_tokens` (sampled ids arriving d2h)."""
    planes = np.asarray(planes, np.uint8)
    width = planes.shape[0]
    t = np.zeros(planes.shape[1:], np.uint32)
    for i, s in enumerate(_shifts(width)):
        t |= planes[i].astype(np.uint32) << np.uint32(s)
    return t.astype(np.int32)
