"""Host-side byte-plane codec of the data shards and the sharded
checkpointer (counterpart of ``repro.utils.planes``).

The transport splits fp32 words into MSB-first uint8 byte planes on the
device (``repro_torch.kernels``: plane 0 = sign + high exponent bits).
Training I/O stores the same representation on the host: a record or a
checkpoint leaf is kept as byte planes, so that a reader can stop after
the most significant ``k`` planes, and a round_to 2 checkpoint leaf
costs exactly 2 bytes an element.

The codec is numpy, not torch: torch has no big-endian dtype, and it runs
on writer threads and in the async checkpointer, off the device.

Conventions (bit-compatible with the transport's planes):

  * plane 0 is the MOST significant byte of each element's bit pattern;
  * dropping trailing planes and zero-filling them is the transport's
    ``truncate`` rounding;
  * the codec is a pure byte shuffle: every dtype (floats, ints, bool)
    round-trips bitwise when all planes are kept.
"""
from __future__ import annotations

import numpy as np


def plane_split(arr: np.ndarray, k: int | None = None) -> np.ndarray:
    """Array -> uint8 byte planes, shape ``(k, arr.size)``: the ``k``
    most significant (all ``itemsize`` by default); plane 0 holds the most
    significant byte of every element."""
    a = np.ascontiguousarray(arr).reshape(-1)
    width = a.dtype.itemsize
    # little-endian bytes: plane p is byte width - 1 - p of each element
    raw = a.astype(a.dtype.newbyteorder("<"), copy=False).view(np.uint8).reshape(-1, width)
    out = np.empty((width if k is None else k, raw.shape[0]), np.uint8)
    for p in range(out.shape[0]):
        out[p] = raw[:, width - 1 - p]
    return out


def plane_join(
    planes: np.ndarray, dtype, shape, *, total_planes: int | None = None,
    lead_skip: int = 0,
) -> np.ndarray:
    """uint8 planes ``(k, n)`` -> array of ``dtype`` and ``shape``.

    ``total_planes`` defaults to the dtype's itemsize; planes past the
    given ``k`` are zero-filled (the transport's truncation: how a
    quality-limited reader rebuilds a float payload). ``lead_skip``
    re-inserts that many all-zero MOST significant planes (integer
    payloads whose high bytes were trimmed at write time)."""
    dtype = np.dtype(dtype)
    total = dtype.itemsize if total_planes is None else int(total_planes)
    planes = np.asarray(planes, np.uint8)
    k, n = planes.shape
    full = np.zeros((n, total), np.uint8)  # little-endian bytes of each element
    for p in range(k):
        full[:, total - 1 - lead_skip - p] = planes[p]
    le = full.view(dtype.newbyteorder("<"))
    return le.astype(dtype, copy=False).reshape(shape)


def lead_zero_planes(planes: np.ndarray) -> int:
    """How many MOST significant planes are all zero (trimmable without
    loss: integer ids far narrower than their dtype). Leaves at least one
    plane."""
    k = 0
    while k < planes.shape[0] - 1 and not planes[k].any():
        k += 1
    return k
