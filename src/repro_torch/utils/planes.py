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


def plane_split(arr: np.ndarray) -> np.ndarray:
    """Array -> uint8 byte planes, shape ``(itemsize, arr.size)``; plane 0
    holds the most significant byte of every element."""
    a = np.ascontiguousarray(arr)
    # big-endian byte order makes byte 0 the MSB for every dtype
    be = a.astype(a.dtype.newbyteorder(">"), copy=False)
    raw = np.frombuffer(be.tobytes(), np.uint8)
    if a.dtype.itemsize == 1:
        return raw.reshape(1, -1)
    return np.ascontiguousarray(raw.reshape(-1, a.dtype.itemsize).T)


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
    full = np.zeros((total, n), np.uint8)
    full[lead_skip:lead_skip + k] = planes
    raw = np.ascontiguousarray(full.T).tobytes()
    be = np.frombuffer(raw, dtype.newbyteorder(">"))
    return be.astype(dtype, copy=False).reshape(shape)


def lead_zero_planes(planes: np.ndarray) -> int:
    """How many MOST significant planes are all zero (trimmable without
    loss: integer ids far narrower than their dtype). Leaves at least one
    plane."""
    k = 0
    while k < planes.shape[0] - 1 and not planes[k].any():
        k += 1
    return k
