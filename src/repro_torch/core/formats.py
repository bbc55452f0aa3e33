"""ADT data-representation formats (paper §III / §V-A).

The paper's transfer formats are byte-truncations of IEEE-754 fp32:

  ============  =======  ==============================
  format        bytes    layout
  ============  =======  ==============================
  ``fp8e7``     1        1 sign + 7 exponent
  ``bf16``      2        1 sign + 8 exponent + 7 mantissa (== bfloat16)
  ``bf24``      3        1 sign + 8 exponent + 15 mantissa
  ``fp32``      4        full single precision
  ============  =======  ==============================

AWP reasons in *bits* (it adds ``N = 8`` bits at a time); ADT transfers in
*bytes* ("rounded to the nearest number of bytes that retains all of its
information", §III-A).
"""
from __future__ import annotations

import dataclasses

FORMAT_NAMES = {1: "fp8e7", 2: "bf16", 3: "bf24", 4: "fp32"}

MIN_BITS = 8
MAX_BITS = 32


def bits_to_bytes(bits: int) -> int:
    """Paper §III-A: round bit count up to whole bytes, clamp to [1, 4]."""
    if bits <= 0:
        raise ValueError(f"bits must be positive, got {bits}")
    return min(4, max(1, (min(bits, MAX_BITS) + 7) // 8))


@dataclasses.dataclass(frozen=True)
class TransferFormat:
    """Static description of one precision group's wire format."""

    round_to: int  # bytes kept per fp32 weight (1..4)

    def __post_init__(self):
        if self.round_to not in (1, 2, 3, 4):
            raise ValueError(f"round_to must be 1..4, got {self.round_to}")

    @property
    def name(self) -> str:
        return FORMAT_NAMES[self.round_to]

    @property
    def bits(self) -> int:
        return 8 * self.round_to

    @property
    def compression_ratio(self) -> float:
        return 4.0 / self.round_to

    @property
    def is_identity(self) -> bool:
        return self.round_to == 4
