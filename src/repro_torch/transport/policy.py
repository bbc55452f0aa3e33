"""CompressionPolicy — the wire format of one precision group (counterpart
of ``repro.transport.policy``, the part the one-device path reads).

  * ``round_to``      — bytes kept per fp32 weight on the transfer path
                        (paper §III: 1=fp8e7, 2=bf16, 3=bf24, 4=fp32),
  * ``mode``          — rounding applied before truncation on that path,
  * ``impl``          — kernel dispatch: ``auto`` picks the CUDA kernels
                        for CUDA tensors and the plain PyTorch versions
                        otherwise; ``cuda`` forces the kernels, ``ref``
                        the plain versions,
  * ``grad_round_to`` / ``grad_mode`` — the format of the reference's
                        gradient collectives; kept so that a policy's
                        JSON has the reference's fields (one device moves
                        no gradients),
  * ``chunks``        — the reference's plane-block gather split; only 1
                        (no split) is ported.

A policy is frozen and hashable: the trainer's step cache keys on it.
"""
from __future__ import annotations

import dataclasses

VALID_ROUND_TO = (1, 2, 3, 4)
VALID_MODES = ("truncate", "nearest", "stochastic")
VALID_IMPLS = ("auto", "cuda", "ref")
FP32_BYTES = 4


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Wire format + dispatch choices for one precision group."""

    round_to: int = 4
    grad_round_to: int = 4
    mode: str = "truncate"
    grad_mode: str = "nearest"
    impl: str = "auto"
    chunks: int = 1

    def __post_init__(self):
        if self.round_to not in VALID_ROUND_TO:
            raise ValueError(f"round_to must be in {VALID_ROUND_TO}")
        if self.grad_round_to not in VALID_ROUND_TO:
            raise ValueError(f"grad_round_to must be in {VALID_ROUND_TO}")
        if self.mode not in VALID_MODES:
            raise ValueError(f"mode must be in {VALID_MODES}")
        if self.grad_mode not in VALID_MODES:
            raise ValueError(f"grad_mode must be in {VALID_MODES}")
        if self.impl not in VALID_IMPLS:
            raise ValueError(f"impl must be in {VALID_IMPLS}")
        if self.chunks < 1:
            raise ValueError("chunks must be >= 1")
        if self.chunks != 1:
            raise NotImplementedError("chunked gathers are not ported")

    # -- format properties ------------------------------------------------
    @property
    def compresses(self) -> bool:
        return self.round_to < FP32_BYTES

    # -- canonical byte accounting ---------------------------------------
    def host_device_bytes(self, elems: int) -> int:
        """Paper's host->device model: every weight moves once per batch."""
        return elems * self.round_to


def policy_for(round_to, **overrides) -> CompressionPolicy:
    """Coerce an int ``round_to`` or an existing policy into a
    CompressionPolicy, optionally overriding fields."""
    if isinstance(round_to, CompressionPolicy):
        return dataclasses.replace(round_to, **overrides) if overrides else round_to
    return CompressionPolicy(round_to=int(round_to), **overrides)
