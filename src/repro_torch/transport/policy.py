"""CompressionPolicy — the wire format of one precision group (counterpart
of ``repro.transport.policy``, the part the one-device paths read).

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

    # -- host<->device token staging (serve engine) -----------------------
    def token_wire_width(self, vocab_size: int) -> int:
        """Staged bytes per token id on the host<->device boundary.

        Ids are integers, so the representation stays lossless: an
        uncompressed policy (``round_to == 4``) stages raw int32 words; a
        compressing policy keeps the low byte planes a ``vocab_size`` id
        can populate, never fewer than that even if ``round_to`` asks for
        fewer (a truncated id would be another token)."""
        needed = max(1, (max(int(vocab_size) - 1, 1).bit_length() + 7) // 8)
        if self.round_to >= FP32_BYTES:
            return FP32_BYTES
        return min(FP32_BYTES, max(needed, self.round_to))

    def token_host_bytes(self, n_tokens: int, vocab_size: int) -> int:
        """Bytes staged across the host<->device boundary for ``n_tokens``
        ids in one direction (prompts h2d, sampled ids d2h, next-step
        feeds h2d)."""
        return n_tokens * self.token_wire_width(vocab_size)


def policy_for(round_to, **overrides) -> CompressionPolicy:
    """Coerce an int ``round_to`` or an existing policy into a
    CompressionPolicy, optionally overriding fields."""
    if isinstance(round_to, CompressionPolicy):
        return dataclasses.replace(round_to, **overrides) if overrides else round_to
    return CompressionPolicy(round_to=int(round_to), **overrides)
