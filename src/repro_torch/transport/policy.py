"""CompressionPolicy — the wire format of one precision group (counterpart
of ``repro.transport.policy``, the parts the one-device, data-parallel
and tensor-parallel paths read).

  * ``round_to``      — bytes kept per fp32 weight on the gather path
                        (paper §III: 1=fp8e7, 2=bf16, 3=bf24, 4=fp32),
  * ``mode``          — rounding applied before truncation on that path,
  * ``grad_round_to`` / ``grad_mode`` — the same for the backward
                        reduce-scatter (4 = the paper's uncompressed fp32),
  * ``impl``          — kernel dispatch: ``auto`` picks the CUDA kernels
                        for CUDA tensors and the plain PyTorch versions
                        otherwise; ``cuda`` forces the kernels, ``ref``
                        the plain versions,
  * ``chunks``        — >1 splits the weight gather into that many plane
                        blocks, each packed, gathered and unpacked on its
                        own, re-interleaved to the unchunked layout.

A policy is frozen and hashable: the trainer's step cache keys on it.
Wire-byte arithmetic lives only here, derived from :func:`ring_wire_bytes`:
the plan's ``wire_table`` and the trainer's measured log (the same
formula applied to the sizes that :mod:`repro_torch.dist.comm` records)
both read it.
"""
from __future__ import annotations

import dataclasses

VALID_ROUND_TO = (1, 2, 3, 4)
VALID_MODES = ("truncate", "nearest", "stochastic")
VALID_IMPLS = ("auto", "cuda", "ref")
FP32_BYTES = 4


def ring_wire_bytes(kind: str, payload_bytes: float, group_size: int) -> float:
    """Per-device wire bytes of one ring-algorithm collective.

    ``payload_bytes`` is the *output* size for all-gather / all-to-all,
    the *input* size for all-reduce / reduce-scatter, the transferred
    size for collective-permute, and the root's whole buffer (every
    rank's block) for a gather to or a scatter from one rank.
    """
    n = max(int(group_size), 1)
    kind = kind.replace("-start", "")
    if kind == "all-gather":
        return payload_bytes * (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * payload_bytes * (n - 1) / n
    if kind in ("reduce-scatter", "all-to-all"):
        return payload_bytes * (n - 1) / n
    if kind == "collective-permute":
        return float(payload_bytes)
    if kind in ("gather", "scatter"):  # to or from one root: n - 1 blocks cross
        return payload_bytes * (n - 1) / n
    raise ValueError(f"unknown collective kind {kind!r}")


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

    # -- format properties ------------------------------------------------
    @property
    def compresses(self) -> bool:
        return self.round_to < FP32_BYTES

    @property
    def compresses_grads(self) -> bool:
        return self.grad_round_to < FP32_BYTES

    @property
    def bytes_per_element(self) -> int:
        """Wire bytes per fp32 element on the weight path."""
        return self.round_to

    # -- canonical byte accounting ---------------------------------------
    def all_gather_wire_bytes(self, s_local: int, axis_size: int) -> int:
        """Bytes received per device for one compressed all-gather of a
        shard of ``s_local`` fp32 elements over ``axis_size`` devices."""
        payload = axis_size * s_local * self.round_to
        return round(ring_wire_bytes("all-gather", payload, axis_size))

    def reduce_scatter_wire_bytes(self, s_local: int, axis_size: int) -> int:
        """Bytes received per device for one (compressed) reduce-scatter
        producing an ``s_local``-element shard."""
        payload = axis_size * s_local * self.grad_round_to
        return round(ring_wire_bytes("reduce-scatter", payload, axis_size))

    # -- activation path (TP axis): forward collectives move (round_to,
    # mode) planes, cotangent collectives (grad_round_to, grad_mode) ---
    def _act_width(self, grad: bool, uncompressed_bytes: int = FP32_BYTES) -> int:
        """Bytes an activation element moves: the packed width, or the
        compute dtype's (``uncompressed_bytes``) where the direction does
        not compress."""
        width = self.grad_round_to if grad else self.round_to
        return width if width < FP32_BYTES else uncompressed_bytes

    def seq_gather_wire_bytes(self, elems_out: int, axis_size: int, *,
                              grad: bool = False,
                              uncompressed_bytes: int = FP32_BYTES) -> int:
        """Bytes received per device for one ``seq_gather`` producing
        ``elems_out`` gathered elements (``grad``: the ``seq_scatter``
        backward's cotangent gather)."""
        payload = elems_out * self._act_width(grad, uncompressed_bytes)
        return round(ring_wire_bytes("all-gather", payload, axis_size))

    def seq_scatter_wire_bytes(self, elems_in: int, axis_size: int, *,
                               grad: bool = False,
                               uncompressed_bytes: int = FP32_BYTES) -> int:
        """Bytes received per device for one ``seq_scatter`` of
        ``elems_in`` input elements (``grad``: the ``seq_gather``
        backward's cotangent reduce-scatter)."""
        payload = elems_in * self._act_width(grad, uncompressed_bytes)
        return round(ring_wire_bytes("reduce-scatter", payload, axis_size))

    def seq_pair_wire_bytes(self, elems: int, axis_size: int, *, grad: bool = False,
                            uncompressed_bytes: int = FP32_BYTES) -> int:
        """One sequence-parallel boundary pair (``seq_gather`` into the
        region + ``seq_scatter`` out of it) in one direction; ``elems`` is
        the full (gathered) activation element count."""
        kw = dict(grad=grad, uncompressed_bytes=uncompressed_bytes)
        return self.seq_gather_wire_bytes(elems, axis_size, **kw) + \
            self.seq_scatter_wire_bytes(elems, axis_size, **kw)

    def all_reduce_wire_bytes(self, elems: int, axis_size: int,
                              uncompressed_bytes: int = FP32_BYTES, *,
                              grad: bool = False) -> int:
        """One TP-region all-reduce of ``elems`` activation elements
        (``grad``: the cotangent all-reduce). Compressed: the packed
        reduce-scatter + all-gather, both at the selected width;
        uncompressed: the ring all-reduce at ``uncompressed_bytes`` an
        element."""
        if self._act_width(grad) < FP32_BYTES:
            return self.seq_scatter_wire_bytes(elems, axis_size, grad=grad) + \
                self.seq_gather_wire_bytes(elems, axis_size, grad=grad)
        payload = elems * uncompressed_bytes
        return round(ring_wire_bytes("all-reduce", payload, axis_size))

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


def policy_for(
    round_to, grad_round_to: int | None = None, **overrides
) -> CompressionPolicy:
    """Coerce an int ``round_to`` or an existing policy into a
    CompressionPolicy, optionally overriding fields."""
    if isinstance(round_to, CompressionPolicy):
        pol = round_to
        if grad_round_to is not None and grad_round_to != pol.grad_round_to:
            overrides = {"grad_round_to": grad_round_to, **overrides}
        return dataclasses.replace(pol, **overrides) if overrides else pol
    return CompressionPolicy(
        round_to=int(round_to),
        grad_round_to=4 if grad_round_to is None else int(grad_round_to),
        **overrides,
    )
