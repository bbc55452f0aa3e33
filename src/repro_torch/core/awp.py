"""AWP — Adaptive Weight Precision (paper Algorithm 1); counterpart of
``repro.core.awp`` with the same semantics and the same ``history``.

AWP monitors the l²-norm of each precision group's weights after every batch
and widens the transfer format by ``N`` bits whenever the relative change
rate dips below ``T`` for ``INTERVAL`` consecutive observations.

The split between device and host mirrors the paper (AWP ran on the CPU
outside the CUDA graph):

  * the train step returns ``group_norms_sq: (num_groups,)`` — per-group
    Σw² of the post-update master weights, the only device-side cost;
  * :class:`AWPController` consumes the norms on the host, applies
    Algorithm 1 verbatim, and reports the per-group byte widths. When a
    width changes, the trainer switches to the (cached) step built for
    the new formats.

Precision granularity is per *group* of layers, not per layer — the paper
itself found block granularity superior for ResNet (§IV-B).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.formats import MAX_BITS, MIN_BITS, bits_to_bytes


@dataclasses.dataclass
class AWPConfig:
    """Hyper-parameters of Algorithm 1 (paper §II, §V-A)."""

    threshold: float = -2e-3      # T      (paper: -5e-2 .. -2e-5, per model)
    interval: int = 100           # INTERVAL (paper: 2000/4000 ~ one epoch-ish)
    increment_bits: int = 8       # N      (paper: 8 — byte granularity)
    initial_bits: int = 8         # paper: training starts at 8-bit
    max_bits: int = MAX_BITS

    def __post_init__(self):
        if self.initial_bits < MIN_BITS:
            raise ValueError("initial_bits must be >= 8")
        if self.interval <= 0:
            raise ValueError("interval must be positive")


@dataclasses.dataclass
class AWPState:
    """Host-side mutable state of the controller (one entry per group)."""

    bits: np.ndarray              # int, current format width per group
    counters: np.ndarray          # int, IntervalCounter per group
    prev_norms: np.ndarray | None # float, |W_{i-1}| per group (l2, not squared)
    step: int = 0

    def round_to(self) -> tuple[int, ...]:
        return tuple(bits_to_bytes(int(b)) for b in self.bits)


class AWPController:
    """Host-side implementation of Algorithm 1 over precision groups."""

    def __init__(self, num_groups: int, config: AWPConfig | None = None):
        self.config = config or AWPConfig()
        self.num_groups = num_groups
        self.state = AWPState(
            bits=np.full((num_groups,), self.config.initial_bits, np.int64),
            counters=np.zeros((num_groups,), np.int64),
            prev_norms=None,
        )
        # trajectory of (step, bits-per-group) transitions for analysis
        self.history: list[tuple[int, tuple[int, ...]]] = [
            (0, tuple(int(b) for b in self.state.bits))
        ]

    # ------------------------------------------------------------------
    def update(self, norms_sq: Sequence[float]) -> tuple[int, ...]:
        """Feed one batch's per-group Σw² values; returns round_to bytes.

        ``norms_sq`` comes squared straight from the step; Algorithm 1
        is defined on the l²-norm so we sqrt here (host-side, num_groups
        floats — negligible, as in the paper's Table II profile).
        """
        cfg = self.config
        st = self.state
        norms = np.sqrt(np.asarray(norms_sq, np.float64))
        if norms.shape != (self.num_groups,):
            raise ValueError(
                f"expected {self.num_groups} group norms, got {norms.shape}"
            )
        if st.prev_norms is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                delta = (norms - st.prev_norms) / st.prev_norms
            delta = np.where(np.isfinite(delta), delta, 0.0)
            hit = delta < cfg.threshold
            # Algorithm 1 requires INTERVAL *consecutive* observations:
            # a miss resets the counter (a cumulative count would widen
            # far too early on noisy norm trajectories).
            st.counters = np.where(hit, st.counters + 1, 0)
            fire = st.counters >= cfg.interval
            if fire.any():
                new_bits = np.minimum(
                    st.bits + cfg.increment_bits * fire, cfg.max_bits
                )
                if not np.array_equal(new_bits, st.bits):
                    st.bits = new_bits
                    self.history.append(
                        (st.step + 1, tuple(int(b) for b in st.bits))
                    )
                st.counters = np.where(fire, 0, st.counters)
        st.prev_norms = norms
        st.step += 1
        return st.round_to()

    # ------------------------------------------------------------------
    @property
    def round_to(self) -> tuple[int, ...]:
        return self.state.round_to()

    def bytes_saved_fraction(self) -> float:
        """Mean wire-byte reduction vs fp32 across groups (equal weights)."""
        rts = self.state.round_to()
        return 1.0 - sum(rts) / (4.0 * len(rts))


def oracle_round_to(num_groups: int, round_to: int) -> tuple[int, ...]:
    """The paper's *oracle* policy: a fixed format for the whole run."""
    return tuple([round_to] * num_groups)
