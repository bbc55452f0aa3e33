"""Execution environment threaded through every model function
(counterpart of ``repro.models.env``).

``Env`` carries the model group (the rank's TP peers; ``None`` = no model
axis, where every collective helper is the identity), the FSDP group, the
TP degree, the compute dtype and the activation policies. ``act_policy``
is the activation group's :class:`~repro_torch.transport.CompressionPolicy`:
when set, every TP-region all-reduce and sequence-parallel collective
issued through this env rides packed byte planes.

``seq_parallel`` switches the activation layout between blocks, as in the
reference:

  * ``False`` (Megatron TP): activations between blocks are replicated
    over the model group; :meth:`enter` / :meth:`exit` are the f/g
    all-reduce pair.
  * ``True``: activations between blocks are sequence shards ``(B, S/tp,
    d)`` — norms and residual adds run on shards, and :meth:`enter` /
    :meth:`exit` become the ``seq_gather`` / ``seq_scatter`` pair.

Tensors that are never sequence-sharded (the vocab-partial loss sums) use
:meth:`psum_enter` / :meth:`psum_exit`, the f/g pair under either layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import collectives as C


@dataclasses.dataclass(frozen=True)
class Env:
    model_group: Any = None               # TP process group (None = no model axis)
    fsdp_group: Any = None                # weight-gather group (None = default)
    tp: int = 1
    dtype: Any = torch.float32            # compute dtype
    attn_chunk: int = 1024                # attend_tiled chunk (q and kv)
    causal_skip: bool = True              # skip fully masked kv chunks
    seq_parallel: bool = False            # sequence-parallel activations
    act_policy: Any = None                # activation CompressionPolicy
    seq_policy: Any = None                # seq-boundary policy (None = act)

    def __post_init__(self):
        if self.tp > 1 and self.model_group is None:
            raise ValueError(f"tp={self.tp} needs the model group")

    @property
    def _seq_pol(self):
        """Policy of the sequence-parallel pair: the plan's ``seq_boundary``
        class, defaulting to the activation policy."""
        return self.seq_policy if self.seq_policy is not None else self.act_policy

    @property
    def _has_model_axis(self) -> bool:
        return self.model_group is not None

    @property
    def seq_parallel_active(self) -> bool:
        """True when activations between blocks are sequence shards."""
        return self.seq_parallel and self._has_model_axis

    def without_seq_parallel(self) -> "Env":
        """The same env in the replicated layout."""
        if not self.seq_parallel:
            return self
        return dataclasses.replace(self, seq_parallel=False)

    def enter(self, x, axis: int = 1):
        """TP-region enter: ``seq_gather`` under seq_parallel, else "f"."""
        if not self._has_model_axis:
            return x
        if self.seq_parallel:
            return C.seq_gather(x, self.model_group, self._seq_pol, axis)
        return C.tp_region_enter(x, self.model_group, self.act_policy)

    def exit(self, x, axis: int = 1):
        """TP-region exit: ``seq_scatter`` under seq_parallel, else "g"."""
        if not self._has_model_axis:
            return x
        if self.seq_parallel:
            return C.seq_scatter(x, self.model_group, self._seq_pol, axis)
        return C.tp_region_exit(x, self.model_group, self.act_policy)

    def psum_enter(self, x, traffic: str = "activations"):
        """Megatron "f" under either layout."""
        if not self._has_model_axis:
            return x
        return C.tp_region_enter(x, self.model_group, self.act_policy, traffic)

    def psum_exit(self, x, traffic: str = "activations"):
        """Megatron "g" under either layout."""
        if not self._has_model_axis:
            return x
        return C.tp_region_exit(x, self.model_group, self.act_policy, traffic)

    def seq_gather(self, x, axis: int = 1):
        if not self._has_model_axis:
            return x
        return C.seq_gather(x, self.model_group, self._seq_pol, axis)

    def seq_scatter(self, x, axis: int = 1):
        if not self._has_model_axis:
            return x
        return C.seq_scatter(x, self.model_group, self._seq_pol, axis)

    def seq_shard(self, x, axis: int = 1):
        """Replicated activation -> this rank's sequence shard (identity
        unless seq-parallel is active)."""
        if not self.seq_parallel_active:
            return x
        return C.seq_split(x, self.model_group, axis)

    def seq_unshard(self, x, axis: int = 1):
        """Sequence shard -> the full replicated sequence (identity unless
        seq-parallel is active)."""
        if not self.seq_parallel_active:
            return x
        return C.seq_merge(x, self.model_group, axis)

    def model_rank(self) -> int:
        if not self._has_model_axis:
            return 0
        return dist.get_rank(self.model_group)

    def heads_local(self, heads: int) -> int:
        """Local head count when sharding ``heads`` over the model group
        (replicated up when heads < tp)."""
        return max(1, heads // self.tp)

    def ff_local(self, ff: int) -> int:
        return max(1, ff // self.tp)
