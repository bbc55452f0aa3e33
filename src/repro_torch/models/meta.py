"""Parameter metadata (counterpart of ``repro.models.meta``): how each
weight shards over TP and whether ADT compresses it (biases/norm scales
are never compressed — paper §III)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    """Sharding + compression descriptor for one parameter.

    tp_dim:   dimension sliced over the model axis (None = replicated).
    tp_units: number of logical units along tp_dim (e.g. kv heads). When
              units < tp, each unit is replicated tp/units times (GQA kv
              replication, DESIGN.md §3); when units % tp == 0 it's an even
              slice. 0 means "dim size itself is the unit count".
    compress: ADT byte-plane compression applies to the FSDP gather.
    """

    tp_dim: int | None = None
    tp_units: int = 0
    compress: bool = True
    # gradient synchronisation over the *model* axis: params that are
    # replicated over TP but consumed inside a TP region (after the
    # enter() boundary) produce rank-partial grads that must be psum'd.
    # Params used on replicated activations already get full grads via the
    # f/g custom_vjp pairs and must NOT be re-summed (DESIGN.md §3).
    grad_sync_model: bool = False
    # like grad_sync_model, but only when the step runs sequence-parallel
    # (Env.seq_parallel): params consumed on *sequence shards* — the
    # pre-boundary RMSNorm scales and the final norm — see each rank's
    # tokens only, so their grads are token-partial and must be psum'd.
    # In the replicated layout the same grads are full and identical per
    # rank (no sync); params consumed on replicated activations (sLSTM)
    # stay identical under both layouts and must never be re-summed.
    grad_sync_seq: bool = False

    def local_shape(self, shape: tuple[int, ...], tp: int) -> tuple[int, ...]:
        if self.tp_dim is None or tp == 1:
            return shape
        dim = self.tp_dim
        units = self.tp_units or shape[dim]
        if units % tp == 0:
            per = shape[dim] // tp
        elif tp % units == 0:
            per = shape[dim] // units  # one unit, replicated
        else:
            raise ValueError(
                f"cannot shard {units} units over tp={tp} (shape {shape})"
            )
        out = list(shape)
        out[dim] = per
        return tuple(out)

    def tp_slice_index(self, rank: int, shape: tuple[int, ...], tp: int) -> int:
        """Start offset (in elements along tp_dim) of ``rank``'s slice."""
        dim = self.tp_dim
        units = self.tp_units or shape[dim]
        unit_w = shape[dim] // units
        if units % tp == 0:
            return rank * (units // tp) * unit_w
        return (rank * units // tp) * unit_w


REPLICATED_SMALL = ParamMeta(tp_dim=None, compress=False)
REPLICATED_BIG = ParamMeta(tp_dim=None, compress=True)
# RMSNorm scales applied before a TP-region enter (token-partial grads
# under the sequence-parallel layout)
SEQ_NORM = ParamMeta(tp_dim=None, compress=False, grad_sync_seq=True)

# compression threshold: leaves smaller than this stay uncompressed and
# replicated-gathered in fp32 (the paper's "biases" carve-out)
COMPRESS_MIN_SIZE = 65536
