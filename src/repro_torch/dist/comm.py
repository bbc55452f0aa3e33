"""Collectives over one ``torch.distributed`` process group: the port's
stand-in for the ``lax`` collectives that ``repro.transport.transport``
and ``repro.core.collectives`` call inside ``shard_map`` (a tiled
``all_gather`` and ``psum_scatter`` along any axis, ``all_to_all``,
``psum`` and ``pmax``).

Each rank is one process; ``group`` is a process group of them (``None``
is the default group, as everywhere in ``torch.distributed``). Blocks go
to and come from the ranks in group-rank order, so a gather over a group
is the concatenation that the reference's tiled gather over its axes
gives.

Backend: gloo. NCCL cannot put two ranks on one card, and the machines
this port is checked on have one card, so gloo it is for now (NCCL with
one rank per card waits for a machine with more than one). Gloo moves
host memory: a CUDA tensor is copied to the host, moved, and the result
copied back to its device. That staging is unconditional on gloo, never a
reaction to an error, and its host-clock seconds are logged beside the
call (it is not the cost NVLink would show).

Log: every call appends a :class:`CommRecord` (kind, traffic class,
payload bytes, group size, staging seconds, and the payload's dtype and
shape and the group's global ranks) to :data:`LOG`. The traffic classes are
the plan's (``weights``, ``gradients``, ``activations`` — the TP-region
all-reduces — and ``seq_boundary`` — the sequence-parallel gather and
scatter) and those it does not price: ``grad_sync`` and ``metrics`` (the
step's fp32 psums), ``loss`` (the vocab-parallel loss's row max and sums),
``logits`` (a serve step's gather of its vocabulary-sharded, and under a
sharded batch row-sharded, logits), ``relayout`` (the lossless
sequence split and merge, the MoE ``ep`` layout's token split, merge
and expert exchanges, and a fleet prefill worker's gather of its KV pages'
kv-head slices over the model group) and ``checkpoint`` (a checkpoint's
leaves gathered to rank 0 on a save and scattered from it on a load,
between steps: :func:`gather` and :func:`scatter`; and the byte planes a
fleet weight publish keeps of each leaf, gathered to every rank). The payload is what
:func:`~repro_torch.transport.policy.ring_wire_bytes` reads (the output
of an all-gather or all-to-all, the input of a reduce-scatter or
all-reduce), so :func:`wire_by_traffic` of the log is a measured count of
the wire, independent of the plan's analytic ``wire_table``. The dtype,
shape and group let an auditor (``repro_torch.audit``) attribute a call
from what it moved and where, without trusting its ``traffic`` label.
Nothing here reads a tensor's storage address, so the functions also run
on fake tensors under a fake process group (the audit's recorder).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.transport.policy import ring_wire_bytes

# torch 2.13 renamed the tensor-in, tensor-out collectives; older releases
# have only the first names (same arguments)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)


@dataclasses.dataclass(frozen=True)
class CommRecord:
    kind: str          # "all-gather" | "all-to-all" | "reduce-scatter" | "all-reduce"
    #                    | "gather" | "scatter"
    traffic: str       # the traffic class (see the module docstring)
    nbytes: int        # payload, as ring_wire_bytes reads it
    group_size: int
    stage_s: float     # host clock of the device <-> host copies (0 on the CPU)
    dtype: str = ""    # the payload's dtype ("float32", "uint8", ...)
    shape: tuple = ()  # the payload's shape (what nbytes counts)
    group: tuple = ()  # the group's global ranks, in group-rank order
    op: str = ""       # an all-reduce's reduction: "sum" | "max"


LOG: list[CommRecord] = []


def clear_log() -> None:
    LOG.clear()


def wire_by_traffic(records) -> dict[str, int]:
    """Per-device wire bytes per traffic class: ``ring_wire_bytes`` of each
    logged call's payload, summed."""
    out: dict[str, float] = {}
    for r in records:
        out[r.traffic] = out.get(r.traffic, 0.0) + ring_wire_bytes(r.kind, r.nbytes,
                                                                     r.group_size)
    return {k: round(v) for k, v in out.items()}


def _to_host(x: torch.Tensor):
    """(host copy, seconds): gloo moves host memory only."""
    if x.device.type == "cpu":
        return x.contiguous(), 0.0
    t0 = time.perf_counter()
    host = x.to("cpu")  # synchronizes with the producing stream
    return host, time.perf_counter() - t0


def _to_device(x: torch.Tensor, device: torch.device):
    if device.type == "cpu":
        return x, 0.0
    t0 = time.perf_counter()
    out = x.to(device)
    return out, time.perf_counter() - t0


def _ranks(group) -> tuple:
    if group is None:
        return tuple(range(dist.get_world_size()))
    return tuple(dist.get_process_group_ranks(group))


def _log(kind, traffic, payload: torch.Tensor, n, stage_s, group=None, *, copies: int = 1,
         op: str = ""):
    """One record of a call whose wire payload is ``payload`` (``copies``
    times over for a gather's or scatter's blocks)."""
    shape = tuple(payload.shape) if copies == 1 else (copies, *payload.shape)
    LOG.append(CommRecord(kind, traffic, copies * payload.numel() * payload.element_size(),
                          n, stage_s, str(payload.dtype).removeprefix("torch."), shape,
                          _ranks(group), op))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_gather(x: torch.Tensor, group=None, *, axis: int = 0, traffic: str) -> torch.Tensor:
    """Tiled all-gather: the ranks' ``x`` concatenated along ``axis`` in
    group-rank order (``lax.all_gather(..., tiled=True)``)."""
    n = dist.get_world_size(group)
    axis = axis % x.ndim
    host, s_in = _to_host(x)
    out = torch.empty(n * host.numel(), dtype=host.dtype)
    _all_gather(out, host.reshape(-1), group=group)
    out = out.view(n, *host.shape)
    shape = list(host.shape)
    shape[axis] *= n
    out = out.movedim(0, axis).reshape(shape)
    out, s_out = _to_device(out, x.device)
    _log("all-gather", traffic, out, n, s_in + s_out, group)
    return out


def all_to_all(x: torch.Tensor, group=None, *, axis: int, traffic: str) -> torch.Tensor:
    """Untiled all-to-all over a dim of size ``n`` (the group's size) with
    the split and concat dims both ``axis``: afterwards block ``j`` of that
    dim holds what rank ``j`` had in block ``rank``
    (``lax.all_to_all(..., split_axis=axis, concat_axis=axis, tiled=False)``)."""
    n = dist.get_world_size(group)
    axis = axis % x.ndim
    if x.shape[axis] != n:
        raise ValueError(f"all_to_all dim {axis} of shape {tuple(x.shape)} must be the "
                         f"group size {n}")
    host, s_in = _to_host(x.movedim(axis, 0).contiguous())
    out = torch.empty(host.numel(), dtype=host.dtype)
    dist.all_to_all_single(out, host.reshape(-1), group=group)  # equal blocks of dim 0
    out = out.view(host.shape).movedim(0, axis).contiguous()
    out, s_out = _to_device(out, x.device)
    _log("all-to-all", traffic, out, n, s_in + s_out, group)
    return out


def reduce_scatter(x: torch.Tensor, group=None, *, axis: int = 0,
                   traffic: str) -> torch.Tensor:
    """Tiled sum-reduce-scatter along ``axis`` (``lax.psum_scatter(...,
    tiled=True)``): rank ``r`` gets block ``r`` of the sum over ranks."""
    n = dist.get_world_size(group)
    axis = axis % x.ndim
    if x.shape[axis] % n:
        raise ValueError(f"scatter dim {axis} of shape {tuple(x.shape)} not divisible by "
                         f"group size {n}")
    host, s_in = _to_host(x.movedim(axis, 0).contiguous())
    out = torch.empty(host.numel() // n, dtype=host.dtype)
    _reduce_scatter(out, host.reshape(-1), op=dist.ReduceOp.SUM, group=group)
    out = out.view(host.shape[0] // n, *host.shape[1:]).movedim(0, axis).contiguous()
    out, s_out = _to_device(out, x.device)
    _log("reduce-scatter", traffic, x, n, s_in + s_out, group)
    return out


def all_reduce(x: torch.Tensor, group=None, *, traffic: str, op: str = "sum") -> torch.Tensor:
    """Sum (``lax.psum``) or, with ``op="max"``, maximum (``lax.pmax``)
    over the group; returns a new tensor, equal on every rank."""
    n = dist.get_world_size(group)
    host, s_in = _to_host(x)
    host = host.clone() if host is x else host  # all_reduce writes in place
    dist.all_reduce(host, op=_OPS[op], group=group)
    out, s_out = _to_device(host, x.device)
    _log("all-reduce", traffic, x, n, s_in + s_out, group, op=op)
    return out


def gather(x: torch.Tensor, *, traffic: str) -> list | None:
    """Every rank's ``x`` (all of one shape and dtype) to rank 0 of the
    default group: there the list of blocks in rank order, on the host
    (the caller writes them out); ``None`` on the other ranks."""
    n = dist.get_world_size()
    host, s_in = _to_host(x)
    out = [torch.empty_like(host) for _ in range(n)] if dist.get_rank() == 0 else None
    dist.gather(host, out, dst=0)
    _log("gather", traffic, host, n, s_in, copies=n)
    return out


def scatter(blocks, like: torch.Tensor, *, traffic: str) -> torch.Tensor:
    """Rank 0's ``blocks[r]`` (host tensors in rank order, read on rank 0
    only) to rank ``r`` of the default group: a fresh tensor of ``like``'s
    shape and dtype on ``like``'s device."""
    n = dist.get_world_size()
    out = torch.empty(like.shape, dtype=like.dtype)
    src = [b.contiguous() for b in blocks] if dist.get_rank() == 0 else None
    dist.scatter(out, src, src=0)
    out, s_out = _to_device(out, like.device)
    _log("scatter", traffic, out, n, s_out, copies=n)
    return out
