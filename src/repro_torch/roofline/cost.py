"""The roofline's inputs from a run (counterpart of ``repro.roofline.hlo_cost``).

The reference walks XLA's optimized HLO text for a step's FLOPs, its
memory traffic and its collectives' wire, multiplying ``while`` bodies by
their trip counts. PyTorch makes no HLO; it runs the step, op by op, so
the same three inputs are counted as the step runs (on real tensors, or
on fake ones inside :func:`~repro_torch.audit.record.recording`, where
nothing is allocated):

  * FLOPs — :func:`count_flops`, by ``torch.utils.flop_counter``'s
    formulas, those of ``FlopCounterMode`` (matmuls, convolutions,
    attention: 2 FLOPs a multiply-add);
  * bytes — :func:`count_bytes`, every aten op's input and output bytes
    (views excepted): the unfused
    analogue of XLA's "bytes accessed", which charges a fusion only its
    boundary, so this is an upper bound of what a fused program moves;
  * wire — the collectives ``dist.comm`` recorded, by kind
    (:func:`wire_by_kind`) and by plan entry (:func:`plan_wire_split`).

The reference's ``analyze_hlo`` and its HLO parser have no counterpart:
there is no HLO text to read.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.transport.policy import ring_wire_bytes


@dataclasses.dataclass
class Cost:
    """A step's FLOPs and the bytes its ops read and wrote."""

    flops: float = 0.0
    bytes: float = 0.0


def _nbytes(x) -> int:
    """Bytes of the tensors in ``x`` (nested lists, tuples and dicts: an
    aten op's arguments and results; a direct walk, ``tree_flatten`` is
    the counter's main cost)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_nbytes(y) for y in x.values())
    return 0


class _Counter(TorchDispatchMode):
    """Adds each aten op's tensor inputs and outputs, in bytes (an op that
    returns a view of its input moves nothing), and its FLOPs by
    ``FlopCounterMode``'s own formulas (one dispatch mode for both: a
    full-width step runs ~10^5 ops, and each mode costs every one)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry

        super().__init__()
        self.bytes = 0
        self.flops = 0
        self._formulas = flop_registry

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


def count_cost(fn, *args, **kwargs) -> Cost:
    """FLOPs and bytes of one call of ``fn(*args, **kwargs)``, forward and
    backward as it runs them, in one pass."""
    with _Counter() as c:
        fn(*args, **kwargs)
    return Cost(flops=float(c.flops), bytes=float(c.bytes))


def count_flops(fn, *args, **kwargs) -> float:
    """:func:`count_cost`'s FLOPs."""
    return count_cost(fn, *args, **kwargs).flops


def count_bytes(fn, *args, **kwargs) -> float:
    """:func:`count_cost`'s bytes."""
    return count_cost(fn, *args, **kwargs).bytes


def wire_by_kind(calls) -> tuple[dict, dict]:
    """``(wire, plane)``: ring wire bytes by collective kind of the recorded
    ``calls``, and the part carried as uint8 byte planes (the compressed
    weight, gradient and activation pipelines)."""
    wire: dict[str, float] = {}
    plane: dict[str, float] = {}
    for c in calls:
        w = ring_wire_bytes(c.kind, c.nbytes, c.group_size)
        wire[c.kind] = wire.get(c.kind, 0.0) + w
        if c.dtype == "uint8":
            plane[c.kind] = plane.get(c.kind, 0.0) + w
    return wire, plane


def plan_wire_split(calls, plan, dist_elems_per_group, gather_axis_size: int, *,
                    training: bool = True) -> dict:
    """Split a step's recorded wire by :class:`~repro_torch.plan.PrecisionPlan`
    traffic class (the reference's ``plan_wire_split`` over recorded calls
    instead of an HLO cost).

    The ``weights`` / ``gradients`` / ``host_device`` entries come from the
    plan's own :meth:`~repro_torch.plan.PrecisionPlan.wire_table`.
    ``plane_residue`` is the recorded packed-plane wire that the
    compressed weight and gradient entries do not explain: the TP-axis
    activation / seq-boundary pipelines and the remat backward's gathers
    again. ``raw_wire`` is the rest (uncompressed collectives, grad syncs,
    metrics, logits). The recorded totals ride along."""
    table = plan.wire_table(dist_elems_per_group, gather_axis_size, training=training)
    # only the groups that compress ride u8 planes: an rt=4 entry's gather
    # is a raw f32 collective and must not be subtracted from the plane wire
    plane_share = 0
    n = int(gather_axis_size)
    if n > 1:
        for pol, e in zip(plan.weight_policies(), dist_elems_per_group):
            if pol.compresses:
                plane_share += pol.all_gather_wire_bytes(e // n, n)
            if training and pol.compresses_grads:
                plane_share += pol.reduce_scatter_wire_bytes(e // n, n)
    wire, plane = wire_by_kind(calls)
    wire_total, plane_total = sum(wire.values()), sum(plane.values())
    split = dict(table)
    split["plane_residue"] = max(round(plane_total - plane_share), 0)
    split["raw_wire"] = round(wire_total - plane_total)
    split["measured_plane_wire"] = round(plane_total)
    split["measured_wire"] = round(wire_total)
    return split
