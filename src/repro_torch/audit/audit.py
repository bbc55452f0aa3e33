"""Attribute recorded collectives to PrecisionPlan traffic classes and pin
their wire bytes to the analytic byte model (counterpart of
``repro.audit.audit``).

The attribution works from what a call moved and where: a compressed
pipeline always moves ``uint8`` planes whose *leading dim is the wire
width* (bytes/element), and the group's ranks say which mesh axis it
crossed, so the record alone reveals the format every collective used.
The caller's ``traffic=`` label is not read to attribute; a label that
disagrees with the attribution is a violation. The verifier then checks
three things, as the reference's does:

(a) **format** — every collective inside a compressing plan region moves
    uint8 planes at one of the plan's declared widths, never raw fp32;
(b) **inventory** — the collective multiset matches what the plan and
    the parameter spec tree say must move (per-leaf weight gathers,
    gradient reduce-scatters, grad-sync and metric all-reduces, a serve
    step's logits gathers), with no unattributed call left over;
(c) **bytes** — per traffic class, the recorded ring wire bytes equal
    ``PrecisionPlan.wire_table``'s analytic bytes (the numbers
    ``roofline.analysis`` charges).

Classes ``weights`` / ``gradients`` / ``grad_sync`` / ``metrics`` /
``logits`` are pinned against expectations derived from the spec tree —
a wrong wire dtype (fp32 where rt=2 planes were promised) diverges by
``4/rt`` and fails. ``activations`` / ``seq_boundary`` payloads are only
discoverable from the run, so their pin is the width contract: detected
plane widths must be plan widths, raw all-reduces are legal only where
the transport's own fallback rule (no tp-divisible dim, or an
uncompressed policy) permits them. ``relayout`` (the lossless sequence
split and merge, the MoE ``ep`` exchanges), ``host_device`` (staging
outside the step) and the fleet classes ``kv_migration`` /
``weight_publish`` (parcels between processes) are accounting-only.

Where the port's structure is not the reference's program, the
inventory is the port's: a stacked group leaf is gathered, synced and
reduce-scattered one repetition at a time (the reference moves the
stack in one collective under its scan), so counts differ and bytes per
class do not; the logits of a serve step are gathered by collectives
(``logits``: the reference's ``out_specs`` assemble them with none); a
MoE train step at dp > 1 also sums its auxiliary loss (``metrics``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter

import torch

from repro_torch.audit.record import collect_comm_calls
from repro_torch.dist.spec import DIST, REPL, TP_SMALL, LeafSpec, MeshCfg
from repro_torch.models.init import eff_vocab
from repro_torch.plan import PrecisionPlan
from repro_torch.transport.policy import FP32_BYTES, ring_wire_bytes
from repro_torch.transport.transport import pick_split_axis
from repro_torch.utils.trees import tree_leaves

# Verifiable step kinds; "place" runs the gathers once over whole leaves
TRAIN_KINDS = ("train", "cnn_train")
KINDS = ("train", "cnn_train", "prefill", "decode", "place")
SERVE_KINDS = ("prefill", "decode")

# the labels a call of each attributed class may carry beside its own:
# the port splits the vocabulary-parallel loss's row max and sums (the
# reference's activation-path psums) into a ``loss`` label of its own
_LABELS = {
    "activations": {"activations", "loss"},
    "seq_boundary": {"seq_boundary", "loss"},
    # an uncompressed sequence-parallel leg is a raw re-layout on the wire
    "relayout": {"relayout", "seq_boundary"},
}


class AuditError(Exception):
    """The recorded step's data motion violates its plan. Carries the
    failing :class:`AuditReport` for inspection."""

    def __init__(self, report: "AuditReport"):
        self.report = report
        lines = "\n  ".join(report.violations)
        super().__init__(f"audit failed ({len(report.violations)} violation(s)):\n  {lines}")


@dataclasses.dataclass
class ClassTotal:
    """Per-traffic-class byte tallies. ``structural=True`` marks classes
    whose analytic side is derived from the recorded structure (payload
    geometry is unknowable without the run); their verification content
    is the format/legality contract, not byte independence.
    ``recorded_bytes`` is the reference's ``jaxpr_bytes``."""

    calls: int = 0
    recorded_bytes: float = 0.0
    analytic_bytes: float = 0.0
    structural: bool = False

    def to_json_dict(self) -> dict:
        return {
            "calls": self.calls,
            "recorded_bytes": round(self.recorded_bytes),
            "analytic_bytes": round(self.analytic_bytes),
            "structural": self.structural,
        }


@dataclasses.dataclass
class AuditReport:
    kind: str
    mesh: str
    classes: dict
    violations: list
    n_comm_calls: int
    notes: list

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_failed(self) -> "AuditReport":
        if not self.ok:
            raise AuditError(self)
        return self

    @property
    def total_recorded_bytes(self) -> int:
        return round(sum(c.recorded_bytes for c in self.classes.values()))

    @property
    def total_analytic_bytes(self) -> int:
        return round(sum(c.analytic_bytes for c in self.classes.values()))

    def to_json_dict(self) -> dict:
        return {
            "kind": self.kind,
            "mesh": self.mesh,
            "ok": self.ok,
            "n_comm_calls": self.n_comm_calls,
            "classes": {k: v.to_json_dict() for k, v in sorted(self.classes.items())},
            "violations": list(self.violations),
            "notes": list(self.notes),
        }


# ---------------------------------------------------------------------------
# what a record shows
# ---------------------------------------------------------------------------


def _ring_bytes(c) -> float:
    return ring_wire_bytes(c.kind, c.nbytes, c.group_size)


def _is_packed(c) -> bool:
    """A uint8 plane pipeline (the transport's compressed format): the
    planes' leading dim is the width."""
    return (c.dtype == "uint8" and len(c.shape) >= 1
            and c.kind in ("all-gather", "all-to-all", "reduce-scatter"))


def _plane_width(c) -> int | None:
    return c.shape[0] if _is_packed(c) else None


def _itemsize(c) -> int:
    return getattr(torch, c.dtype).itemsize


def _payload_elems(c) -> int:
    """Logical (pre-packing) element count of the payload (the record's
    shape is already what the ring formula reads)."""
    total = math.prod(c.shape)
    return total // c.shape[0] if _is_packed(c) else total


def describe(c) -> str:
    op = f" {c.op}" if c.op and c.op != "sum" else ""
    return (f"{c.kind}{op}[{c.traffic}|n={c.group_size}] {c.dtype}{list(c.shape)} "
            f"ranks {list(c.group)}")


# ---------------------------------------------------------------------------
# expected inventories (the spec-tree / plan side — independent of the run)
# ---------------------------------------------------------------------------


def _iter_leaf_groups(spec_tree, num_entries, groups_info=None):
    """Yield ``(group_index, LeafSpec)`` for both parameter layouts: the LM
    ``{"groups": [...], <top>}`` tree (top leaves ride the last entry) and
    the CNN ``{"layers": {name: ...}}`` tree (``groups_info`` maps layer
    name -> group)."""
    if "groups" in spec_tree:
        for g, sub in enumerate(spec_tree["groups"]):
            for s in tree_leaves(sub):
                yield g, s
        for k, v in spec_tree.items():
            if k != "groups":
                for s in tree_leaves(v):
                    yield num_entries - 1, s
    elif "layers" in spec_tree and groups_info is not None:
        for name, sub in spec_tree["layers"].items():
            for s in tree_leaves(sub):
                yield groups_info[0][name], s
    else:
        raise ValueError("unrecognized spec tree layout (need 'groups', or 'layers' with "
                         "groups_info)")


def _grad_shape(s: LeafSpec, mesh_cfg: MeshCfg) -> tuple[int, ...]:
    """The rank's gradient of one repetition of a storage leaf: the
    operand shape of its grad-sync all-reduce."""
    if mesh_cfg.trivial or s.kind == REPL:
        return tuple(s.logical)
    if s.kind == TP_SMALL:
        return (1,) + tuple(s.local_logical)
    per = s.pad_rep // mesh_cfg.dshards
    return (1, per) if s.meta.tp_dim is not None else (per,)


@dataclasses.dataclass
class _Expected:
    """Multiset expectations keyed by what a record shows."""

    # (payload_elems, wire_width) -> count
    weight_gathers: Counter
    grad_scatters: Counter
    # (shape, dtype) -> Counter of class tags ("grad_sync" | "metrics")
    dp_psums: dict
    model_psums: dict
    # (axis, shape) -> count: a serve step's logits gathers
    logits: Counter
    dist_elems: list


def _expected_inventory(plan: PrecisionPlan, mesh_cfg: MeshCfg, spec_tree, kind: str,
                        groups_info=None, cfg=None, batch_shape=None) -> _Expected:
    policies = plan.weight_policies()
    num_entries = len(policies)
    n, tp = mesh_cfg.dshards, mesh_cfg.tp
    train = kind in TRAIN_KINDS
    accum = plan.accum_steps if kind == "train" else 1

    weights: Counter = Counter()
    grads: Counter = Counter()
    dp_psums: dict = {}
    model_psums: dict = {}
    logits: Counter = Counter()
    dist_elems = [0] * num_entries

    def add_psum(table, shape, dtype, tag, count=1):
        table.setdefault((tuple(shape), dtype), Counter())[tag] += count

    for g, s in _iter_leaf_groups(spec_tree, num_entries, groups_info):
        pol = policies[g]
        # model-axis grad sync is orthogonal to the storage kind: every
        # flagged leaf, DIST included (compute-replicated leaves whose
        # storage shards over the model axis, e.g. mlstm wq/wk)
        if kind == "train" and tp > 1 and (
                s.meta.grad_sync_model or (plan.seq_parallel and s.meta.grad_sync_seq)):
            add_psum(model_psums, _grad_shape(s, mesh_cfg), "float32", "grad_sync", s.reps)
        if s.kind != DIST:
            if train and n > 1:
                add_psum(dp_psums, _grad_shape(s, mesh_cfg), "float32", "grad_sync", s.reps)
            continue
        dist_elems[g] += s.s_loc * max(n, 1)
        if n <= 1:
            continue  # no gather axis: weights stage host->device
        width = pol.round_to if pol.compresses else FP32_BYTES
        per = s.pad_rep // n  # one repetition's flat shard
        if kind == "place":  # a stacked leaf's repetitions in one gather
            if s.stacked:
                weights[(s.reps * s.pad_rep, width)] += 1
            elif pol.compresses and pol.chunks > 1 and per % pol.chunks == 0:
                weights[(s.pad_rep // pol.chunks, width)] += pol.chunks
            else:
                weights[(s.pad_rep, width)] += 1
            continue
        if pol.compresses and pol.chunks > 1 and per % pol.chunks == 0:
            weights[(s.pad_rep // pol.chunks, width)] += s.reps * pol.chunks * accum
        else:
            weights[(s.pad_rep, width)] += s.reps * accum
        if train:
            gw = pol.grad_round_to if pol.compresses_grads else FP32_BYTES
            grads[(s.pad_rep, gw)] += s.reps * accum

    if kind == "train":
        if n > 1:
            add_psum(dp_psums, (), "float32", "metrics", 2)  # loss + count
            if cfg is not None and cfg.num_experts:
                add_psum(dp_psums, (), "float32", "metrics")  # the aux loss
            add_psum(dp_psums, (num_entries,), "float32", "metrics")
        if tp > 1:
            add_psum(model_psums, (num_entries,), "float32", "metrics")
    elif kind == "cnn_train" and n > 1:
        add_psum(dp_psums, (), "float32", "metrics")  # loss
        add_psum(dp_psums, (num_entries,), "float32", "metrics")
    elif kind in SERVE_KINDS and cfg is not None and batch_shape is not None:
        rows, sharded = batch_shape
        v = eff_vocab(cfg, tp)
        local = rows // n if sharded else rows
        if tp > 1:
            logits[("model", (local, 1, v))] += 1
        if sharded and n > 1:
            logits[("fsdp", (rows, 1, v))] += 1

    return _Expected(weights, grads, dp_psums, model_psums, logits, dist_elems)


# ---------------------------------------------------------------------------
# attribution + verification
# ---------------------------------------------------------------------------


def _take_psum(table, c) -> str | None:
    """Consume one expected all-reduce matching this call; returns its class."""
    tags = table.get((tuple(c.shape), c.dtype))
    if not tags:
        return None
    for tag in ("grad_sync", "metrics"):
        if tags.get(tag, 0) > 0:
            tags[tag] -= 1
            return tag
    return None


def _act_widths(plan: PrecisionPlan) -> set[int]:
    """Plane widths the activation / seq-boundary policies may put on the
    wire (forward and cotangent directions)."""
    widths = set()
    for pol in (plan.activations, plan.seq_policy()):
        if pol is None:
            continue
        if pol.round_to < FP32_BYTES:
            widths.add(pol.round_to)
        if pol.grad_round_to < FP32_BYTES:
            widths.add(pol.grad_round_to)
    return widths


def _axis_ranks(mesh, mesh_cfg: MeshCfg) -> dict:
    """``{ranks: axis}`` of this rank's FSDP and model groups."""
    from repro_torch.dist.comm import _ranks as ranks

    out = {}
    if mesh is None:
        return out
    if mesh_cfg.tp > 1:
        out[ranks(mesh.model)] = "model"
    if mesh_cfg.dshards > 1:
        out[ranks(mesh.fsdp)] = "fsdp"
    return out


def audit_calls(calls, plan: PrecisionPlan, *, mesh_cfg: MeshCfg, mesh, spec_tree,
                kind: str = "train", groups_info=None, cfg=None,
                batch_shape=None) -> AuditReport:
    """Verify recorded ``calls`` (:class:`~repro_torch.dist.comm.CommRecord`
    s of one step of ``kind``) against ``plan``; see :func:`audit_step`."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    n, tp = mesh_cfg.dshards, mesh_cfg.tp
    num_entries = len(spec_tree["groups"]) + 1 if "groups" in spec_tree else groups_info[1]
    plan = plan.broadcast(num_entries)
    exp = _expected_inventory(plan, mesh_cfg, spec_tree, kind, groups_info, cfg,
                              batch_shape)
    axes_of = _axis_ranks(mesh, mesh_cfg)
    act_widths = _act_widths(plan)
    act_pol = plan.seq_policy() if plan.seq_parallel else plan.activations
    boundary_class = "seq_boundary" if plan.seq_parallel else "activations"

    classes: dict[str, ClassTotal] = {}
    violations: list[str] = []
    notes: list[str] = []

    def tally(name, c, analytic, structural=False):
        allowed = _LABELS.get(name, {name})
        if c.traffic not in allowed:
            violations.append(f"label {c.traffic!r} on a call attributed to {name}: "
                              f"{describe(c)}")
        t = classes.setdefault(name, ClassTotal())
        t.calls += 1
        t.recorded_bytes += _ring_bytes(c)
        t.analytic_bytes += analytic
        t.structural = t.structural or structural

    got_weights: Counter = Counter()
    got_grads: Counter = Counter()
    got_logits: Counter = Counter()

    for c in calls:
        axis = axes_of.get(tuple(c.group))
        if c.kind in ("gather", "scatter"):
            violations.append(f"checkpoint transfer inside the step: {describe(c)}")
            continue
        if c.kind not in ("all-gather", "all-to-all", "reduce-scatter", "all-reduce"):
            violations.append(f"unknown collective kind: {describe(c)}")
            continue
        logits_key = (axis, tuple(c.shape))
        if (c.kind == "all-gather" and not _is_packed(c)
                and got_logits[logits_key] < exp.logits[logits_key]):
            got_logits[logits_key] += 1
            tally("logits", c, _ring_bytes(c))
            continue
        if axis == "fsdp":
            width = _plane_width(c) or _itemsize(c)
            if c.kind == "all-gather":
                got_weights[(_payload_elems(c), width)] += 1
                tally("weights", c,
                      ring_wire_bytes("all-gather", _payload_elems(c) * width, n))
            elif c.kind in ("all-to-all", "reduce-scatter"):
                got_grads[(_payload_elems(c), width)] += 1
                tally("gradients", c,
                      ring_wire_bytes("reduce-scatter", _payload_elems(c) * width, n))
            elif c.op == "sum":
                tag = _take_psum(exp.dp_psums, c)
                if tag is None:
                    violations.append(f"unattributed data-axis all-reduce: {describe(c)}")
                else:
                    tally(tag, c, _ring_bytes(c))
            else:
                violations.append(f"unattributed data-axis collective: {describe(c)}")
        elif axis == "model":
            if c.kind == "all-reduce" and c.op != "sum":
                # min/max all-reduces (the vocab-parallel softmax max) are
                # exempt from the plane-compression contract: the uint8
                # pipeline relies on sums being ring-splittable, which
                # max/min are not — raw dtype IS their wire format
                tally(boundary_class, c, _ring_bytes(c), structural=True)
                continue
            if c.kind == "all-reduce":
                tag = _take_psum(exp.model_psums, c)
                if tag is not None:
                    tally(tag, c, _ring_bytes(c))
                    continue
                if len(c.shape) == 0:
                    # per-layer scalar reductions (the MoE aux loss): metrics
                    tally("metrics", c, _ring_bytes(c), structural=True)
                    continue
                # raw all-reduce on the activation path: legal only where
                # the transport's own fallback rule would emit one
                compressing = act_pol is not None and (
                    act_pol.round_to < FP32_BYTES or act_pol.grad_round_to < FP32_BYTES)
                if compressing and pick_split_axis(c.shape, tp) is not None:
                    violations.append("raw all-reduce inside a compressing activation "
                                      f"region (expected uint8 planes): {describe(c)}")
                    continue
                if act_pol is None:
                    analytic = _ring_bytes(c)
                else:
                    analytic = act_pol.all_reduce_wire_bytes(
                        math.prod(c.shape), tp, uncompressed_bytes=_itemsize(c))
                tally(boundary_class, c, analytic, structural=True)
            elif _is_packed(c):
                width = _plane_width(c)
                if width not in act_widths:
                    violations.append(f"plane width {width} not declared by the plan's "
                                      f"activation/seq policies {sorted(act_widths)}: "
                                      f"{describe(c)}")
                    continue
                grad = width == act_pol.grad_round_to and width != act_pol.round_to
                elems = _payload_elems(c)
                if c.kind == "all-gather":
                    analytic = act_pol.seq_gather_wire_bytes(elems, tp, grad=grad)
                else:
                    analytic = act_pol.seq_scatter_wire_bytes(elems, tp, grad=grad)
                tally(boundary_class, c, analytic, structural=True)
            else:
                # raw-dtype re-layout: seq_split / seq_merge, the MoE ep
                # exchanges, uncompressed boundary legs — lossless, priced
                # at the payload's own width
                tally("relayout", c, _ring_bytes(c), structural=True)
        else:
            violations.append(f"collective over a group that is neither this rank's FSDP "
                              f"nor its model group: {describe(c)}")

    # -- inventory diffs ---------------------------------------------------
    def diff(name, got: Counter, want: Counter):
        for key in sorted(set(got) | set(want), key=str):
            d = got[key] - want[key]
            if name == "logits":
                what = f"{key[0]}-axis gather of {list(key[1])}"
            else:
                what = f"of {key[0]} elems at {key[1]} B/elem"
            if d > 0:
                widths = sorted({w for _, w in want}) if name != "logits" else []
                violations.append(f"{name}: {d} unexpected collective(s) {what}"
                                  + (f" (plan promised widths {widths})" if widths else ""))
            elif d < 0:
                violations.append(f"{name}: {-d} missing collective(s) {what}")

    diff("weights", got_weights, exp.weight_gathers)
    diff("gradients", got_grads, exp.grad_scatters)
    diff("logits", got_logits, exp.logits)
    for table, where in ((exp.dp_psums, "data"), (exp.model_psums, "model")):
        for (shape, dtype), tags in table.items():
            for tag, cnt in tags.items():
                if cnt > 0:
                    violations.append(f"{tag}: missing {cnt} {where}-axis all-reduce(s) of "
                                      f"{dtype}{list(shape)}")

    # -- analytic totals for the independent classes -----------------------
    accum = plan.accum_steps if kind == "train" else 1
    table = plan.wire_table(exp.dist_elems, n, training=kind in TRAIN_KINDS, tp=tp)
    for name in ("weights", "gradients"):
        want = table[name] * accum
        c = classes.get(name)
        have = round(c.analytic_bytes) if c else 0
        if have != round(want):
            violations.append(f"{name}: analytic bytes {have} != wire_table {want} "
                              "(per-call policy pricing drifted from the plan table)")
        elif c is not None:
            c.analytic_bytes = float(want)
    if n <= 1 and table["host_device"]:
        classes["host_device"] = ClassTotal(analytic_bytes=float(table["host_device"]),
                                            structural=True)
        notes.append("host_device is accounting-only: staging happens outside the step "
                     "(no collective carries it); bytes from the plan's host_device entry")
    for name in ("kv_migration", "weight_publish"):
        if table[name]:
            classes[name] = ClassTotal(analytic_bytes=float(table[name]), structural=True)
        if getattr(plan, name, None) is not None:
            notes.append(f"{name} is accounting-only: fleet fabric parcels cross between "
                         "processes (no collective carries them); measured bytes live in "
                         "the FabricChannel hop log, pinned against "
                         "roofline.fleet_migration_bytes")

    # -- the byte pin ------------------------------------------------------
    for name, c in sorted(classes.items()):
        if name in ("host_device", "kv_migration", "weight_publish"):
            continue
        if round(c.recorded_bytes) != round(c.analytic_bytes):
            violations.append(f"{name}: recorded wire bytes {round(c.recorded_bytes)} != "
                              f"analytic {round(c.analytic_bytes)}")

    mesh_str = (f"{mesh_cfg.pods}x{mesh_cfg.dp}x{mesh_cfg.tp}" if mesh_cfg.pods > 1
                else f"{mesh_cfg.dp}x{mesh_cfg.tp}")
    return AuditReport(kind=kind, mesh=mesh_str, classes=classes, violations=violations,
                       n_comm_calls=len(calls), notes=notes)


def audit_step(step_fn, args, plan: PrecisionPlan, *, mesh_cfg: MeshCfg, mesh, spec_tree,
               kind: str = "train", groups_info=None, cfg=None,
               batch_shape=None) -> AuditReport:
    """Run ``step_fn(*args)`` and verify its data motion against ``plan``.
    Call inside :func:`~repro_torch.audit.record.recording` (``mesh`` is
    the recording's); returns an :class:`AuditReport`: call
    ``report.raise_if_failed()`` (or check ``report.ok``) to enforce.

    ``step_fn`` is any step-factory product (train / cnn_train / prefill
    / decode / place: pass the matching ``kind``) and ``args`` the fake
    inputs it runs on; ``spec_tree`` the parameter spec tree the step was
    built from (``groups_info`` additionally for the CNN layout). ``cfg``
    prices the port's own calls: the MoE aux loss of a train step and,
    with ``batch_shape`` ``(global rows, shard_batch)``, a serve step's
    logits gathers."""
    calls = collect_comm_calls(step_fn, *args)
    return audit_calls(calls, plan, mesh_cfg=mesh_cfg, mesh=mesh, spec_tree=spec_tree,
                       kind=kind, groups_info=groups_info, cfg=cfg, batch_shape=batch_shape)
