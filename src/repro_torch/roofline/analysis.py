"""Roofline and analytic byte models (counterpart of
``repro.roofline.analysis``): the hardware constants of the card the port
runs on, :func:`model_flops_estimate`, the three-term
:func:`roofline_from_run`, and the serve-wire, speculative serve-wire,
paged-residency, training-ingest, checkpoint and fleet-fabric models.
The byte models and ``model_flops_estimate`` are pure arithmetic on the
policy formulas, the config and shard manifests, so their outputs must
equal the reference's exactly.

The reference's HLO readers have no counterpart: ``parse_collectives``
and ``shape_bytes`` parse XLA's HLO text, which PyTorch does not make.
:func:`roofline_from_run` takes the same inputs from a run instead
(:mod:`repro_torch.roofline.cost`: FLOPs from ``FlopCounterMode``, bytes
from every op's inputs and outputs, wire from the recorded collectives).
"""
from __future__ import annotations

import dataclasses
import math

# The card: NVIDIA H100 SXM (NVIDIA's data sheet, dense rates), the figures
# every bound of the kernel table uses; they assume the full 700 W power
# limit (the H100 80GB HBM3 the port is measured on reports 700.00 W).
PEAK_FLOPS_FP32 = 67e12     # FLOP/s, fp32 outside the tensor cores (TF32 is off)
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, bf16 on the tensor cores
HBM_BW = 3.35e12            # bytes/s
# The collective path every ``dist.comm`` call takes today: gloo through
# host memory, ranks sharing one card, each CUDA tensor staged to the
# host and back. Measured by ``chip_smoke.py`` phase 23 (a) on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit: the median of a 1 KiB u8
# ``comm.all_gather`` over two ranks is the latency (1,451.1 us); the
# ring wire bytes of a 64 MiB-a-rank one (67,108,864 B) over its median
# (202.64 ms) less the latency is the rate. NCCL with one rank per card
# will change both.
LINK_BW = 3.336e8             # bytes/s of ring wire
COLLECTIVE_LATENCY = 1.4511e-3  # s per collective call


def serve_host_device_bytes(
    plan_or_policy,
    vocab_size: int,
    *,
    n_slots: int,
    prompt_lens,
    decode_steps: int,
    page_table_entries: int = 0,
) -> dict:
    """Host<->device staging bytes of one continuous-batching engine run;
    ``ServeEngine.wire_summary()["host_device"]`` must equal ``total``
    for the run's observed geometry:

      * ``prompt_h2d``      — each admitted prompt staged once, h2d;
      * ``first_token_d2h`` — one sampled id per admission, d2h;
      * ``decode_token_io`` — per decode step the full slot batch both
        ways (feed h2d + sampled ids d2h), retired-slot ballast included;
      * ``page_table_h2d``  — paged engines' page table (raw int32) per
        decode step; 0 entries for the contiguous layout.
    """
    pol = plan_or_policy
    if hasattr(pol, "host_device_policies"):  # a PrecisionPlan
        pol = pol.host_device_policies()[0]
    prompt_lens = list(prompt_lens)
    tok = pol.token_host_bytes
    table = {
        "prompt_h2d": tok(sum(prompt_lens), vocab_size),
        "first_token_d2h": tok(len(prompt_lens), vocab_size),
        "decode_token_io": 2 * tok(n_slots, vocab_size) * int(decode_steps),
        "page_table_h2d": 4 * int(page_table_entries) * int(decode_steps),
        "token_width": pol.token_wire_width(vocab_size),
    }
    table["total"] = (
        table["prompt_h2d"] + table["first_token_d2h"]
        + table["decode_token_io"] + table["page_table_h2d"]
    )
    return table


def serve_spec_decode_bytes(
    plan_or_policy,
    vocab_size: int,
    *,
    n_slots: int,
    prompt_lens,
    spec_rounds: int,
    spec_k: int,
    page_table_entries: int = 0,
) -> dict:
    """Host<->device staging bytes of one speculative engine run;
    ``ServeEngine.wire_summary()["host_device"]`` must equal ``total``.
    The arithmetic of :func:`serve_host_device_bytes`, reshaped by the
    draft/verify protocol (``T = spec_k + 1``):

      * ``prompt_h2d``      — each admitted prompt staged once, h2d (the
        draft prefills from the same staged device tokens);
      * ``first_token_d2h`` — one sampled id per admission, d2h;
      * ``draft_h2d``       — per round ``T`` draft micro steps, each
        feeding the full slot batch one token h2d;
      * ``draft_d2h``       — per round ``k`` proposal batches d2h (the
        last micro step only absorbs);
      * ``verify_token_io`` — per round the ``(B, T)`` verify block h2d and
        the ``T`` verified ids a slot d2h;
      * ``page_table_h2d``  — paged engines' (spec-widened) table per
        verify step, raw int32.
    """
    pol = plan_or_policy
    if hasattr(pol, "host_device_policies"):  # a PrecisionPlan
        pol = pol.host_device_policies()[0]
    prompt_lens = list(prompt_lens)
    tok = pol.token_host_bytes
    rounds, k = int(spec_rounds), int(spec_k)
    T = k + 1
    table = {
        "prompt_h2d": tok(sum(prompt_lens), vocab_size),
        "first_token_d2h": tok(len(prompt_lens), vocab_size),
        "draft_h2d": rounds * tok(n_slots * T, vocab_size),
        "draft_d2h": rounds * tok(n_slots * k, vocab_size),
        "verify_token_io": 2 * rounds * tok(n_slots * T, vocab_size),
        "page_table_h2d": 4 * int(page_table_entries) * rounds,
        "token_width": pol.token_wire_width(vocab_size),
    }
    table["total"] = (
        table["prompt_h2d"] + table["first_token_d2h"]
        + table["draft_h2d"] + table["draft_d2h"]
        + table["verify_token_io"] + table["page_table_h2d"]
    )
    return table


def serve_paged_kv_bytes(
    cfg,
    *,
    page_size: int,
    requests,
    shared_prefix_len: int = 0,
    int8_kv: bool = False,
    dtype_bytes: int = 4,
) -> dict:
    """Page-granular KV residency of the paged serve engine when every
    request is resident at once: ``ServeEngine.kv_residency()["pages_peak"]``
    must equal ``pages`` then.

    ``requests`` is an iterable of ``(prompt_len, max_new_tokens)``;
    ``shared_prefix_len`` tokens are common to ALL requests, so their whole
    pages (``shared_prefix_len // page_size``) are stored once instead of
    per request. Per page, every attention layer holds K + V: ``2 *
    page_size * num_kv_heads * head_dim`` elements of ``dtype_bytes`` (1
    for int8 KV, which then adds two fp32 scale planes of ``page_size *
    num_kv_heads`` each).
    """
    reqs = list(requests)
    layers = cfg.num_groups * cfg.layers_per_group
    attn_frac = sum(1 for k in cfg.pattern if k == "attn") / len(cfg.pattern)
    attn_layers = int(layers * attn_frac)
    kv_elems = page_size * cfg.num_kv_heads * cfg.head_dim
    per_layer = 2 * kv_elems * (1 if int8_kv else dtype_bytes)
    if int8_kv:
        per_layer += 2 * page_size * cfg.num_kv_heads * 4  # fp32 scales
    bytes_per_page = per_layer * attn_layers
    shared_pages = shared_prefix_len // page_size
    private_pages = sum(-(-(s + g) // page_size) - shared_pages for s, g in reqs)
    pages = shared_pages + private_pages
    return {
        "bytes_per_page": bytes_per_page,
        "shared_pages": shared_pages,
        "private_pages": private_pages,
        "pages": pages,
        "kv_bytes_resident": pages * bytes_per_page,
    }


def train_ingest_bytes(plan_or_policy, vocab_size: int, *, kind: str, batch: int, seq: int,
                       steps: int, dim: int = 0, reader=None) -> dict:
    """Training-ingest bytes of ``steps`` batches fed from the tiered shard
    pipeline; the prefetcher's per-step ``io_by_entry`` must sum to it:

      * ``shard_read`` — stored bytes the reader moves off disk,
        :meth:`~repro_torch.data.shards.ShardReader.planned_bytes` from the
        reader's *current* position (0 without a ``reader``);
      * ``ingest_h2d`` — bytes staged host->device at the plan's
        ``host_device`` policy: the ids
        (:func:`~repro_torch.data.prefetch.staged_ids_per_batch` a batch)
        at ``token_wire_width``, plus raw fp32 features
        (``batch·seq·dim·4``)."""
    from repro_torch.data.prefetch import resolve_policy, staged_ids_per_batch

    pol = resolve_policy(plan_or_policy)
    steps = int(steps)
    ids = staged_ids_per_batch(kind, batch, seq) * steps
    float_bytes = 4 * batch * seq * int(dim) * steps if kind == "feature" else 0
    table = {
        "shard_read": reader.planned_bytes(batch * steps) if reader is not None else 0,
        "ingest_h2d": pol.token_host_bytes(ids, vocab_size) + float_bytes,
        "token_width": pol.token_wire_width(vocab_size),
    }
    table["total"] = table["shard_read"] + table["ingest_h2d"]
    return table


def train_checkpoint_bytes(storage_like, opt_like=None, *, spec_tree=None, round_tos=None,
                           residuals: bool = True) -> dict:
    """Bytes of one width-aware sharded checkpoint; must equal
    :func:`repro_torch.checkpoint.sharded.manifest_bytes` of the written
    directory and the summed sizes of its ``.bin`` files. Walks the
    writer's own :func:`~repro_torch.checkpoint.sharded.assign_widths`: a
    compressible fp32 leaf of a group at ``round_to`` rt costs ``elems·rt``
    wire bytes (+ ``elems·(4-rt)`` residual bytes with ``residuals``);
    every other storage leaf and the whole optimizer tree cost full
    width. Leaves may be tensors or arrays: only shapes and dtypes are
    read."""
    from repro_torch.checkpoint.sharded import assign_widths, leaf_entries, np_dtype

    widths: dict[str, int] = {}
    if round_tos is not None and spec_tree is not None:
        widths = assign_widths(storage_like, spec_tree, round_tos)
    wire = residual = 0
    for tree, use_widths in ((storage_like, True), (opt_like, False)):
        if tree is None:
            continue
        for kpath, leaf in leaf_entries(tree):
            n = math.prod(leaf.shape) if len(leaf.shape) else 1
            full = np_dtype(leaf).itemsize
            w = widths.get(kpath, full) if use_widths else full
            wire += n * w
            if residuals and w < full:
                residual += n * (full - w)
    return {"wire": wire, "residual": residual, "total": wire + residual}


def fleet_migration_bytes(plan_or_policy, cfg, *, page_size: int, migrated_pages: int,
                          int8_kv: bool = False, dtype_bytes: int = 4,
                          publish_wire_bytes: int = 0, publish_installs: int = 0) -> dict:
    """Fleet-fabric bytes of a disaggregated serving run; the
    :class:`~repro_torch.transport.fabric.FabricChannel` hop log must equal
    both classes exactly:

      * ``kv_migration`` — each migrated page ships every attention layer's
        K + V at the ``kv_migration`` policy's ``kv_wire_width`` (the
        :func:`serve_paged_kv_bytes` geometry at wire width; int8 pools add
        their fp32 scale rows at ``kv_wire_width(4)``); ``migrated_pages``
        counts the run's new (not shared-prefix) prompt pages;
      * ``weight_publish`` — each replica install (join or refresh) moves
        one weight parcel of ``publish_wire_bytes``."""
    pol = plan_or_policy
    if hasattr(pol, "kv_migration_policy"):  # a PrecisionPlan
        pol = pol.kv_migration_policy()
    layers = cfg.num_groups * cfg.layers_per_group
    attn_frac = sum(1 for k in cfg.pattern if k == "attn") / len(cfg.pattern)
    attn_layers = int(layers * attn_frac)
    kv_elems = page_size * cfg.num_kv_heads * cfg.head_dim
    kv_width = pol.kv_wire_width(1 if int8_kv else dtype_bytes)
    per_layer = 2 * kv_elems * kv_width
    if int8_kv:
        per_layer += 2 * page_size * cfg.num_kv_heads * pol.kv_wire_width(4)
    page_wire_bytes = per_layer * attn_layers
    table = {
        "page_wire_bytes": page_wire_bytes,
        "kv_width": kv_width,
        "migrated_pages": int(migrated_pages),
        "kv_migration": page_wire_bytes * int(migrated_pages),
        "weight_publish": int(publish_wire_bytes) * int(publish_installs),
    }
    table["total"] = table["kv_migration"] + table["weight_publish"]
    return table


def model_flops_estimate(cfg, shape, chips: int) -> float:
    """6·N_active·D per device (decode: D = new tokens = batch)."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / chips
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch / chips


@dataclasses.dataclass
class Roofline:
    """The reference's ``Roofline`` fields, from a run on one rank."""

    flops: float
    hbm_bytes: float
    wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    collectives: dict

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_from_run(cost, calls, model_flops_per_device: float, *, plan=None,
                      plan_geometry: dict | None = None,
                      peak_flops: float = PEAK_FLOPS_FP32) -> Roofline:
    """Three-term roofline of one step on one rank (the counterpart of
    ``roofline_from_compiled``):

      compute term    = FLOPs / ``peak_flops``
      memory term     = bytes / ``HBM_BW``
      collective term = ring wire bytes / ``LINK_BW``

    ``cost`` is a :class:`~repro_torch.roofline.cost.Cost` of the step
    (its ``flops`` and ``bytes``); ``calls`` the step's recorded
    collectives (``dist.comm`` records), whose ring wire bytes are
    summed by kind and split into packed planes (uint8 payloads: the
    compressed weight, gradient and activation pipelines) and the rest.
    Every call is charged at the width it moved: the port's collectives
    run in the compute dtype, so no correction for a promoted psum
    applies (the reference's ``act_bytes``). ``plan`` + ``plan_geometry``
    (``dist_elems_per_group``, ``gather_axis_size``, optional
    ``training``) add the wire per plan entry
    (:func:`~repro_torch.roofline.cost.plan_wire_split`) in
    ``collectives["per_plan_entry"]``. The terms use the card's constants
    above; pass ``peak_flops=PEAK_FLOPS_BF16`` for a bf16 step."""
    from repro_torch.roofline.cost import plan_wire_split, wire_by_kind

    wire, plane = wire_by_kind(calls)
    counts: dict[str, int] = {}
    for c in calls:
        counts[c.kind] = counts.get(c.kind, 0) + 1
    wire_total = sum(wire.values())
    compute_s = cost.flops / peak_flops
    memory_s = cost.bytes / HBM_BW
    coll_s = wire_total / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    per_plan_entry = None
    if plan is not None:
        per_plan_entry = plan_wire_split(calls, plan, **(plan_geometry or {}))
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes,
        wire_bytes=float(wire_total),
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=coll_s,
        dominant=max(terms, key=terms.get),
        model_flops=model_flops_per_device,
        useful_ratio=model_flops_per_device / cost.flops if cost.flops else 0.0,
        collectives={
            "counts": counts,
            "wire_bytes": wire,
            # packed-plane (compressed transport) share of wire_bytes
            "plane_wire_bytes": plane,
            "plane_wire_total": sum(plane.values()),
            "per_plan_entry": per_plan_entry,
        },
    )
