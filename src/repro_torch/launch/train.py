"""Training launcher (twin of ``repro.launch.train``): the A²DTWP loop
(AWP controller + ADT weight transfer) on the synthetic k-gram token
stream, on one GPU or on an FSDP×TP mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --steps 25 --awp-interval 5 --awp-threshold 1e-3 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --mesh 2x2 --steps 2 --policy oracle:2 --act-round-to 2 [--device cpu]

Weights are random, from seed 0 (``repro_torch.models.init``); batches
are ``synthetic_lm_batch(vocab, batch, seq, step)``, the reference's (an
audio arch's ``synthetic_feature_batch(vision_dim, vocab, batch, seq,
step)``; a vision arch adds each step's ``image_features``, ``(batch,
num_image_tokens, vision_dim)`` normals from one ``default_rng(0)`` drawn
step after step, as the reference's launcher draws them).
``--mesh`` is ``DPxTP`` or ``PODSxDPxTP``: anything but ``1x1`` runs
``pods × dp × tp`` ranks, processes spawned by
``repro_torch.launch.mesh.spawn_ranks`` that meet in a gloo group (on
the card they share it, or take one each where there are several); each
rank holds its blocks of the weights, and builds them in turn with the
others waiting, so that one whole model at a time is on a card. The
precision flags build the plan as the reference's do: ``--grad-round-to``
/ ``--grad-mode`` (truncate or nearest) the gradient reduce-scatter,
``--act-round-to`` the TP-region all-reduces, ``--seq-parallel`` the
sequence-parallel layout, ``--chunks`` the gather's plane blocks
(``auto``: :func:`~repro_torch.plan.sweep.pick_chunks` at the largest
``DIST`` shard, under the port's hardware constants, the count printed as
the reference's launcher prints it),
``--bf16`` the bf16 compute dtype, ``--accum`` the micro-batches a step
sums. ``--grad-mode stochastic`` (or a plan with a stochastic entry)
gives each step the key ``PRNGKey(step)``, as the reference's launcher.
Prints the reference launcher's ``step``, ``done: ... wire-reduction``,
``wire by plan entry`` and ``AWP: ...`` lines (rank 0's), and on a mesh
one more: the collectives' measured wire by class against
:func:`~repro_torch.train.step.step_wire_table`. Runs on ``cuda`` unless
``--device cpu``.

Training I/O, on any mesh: ``--data-dir`` trains from a shard
directory (``python -m repro_torch.data.write``) through the
:class:`~repro_torch.data.prefetch.Prefetcher` (``--data-quality``,
``--prefetch-depth``), the shards' meta checked against the run, and
prints the measured ingest bytes against
:func:`~repro_torch.roofline.analysis.train_ingest_bytes`; ``--ckpt``
writes a width-aware sharded checkpoint at the end (and every
``--ckpt-every`` steps, on a worker thread with ``--async-ckpt``) with the
plan and the consumed batch's data state; ``--resume`` restores storage,
momentum, the AWP state and the data position from ``--ckpt`` and runs on
to ``--steps``. A ``--plan`` may carry a ``host_device`` entry (the
ingest's staging width and the ``host_device`` wire entry). On a mesh every
rank reads the whole global batch through its own reader and prefetcher
(each is deterministic from ``seed=0`` and the data state) and the step
takes the rank's rows, as the reference's step slices its global batch:
the ingest bytes are per rank, each rank's equal to
``train_ingest_bytes`` of the global batch, which the reference reckons
per step on its one host. A checkpoint is gathered to rank 0, which writes
the global state (byte-equal to the reference's at the same mesh), and a
resume reads it on rank 0 and scatters each rank its blocks; the data
state saved is the consumed batch's, checked equal on every rank.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --steps 6 --data-dir shards/ --ckpt ck --ckpt-every 3 --async-ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
      --steps 6 --data-dir shards/ --ckpt ck --resume [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import fp32_math, resolve_device
from repro_torch import random as _random
from repro_torch.checkpoint.ckpt import (
    AsyncCheckpointer, load_checkpoint, load_extra, save_checkpoint,
)
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.data.pipeline import synthetic_feature_batch, synthetic_lm_batch
from repro_torch.data.prefetch import Prefetcher
from repro_torch.data.shards import ShardReader, batches
from repro_torch.dist.spec import (
    DIST, MeshCfg, build_spec_tree, dist_elems_per_group, leaf_to_local, tree_to_storage,
)
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan, pick_chunks
from repro_torch.roofline.analysis import train_ingest_bytes
from repro_torch.train.loop import Trainer
from repro_torch.train.step import COLLECTIVE_CLASSES, make_train_step, step_wire_table
from repro_torch.utils.trees import tree_leaves, tree_map


def parse_mesh(spec: str) -> MeshCfg:
    """"1x1" | "<dp>x<tp>" | "<pods>x<dp>x<tp>"."""
    parts = [int(p) for p in spec.split("x")]
    if len(parts) == 2:
        return MeshCfg(tp=parts[1], dp=parts[0])
    if len(parts) == 3:
        return MeshCfg(tp=parts[2], dp=parts[1], pods=parts[0])
    raise SystemExit(f"bad --mesh {spec!r}")


def auto_chunks(spec_tree, mesh_cfg: MeshCfg, round_to: int, **hw) -> tuple[int, int]:
    """``(chunks, s_loc)`` of ``--chunks auto``: :func:`pick_chunks` at the
    largest ``DIST`` leaf's flat shard ``s_loc`` over the FSDP ranks, for a
    gather at ``round_to`` (the reference's representative shard). ``hw``:
    the sweep's hardware keywords (the port's constants by default)."""
    s_loc = max((s.s_loc for s in tree_leaves(spec_tree) if s.kind == DIST), default=0)
    return pick_chunks(s_loc, max(mesh_cfg.dshards, 1), round_to, **hw), s_loc


def plan_from_args(args, nrt: int, spec_tree, mesh_cfg: MeshCfg, *,
                   say=print) -> PrecisionPlan:
    """CLI flags -> PrecisionPlan (``--plan`` wins outright). ``--chunks
    auto`` reads ``spec_tree`` and ``mesh_cfg`` and reports its choice
    through ``say``."""
    if args.plan:
        return PrecisionPlan.from_file(args.plan).broadcast(nrt)
    schedule, round_to = "awp", 4
    if args.policy == "baseline":
        schedule = "static"
    elif args.policy.startswith("oracle:"):
        schedule, round_to = "static", int(args.policy.split(":")[1])
    elif args.policy != "awp":
        raise SystemExit(f"bad --policy {args.policy!r}")
    if args.chunks == "auto":
        # under AWP the gather starts at 8 bits: round_to 1
        chunks, s_loc = auto_chunks(spec_tree, mesh_cfg, round_to if schedule == "static" else 1)
        say(f"--chunks auto -> {chunks} (roofline sweep, s_loc={s_loc})")
    else:
        chunks = int(args.chunks)
    return PrecisionPlan.build(
        nrt, round_to=round_to, grad_round_to=args.grad_round_to,
        grad_mode=args.grad_mode, act_round_to=args.act_round_to,
        seq_parallel=args.seq_parallel, chunks=chunks,
        dtype="bf16" if args.bf16 else "f32", accum_steps=args.accum, schedule=schedule,
        awp_threshold=args.awp_threshold, awp_interval=args.awp_interval,
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--plan", default="", help="PrecisionPlan JSON (weights + schedule)")
    ap.add_argument("--policy", default="awp", help="awp | baseline | oracle:<rt>")
    ap.add_argument("--awp-threshold", type=float, default=1e-3)
    ap.add_argument("--awp-interval", type=int, default=25)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--grad-round-to", type=int, default=4)
    ap.add_argument("--grad-mode", default="nearest",
                    choices=["truncate", "nearest", "stochastic"])
    ap.add_argument("--act-round-to", type=int, default=4)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--chunks", default="1")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-dir", default="",
                    help="train from a tiered shard dir (repro_torch.data.write) through "
                         "the prefetcher instead of making batches inline")
    ap.add_argument("--data-quality", type=int, default=4,
                    help="progressive-record tier: float payloads read only their N most "
                         "significant byte planes (ids are always lossless)")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--losses-out", default="",
                    help="write the per-step loss stream as JSON")
    ap.add_argument("--check", default="",
                    help="reference losses JSON: exit nonzero unless this run's "
                         "losses are bit-exact on the overlapping steps")
    ap.add_argument("--device", default="cuda")
    return ap


def setup(cfg, mesh_cfg: MeshCfg, *, device, params=None, rank: int = 0, visit=None):
    """``(spec_tree, storage, momentum)`` of rank ``rank``
    (:func:`setup_storage`, and zero momentum beside the storage)."""
    spec_tree, storage = setup_storage(cfg, mesh_cfg, device=device, params=params,
                                       rank=rank, visit=visit)
    return spec_tree, storage, init_momentum(storage)


def setup_storage(cfg, mesh_cfg: MeshCfg, *, device, params=None, rank: int = 0,
                  visit=None, seed: int = 0):
    """``(spec_tree, storage)`` of rank ``rank``: random weights from
    ``seed`` on ``device``, or ``params`` (a port LM tree at the mesh's
    ``tp``, e.g. converted reference weights). On a mesh the storage is
    the rank's blocks, laid out leaf by leaf from the whole model, which
    the ranks build in turn behind a barrier (one whole model at a time
    on a shared card); there ``visit(leaf, spec)``, if given, sees each
    whole leaf before it is freed."""
    shapes, metas = init_params(cfg, device="meta", tp=mesh_cfg.tp)
    if mesh_cfg.trivial:
        if params is None:
            params, _ = init_params(cfg, seed, device=device)
        spec_tree = build_spec_tree(params, metas, mesh_cfg)
        return spec_tree, tree_to_storage(params, spec_tree, mesh_cfg)
    spec_tree = build_spec_tree(shapes, metas, mesh_cfg)
    storage = None
    for turn in range(dist.get_world_size()):
        if turn == rank:
            whole = params
            if whole is None:
                whole, _ = init_params(cfg, seed, device=device, tp=mesh_cfg.tp)

            def local(s, x):
                if visit is not None:
                    visit(x, s)
                return leaf_to_local(x.to(device), s, mesh_cfg, rank)

            storage = tree_map(local, spec_tree, whole)  # in the spec tree's order
            del whole
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return spec_tree, storage


def rank_device(args, rank: int, world: int) -> torch.device:
    """``args.device``; on the card with several ranks, rank ``rank``'s card
    (the ranks share the cards in turn)."""
    device = resolve_device(args.device)
    if device.type == "cuda" and world > 1:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def open_shards(args, cfg, plan, device, *, data_state=None, steps: int):
    """``(reader, prefetcher, ingest)`` for ``--data-dir``: the reader at
    ``data_state`` (a resumed run's), its meta checked against the run, the
    analytic ingest bytes of ``steps`` batches priced from its position
    before the prefetcher reads ahead, and the prefetcher."""
    reader = ShardReader(args.data_dir, quality=args.data_quality, seed=0)
    want_kind = "feature" if cfg.embed_is_input_stub else "lm"
    if reader.kind != want_kind:
        raise SystemExit(f"--data-dir holds {reader.kind!r} shards, arch needs {want_kind!r}")
    for key, want in (("vocab", cfg.vocab_size), ("seq", args.seq)):
        got = reader.meta.get(key)
        if got is not None and got != want:
            raise SystemExit(f"--data-dir {key}={got} does not match run {key}={want}")
    if data_state is not None:
        reader.load_state(data_state)
    ingest = train_ingest_bytes(plan, cfg.vocab_size, kind=reader.kind, batch=args.batch,
                                seq=args.seq, steps=steps, dim=cfg.vision_dim, reader=reader)
    prefetcher = Prefetcher(batches(reader, args.batch), kind=reader.kind, vocab=cfg.vocab_size,
                            plan=plan, depth=args.prefetch_depth, device=device)
    return reader, prefetcher, ingest


def _train(rank: int, args, params=None, cfg=None) -> dict:
    """The training loop of :func:`main` on rank ``rank`` (the only one on
    ``1x1``); returns plain data: the header, the trainer's summary, the
    step records, the per-step step-wire tables, the I/O lines and the
    plan's chunk count. ``cfg`` replaces ``--arch``'s config."""
    fp32_math()
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    mesh_cfg = parse_mesh(args.mesh)
    world = mesh_cfg.dshards * mesh_cfg.tp
    device = rank_device(args, rank, world)
    mesh = make_mesh_from_cfg(mesh_cfg)
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, params=params, rank=rank)
    nrt = cfg.num_groups + 1
    plan = plan_from_args(args, nrt, spec_tree, mesh_cfg,
                          say=print if rank == 0 else (lambda _: None))
    B, S = args.batch, args.seq
    opt = SGDConfig(lr=args.lr, momentum=0.9, weight_decay=1e-4)
    audio = cfg.embed_is_input_stub
    batch_shapes = {"features": (B, S, cfg.vision_dim)} if audio else {"tokens": (B, S)}
    batch_shapes["labels"] = (B, S)
    if cfg.num_image_tokens:
        batch_shapes["image_features"] = (B, cfg.num_image_tokens, cfg.vision_dim)

    def builder(round_tos):
        return make_train_step(cfg, mesh_cfg, mesh, spec_tree, opt, batch_shapes,
                               plan=plan.with_round_tos(round_tos))

    trainer = Trainer(builder, nrt, plan=plan,
                      dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, nrt),
                      gather_axis_size=max(mesh_cfg.dshards, 1))
    notes = {"resumed": None, "ingest": None, "ckpt": None}
    # -- resume: storage, momentum, AWP state and the data position
    start_step, data_state = 0, None
    if args.resume:
        if not args.ckpt:
            raise SystemExit("--resume needs --ckpt")
        storage, mom, start_step = load_checkpoint(args.ckpt, storage, mom, trainer.controller,
                                                   spec_tree=spec_tree, mesh_cfg=mesh_cfg)
        data_state = load_extra(args.ckpt).get("data_state")
        notes["resumed"] = f"resumed {args.ckpt} at step {start_step}"
    if start_step >= args.steps:
        raise SystemExit(f"checkpoint step {start_step} >= --steps {args.steps}")
    reader = prefetcher = ingest = None
    if args.data_dir:
        reader, prefetcher, ingest = open_shards(args, cfg, plan, device, data_state=data_state,
                                                 steps=args.steps - start_step)
    async_ckpt = AsyncCheckpointer() if args.async_ckpt else None

    def checkpoint(step):
        save_checkpoint(args.ckpt, storage, mom, trainer.controller, step, plan=plan,
                        spec_tree=spec_tree, round_tos=trainer.current_round_tos(),
                        extra={"data_state": data_state} if data_state else None,
                        async_ckpt=async_ckpt, mesh_cfg=mesh_cfg)

    rngi = np.random.default_rng(0)  # the vision archs' image features, step after step
    t0, elapsed, step_tables = time.time(), [], []
    try:
        for step in range(start_step, args.steps):
            io_log = None
            if prefetcher is not None:
                batch, io_log = prefetcher.next()
                # the consumed batch's position: the reader is ahead by the queue
                data_state = io_log["data_state"]
            elif audio:
                feats, labels = synthetic_feature_batch(cfg.vision_dim, cfg.vocab_size, B, S,
                                                        step, device=device)
                batch = {"features": feats, "labels": labels}
            else:
                tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, step, device=device)
                batch = {"tokens": tokens, "labels": labels}
            if cfg.num_image_tokens and "image_features" not in batch:
                img = rngi.normal(0, 1, (B, cfg.num_image_tokens, cfg.vision_dim))
                batch["image_features"] = torch.from_numpy(img.astype(np.float32)).to(device)
            extra = (_random.PRNGKey(step),) if plan.needs_rng else ()
            storage, mom, _ = trainer.run_step(storage, mom, batch, args.lr, *extra,
                                               io_log=io_log)
            elapsed.append(time.time() - t0)
            step_tables.append(step_wire_table(
                plan.with_round_tos(trainer.records[-1].round_tos), cfg, spec_tree, mesh_cfg,
                (B, S)))
            if args.ckpt and args.ckpt_every and (
                    (step + 1) % args.ckpt_every == 0 and step + 1 < args.steps):
                checkpoint(step + 1)
    finally:
        if prefetcher is not None:
            prefetcher.close()
            reader.close()
    summary = trainer.summary()
    if ingest is not None:
        io = summary.get("io_by_entry", {})
        measured = {"shard_read": io.get("shard_read", 0),
                    "ingest_h2d": io.get("host_device", 0)}
        analytic = {k: ingest[k] for k in measured}
        status = "OK" if measured == analytic else "MISMATCH"
        notes["ingest"] = f"ingest bytes measured {measured} analytic {analytic} [{status}]"
        if measured != analytic:
            raise SystemExit(f"{notes['ingest']}: measured ingest bytes != analytic model")
    if args.ckpt:
        checkpoint(args.steps)
        if async_ckpt is not None:
            async_ckpt.wait()
        notes["ckpt"] = f"checkpoint -> {args.ckpt} (plan + data state persisted)"
    n = sum(math.prod(s.logical) * s.reps for s in tree_leaves(spec_tree))
    return {
        "header": f"{cfg.name}: {n/1e6:.1f}M params, mesh {mesh_cfg.shape}, "
                  f"schedule {plan.schedule.source}, rts {plan.round_tos}",
        "summary": summary,
        "records": [dict(loss=r.loss, round_tos=r.round_tos, wire_bytes=r.wire_bytes,
                         measured=r.measured_by_entry, stage_s=r.stage_s, wall_s=r.wall_s,
                         io=r.io_by_entry)
                    for r in trainer.records],
        "elapsed": elapsed,
        "step_tables": step_tables,
        "trivial": mesh_cfg.trivial,
        "start_step": start_step,
        "notes": notes,
        "chunks": plan.chunks,
    }


def main(argv=None, *, params=None) -> dict:
    """Run the launcher; returns rank 0's trainer summary with the per-step
    ``losses``, ``wire_bytes`` and, on a mesh, ``measured`` (per class)
    and ``step_tables`` (:func:`~repro_torch.train.step.step_wire_table`).
    ``params`` replaces the seeded weights (the parity tests start both
    packages from one state)."""
    args = build_parser().parse_args(argv)
    mesh_cfg = parse_mesh(args.mesh)
    if mesh_cfg.trivial:
        out = _train(0, args, params)
    else:
        world = mesh_cfg.dshards * mesh_cfg.tp
        resolve_device(args.device)  # a missing card fails here, not in the ranks
        threads = 1 if args.device == "cpu" else max(1, (os.cpu_count() or 1) // world)
        out = spawn_ranks(_train, world, args, params, threads=threads)[0]
    print(out["header"])
    records, start, notes = out["records"], out["start_step"], out["notes"]
    if notes["resumed"]:
        print(notes["resumed"])
    for i, r in enumerate(records):
        if (i + 1) % 20 == 0:
            print(f"step {start+i+1:4d}  loss {r['loss']:.4f}  rts {r['round_tos']}"
                  f"  wire {r['wire_bytes']/1e6:.1f}MB"
                  f"  {out['elapsed'][i]/(i + 1):.2f}s/step", flush=True)
    s = out["summary"]
    print(f"done: loss {s['final_loss']:.4f}  wire-reduction "
          f"{s['wire_reduction']*100:.1f}%  recompiles {s['recompiles']}")
    entries = ", ".join(f"{k} {v/1e6:.1f}MB" for k, v in s["wire_by_entry"].items() if v)
    print(f"wire by plan entry: {entries}")
    if not out["trivial"]:
        got = {k: sum(r["measured"].get(k, 0) for r in records) for k in COLLECTIVE_CLASSES}
        want = {k: sum(t[k] for t in out["step_tables"]) for k in COLLECTIVE_CLASSES}
        other = {k: v for k, v in s["measured_by_entry"].items() if k not in COLLECTIVE_CLASSES}
        status = "OK" if got == want else "MISMATCH"
        shown = ", ".join(f"{k} {v/1e6:.1f}MB" for k, v in got.items() if v)
        print(f"measured wire by class (rank 0): {shown} [{status} against "
              f"step_wire_table]; not priced: "
              + ", ".join(f"{k} {v/1e6:.3f}MB" for k, v in other.items()))
    if notes["ingest"]:
        print(notes["ingest"])
    print(f"AWP: {s['bits_history']}")
    if notes["ckpt"]:
        print(notes["ckpt"])

    losses = [r["loss"] for r in records]
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump({"start_step": start, "losses": losses}, f)
        print(f"losses -> {args.losses_out}")
    if args.check:
        with open(args.check) as f:
            ref = json.load(f)
        r0 = ref["start_step"]
        mism = [(g, ref["losses"][g - r0], losses[g - start])
                for g in range(max(start, r0),
                               min(start + len(losses), r0 + len(ref["losses"])))
                if ref["losses"][g - r0] != losses[g - start]]
        if mism:
            for g, a, b in mism[:5]:
                print(f"step {g}: ref {a!r} != run {b!r}")
            raise SystemExit(f"--check: {len(mism)} loss mismatches vs {args.check}")
        print(f"--check OK: losses bit-exact vs {args.check}")
    s["losses"] = losses
    s["start_step"] = start
    s["io"] = [r["io"] for r in records]
    s["step_wire_bytes"] = [r["wire_bytes"] for r in records]
    s["measured"] = [r["measured"] for r in records]
    s["step_tables"] = out["step_tables"]
    s["chunks"] = out["chunks"]
    return s


if __name__ == "__main__":
    main()
