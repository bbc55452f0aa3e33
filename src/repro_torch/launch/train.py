"""Training launcher (twin of ``repro.launch.train``): the A²DTWP loop
(AWP controller + ADT weight transfer) on the synthetic k-gram token
stream, on one GPU or on an FSDP×TP mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --steps 25 --awp-interval 5 --awp-threshold 1e-3 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --mesh 2x2 --steps 2 --policy oracle:2 --act-round-to 2 [--device cpu]

Weights are random, from seed 0 (``repro_torch.models.init``); batches
are ``synthetic_lm_batch(vocab, batch, seq, step)``, the reference's.
``--mesh`` is ``DPxTP`` or ``PODSxDPxTP``: anything but ``1x1`` runs
``pods × dp × tp`` ranks, processes spawned by
``repro_torch.launch.mesh.spawn_ranks`` that meet in a gloo group (on
the card they share it, or take one each where there are several); each
rank holds its blocks of the weights, and builds them in turn with the
others waiting, so that one whole model at a time is on a card. The
precision flags build the plan as the reference's do: ``--grad-round-to``
/ ``--grad-mode`` (truncate or nearest) the gradient reduce-scatter,
``--act-round-to`` the TP-region all-reduces, ``--seq-parallel`` the
sequence-parallel layout, ``--chunks`` the gather's plane blocks.
Prints the reference launcher's ``step``, ``done: ... wire-reduction``,
``wire by plan entry`` and ``AWP: ...`` lines (rank 0's), and on a mesh
one more: the collectives' measured wire by class against
:func:`~repro_torch.train.step.step_wire_table`. Runs on ``cuda`` unless
``--device cpu``.

Every flag of the reference that needs a module the port does not have
raises ``NotImplementedError`` naming its ROADMAP item: ``--bf16``,
``--grad-mode stochastic``, ``--accum``, ``--ckpt`` and its options,
``--resume``, ``--data-dir``, ``--chunks auto``, and a ``--plan`` with
such fields.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch
import torch.distributed as dist

from repro_torch import fp32_math, resolve_device
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import (
    MeshCfg, build_spec_tree, dist_elems_per_group, leaf_to_local, tree_to_storage,
)
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
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


def _unported(args) -> list[str]:
    """The set flags that need a module the port does not have."""
    checks = (
        (args.bf16, "--bf16 (the bf16 compute dtype, ROADMAP item 6.4)"),
        (args.grad_mode == "stochastic",
         "--grad-mode stochastic (stochastic rounding, ROADMAP item 6.3)"),
        (args.chunks == "auto", "--chunks auto (plan/sweep.py's pick_chunks, ROADMAP item 12)"),
        (args.accum != 1, "--accum (gradient accumulation, accum_steps, ROADMAP item 6.2)"),
        (args.ckpt or args.ckpt_every or args.async_ckpt,
         "--ckpt/--ckpt-every/--async-ckpt (checkpoint/ckpt.py, checkpoint/sharded.py, "
         "ROADMAP item 9)"),
        (args.resume, "--resume (checkpoint/ckpt.py, ROADMAP item 9)"),
        (args.data_dir, "--data-dir (data/shards.py, data/prefetch.py, ROADMAP item 9)"),
    )
    return [what for cond, what in checks if cond]


def plan_from_args(args, nrt: int) -> PrecisionPlan:
    """CLI flags -> PrecisionPlan (``--plan`` wins outright)."""
    if args.plan:
        with open(args.plan) as f:
            plan = PrecisionPlan.from_json(f.read()).broadcast(nrt)
        if plan.host_device is not None:
            raise NotImplementedError(
                f"--plan {args.plan}: host_device staging is not ported for LM training"
            )
        return plan
    schedule, round_to = "awp", 4
    if args.policy == "baseline":
        schedule = "static"
    elif args.policy.startswith("oracle:"):
        schedule, round_to = "static", int(args.policy.split(":")[1])
    elif args.policy != "awp":
        raise SystemExit(f"bad --policy {args.policy!r}")
    return PrecisionPlan.build(
        nrt, round_to=round_to, grad_round_to=args.grad_round_to,
        grad_mode=args.grad_mode, act_round_to=args.act_round_to,
        seq_parallel=args.seq_parallel, chunks=int(args.chunks), schedule=schedule,
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
    ap.add_argument("--data-dir", default="")
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


def _train(rank: int, args, params=None) -> dict:
    """The training loop of :func:`main` on rank ``rank`` (the only one on
    ``1x1``); returns plain data: the header, the trainer's summary, the
    step records and the per-step step-wire tables."""
    fp32_math()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh_cfg = parse_mesh(args.mesh)
    world = mesh_cfg.dshards * mesh_cfg.tp
    device = rank_device(args, rank, world)
    mesh = make_mesh_from_cfg(mesh_cfg)
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, params=params, rank=rank)
    nrt = cfg.num_groups + 1
    plan = plan_from_args(args, nrt)
    B, S = args.batch, args.seq
    opt = SGDConfig(lr=args.lr, momentum=0.9, weight_decay=1e-4)
    batch_shapes = {"tokens": (B, S), "labels": (B, S)}

    def builder(round_tos):
        return make_train_step(cfg, mesh_cfg, mesh, spec_tree, opt, batch_shapes,
                               plan=plan.with_round_tos(round_tos))

    trainer = Trainer(builder, nrt, plan=plan,
                      dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, nrt),
                      gather_axis_size=max(mesh_cfg.dshards, 1))
    t0, elapsed, step_tables = time.time(), [], []
    for step in range(args.steps):
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, step, device=device)
        storage, mom, _ = trainer.run_step(
            storage, mom, {"tokens": tokens, "labels": labels}, args.lr
        )
        elapsed.append(time.time() - t0)
        step_tables.append(step_wire_table(
            plan.with_round_tos(trainer.records[-1].round_tos), cfg, spec_tree, mesh_cfg,
            (B, S)))
    n = sum(math.prod(s.logical) * s.reps for s in tree_leaves(spec_tree))
    return {
        "header": f"{cfg.name}: {n/1e6:.1f}M params, mesh {mesh_cfg.shape}, "
                  f"schedule {plan.schedule.source}, rts {plan.round_tos}",
        "summary": trainer.summary(),
        "records": [dict(loss=r.loss, round_tos=r.round_tos, wire_bytes=r.wire_bytes,
                         measured=r.measured_by_entry, stage_s=r.stage_s, wall_s=r.wall_s)
                    for r in trainer.records],
        "elapsed": elapsed,
        "step_tables": step_tables,
        "trivial": mesh_cfg.trivial,
    }


def main(argv=None, *, params=None) -> dict:
    """Run the launcher; returns rank 0's trainer summary with the per-step
    ``losses``, ``wire_bytes`` and, on a mesh, ``measured`` (per class)
    and ``step_tables`` (:func:`~repro_torch.train.step.step_wire_table`).
    ``params`` replaces the seeded weights (the parity tests start both
    packages from one state)."""
    args = build_parser().parse_args(argv)
    bad = _unported(args)
    if bad:
        raise NotImplementedError(f"not ported: {'; '.join(bad)}")
    mesh_cfg = parse_mesh(args.mesh)
    if mesh_cfg.trivial:
        out = _train(0, args, params)
    else:
        world = mesh_cfg.dshards * mesh_cfg.tp
        resolve_device(args.device)  # a missing card fails here, not in the ranks
        threads = 1 if args.device == "cpu" else max(1, (os.cpu_count() or 1) // world)
        out = spawn_ranks(_train, world, args, params, threads=threads)[0]
    print(out["header"])
    records = out["records"]
    for i, r in enumerate(records):
        if (i + 1) % 20 == 0:
            print(f"step {i+1:4d}  loss {r['loss']:.4f}  rts {r['round_tos']}"
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
    print(f"AWP: {s['bits_history']}")

    losses = [r["loss"] for r in records]
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump({"start_step": 0, "losses": losses}, f)
        print(f"losses -> {args.losses_out}")
    if args.check:
        with open(args.check) as f:
            ref = json.load(f)
        start = ref["start_step"]
        mism = [(g, ref["losses"][g - start], losses[g])
                for g in range(start, min(len(losses), start + len(ref["losses"])))
                if ref["losses"][g - start] != losses[g]]
        if mism:
            for g, a, b in mism[:5]:
                print(f"step {g}: ref {a!r} != run {b!r}")
            raise SystemExit(f"--check: {len(mism)} loss mismatches vs {args.check}")
        print(f"--check OK: losses bit-exact vs {args.check}")
    s["losses"] = losses
    s["step_wire_bytes"] = [r["wire_bytes"] for r in records]
    s["measured"] = [r["measured"] for r in records]
    s["step_tables"] = out["step_tables"]
    return s


if __name__ == "__main__":
    main()
