"""Training launcher on one GPU (twin of ``repro.launch.train`` at
``--mesh 1x1``): the A²DTWP loop (AWP controller + ADT weight transfer)
on the synthetic k-gram token stream.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --reduced --steps 25 --awp-interval 5 --awp-threshold 1e-3 [--device cpu]

Weights are random, from seed 0 (``repro_torch.models.init``); batches
are ``synthetic_lm_batch(vocab, batch, seq, step)``, the reference's.
Prints the reference launcher's ``step``, ``done: ... wire-reduction``,
``wire by plan entry`` and ``AWP: ...`` lines. Runs on ``cuda`` unless
``--device cpu``.

Every flag of the reference that needs a module the port does not have
raises ``NotImplementedError`` naming it: a mesh other than 1x1
(FSDP×TP), ``--plan`` with fields other than ``weights`` and
``schedule``, ``--bf16``, ``--grad-round-to``/``--grad-mode``,
``--act-round-to``, ``--seq-parallel``, ``--chunks``, ``--accum``,
``--ckpt`` and its options, ``--resume`` and ``--data-dir``.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import fp32_math, resolve_device
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group, tree_to_storage
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step
from repro_torch.utils.trees import tree_leaves


def parse_mesh(spec: str) -> MeshCfg:
    """"1x1" | "<dp>x<tp>" | "<pods>x<dp>x<tp>"; only 1x1 runs."""
    parts = [int(p) for p in spec.split("x")]
    if len(parts) not in (2, 3):
        raise SystemExit(f"bad --mesh {spec!r}")
    if any(p != 1 for p in parts):
        raise NotImplementedError(
            f"--mesh {spec}: FSDP×TP (dist/shard.py, launch/mesh.py, the "
            "transport collectives) is not ported; only 1x1 runs"
        )
    return MeshCfg()


def _unported(args) -> list[str]:
    """The set flags that need a module the port does not have."""
    checks = (
        (args.bf16, "--bf16 (the bf16 compute dtype)"),
        (args.grad_round_to != 4 or args.grad_mode != "nearest",
         "--grad-round-to/--grad-mode (the compressed gradient reduce-scatter)"),
        (args.act_round_to != 4, "--act-round-to (core/collectives.py's packed TP psums)"),
        (args.seq_parallel, "--seq-parallel (Env.seq_parallel, seq_gather/seq_scatter)"),
        (args.chunks != "1", "--chunks (the chunked double-buffered all-gather)"),
        (args.accum != 1, "--accum (gradient accumulation, accum_steps)"),
        (args.ckpt or args.ckpt_every or args.async_ckpt,
         "--ckpt/--ckpt-every/--async-ckpt (checkpoint/ckpt.py, checkpoint/sharded.py)"),
        (args.resume, "--resume (checkpoint/ckpt.py)"),
        (args.data_dir, "--data-dir (data/shards.py, data/prefetch.py)"),
    )
    return [what for cond, what in checks if cond]


def plan_from_args(args, nrt: int) -> PrecisionPlan:
    """CLI flags -> PrecisionPlan (``--plan`` wins outright)."""
    if args.plan:
        with open(args.plan) as f:
            plan = PrecisionPlan.from_json(f.read()).broadcast(nrt)
        if plan.activations is not None or plan.host_device is not None:
            raise NotImplementedError(
                f"--plan {args.plan}: only the weights and schedule fields are "
                "ported for LM training"
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
        nrt, round_to=round_to, schedule=schedule,
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


def setup(cfg, mesh_cfg: MeshCfg, *, device, params=None):
    """``(spec_tree, storage, momentum)``: random weights from seed 0 on
    ``device``, or ``params`` (a port LM tree, e.g. converted reference
    weights)."""
    if params is None:
        params, metas = init_params(cfg, 0, device=device)
    else:
        _, metas = init_params(cfg, device="meta")
    spec_tree = build_spec_tree(params, metas, mesh_cfg)
    storage = tree_to_storage(params, spec_tree, mesh_cfg)
    return spec_tree, storage, init_momentum(storage)


def run(args, *, params=None) -> Trainer:
    """The training loop of :func:`main`; ``params`` replaces the seeded
    weights (the parity tests start both packages from one state)."""
    bad = _unported(args)
    if bad:
        raise NotImplementedError(f"not ported: {'; '.join(bad)}")
    fp32_math()
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    mesh_cfg = parse_mesh(args.mesh)
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, params=params)
    n = sum(x.numel() for x in tree_leaves(storage))
    nrt = cfg.num_groups + 1
    plan = plan_from_args(args, nrt)
    print(f"{cfg.name}: {n/1e6:.1f}M params, mesh (1, 1), "
          f"schedule {plan.schedule.source}, rts {plan.round_tos}")

    B, S = args.batch, args.seq
    opt = SGDConfig(lr=args.lr, momentum=0.9, weight_decay=1e-4)
    batch_shapes = {"tokens": (B, S), "labels": (B, S)}

    def builder(round_tos):
        return make_train_step(cfg, mesh_cfg, None, spec_tree, opt, batch_shapes,
                               plan=plan.with_round_tos(round_tos))

    trainer = Trainer(builder, nrt, plan=plan,
                      dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, nrt))
    t0 = time.time()
    for step in range(args.steps):
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, step, device=device)
        storage, mom, _ = trainer.run_step(
            storage, mom, {"tokens": tokens, "labels": labels}, args.lr
        )
        if (step + 1) % 20 == 0:
            r = trainer.records[-1]
            print(f"step {step+1:4d}  loss {r.loss:.4f}  rts {r.round_tos}"
                  f"  wire {r.wire_bytes/1e6:.1f}MB"
                  f"  {(time.time()-t0)/(step + 1):.2f}s/step", flush=True)
    return trainer


def main(argv=None, *, params=None) -> dict:
    """Run the launcher; returns the trainer's summary with the per-step
    ``losses`` and ``wire_bytes``. ``params``: as :func:`run`'s."""
    args = build_parser().parse_args(argv)
    trainer = run(args, params=params)
    s = trainer.summary()
    print(f"done: loss {s['final_loss']:.4f}  wire-reduction "
          f"{s['wire_reduction']*100:.1f}%  recompiles {s['recompiles']}")
    entries = ", ".join(f"{k} {v/1e6:.1f}MB" for k, v in s["wire_by_entry"].items() if v)
    print(f"wire by plan entry: {entries}")
    print(f"AWP: {s['bits_history']}")

    losses = [r.loss for r in trainer.records]
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
    s["step_wire_bytes"] = [r.wire_bytes for r in trainer.records]
    return s


if __name__ == "__main__":
    main()
