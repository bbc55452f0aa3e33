"""End-to-end LM training driver with A²DTWP (twin of
``examples/train_lm.py``), on one GPU or on a data × model mesh of ranks.

Presets, the reference's:
  cpu-demo : reduced qwen3-1.7b at 4 layers (~1 M params), 200 steps, one
             device (``compress_min_size`` 4096)
  8dev     : the same model on a 4 × 2 (data × model) mesh: 8 gloo ranks,
             batch 16
  100m     : a ~100 M-parameter qwen3-family config (8 layers, d 768, hd
             64, vocab 32,768, the layer scan and remat on), 300 steps at
             batch 8 × 512, sized for a card

Logs the loss, the AWP format trajectory and the wire bytes, and writes
a checkpoint at the end, as the reference's: the sharded directory of
``--ckpt`` (default, as the reference's, ``repro_lm_ckpt.npz`` in the
temporary directory; ``ckpt_dir`` maps it to ``repro_lm_ckpt.ckpt/``),
full width, with the plan and the AWP state. At a mesh preset (``8dev``)
the ranks' blocks are gathered to rank 0, which writes the global state
(``repro_torch.checkpoint.sharded``), as the reference's writes its
sharded arrays.

  PYTHONPATH=src python -m repro_torch.launch.train_lm --preset cpu-demo [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

from repro_torch import fp32_math, resolve_device
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, dist_elems_per_group
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.launch.train import rank_device, setup
from repro_torch.optim.sgd import SGDConfig
from repro_torch.plan import PrecisionPlan
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step
from repro_torch.utils.trees import tree_leaves

PRESETS = ("cpu-demo", "8dev", "100m")


def build_preset(name: str):
    """``(cfg, mesh_cfg, batch, seq, steps)`` of a preset, as the
    reference's ``build_preset``."""
    if name == "cpu-demo":
        cfg = reduced(get_config("qwen3-1.7b"), layers=4)
        return cfg, MeshCfg(tp=1, dp=1, compress_min_size=4096), 8, 128, 200
    if name == "8dev":
        cfg = reduced(get_config("qwen3-1.7b"), layers=4)
        return cfg, MeshCfg(tp=2, dp=4, compress_min_size=4096), 16, 128, 200
    if name == "100m":
        cfg = dataclasses.replace(
            get_config("qwen3-1.7b"),
            num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32768,
            num_precision_groups=4, scan_layers=True, remat=True,
        )
        return cfg, MeshCfg(tp=1, dp=1), 8, 512, 300
    raise SystemExit(f"unknown preset {name}")


def build_plan(policy: str, nrt: int) -> PrecisionPlan:
    """The reference's three policies: AWP (threshold 1e-3, interval 25),
    the fp32 baseline, or one fixed format."""
    if policy == "awp":
        return PrecisionPlan.build(nrt, schedule="awp", awp_threshold=1e-3, awp_interval=25)
    if policy == "baseline":
        return PrecisionPlan.build(nrt, round_to=4)
    if policy.startswith("oracle:"):
        return PrecisionPlan.build(nrt, round_to=int(policy.split(":")[1]))
    raise SystemExit(f"unknown --policy {policy}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-demo", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--policy", default="awp", help="awp | baseline | oracle:<rt>")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (default repro_lm_ckpt.npz in the temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda")
    return ap


def _run(rank: int, args, params=None) -> dict:
    """The preset's training loop on rank ``rank`` (the only one on one
    device); returns the header, the per-step records and the summary."""
    fp32_math()
    cfg, mesh_cfg, B, S, steps = build_preset(args.preset)
    steps = args.steps or steps
    world = mesh_cfg.dshards * mesh_cfg.tp
    device = rank_device(args, rank, world)
    mesh = make_mesh_from_cfg(mesh_cfg)
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device, params=params, rank=rank)
    nrt = cfg.num_groups + 1
    plan = build_plan(args.policy, nrt)
    opt = SGDConfig(lr=args.lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (B, S), "labels": (B, S)}

    def builder(round_tos):
        return make_train_step(cfg, mesh_cfg, mesh, spec_tree, opt, shapes,
                               plan=plan.with_round_tos(round_tos))

    trainer = Trainer(builder, nrt, plan=plan,
                      dist_elems_per_group=dist_elems_per_group(spec_tree, mesh_cfg, nrt),
                      gather_axis_size=max(mesh_cfg.dshards, 1))
    n = sum(math.prod(s.logical) * s.reps for s in tree_leaves(spec_tree))
    lines = [f"model: {cfg.name} ({n/1e6:.1f}M params)  "
             f"mesh: {mesh_cfg.shape if mesh is not None else 'single'}  batch: {B}x{S}"]
    t0 = time.time()
    for step in range(steps):
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, step, device=device)
        storage, mom, _ = trainer.run_step(storage, mom, {"tokens": tokens, "labels": labels},
                                           args.lr)
        if step % 25 == 24:
            r = trainer.records[-1]
            lines.append(f"step {step+1:4d}  loss {r.loss:.4f}  rts {r.round_tos}  "
                         f"wire {r.wire_bytes/1e6:.1f}MB  {(time.time()-t0)/(step+1):.2f}s/step")
    save_checkpoint(args.ckpt, storage, mom, trainer.controller, steps, plan=plan,
                    spec_tree=spec_tree, mesh_cfg=mesh_cfg)
    return {"lines": lines, "summary": trainer.summary(),
            "losses": [r.loss for r in trainer.records]}


def main(argv=None, *, params=None) -> dict:
    """Run the driver; returns rank 0's trainer summary with the per-step
    ``losses``. ``params`` replaces the seeded weights (a port LM tree at
    the preset mesh's ``tp``: the parity tests start both packages from
    one state)."""
    args = build_parser().parse_args(argv)
    _, mesh_cfg, *_ = build_preset(args.preset)
    if args.ckpt is None:
        args.ckpt = os.path.join(tempfile.gettempdir(), "repro_lm_ckpt.npz")
    if mesh_cfg.trivial:
        out = _run(0, args, params)
    else:
        world = mesh_cfg.dshards * mesh_cfg.tp
        resolve_device(args.device)  # a missing card fails here, not in the ranks
        threads = 1 if args.device == "cpu" else max(1, (os.cpu_count() or 1) // world)
        out = spawn_ranks(_run, world, args, params, threads=threads)[0]
    for line in out["lines"]:
        print(line, flush=True)
    s = out["summary"]
    print(f"\nfinal loss {s['final_loss']:.4f}  wire reduction "
          f"{s['wire_reduction']*100:.1f}%  recompiles {s['recompiles']}")
    print(f"AWP history: {s['bits_history']}")
    print(f"checkpoint -> {args.ckpt}")
    s["losses"] = out["losses"]
    return s


if __name__ == "__main__":
    main()
