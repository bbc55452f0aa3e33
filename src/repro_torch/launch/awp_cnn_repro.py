"""Paper reproduction on one GPU: A²DTWP vs oracle vs 32-bit baseline on the
paper's three networks (twin of ``examples/awp_cnn_repro.py``).

  * trains the network under three policies — ``baseline`` (fp32),
    ``oracle:<rt>`` (one fixed format, ADT only) and ``awp`` (A²DTWP) —
  * tracks top-5 validation error against the modeled transfer time
    (bytes / link bandwidth, the paper's Table II accounting),
  * reports the AWP precision trajectory (8→16→24→32 per layer/block) and
    the weight-motion byte reduction.

Default: the reduced networks on synthetic 32×32 ImageNet-like data;
``--full-width`` runs the published configuration (224×224, 200 classes,
paper init) with the default ``compress_min_size``.

``--devices N`` (N > 1) trains data-parallel, as the reference's
``--devices`` does on N fake devices: N gloo ranks, processes spawned on
``--device`` (several may share one card), each holding its shards of the
``DIST`` weights and its slice of every batch; ``--grad-round-to`` packs
the gradient reduce-scatter (``--grad-mode`` nearest, truncate or
stochastic: the step's key, ``PRNGKey(1000 + step)``, folded as the
reference folds it). The figures are rank 0's, printed by this
process.

Run:  PYTHONPATH=src python -m repro_torch.launch.awp_cnn_repro --net alexnet --steps 150
      PYTHONPATH=src python -m repro_torch.launch.awp_cnn_repro --devices 2 --device cpu
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import fp32_math, resolve_device
from repro_torch import random as jr
from repro_torch.data.pipeline import SyntheticImageNet
from repro_torch.dist.spec import MeshCfg, tree_to_local
from repro_torch.launch.mesh import make_mesh_from_cfg, spawn_ranks
from repro_torch.models.cnn import ALEXNET, RESNET34, VGG_A, init_cnn, reduced_cnn
from repro_torch.optim.sgd import SGDConfig, init_momentum, lr_at
from repro_torch.plan import PrecisionPlan
from repro_torch.train.cnn_step import (
    build_cnn_spec_tree,
    cnn_dist_elems,
    cnn_to_storage,
    make_cnn_eval,
    make_cnn_train_step,
)
from repro_torch.train.loop import Trainer

NETS = {"alexnet": ALEXNET, "vgg": VGG_A, "resnet": RESNET34}

# modeled link bandwidth for the transfer-time account (paper: PCIe 8 GT/s
# x8 ≈ 7.9 GB/s); compute is identical across policies, so only the
# transfer term differs — §V-G methodology.
LINK_BW = 7.9e9


def _init(cfg, mesh_cfg, seed, device, rank=0):
    """Weights from ``seed`` (the same on every rank), laid out in storage
    form, and the rank's shards of them."""
    params, metas, groups_info = init_cnn(cfg, seed, device=device)
    spec_tree = build_cnn_spec_tree(params, metas, mesh_cfg)
    storage = cnn_to_storage(params, spec_tree, mesh_cfg)
    if not mesh_cfg.trivial:
        storage = tree_to_local(storage, spec_tree, mesh_cfg, rank)
    return storage, spec_tree, groups_info


def tune_threshold(cfg, data, mesh_cfg, batch, lr0, *, device, monitor_steps=25,
                   mesh=None, rank=0):
    """Paper §V-A: the mean per-batch l2-norm change rate over a short fp32
    monitoring window (its later half) is the threshold T."""
    storage, spec_tree, groups_info = _init(cfg, mesh_cfg, 7, device, rank)
    _, num_groups = groups_info
    opt = SGDConfig(lr=lr0, momentum=0.9, weight_decay=5e-4)
    step = make_cnn_train_step(
        cfg, mesh_cfg, spec_tree, groups_info, opt,
        plan=PrecisionPlan.build(num_groups, round_to=4), mesh=mesh,
    )
    mom = init_momentum(storage)
    deltas, prev = [], None
    for i in range(monitor_steps):
        imgs, labels = data.batch(batch, 10_000 + i)
        storage, mom, m = step(
            storage, mom, {"images": imgs, "labels": labels}, lr0, jr.PRNGKey(i)
        )
        norms = np.sqrt(m["group_norms_sq"].cpu().numpy().astype(np.float64))
        if prev is not None:
            deltas.append(np.mean((norms - prev) / np.maximum(prev, 1e-12)))
        prev = norms
    return float(np.mean(deltas[len(deltas) // 2:]))


def run_policy(policy, cfg, data, mesh_cfg, steps, batch, lr0, t_thresh, *,
               device, seed=0, grad_round_to=None, grad_mode="nearest", mesh=None,
               rank=0):
    storage, spec_tree, groups_info = _init(cfg, mesh_cfg, seed, device, rank)
    _, num_groups = groups_info
    opt = SGDConfig(lr=lr0, momentum=0.9, weight_decay=5e-4, lr_decay_every=0)
    rt0 = int(policy.split(":")[1]) if policy.startswith("oracle:") else 4
    plan = PrecisionPlan.build(
        num_groups, round_to=rt0,
        grad_round_to=grad_round_to, grad_mode=grad_mode,
        schedule="awp" if policy == "awp" else "static",
        awp_threshold=t_thresh, awp_interval=10,
    )

    def builder(round_tos):
        return make_cnn_train_step(
            cfg, mesh_cfg, spec_tree, groups_info, opt,
            plan=plan.with_round_tos(round_tos), mesh=mesh,
        )

    trainer = Trainer(
        builder, num_groups, plan=plan,
        dist_elems_per_group=cnn_dist_elems(spec_tree, groups_info, mesh_cfg),
        gather_axis_size=mesh_cfg.dshards,
    )
    evaluators = {}

    def evaluate(rts):
        if rts not in evaluators:
            evaluators[rts] = make_cnn_eval(
                cfg, mesh_cfg, spec_tree, groups_info,
                plan=plan.with_round_tos(rts), mesh=mesh,
            )
        imgs, labels = data.validation(256)
        return float(evaluators[rts](storage, imgs, labels))

    mom = init_momentum(storage)
    curve = []
    for step in range(steps):
        imgs, labels = data.batch(batch, step)
        storage, mom, _ = trainer.run_step(
            storage, mom, {"images": imgs, "labels": labels},
            lr_at(opt, step), jr.PRNGKey(1000 + step),
        )
        if step % 10 == 9 or step == steps - 1:
            err = evaluate(trainer.current_round_tos())
            xfer_s = sum(r.wire_bytes for r in trainer.records) / LINK_BW
            curve.append(
                {"step": step + 1, "top5_err": err, "modeled_xfer_s": xfer_s}
            )
    s = trainer.summary()
    s["curve"] = curve
    s["policy"] = policy
    s["step_s"] = [r.wall_s for r in trainer.records]
    s["losses"] = [r.loss for r in trainer.records]
    return s


POLICIES = ("baseline", "oracle:2", "awp")


def _setup(args):
    """(cfg, mesh_cfg) of the run: the reduced networks compress every
    leaf of at least 256 elements (1 KiB), as the reference's example."""
    dp = max(args.devices, 1)
    if args.full_width:
        return NETS[args.net], MeshCfg(dp=dp)
    return reduced_cnn(NETS[args.net], num_classes=20, in_hw=32), MeshCfg(
        dp=dp, compress_min_size=256)


def run_all(rank, args, device):
    """Tune T, then train the three policies; returns the results (rank
    0's on a data-parallel mesh: every rank holds the same loss, norms and
    wire figures)."""
    fp32_math()
    device = resolve_device(device)
    cfg, mesh_cfg = _setup(args)
    mesh = make_mesh_from_cfg(mesh_cfg)
    data = SyntheticImageNet(
        num_classes=cfg.num_classes, hw=cfg.in_hw, device=str(device)
    )
    t_thresh = tune_threshold(cfg, data, mesh_cfg, args.batch, args.lr, device=device,
                              mesh=mesh, rank=rank)
    results = {"t_thresh": t_thresh, "cfg_name": cfg.name, "policies": {}}
    for policy in POLICIES:
        results["policies"][policy] = run_policy(
            policy, cfg, data, mesh_cfg, args.steps, args.batch, args.lr, t_thresh,
            device=device, grad_round_to=args.grad_round_to, grad_mode=args.grad_mode,
            mesh=mesh, rank=rank,
        )
    return results if rank == 0 else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=sorted(NETS), default="alexnet")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--full-width", action="store_true",
                    help="published widths (224x224, 200 classes, paper init)")
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel gloo ranks on --device (0 = single)")
    ap.add_argument("--grad-round-to", type=int, default=None,
                    help="compress the gradient reduce-scatter (devices > 1)")
    ap.add_argument("--grad-mode", default="nearest",
                    choices=["truncate", "nearest", "stochastic"],
                    help="gradient rounding of the packed reduce-scatter")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.devices > 1:
        run = spawn_ranks(run_all, args.devices, args, str(device))[0]
    else:
        run = run_all(0, args, str(device))
    print(f"   tuned T = {run['t_thresh']:.2e} (paper procedure §V-A)")

    results = run["policies"]
    for policy, r in results.items():
        print(f"== {run['cfg_name']} / {policy} ==", flush=True)
        print(
            f"   final loss {r['final_loss']:.3f}  "
            f"top5err {r['curve'][-1]['top5_err']:.3f}  "
            f"wire reduction {r['wire_reduction']*100:.1f}%  "
            f"format changes {r['recompiles']}"
        )
        if policy == "awp":
            print(f"   AWP bits history: {r['bits_history']}")

    base_err = results["baseline"]["curve"][-1]["top5_err"]
    awp_err = results["awp"]["curve"][-1]["top5_err"]
    print(
        f"\nvalidation-error parity: baseline {base_err:.3f} vs "
        f"A2DTWP {awp_err:.3f} (|Δ| = {abs(base_err-awp_err):.3f})"
    )
    print(
        f"A2DTWP weight-motion reduction: "
        f"{results['awp']['wire_reduction']*100:.1f}%"
    )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
    return results


if __name__ == "__main__":
    main()
