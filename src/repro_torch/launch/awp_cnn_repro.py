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

Run:  PYTHONPATH=src python -m repro_torch.launch.awp_cnn_repro --net alexnet --steps 150
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import fp32_math, resolve_device
from repro_torch import random as jr
from repro_torch.data.pipeline import SyntheticImageNet
from repro_torch.dist.spec import MeshCfg
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


def _init(cfg, mesh_cfg, seed, device):
    params, metas, groups_info = init_cnn(cfg, seed, device=device)
    spec_tree = build_cnn_spec_tree(params, metas, mesh_cfg)
    return cnn_to_storage(params, spec_tree, mesh_cfg), spec_tree, groups_info


def tune_threshold(cfg, data, mesh_cfg, batch, lr0, *, device, monitor_steps=25):
    """Paper §V-A: the mean per-batch l2-norm change rate over a short fp32
    monitoring window (its later half) is the threshold T."""
    storage, spec_tree, groups_info = _init(cfg, mesh_cfg, 7, device)
    _, num_groups = groups_info
    opt = SGDConfig(lr=lr0, momentum=0.9, weight_decay=5e-4)
    step = make_cnn_train_step(
        cfg, mesh_cfg, spec_tree, groups_info, opt,
        plan=PrecisionPlan.build(num_groups, round_to=4),
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
               device, seed=0):
    storage, spec_tree, groups_info = _init(cfg, mesh_cfg, seed, device)
    _, num_groups = groups_info
    opt = SGDConfig(lr=lr0, momentum=0.9, weight_decay=5e-4, lr_decay_every=0)
    rt0 = int(policy.split(":")[1]) if policy.startswith("oracle:") else 4
    plan = PrecisionPlan.build(
        num_groups, round_to=rt0,
        schedule="awp" if policy == "awp" else "static",
        awp_threshold=t_thresh, awp_interval=10,
    )

    def builder(round_tos):
        return make_cnn_train_step(
            cfg, mesh_cfg, spec_tree, groups_info, opt,
            plan=plan.with_round_tos(round_tos),
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
                plan=plan.with_round_tos(rts),
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=sorted(NETS), default="alexnet")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--full-width", action="store_true",
                    help="published widths (224x224, 200 classes, paper init)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    fp32_math()
    device = resolve_device(args.device)
    if args.full_width:
        cfg = NETS[args.net]
        mesh_cfg = MeshCfg()
    else:
        cfg = reduced_cnn(NETS[args.net], num_classes=20, in_hw=32)
        # mini-nets have small weight tensors: compress everything >= 1 KiB
        mesh_cfg = MeshCfg(compress_min_size=256)
    data = SyntheticImageNet(
        num_classes=cfg.num_classes, hw=cfg.in_hw, device=str(device)
    )
    t_thresh = tune_threshold(cfg, data, mesh_cfg, args.batch, args.lr, device=device)
    print(f"   tuned T = {t_thresh:.2e} (paper procedure §V-A)")

    results = {}
    for policy in ("baseline", "oracle:2", "awp"):
        print(f"== {cfg.name} / {policy} ==", flush=True)
        r = run_policy(
            policy, cfg, data, mesh_cfg, args.steps, args.batch, args.lr,
            t_thresh, device=device,
        )
        results[policy] = r
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
