"""Production-mesh dry run: every (arch × shape × mesh) combo at full width,
without a card (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 emulated host
devices and reads XLA's cost and memory analyses. The port has no
compiler to ask, so it runs the step instead, as rank 0 of a fake world of
256 ranks (512 with ``--multi-pod``) under ``FakeTensorMode``
(:func:`~repro_torch.audit.record.recording`): the model at full width,
every collective recorded, nothing allocated. The step's FLOPs and bytes
come from :func:`~repro_torch.roofline.cost.count_cost`, its collectives'
wire from the records, its memory from ``MemTracker``'s peak on the rank,
and the three together make the roofline under the card's constants
(:func:`~repro_torch.roofline.analysis.roofline_from_run`). An op that
needs data under fake tensors (``.item()``, ``nonzero``, a host round
trip) fails its combo with the op named.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k [--multi-pod] [--round-to 2] [--json out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHS, get_config, get_shape
from repro_torch.configs.shapes import applicable
from repro_torch.dist.spec import dist_elems_per_group
from repro_torch.launch.mesh import mesh_cfg_for
from repro_torch.plan import PrecisionPlan
from repro_torch.roofline.analysis import (
    PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, model_flops_estimate, roofline_from_run,
)


def plan_for_combo(cfg, shape, round_to, opts=None, plan=None) -> PrecisionPlan:
    """(round_to, opts) -> PrecisionPlan (``plan`` wins outright), as the
    reference's: the ``opts`` dict (train_dtype, accum, grad_round_to,
    int8_kv, causal_skip, mlstm_chunk, seq_parallel, chunks) is
    plan-builder sugar; ``weight_stationary`` stays an option of the decode
    step."""
    if plan is not None:
        return plan.broadcast(cfg.num_groups + 1)
    opts = dict(opts or {})
    env_overrides = {}
    if "causal_skip" in opts:
        env_overrides["causal_skip"] = opts["causal_skip"]
    if "mlstm_chunk" in opts:
        env_overrides["mlstm_chunk"] = opts["mlstm_chunk"]
    dtype = "bf16" if (shape.kind != "train" or opts.get("train_dtype") == "bf16") else "f32"
    return PrecisionPlan.build(
        cfg.num_groups + 1,
        round_to=round_to,
        grad_round_to=opts.get("grad_round_to"),
        seq_parallel=bool(opts.get("seq_parallel")),
        chunks=int(opts.get("chunks", 1)),
        dtype=dtype,
        int8_kv=bool(opts.get("int8_kv")),
        accum_steps=int(opts.get("accum", 1)),
        env_overrides=env_overrides,
    )


def run_one(arch, shape_name, multi_pod, round_to, *, verbose=True, opts=None, plan=None):
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.audit.cases import build_case
    from repro_torch.audit.record import recording
    from repro_torch.roofline.cost import count_cost

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = applicable(cfg, shape)
    if not ok:
        result = {"arch": arch, "shape": shape_name, "skipped": reason}
        if verbose:
            print(json.dumps(result, indent=2))
        return result
    mesh_cfg = mesh_cfg_for(multi_pod=multi_pod)
    chips = mesh_cfg.tp * mesh_cfg.dp * mesh_cfg.pods
    plan = plan_for_combo(cfg, shape, round_to, opts, plan)
    t0 = time.time()
    with recording(mesh_cfg) as rec:
        case = build_case(arch, shape.kind, mesh_cfg, plan, mesh=rec.mesh, cfg=cfg,
                          seq_len=shape.seq_len, global_batch=shape.global_batch,
                          window=shape.window,
                          weight_stationary=bool((opts or {}).get("weight_stationary")))
        step, args, spec_tree = case.step, case.args, case.spec_tree
        first = len(rec.records)
        tracker = MemTracker()
        tensors = [x for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor)]
        tracker.track_external(*tensors)
        with tracker:
            cost = count_cost(step, *args)
        peak = tracker.get_tracker_snapshot("peak")
        arg_bytes = sum(x.numel() * x.element_size() for x in tensors)
    calls = rec.records[first:]
    run_s = time.time() - t0
    plan_geometry = {
        "dist_elems_per_group": dist_elems_per_group(spec_tree, mesh_cfg, cfg.num_groups + 1),
        "gather_axis_size": max(mesh_cfg.dshards, 1),
        "training": shape.kind == "train",
    }
    rf = roofline_from_run(cost, calls, model_flops_estimate(cfg, shape, chips), plan=plan,
                           plan_geometry=plan_geometry,
                           peak_flops=PEAK_FLOPS_BF16 if plan.dtype == "bf16" else PEAK_FLOPS_FP32)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "round_to": round_to,
        "opts": opts or {},
        "plan": plan.to_json_dict(),
        "run_s": round(run_s, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_bytes": max(d["Total"] for d in peak.values()) if peak else 0,
        },
        "roofline": rf.to_dict(),
    }
    if verbose:
        print(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--round-to", type=int, default=2)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--bf16-train", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--grad-round-to", type=int, default=4)
    ap.add_argument("--weight-stationary", action="store_true")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--no-causal-skip", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--plan", default=None, help="PrecisionPlan JSON (overrides the sugar flags)")
    args = ap.parse_args(argv)
    plan = PrecisionPlan.from_file(args.plan) if args.plan else None
    opts = {}
    if args.bf16_train:
        opts["train_dtype"] = "bf16"
    if args.accum > 1:
        opts["accum"] = args.accum
    if args.grad_round_to != 4:
        opts["grad_round_to"] = args.grad_round_to
    if args.weight_stationary:
        opts["weight_stationary"] = True
    if args.int8_kv:
        opts["int8_kv"] = True
    if args.no_causal_skip:
        opts["causal_skip"] = False
    if args.seq_parallel:
        opts["seq_parallel"] = True
    if args.chunks > 1:
        opts["chunks"] = args.chunks

    combos = ([(a, s) for a in sorted(ARCHS) for s in INPUT_SHAPES] if args.all
              else [(args.arch, args.shape)])
    results = []
    failures = 0
    for arch, shape in combos:
        try:
            results.append(run_one(arch, shape, args.multi_pod, args.round_to, opts=opts,
                                   plan=plan))
        except Exception as e:  # one combo's failure is reported, the sweep goes on
            failures += 1
            traceback.print_exc()
            results.append({"arch": arch, "shape": shape, "error": repr(e)})
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2, default=str)
    print(f"\n{len(results)} combos, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
