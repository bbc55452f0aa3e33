"""``python -m repro_torch.audit`` — the data-motion sweep over the
registry (counterpart of ``python -m repro.audit``).

Runs every (arch × plan × mesh × seq-layout × kind) combo as rank 0 of a
fake process group (and, on a mesh of more than one rank, as its last
rank too: the port's code may branch on the rank), with fake tensors,
attributes each recorded collective to a plan traffic class, and fails
unless the recorded wire bytes equal the analytic model with no
unattributed call. One CPU process, nothing allocated.

Usage:
  PYTHONPATH=src python -m repro_torch.audit                       # full sweep
  PYTHONPATH=src python -m repro_torch.audit --archs qwen3-1.7b \\
      --kinds train,prefill --meshes 1x2 --plans rt2 --json report.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.audit.audit import audit_step
from repro_torch.audit.cases import PLAN_NAMES, build_case, make_plan, parse_mesh
from repro_torch.audit.record import recording
from repro_torch.configs.registry import ARCHS, get_config, reduced


def _fmt_classes(report) -> str:
    return " ".join(f"{name}={round(c.recorded_bytes)}"
                    for name, c in sorted(report.classes.items())) or "-"


def audit_combo(arch, kind, mesh_cfg, plan, *, rank=0, seq_len=32, global_batch=4):
    """The :class:`~repro_torch.audit.audit.AuditReport` of one registry
    combo on rank ``rank``, or ``None`` where it does not apply."""
    cfg = reduced(get_config(arch))
    with recording(mesh_cfg, rank=rank) as rec:
        case = build_case(arch, kind, mesh_cfg, plan, mesh=rec.mesh, rank=rank,
                          seq_len=seq_len, global_batch=global_batch, cfg=cfg)
        if case is None:
            return None
        return audit_step(case.step, case.args, case.plan, mesh_cfg=mesh_cfg, mesh=rec.mesh,
                          spec_tree=case.spec_tree, kind=kind, cfg=cfg,
                          batch_shape=(global_batch, global_batch >= mesh_cfg.dshards))


def run_sweep(archs, kinds, meshes, plans, *, seq_parallel="auto", seq_len=32,
              global_batch=4, verbose=True):
    """Returns ``(results, n_failed)``. Each result is a JSON-ready dict."""
    results = []
    n_failed = 0
    for arch in archs:
        num_entries = reduced(get_config(arch)).num_groups + 1
        for mesh_spec in meshes:
            mesh_cfg = parse_mesh(mesh_spec)
            world = mesh_cfg.dshards * mesh_cfg.tp
            layouts = [False]
            if seq_parallel == "on":
                layouts = [True]
            elif seq_parallel == "auto" and mesh_cfg.tp > 1:
                layouts = [False, True]
            for plan_name in plans:
                for sp in layouts:
                    for kind in kinds:
                        if sp and kind == "decode":
                            continue  # decode has no sequence dim to shard
                        plan = make_plan(plan_name, num_entries, seq_parallel=sp)
                        for rank in sorted({0, world - 1}):
                            combo = dict(arch=arch, kind=kind, mesh=mesh_spec,
                                         plan=plan_name, seq_parallel=sp, rank=rank)
                            t0 = time.time()
                            try:
                                report = audit_combo(arch, kind, mesh_cfg, plan, rank=rank,
                                                     seq_len=seq_len,
                                                     global_batch=global_batch)
                            except Exception as exc:  # a run-time failure of the step
                                combo["error"] = f"{type(exc).__name__}: {exc}"
                                results.append(combo)
                                n_failed += 1
                                if verbose:
                                    print(f"ERROR {arch} {kind} {mesh_spec} {plan_name} "
                                          f"rank {rank}: {combo['error']}")
                                continue
                            if report is None:
                                combo["skipped"] = "not applicable"
                                results.append(combo)
                                break
                            combo["report"] = report.to_json_dict()
                            combo["run_s"] = round(time.time() - t0, 2)
                            results.append(combo)
                            n_failed += not report.ok
                            if verbose:
                                status = "ok" if report.ok else "FAIL"
                                sp_tag = " sp" if sp else ""
                                print(f"{status:4s} {arch:20s} {kind:8s} {mesh_spec}{sp_tag:3s} "
                                      f"{plan_name:11s} r{rank} "
                                      f"calls={report.n_comm_calls:3d} {_fmt_classes(report)}")
                                for v in report.violations:
                                    print(f"       ! {v}")
    return results, n_failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.audit",
                                 description="data-motion audit over the registry")
    ap.add_argument("--archs", default="all", help="comma-separated arch names, or 'all'")
    ap.add_argument("--kinds", default="train", help="train,prefill,decode,place")
    ap.add_argument("--meshes", default="1x2,2x1", help="comma-separated dpxtp specs")
    ap.add_argument("--plans", default=",".join(PLAN_NAMES))
    ap.add_argument("--seq-parallel", choices=("auto", "on", "off"), default="auto",
                    help="auto: audit both layouts wherever tp > 1")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--json", default=None,
                    help="write the per-config attribution report here")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.archs == "all" else args.archs.split(",")
    results, n_failed = run_sweep(
        archs, args.kinds.split(","), args.meshes.split(","), args.plans.split(","),
        seq_parallel=args.seq_parallel, seq_len=args.seq_len,
        global_batch=args.global_batch)
    audited = [r for r in results if "report" in r]
    print(f"\naudited {len(audited)} combos ({len(results) - len(audited)} skipped/errored), "
          f"{n_failed} failed")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"results": results, "failed": n_failed}, f, indent=1)
        print(f"report -> {args.json}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
