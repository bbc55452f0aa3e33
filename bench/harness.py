"""One run of one cell: set-up, the measured window, the traced steps, the
check against the reference, and the result's line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix. The configuration's ``kind`` names the
driver, ``bench/kinds/<kind>.py``; each metric of ``BENCHMARK.json`` is
read by ``bench/metrics/<name>.py``; the cell's limits are
``bench/limits/<cell>.json``. All are found by name.

Set-up builds one training job (weights and the batch pool from the
seed), copies its weights, and runs the first ``check_steps`` steps
through the window's own call: they warm every shape the window uses and
give the program's readings (losses, the monitor's sums, the first
gradient from the momentum, each leaf's change). The window then runs
whole steps until ``seconds`` have passed; each step ends in the
trainer's loss sync. Once it has closed and the memory peak is read, the
job is freed and the reference runs the checked steps again.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
# top-level modules that no run may load: JAX and the JAX package
BANNED = frozenset({"jax", "jaxlib", "flax", "repro", "benchmarks"})


class BenchError(RuntimeError):
    """A run that cannot give a result."""


def load_module(path: pathlib.Path):
    """A benchmark file by path (metric and kind names need not be
    identifiers)."""
    if not path.is_file():
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise BenchError(f"no file {path}")
    return json.loads(path.read_text())


def load_cell(workload: str, root: pathlib.Path = ROOT) -> types.SimpleNamespace:
    """The cell, its configuration, mix, limits, driver and metric readers,
    by name from ``<root>/BENCHMARK.json``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    doc = _json(root / configs[cell["config"]]["file"])
    here = root / "bench"

    def mine(metrics):
        return [dict(m, read=load_module(here / "metrics" / f"{m['name']}.py").read)
                for m in metrics if workload in m.get("workloads", [workload])]

    return types.SimpleNamespace(
        name=workload, cell=cell, doc=doc,
        mix=_json(here / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(here / "limits" / f"{workload}.json"),
        kind=load_module(here / "kinds" / f"{doc['kind']}.py"),
        end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]),
    )


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`BANNED`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def program_readings(prog, kind, steps: int) -> dict:
    """Run the first ``steps`` steps and read the program's state: each
    loss, the monitor's sums, the first gradient (momentum after one step,
    less the weight decay the optimizer added) and each leaf's change."""
    from bench.reference import common

    wd = prog.weight_decay
    p0 = {k: v.detach().clone() for k, v in prog.params().items()}
    out = common.new_readings()
    for i in range(steps):
        metrics = prog.step(i)
        out["losses"].append(prog.trainer.records[-1].loss)
        out["monitor"].append([float(x) for x in metrics["group_norms_sq"].tolist()])
        if i == 0:
            out["grad1"] = common.norms({
                k: m - wd * p0[k] if kind.decayed(k) else m
                for k, m in prog.momenta().items()})
    out["update3"] = common.norms({k: v - p0[k] for k, v in prog.params().items()})
    del p0
    return out


def run_cell(c: types.SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run; returns the result's fields (``check`` last)."""
    import torch

    from bench import compare, devtrace

    cuda = torch.device(device).type == "cuda"
    phases = {"import_s": time.perf_counter() - t_start}
    if cuda:
        from repro_torch.kernels.build import library

        library()
    phases["extensions_s"] = time.perf_counter() - t_start - sum(phases.values())
    prog = c.kind.Program(c.doc, c.mix, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["weights_s"] = time.perf_counter() - t_start - sum(phases.values())
    steps = c.mix["check_steps"]
    mine = program_readings(prog, c.kind, steps)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["warm_steps_s"] = time.perf_counter() - t_start - sum(phases.values())
    setup_s = time.perf_counter() - t_start

    i, n, t0 = steps, 0, time.perf_counter()
    while True:
        prog.step(i)
        i, n = i + 1, n + 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    window_losses = [r.loss for r in prog.trainer.records[steps:]]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = devtrace.trace_steps(prog.step, i, torch) if trace else None
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = c.kind.train_reference(c.doc, c.mix, seed, device, steps=steps)
    ref_s = time.perf_counter() - t_ref
    correct, check = compare.judge(compare.numbers(mine, ref), c.limits)

    ctx = types.SimpleNamespace(
        setup_s=setup_s, step_s=elapsed / n, steps=n, trace=tr,
        flops_per_step=c.kind.flops_per_step(c.doc, c.mix),
        transport_bytes_per_step=c.kind.transport_bytes_per_step(c.doc, c.mix),
    )
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = m["read"](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": c.cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": n,
           "failed": sum(not math.isfinite(x) for x in window_losses),
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        top = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k[:120], s] for k, s in top],
                            "idle_gaps": [[k[:120], s] for k, s in tr.gaps[:10]]}
        out["traced_launches"] = {"steps": tr.steps, "all": tr.launches,
                                  "transport": tr.launches_of(devtrace.TRANSPORT),
                                  "monitor": tr.launches_of(devtrace.MONITOR)}
    out["setup_phases"] = phases
    out["reference_s"] = ref_s
    out["check"] = check
    return out
