"""Run ``chip_smoke.py`` phases 19, 23, 18 (b), (c) and 24 alone on one
card: the fleet on one device, then the accounting phase whose two rank
processes go on to run phase 18 (b), (c) and to serve phase 19's
scenario through the fleet at tp 2, with ``mfu_line`` counting in a
thread meanwhile, as ``main()`` runs them; then a second pair of rank
processes runs phase 24, phase 18 (b), (c) and phase 24 again.

    python3 tools/fleet_phases.py          # from the root of a checkout; needs one card

The references phase 19 takes (phase 7's requests and static streams,
phase 15 (a)'s sampled and (b)'s paged int8 engine streams) are made here
at ``CUT_LAYERS`` by the same port calls as the whole script makes them;
phase 18 (b), (c) are held to each other only (no phase 15 window run).
The second pair times phase 24 in fresh rank processes before and after
phase 18 (b), (c) ran there, so that what (b), (c) leave in a process
shows in the tick. Every line carries the script's clock; the card's
name and power limit are printed first.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _order_rank(rank, device_name, cfg, fleet, mesh_bc):
    """One rank of the second pair: phase 24, phase 18 (b), (c), phase 24
    again, in one process."""
    import chip_smoke as c

    out = {"cold": c._fleet_mesh_rank(rank, device_name, cfg, fleet)}
    c._mesh_serve_rank(rank, device_name, *mesh_bc)
    gc.collect()
    out["after"] = c._fleet_mesh_rank(rank, device_name, cfg, fleet)
    return out


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as c
    from repro_torch import fp32_math
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.serve import build_requests, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static

    if not torch.cuda.is_available():
        print("fleet_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    c.say(smi)
    t0 = t_all = time.perf_counter()
    fp32_math()
    build.library()
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config("qwen3-1.7b"), num_layers=c.CUT_LAYERS)
    mesh_cfg, spec, storage = setup(cfg, seed=0, device=dev)
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    plan8 = dataclasses.replace(plan, int8_kv=True)
    requests = build_requests(c.SERVE_LENS, c.SERVE_GEN, cfg.vocab_size)
    cap = max(c.SERVE_LENS) + c.SERVE_GEN

    def run(reqs, p, **kw):
        eng = ServeEngine(cfg, mesh_cfg, None, spec, storage, plan=p, max_slots=c.SERVE_SLOTS,
                          cache_capacity=cap, **kw)
        return {rid: r.tokens for rid, r in eng.run(reqs).items()}

    refs = {"requests": requests,
            "static": generate_static(cfg, mesh_cfg, None, spec, storage, requests, plan=plan),
            "sampled": run(c.sampled_requests(requests), plan),
            "int8": run(requests, plan8, paged=True, page_size=c.PAGE)}
    del storage
    gc.collect()
    torch.cuda.empty_cache()
    c.say(f"references at {c.CUT_LAYERS} layers: {time.perf_counter() - t0:.1f} s; {smi}")
    c.say("phase 19: the fleet on one device")
    fleet19 = c.fleet_path(torch, dev, refs, cfg=cfg)
    gc.collect()
    torch.cuda.empty_cache()
    c.say("phase 23: accounting and tooling, then phase 18 (b), (c) and phase 24 in its two "
          "rank processes; mfu_line in a thread meanwhile")
    bc = c.mesh_bc_args(cfg, requests)
    t23 = time.perf_counter()
    mfu_s = []

    def mfu():
        t0 = time.perf_counter()
        c.mfu_line(torch, get_config("qwen3-1.7b"), c.LM_BATCH, c.LM_SEQ, 1.0)
        mfu_s.append(time.perf_counter() - t0)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(mfu)
        acct = c.accounting_path(torch, dev, bc, fleet19)
        job.result()
    c.say(f"   phases 23, 18 (b), (c) and 24 took {time.perf_counter() - t23:.1f} s, mfu_line's "
          f"count {mfu_s[0]:.1f} s of it in its thread; {smi}")
    c.say("phase 18 (b), (c) at 1x2")
    c.mesh_serve_report(acct["mesh_bc"], smi)
    c.say("phase 24: the fleet at tp 2")
    fleet24 = c.fleet_mesh_report(acct["fleet"], smi)
    c.say(f"   phase 24 launches {fleet24['launches']}, flash within {fleet24['flash_err']:.3e}, "
          f"paged_attend within {fleet24['paged_err']:.3e} of the plain versions; the ranks' "
          f"phase {fleet24['phase_s']:.1f} s; {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    c.say("order: a fresh pair runs phase 24, then phase 18 (b), (c), then phase 24 again")
    t0 = time.perf_counter()
    pair = spawn_ranks(_order_rank, c.TPS_TP, str(dev), cfg, fleet19, bc,
                       threads=max(1, (os.cpu_count() or 1) // 4) * 2, timeout_s=900)
    for when in ("cold", "after"):
        c.say(f"order: phase 24 {when}")
        c.fleet_mesh_report([o[when] for o in pair], smi)
    c.say(f"   the order pair took {time.perf_counter() - t0:.1f} s; {smi}")
    c.say(f"all {time.perf_counter() - t_all:.1f} s; {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
