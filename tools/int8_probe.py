#!/usr/bin/env python3
"""Diagnose ``chip_smoke.py`` phase 15 (e) alone: qwen3-1.7b at its widths
and ``--layers`` of its layers (default ``CUT_LAYERS``), phase 7's
requests sampled as phase 15 (a) samples them, served with int8 KV on a
1×2 mesh of gloo ranks through the static path and the 2-slot engine.

    python3 tools/int8_probe.py [--layers N] [--repeat K] [--device cpu --reduced]

Both runs record every int8 KV quantization (``chip_smoke.kv_probe``) and
keep the logits rows they sample from. Where the engine's stream leaves the
static run's, each rank prints ``chip_smoke.int8_probe_report``: the first
request and token at which they part, both runs' top-2 logit gaps there
(absolute and in fp32 ulps) and the draw's distance to its nearest CDF
step (a share of ``cw[-1]``), and the int8 codes and scales that differ
between the runs over the positions that token reads, by layer, with
``x / scale`` on either side of each flipped code step. ``--repeat`` runs
the pair again, to show whether the parting repeats. Prints the card's name
and power limit first, one JSON line of the reports last.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=0, help="depth (default: CUT_LAYERS)")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="reduced() widths (a CPU rehearsal)")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as c
    from repro_torch import fp32_math
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.serve import build_requests

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("int8_probe: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip())
        from repro_torch.kernels import build

        build.library()
    fp32_math()
    cfg = get_config("qwen3-1.7b")
    cfg = reduced(cfg) if args.reduced else cfg
    cfg = dataclasses.replace(cfg, num_layers=args.layers or c.CUT_LAYERS)
    lens = (32, 32, 24, 16, 12) if args.reduced else c.SERVE_LENS
    gen = 5 if args.reduced else c.SERVE_GEN
    sampled = c.sampled_requests(build_requests(lens, gen, cfg.vocab_size))
    reports = []
    for i in range(args.repeat):
        t0 = time.perf_counter()
        ranks = c.mesh_int8_runs(device, cfg, sampled)
        r0 = ranks[0]["runs"]
        same = r0["engine"]["streams"] == r0["static"]["streams"]
        print(f"run {i}: {cfg.num_layers} layers, engine == static: {same} "
              f"({time.perf_counter() - t0:.1f} s)")
        reports.append([o["probe"]["cases"] for o in ranks])
    print(json.dumps(reports))
    return 0


if __name__ == "__main__":
    sys.exit(main())
