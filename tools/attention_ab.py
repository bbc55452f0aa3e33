#!/usr/bin/env python3
"""Time one checkout's flash prefill and paged decode kernels on the card.

    python3 tools/attention_ab.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two versions of the kernels can be timed in one
run on one card, in turns (A, B, B, A). The shapes are ``chip_smoke.py``'s
timed rows: flash at B=1, H=16, Kv=8, S = 128 / 512 / 2048; paged decode at
phase 9's shape (warm, and with the L2 cold over ``COLD_COPIES`` copies of
the pools) and at B=16, 4096 tokens. Each is timed eagerly with CUDA events
(``time_cuda``, which reads the host's dispatch wherever that is slower
than the kernel) and in a CUDA graph (``time_graph``, the device time).
Prints the card's name and power limit, then one JSON line of
microseconds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()

    # the timed package first: chip_smoke puts this checkout's src on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import fp32_math
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.paged_attend import paged_attend

    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("attention_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    fp32_math()
    device = torch.device("cuda", 0)
    us = {}
    gen = torch.Generator(device=device).manual_seed(6)
    for S in cs.FLASH_TIMED:
        q = torch.randn((1, 16, S, 128), generator=gen, device=device)
        k = torch.randn((1, 8, S, 128), generator=gen, device=device)
        v = torch.randn((1, 8, S, 128), generator=gen, device=device)
        fn = lambda: flash_prefill(q, k, v)  # noqa: E731
        us[f"flash S={S} eager"] = cs.time_cuda(torch, fn) * 1e3
        us[f"flash S={S} graph"] = cs.time_graph(torch, [fn], reps=10) * 1e3
    gen = torch.Generator(device=device).manual_seed(8)
    for label, (B, Kv, G, page, width, P, lengths) in cs.PAGED_TIMED:
        a = cs.paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
        fn = lambda: paged_attend(*a)  # noqa: E731
        us[f"paged {label} eager"] = cs.time_cuda(torch, fn) * 1e3
        us[f"paged {label} graph warm"] = cs.time_graph(torch, [fn], reps=10) * 1e3
        if P < 100:
            copies = [a] + [(a[0], a[1].clone(), a[2].clone(), *a[3:])
                            for _ in range(cs.COLD_COPIES - 1)]
            us[f"paged {label} graph cold"] = cs.time_graph(
                torch, [lambda c=c: paged_attend(*c) for c in copies]) * 1e3
    print(json.dumps({"label": args.label, "device": torch.cuda.get_device_name(0),
                      "us": {k: round(t, 2) for k, t in us.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
