#!/usr/bin/env python3
"""Time one checkout's flash prefill and paged decode kernels on the card.

    python3 tools/attention_ab.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that two versions of the kernels can be timed in one
run on one card, in turns (A, B, B, A). The shapes are ``chip_smoke.py``'s
timed rows: flash at B=1, H=16, Kv=8, S = 128 / 512 / 2048, and at B=2,
S=512 (phase 7's static prefill), in fp32 and (in a graph) in bf16, where
the tp-2 heads (H 8, Kv 4, S 512) join them; paged decode at phase 9's shape (warm,
and with the L2 cold over ``COLD_COPIES`` copies of the pools) and at B=16,
4096 tokens. ``--split-rows R`` sets ``paged_attend.SPLIT_ROWS`` (the
logical rows a split of the paged kernel covers) before timing, so that
one checkout's choices of R can be timed side by side. Each is timed eagerly with CUDA events
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
    ap.add_argument("--split-rows", type=int, default=0,
                    help="paged_attend.SPLIT_ROWS to time (default: the checkout's)")
    args = ap.parse_args()

    # the timed package first: chip_smoke puts this checkout's src on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    from repro_torch import fp32_math
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels import paged_attend as paged_module
    from repro_torch.kernels.paged_attend import paged_attend

    if args.split_rows:
        paged_module.SPLIT_ROWS = args.split_rows

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
    for B, S in [(1, S) for S in cs.FLASH_TIMED] + [(2, 512)]:
        q = torch.randn((B, 16, S, 128), generator=gen, device=device)
        k = torch.randn((B, 8, S, 128), generator=gen, device=device)
        v = torch.randn((B, 8, S, 128), generator=gen, device=device)
        fn = lambda: flash_prefill(q, k, v)  # noqa: E731
        name = f"flash S={S}" if B == 1 else f"flash B={B} S={S}"
        us[f"{name} eager"] = cs.time_cuda(torch, fn) * 1e3
        us[f"{name} graph"] = cs.time_graph(torch, [fn], reps=10) * 1e3
    # the bf16 path: S 128 / 512 / 2048, the tp-2 heads, B=2 at 512
    for B, H, Kv, S in [(1, 16, 8, S) for S in cs.FLASH_TIMED] + [(1, 8, 4, 512), (2, 16, 8, 512)]:
        q, k, v = (torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
                   for s in ((B, H, S, 128), (B, Kv, S, 128), (B, Kv, S, 128)))
        fn = lambda: flash_prefill(q, k, v)  # noqa: E731
        us[f"bf16 flash B={B} H={H} S={S} graph"] = cs.time_graph(torch, [fn], reps=10) * 1e3
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
    print(json.dumps({"label": args.label, "split_rows": getattr(paged_module, "SPLIT_ROWS", None),
                      "device": torch.cuda.get_device_name(0),
                      "us": {k: round(t, 2) for k, t in us.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
