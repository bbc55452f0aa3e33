#!/usr/bin/env python3
"""Split ``count_flops`` of ``chip_smoke.py``'s MFU step (phase 11's:
full-width qwen3-1.7b, fp32, ``oracle:2``, batch 8 x seq 128) into a
layer's FLOPs and the rest, with and without remat, beside
``model_flops_estimate``'s 6·N·D and its parameter split.

    python3 tools/flop_split.py [--batch 8] [--seq 128]

Each count runs the step at 1 and at 2 layers on fake tensors
(``chip_smoke.mfu_line``: nothing allocated, any CPU, a few seconds):
the difference is one layer's FLOPs, the rest the head's and the loss's,
and ``rest + L · layer`` the full depth's count. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as c
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.roofline.analysis import model_flops_estimate

    base = get_config("qwen3-1.7b")
    tokens = args.batch * args.seq
    one = dataclasses.replace(base, num_layers=1)
    two = dataclasses.replace(base, num_layers=2)
    layer_params = two.active_params() - one.active_params()
    out = {"tokens": tokens, "layers": base.num_layers, "params": base.active_params(),
           "layer_params": layer_params,
           "rest_params": base.active_params() - base.num_layers * layer_params,
           "estimate": model_flops_estimate(base, InputShape("mfu", args.seq, args.batch,
                                                             "train"), 1)}
    for remat in (False, True):
        counted = [c.mfu_line(torch, dataclasses.replace(cfg, remat=remat), args.batch,
                              args.seq, 1.0)[1] for cfg in (one, two)]
        layer = counted[1] - counted[0]
        rest = counted[0] - layer
        out["remat" if remat else "no_remat"] = {
            "layer": layer, "rest": rest, "full_depth": rest + base.num_layers * layer}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
