"""Run one cell of ``BENCHMARK.json`` once and print its result's line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Exits non-zero with no result when the
cell's chips are not there, when a file is missing, or when ``jax`` or
the JAX package was loaded. The last line of standard output is the
result; the last lines of standard error are the numbers checked, each
beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``build/torch_ext`` itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    from bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.cell["chips"]:
        print(f"bench: {cell.name} needs {cell.cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"bench: modules of JAX or the JAX package loaded: {banned}", file=sys.stderr)
        return 4
    check = out.pop("check")
    out["power_limit"] = _power_limit()
    out["check"] = check
    for v in check.values():  # JSON has no inf or NaN
        if not math.isfinite(v["value"]):
            v["value"] = str(v["value"])
    for name, v in check.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
