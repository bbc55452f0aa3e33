"""The readings that the limits of ``bench/limits/<cell>.json`` are set
from, in one process (not run by the benchmark's own runs):

- ``program``: the program against the reference, one seed after another
  (the lower reading is the largest over a dozen seeds or more);
- ``control``: the reference computed with TF32 on, in the program's
  place, against the reference with it off (the configuration's fp32);
- ``half_batch``: the program with each step fed half its batch, the
  mean taken over the rest (a fault planted under the harness);
- ``unchanged``: the program with its update skipped, so that each step
  returns its state unchanged.

    python3 bench/readings.py --workload vgg-a.adt16 --program 1 2 3 \\
        --control 4 5 6 --half-batch 7 8 9 --unchanged 10

Each reading is one JSON line on standard output (and, with ``--out``, in
that file).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def half_batch(prog) -> None:
    """Feed every step half of its batch (the first rows)."""
    build = prog.trainer.step_builder

    def builder(round_tos):
        fn = build(round_tos)

        def step(storage, mom, batch, lr, *extra):
            b = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return fn(storage, mom, b, lr, *extra)

        return step

    prog.trainer.step_builder = builder


@contextlib.contextmanager
def unchanged():
    """Skip the SGD update inside the program's steps."""
    import repro_torch.train.cnn_step as cnn_step
    import repro_torch.train.step as lm_step

    saved = cnn_step.sgd_update, lm_step.sgd_update

    def skip(params, grads, momentum, *args, **kwargs):
        return params, momentum

    cnn_step.sgd_update = lm_step.sgd_update = skip
    try:
        yield
    finally:
        cnn_step.sgd_update, lm_step.sgd_update = saved


def reading(c, seed: int, what: str, device) -> dict:
    import torch

    from bench import compare, harness

    t0 = time.perf_counter()
    steps = c.mix["check_steps"]
    if what == "control":
        mine = c.kind.train_reference(c.doc, c.mix, seed, device, steps=steps, tf32=True)
    else:
        with unchanged() if what == "unchanged" else contextlib.nullcontext():
            prog = c.kind.Program(c.doc, c.mix, seed, device)
            if what == "half_batch":
                half_batch(prog)
            mine = harness.program_readings(prog, c.kind, steps)
            del prog
    gc.collect()
    torch.cuda.empty_cache()
    ref = c.kind.train_reference(c.doc, c.mix, seed, device, steps=steps)
    return {"workload": c.name, "seed": seed, "what": what,
            "numbers": compare.numbers(mine, ref), "losses": mine["losses"],
            "ref_losses": ref["losses"], "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    for what in ("program", "control", "half-batch", "unchanged"):
        ap.add_argument(f"--{what}", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:1] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness
    from repro_torch.kernels.build import library

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 3
    library()
    c = harness.load_cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for what in ("program", "control", "half_batch", "unchanged"):
            for seed in getattr(args, what):
                line = json.dumps(reading(c, seed, what, "cuda"))
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
