#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Phases, each printing its own lines:

  1. device  — requires ``torch.cuda.is_available()``; prints the card's name
     and power limit as ``nvidia-smi`` reports them.
  2. build   — builds the hand-written kernels (``src/repro_torch/csrc``) for
     ``sm_90a`` into ``build/torch_ext/`` and prints the build seconds.
  3. kernels — Bitpack / Bitunpack against their plain PyTorch versions on
     the same CUDA tensors (round_to 1..3; sizes 1, 127, 32,769 and fc5's
     51,380,224; special values; an unaligned view): planes byte-equal,
     unpack bit-equal, pack∘unpack equal to ``quantize_ref``. Then times
     both at fc5's size with CUDA events beside the plain versions and the
     HBM bound.
  4. main path — A²DTWP training of full-width AlexNet (224×224, 200
     classes, paper init from a seed, batch 64, default ``compress_min_size``)
     through ``Trainer``: an AWP plan that widens every 2 steps
     (8→16→24→32 bits), then ``oracle:2`` steps, then one ``make_cnn_eval``.
     Launch counts are zeroed just before and read just after; every packed
     leaf must have gone through the CUDA kernels, every ``StepRecord``'s
     wire bytes must equal the plan's ``wire_table``. A ``torch.profiler``
     trace of one more warm ``oracle:2`` step gives kernel time by name and
     the device's idle share.
  5. reference — reduced AlexNet trained 4 steps on the card and on the CPU
     (plain versions) from the same weights: losses and norms must agree.

Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without the last line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3 (the rate that bounds these
# memory-bound kernels); the card's own power limit is printed beside it.
HBM_BYTES_PER_S = 3.35e12
FC5 = 51_380_224  # AlexNet fc5: 256·7·7 × 4096 weights, the largest leaf
ALEXNET_DIST = 88_936_448  # weights in DIST leaves (all but conv0)
SPECIAL_BITS = (
    0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000, 0xFF800000,
    0x00000001, 0x807FFFFF, 0x00400000, 0x7FC00000, 0x7F800001, 0xFFFFFFFF,
    0x7FBADBAD, 0x7F7FFFFF, 0xFF7FFFFF, 0x3FFFFFFF, 0x00FFFFFF, 0xFFFF0000,
)


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(torch, device):
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(0)
    for n in (1, 127, 32_769, FC5):
        yield f"normal n={n}", torch.randn(n, generator=gen, device=device) * 3.0
    special = np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32)
    yield "special", torch.from_numpy(np.tile(special, 37)).to(device)
    base = torch.randn(32_772, generator=gen, device=device)
    yield "unaligned view n=32768", base[1:32_769]


def word_err(torch, a, b):
    """Largest difference of two tensors over their integer views."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_kernels(torch, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    err = {"bitpack": 0, "bitunpack": 0}
    for label, w in kernel_cases(torch, device):
        for rt in (1, 2, 3):
            planes = bitpack(w, rt)
            want = ref.bitpack_ref(w, rt)
            check(planes.shape == (rt, *w.shape), f"{label} rt={rt}: plane shape")
            err["bitpack"] = max(err["bitpack"], word_err(torch, planes, want))
            back = bitunpack(planes)
            err["bitunpack"] = max(
                err["bitunpack"], word_err(torch, back, ref.bitunpack_ref(planes))
            )
            q = word_err(torch, back, ref.quantize_ref(w, rt))
            torch.cuda.synchronize()
            check(err["bitpack"] == 0, f"{label} rt={rt}: planes differ from bitpack_ref")
            check(err["bitunpack"] == 0, f"{label} rt={rt}: unpack differs from bitunpack_ref")
            check(q == 0, f"{label} rt={rt}: pack∘unpack differs from quantize_ref")
        say(f"   {label}: planes byte-equal, unpack bit-equal (round_to 1..3)")
    return err


def time_cuda(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(torch, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    gen = torch.Generator(device=device).manual_seed(1)
    w = torch.randn(FC5, generator=gen, device=device)
    out = {}
    for rt in (1, 2, 3):
        planes = bitpack(w, rt)
        nbytes = (4 + rt) * FC5  # each input read once, each output written once
        row = {
            "bitpack": (time_cuda(torch, lambda: bitpack(w, rt)),
                        time_cuda(torch, lambda: ref.bitpack_ref(w, rt), iters=5)),
            "bitunpack": (time_cuda(torch, lambda: bitunpack(planes)),
                          time_cuda(torch, lambda: ref.bitunpack_ref(planes), iters=5)),
        }
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, (ms, plain) in row.items():
            say(
                f"   {name} n={FC5} round_to={rt}: {ms * 1e3:.1f} us "
                f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain * 1e3:.1f} us, "
                f"HBM bound {bound * 1e3:.1f} us ({bound / ms:.0%} of peak)"
            )
            out[(name, rt)] = {"ms": ms, "plain_ms": plain, "bound_ms": bound}
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def build_run(cfg, mesh_cfg, device, seed=0, params=None):
    from repro_torch.models.cnn import init_cnn
    from repro_torch.optim.sgd import init_momentum
    from repro_torch.train.cnn_step import build_cnn_spec_tree, cnn_to_storage

    fresh, metas, groups_info = init_cnn(
        cfg, seed, device=device if params is None else "meta"
    )
    params = fresh if params is None else params
    spec_tree = build_cnn_spec_tree(params, metas, mesh_cfg)
    storage = cnn_to_storage(params, spec_tree, mesh_cfg)
    return storage, init_momentum(storage), spec_tree, groups_info


def train(trainer, storage, mom, data, steps, batch, lr, first_step=0):
    from repro_torch import random as jr

    metrics, data_s = [], 0.0
    for i in range(first_step, first_step + steps):
        t0 = time.perf_counter()
        imgs, labels = data.batch(batch, i)
        data_s += time.perf_counter() - t0
        storage, mom, m = trainer.run_step(
            storage, mom, {"images": imgs, "labels": labels}, lr, jr.PRNGKey(1000 + i)
        )
        metrics.append({k: v.detach().cpu().numpy() for k, v in m.items()})
    return storage, mom, metrics, data_s


AWP_STEPS, ORACLE_STEPS, EVAL_SIZE = 8, 3, 64


def main_path(torch, device, *, cfg=None, batch=64):
    """Full-width AlexNet A²DTWP training through the port's entry points.
    Returns the measurements; raises on a failed check."""
    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.models.cnn import ALEXNET
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import cnn_dist_elems, make_cnn_eval, make_cnn_train_step
    from repro_torch.train.loop import Trainer

    cfg = cfg or ALEXNET
    mesh_cfg = MeshCfg()
    t0 = time.perf_counter()
    storage, mom, spec_tree, groups_info = build_run(cfg, mesh_cfg, device)
    _, num_groups = groups_info
    elems = cnn_dist_elems(spec_tree, groups_info, mesh_cfg)
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, device=str(device))
    setup_s = time.perf_counter() - t0
    # The paper init, N(0, 0.1²) on every weight, starts full-width AlexNet
    # at a loss of about 5e6: from there lr 0.01 and 1e-4 overflow within
    # two steps, and lr 1e-8 lowers the loss step by step.
    opt = SGDConfig(lr=1e-8 if cfg.paper_init else 0.01, momentum=0.9, weight_decay=5e-4)
    n_dist = sum(
        s.kind == "dist" for leafs in spec_tree["layers"].values() for s in leafs.values()
    )

    def trainer_for(plan):
        def builder(rts):
            return make_cnn_train_step(
                cfg, mesh_cfg, spec_tree, groups_info, opt, plan=plan.with_round_tos(rts)
            )
        return Trainer(builder, num_groups, plan=plan, dist_elems_per_group=elems)

    # AWP forced to widen: every |Δ| is below threshold 1.0, so each group
    # widens after `interval` consecutive observations
    awp_plan = PrecisionPlan.build(
        num_groups, round_to=4, schedule="awp", awp_threshold=1.0, awp_interval=2
    )
    awp = trainer_for(awp_plan)
    oracle_plan = PrecisionPlan.build(num_groups, round_to=2)
    oracle = trainer_for(oracle_plan)
    evaluate = make_cnn_eval(cfg, mesh_cfg, spec_tree, groups_info, plan=oracle_plan)
    val_imgs, val_labels = data.validation(EVAL_SIZE)

    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    fc5_start = storage["layers"]["fc5"]["w"].clone() if "fc5" in storage["layers"] else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    bitpack.launches = bitunpack.launches = 0
    t_run = time.perf_counter()
    storage, mom, _, awp_data_s = train(awp, storage, mom, data, AWP_STEPS, batch, opt.lr)
    storage, mom, _, orc_data_s = train(
        oracle, storage, mom, data, ORACLE_STEPS, batch, opt.lr, first_step=AWP_STEPS
    )
    top5 = float(evaluate(storage, val_imgs, val_labels))
    run_s = time.perf_counter() - t_run
    launches = {"bitpack": bitpack.launches, "bitunpack": bitunpack.launches}

    moved = None
    if fc5_start is not None:
        w = storage["layers"]["fc5"]["w"]
        moved = float((w - fc5_start).norm() / fc5_start.norm())
        check(moved > 0.0, "the fc5 master weights did not move")
    records = awp.records + oracle.records
    losses = [r.loss for r in records]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    check(0.0 <= top5 <= 1.0, f"top-5 error {top5} out of range")
    for r, plan in [(r, awp_plan) for r in awp.records] + [(r, oracle_plan) for r in oracle.records]:
        want = plan.with_round_tos(r.round_tos).wire_table(elems, 1)["total"]
        check(r.wire_bytes == want, f"step {r.step}: wire {r.wire_bytes} != plan {want}")
    widened = sum(1 for r in awp.records if r.round_tos[0] < 4)
    packed_steps = widened + ORACLE_STEPS + 1  # + the eval's materialization
    expect = n_dist * packed_steps
    if device.type == "cuda":
        for name, count in launches.items():
            check(count == expect, f"{name}: {count} launches, expected {expect}")
        step = make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, opt, plan=oracle_plan)
        profile_step(torch, step, storage, mom, data, batch, opt.lr)
    return {
        "elems": elems, "n_dist": n_dist, "awp": awp, "oracle": oracle,
        "top5": top5, "launches": launches, "setup_s": setup_s,
        "run_s": run_s, "data_s": awp_data_s + orc_data_s, "fc5_moved": moved,
        "lr": opt.lr,
    }


def profile_step(torch, step, storage, mom, data, batch, lr):
    """Kernel time by name over one warm step (torch.profiler): device
    busy time is the sum of the CUDA kernels' own durations (one stream,
    so they do not overlap), idle share is the rest of the step's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import random as jr

    imgs, labels = data.batch(batch, 10_000)
    b = {"images": imgs, "labels": labels}
    float(step(storage, mom, b, lr, jr.PRNGKey(7))[2]["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step(storage, mom, b, lr, jr.PRNGKey(8))[2]["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    packing = sum(e.self_device_time_total for e in rows if "bitpack" in e.key or "bitunpack" in e.key) / 1e3
    say(f"   profile oracle:2 step: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms "
        f"({len(rows)} kernel names, {sum(e.count for e in rows)} launches), idle share "
        f"{1 - busy_ms / wall_ms:.1%}; bitpack+bitunpack {packing:.3f} ms")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"   profile: {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------


def reference_check(torch, device):
    """Reduced AlexNet, 4 AWP steps (round_to 1, 1, 2, 3): the card's run
    (CUDA kernels, cuDNN) against the CPU's (plain versions, oneDNN) from
    the same weights. Tolerance rtol 1e-3 on the loss and Σw²: the two
    sum their fp32 convolutions in another order, and a weight that sits
    on a truncation boundary may round to the next format step on one
    side."""
    import numpy as np

    from repro_torch.models.cnn import ALEXNET, init_cnn, reduced_cnn
    from repro_torch.utils.trees import tree_map

    cfg = reduced_cnn(ALEXNET, num_classes=10, in_hw=32)
    cpu_params, _, _ = init_cnn(cfg, 3, device="cpu")
    runs = {}
    for dev in (torch.device("cpu"), device):
        params = tree_map(lambda t: t.clone().to(dev), cpu_params)
        runs[dev.type] = _small_run(torch, dev, cfg, params)
    a, b = runs["cpu"], runs[device.type]
    check(a["round_tos"] == b["round_tos"], "round_to trajectories differ")
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-3)
    np.testing.assert_allclose(b["norms"], a["norms"], rtol=1e-3)
    say(f"   reduced alexnet, 4 awp steps, round_tos {[r[1] for r in a['round_tos']]}: "
        f"losses cpu {np.round(a['losses'], 5).tolist()} gpu {np.round(b['losses'], 5).tolist()}")


def _small_run(torch, device, cfg, params):
    import numpy as np

    from repro_torch.data.pipeline import SyntheticImageNet
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.cnn_step import cnn_dist_elems, make_cnn_train_step
    from repro_torch.train.loop import Trainer

    mesh_cfg = MeshCfg(compress_min_size=256)
    storage, mom, spec_tree, groups_info = build_run(cfg, mesh_cfg, device, params=params)
    plan = PrecisionPlan.build(
        groups_info[1], round_to=4, schedule="awp", awp_threshold=1.0, awp_interval=1
    )
    opt = SGDConfig(lr=0.01, momentum=0.9, weight_decay=5e-4)
    trainer = Trainer(
        lambda rts: make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, opt,
                                        plan=plan.with_round_tos(rts)),
        groups_info[1], plan=plan,
        dist_elems_per_group=cnn_dist_elems(spec_tree, groups_info, mesh_cfg),
    )
    data = SyntheticImageNet(num_classes=cfg.num_classes, hw=cfg.in_hw, noise=0.1,
                             device=str(device))
    _, _, metrics, _ = train(trainer, storage, mom, data, 4, 16, opt.lr)
    return {
        "losses": [r.loss for r in trainer.records],
        "round_tos": [r.round_tos for r in trainer.records],
        "norms": np.stack([m["group_norms_sq"] for m in metrics]),
    }


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    say("phase 1: device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    check(smi, "nvidia-smi printed nothing")
    say(smi[0])
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    say(f"   torch {torch.__version__} cuda {torch.version.cuda} on {device_name}")

    from repro_torch import fp32_math
    from repro_torch.kernels import build

    fp32_math()
    say("phase 2: build")
    t0 = time.perf_counter()
    lib = build.library()
    say(f"   built {', '.join(build.SOURCES)} for sm_90a into "
        f"{os.path.relpath(build.BUILD_DIR, ROOT)} in {time.perf_counter() - t0:.1f} s ({lib._name})")

    say("phase 3: kernels vs plain versions on the card")
    err = check_kernels(torch, device)
    times = time_kernels(torch, device)

    say("phase 4: main path — full-width AlexNet A²DTWP training, batch 64")
    run = main_path(torch, device)
    awp, oracle = run["awp"], run["oracle"]
    check(sum(run["elems"]) == ALEXNET_DIST, f"DIST elements {sum(run['elems'])}")
    bits = [(s, b[0]) for s, b in awp.bits_history]
    check(bits == [(0, 8), (3, 16), (5, 24), (7, 32)], f"bits history {awp.bits_history}")
    check(all(len(set(b)) == 1 for _, b in awp.bits_history), "groups widened apart")
    rts = [r.round_tos[0] for r in awp.records + oracle.records]
    check(rts == [1, 1, 1, 2, 2, 3, 3, 4, 2, 2, 2], f"round_to per step {rts}")
    wire = [r.wire_bytes for r in awp.records + oracle.records]
    check(wire[0] == ALEXNET_DIST, f"8-bit step moved {wire[0]} B")
    for r in awp.records + oracle.records:
        say(f"   step {r.step:2d} round_to {r.round_tos[0]} loss {r.loss:.5f} "
            f"wire {r.wire_bytes} B  {r.wall_s * 1e3:.1f} ms"
            f"{'  (first at these formats)' if r.recompiled else ''}")
    warm = [r.wall_s for r in awp.records + oracle.records if not r.recompiled]
    say(f"   AWP bits history {awp.bits_history}")
    say(f"   launches: bitpack {run['launches']['bitpack']}, bitunpack "
        f"{run['launches']['bitunpack']} ({run['n_dist']} packed leaves per step)")
    say(f"   top-5 error after {len(rts)} steps: {run['top5']:.4f}; fc5 master moved by "
        f"{run['fc5_moved']:.3e} of its norm (lr {run['lr']:g})")
    say(f"   step ms (host clock to the loss sync): median of warm steps "
        f"{sorted(warm)[len(warm) // 2] * 1e3:.2f}, all {[round(r.wall_s * 1e3, 2) for r in awp.records + oracle.records]}")
    say(f"   set-up {run['setup_s']:.2f} s, run {run['run_s']:.2f} s of which batch "
        f"synthesis on the host {run['data_s']:.2f} s")

    say("phase 5: reference — reduced AlexNet on the card vs the CPU")
    reference_check(torch, device)

    kernels = []
    for name, src, replaces in (
        ("bitpack", "src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:52"),
        ("bitunpack", "src/repro_torch/csrc/bitunpack.cu", "src/repro/kernels/bitunpack.py:30"),
    ):
        t = times[(name, 2)]  # fc5 at round_to=2 (bf16), the oracle:2 format
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name], "max_abs_err": float(err[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
