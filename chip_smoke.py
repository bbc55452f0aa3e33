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
     HBM bound, and at qwen3-1.7b's per-layer lengths and its embed at
     round_to 2 with the L2 cold (a CUDA graph over input copies).
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
  6. flash — the flash prefill kernel against its plain version on the card
     at qwen3-1.7b's heads (B=1, H=16, Kv=8, hd=128; Sq=Sk 128, 256, 384,
     512, 1024, 2048; a continuation Sq=128, Sk=512, q_offset=384 at B=1
     and 2; B=2 at 512) and at G=1 and G=4, unit normals from a seed, max
     |err| <= 1e-5, two calls bit-equal. Times the kernel (in a CUDA graph,
     the device time, and eager), the plain version and
     ``scaled_dot_product_attention`` (the library yardstick) with CUDA
     events beside the bound (causal FLOPs at 67 TFLOP/s fp32, or bytes at
     3.35 TB/s).
  7. serve — full-width qwen3-1.7b (28 layers, d 2048, vocab 151,936, random
     weights from seed 0) served through ``repro_torch.launch.serve``'s
     functions: ``PrecisionPlan.build(round_to=2)``, five greedy requests
     (prompts 512, 512, 384, 256, 200; 16 new tokens each), 2 slots, cache
     512 + 16. The static one-shot reference, then the engine, then the
     engine with ``weight_stationary``. Launch counts are zeroed before and
     read after each run: 28 flash launches per prefill whose length is a
     multiple of 128 (the 200-token prompt takes ``attend_tiled``, by the
     reference's rule), Bitpack/Bitunpack once per ``DIST`` leaf per
     materialization. Engine streams must equal the static streams, the
     measured ``host_device`` bytes must equal ``serve_host_device_bytes``,
     and every logit the engines sample from must be finite. The first
     flash launch at each distinct shape of these runs (B=1 at 512, 384 and
     256; B=2 at 512 in the static run) is recorded and held to the plain
     version on its own inputs within 1e-5, so a kernel fault at a main-path
     shape fails the run even though the engine and the static reference
     both go through the kernel. Prints
     admission (prefill) ms per prompt length, decode ms/step, tokens/s, the
     memory peak, and a ``torch.profiler`` trace of one 512-token admission
     and one warm decode step.

  8. paged — the paged decode kernel against its plain version on the card
     at phase 9's shape (B=2, Kv=8, G=2, hd=128, page 64, a 9-page table,
     19 pool rows; lengths 1, 63, 64, 65, 200, 528 and 0; a permuted table
     with unused entries at the trash row) and at page 8 with G = 1 and 4,
     and at the split's edges (lengths on them, a table wider than the live
     pages, B=16 at 64 pages), unit normals from a seed, max |err| <= 2e-6;
     each case again on a permuted pool, where the output must not change,
     and twice, where the bits must not. Times the kernel (in a CUDA graph
     with the L2 cold and warm, and eager), the plain version and a
     ``k_pool[table]`` gather plus fp32
     ``scaled_dot_product_attention`` with a length mask (two calls: no
     single PyTorch call reads through a page table) with CUDA events, at
     phase 9's shape and at B=16, 4096 tokens a slot in 64 pages of 64,
     beside the bound (K and V of the attended rows, q and out at 3.35 TB/s).
  9. paged serve — phase 7's weights served through
     ``ServeEngine(paged=True, page_size=64)``. Phase 7's requests (2 slots,
     capacity 528): streams equal to phase 7's static and contiguous-engine
     streams (a divergence prints the reference's top-2 logit gap and
     fails), measured ``host_device`` (the 72 B page table a decode step
     included) equal to ``serve_host_device_bytes``, a clean page audit, 3
     prefill buckets first seen and 2 seen before, and launches: flash 28
     per admission (every bucket, 512, 384 and 256, is a multiple of 128),
     ``paged_attend`` 28 per decode step, Bitpack/Bitunpack once per
     ``DIST`` leaf per forward. Then a 256-token shared prefix with tails of
     64, 100 and 128 tokens (3 slots, capacity 400): the peak equals
     ``serve_paged_kv_bytes`` (11 pages of 14,680,064 B) and streams equal
     ``generate_static`` (a divergence passes only at a reference top-2 gap
     below 1e-3, since the shared pages hold the first writer's bits). The
     first ``paged_attend`` launch at each shape and layer 0's launch of
     every decode step are recorded and held to the plain version on their
     own inputs within 2e-6. Prints decode ms/step, admission ms, tokens/s,
     the memory peak and a ``torch.profiler`` trace of one paged decode
     step.
 10. l2norm — the AWP monitor's Σw² kernel against its plain version on the
     card: unit normals from a seed at lengths 1, 127, 32,769, 20,000,000
     (the Table II/III profile size), 88,080,384 (a stacked gate of
     qwen3-1.7b), 88,936,448 (AlexNet's DIST weights) and 311,164,928
     (qwen3-1.7b's embed), an unaligned view, and the
     special values (inf and NaN where the plain version has them); rtol
     1e-5, and two calls on one input must give the same bits. Times the
     kernel, the plain version and ``torch.dot(x, x)`` (the library
     yardstick) with CUDA events at 20,000,000, a stacked gate
     (88,080,384) and the embed, beside the bound (4 B an element at
     3.35 TB/s).
 11. main path — A²DTWP training of full-width qwen3-1.7b (28 layers,
     random weights from seed 0, ``cfg.remat`` on) through ``Trainer`` and
     ``make_train_step`` on ``synthetic_lm_batch`` at batch 8 x seq 128:
     an AWP plan forced to widen every 2 steps (8→16→24→32 bits), then
     ``oracle:2`` steps. Losses finite, wire bytes equal to the plan's
     ``wire_table``, and launch counts zeroed before and read after:
     Bitpack/Bitunpack once per ``DIST`` leaf per materialization (198 a
     forward, and the 196 group leaves again in the remat backward, at
     every step below 32 bits), ``l2norm_sq`` once per ``DIST`` leaf per
     step (30). Layer group 0's first monitor call of each step is recorded
     and held to the plain version within rtol 1e-5. Prints warm step ms,
     the memory peak and a ``torch.profiler`` trace of one ``oracle:2``
     step with the monitor's and the transfer's share of kernel time.

Phase 4's AWP monitor goes through ``l2norm_sq`` too (one launch per
monitored leaf per step). Then one ``{"kernels": [...]}`` line and, last, the device line
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without the last line.
"""
from __future__ import annotations

import gc
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
QWEN3_EMBED = 151_936 * 2_048  # qwen3-1.7b's embed (and head): the largest leaf
# one layer's gate/up/down, wq/wo and wk/wv: the per-layer views that
# phases 7, 9 and 11 pack and unpack
QWEN3_LAYER = (2_048 * 6_144, 2_048 * 2_048, 2_048 * 1_024)
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
    for n in (1, 127, 32_769, FC5, *QWEN3_LAYER, QWEN3_EMBED):
        yield f"normal n={n}", torch.randn(n, generator=gen, device=device) * 3.0
    special = np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32)
    yield "special", torch.from_numpy(np.tile(special, 37)).to(device)
    base = torch.randn(32_772, generator=gen, device=device)
    yield "unaligned view n=32768", base[1:32_769]


def word_err(torch, a, b):
    """Largest difference of two tensors over their integer views."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.numel() == 0 or torch.equal(a, b):  # no int64 copies of equal tensors
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


def time_graph(torch, fns, reps=2):
    """Device time of one call, with no host dispatch in it: the calls
    ``fns`` (a rotation over input copies, which a caller sizes past the
    50 MB L2 to time it cold) captured ``reps`` times over into one CUDA
    graph and replayed; the mean per call, launch gaps included. The
    eager loop of :func:`time_cuda` measures the host instead wherever a
    call's dispatch takes longer than its kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm, on the capture stream's workspaces
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            for fn in fns:
                fn()
    torch.cuda.synchronize()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def time_qwen3_packing(torch, device):
    """Bitpack and Bitunpack at qwen3-1.7b's per-layer lengths and its
    embed, round_to 2 (the oracle:2 format), L2 cold: each times a
    rotation over enough copies that one pass touches >= 100 MB."""
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    gen = torch.Generator(device=device).manual_seed(3)
    for n in (*QWEN3_LAYER, QWEN3_EMBED):
        nbytes = 6 * n  # 4 B read and 2 B written an element, either way
        copies = max(1, -(-100_000_000 // nbytes))
        ws = [torch.randn(n, generator=gen, device=device) for _ in range(copies)]
        planes = [bitpack(w, 2) for w in ws]
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for name, fns in (
            ("bitpack", [lambda w=w: bitpack(w, 2) for w in ws]),
            ("bitunpack", [lambda p=p: bitunpack(p) for p in planes]),
        ):
            ms = time_graph(torch, fns, reps=1 if n == QWEN3_EMBED else 2)
            say(f"   {name} n={n} round_to=2, L2 cold ({copies} copies): {ms * 1e3:.1f} us "
                f"({nbytes / ms / 1e6:.0f} GB/s), HBM bound {bound * 1e3:.1f} us "
                f"({bound / ms:.0%} of it)")
        del ws, planes


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

    n_monitor = sum(
        s.meta.compress for leafs in spec_tree["layers"].values() for s in leafs.values()
    )

    fc5_start = storage["layers"]["fc5"]["w"].clone() if "fc5" in storage["layers"] else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    zero_counts()
    t_run = time.perf_counter()
    storage, mom, _, awp_data_s = train(awp, storage, mom, data, AWP_STEPS, batch, opt.lr)
    storage, mom, _, orc_data_s = train(
        oracle, storage, mom, data, ORACLE_STEPS, batch, opt.lr, first_step=AWP_STEPS
    )
    top5 = float(evaluate(storage, val_imgs, val_labels))
    run_s = time.perf_counter() - t_run
    got = counts()
    launches = {k: got[k] for k in ("bitpack", "bitunpack", "l2norm_sq")}

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
        for name in ("bitpack", "bitunpack"):
            check(launches[name] == expect, f"{name}: {launches[name]} launches, "
                                            f"expected {expect}")
        # the AWP monitor: one l2norm_sq per monitored leaf per train step
        want = n_monitor * (AWP_STEPS + ORACLE_STEPS)
        check(launches["l2norm_sq"] == want,
              f"l2norm_sq: {launches['l2norm_sq']} launches, expected {want}")
        step = make_cnn_train_step(cfg, mesh_cfg, spec_tree, groups_info, opt, plan=oracle_plan)
        profile_step(torch, step, storage, mom, data, batch, opt.lr)
    return {
        "elems": elems, "n_dist": n_dist, "n_monitor": n_monitor, "awp": awp, "oracle": oracle,
        "top5": top5, "launches": launches, "setup_s": setup_s,
        "run_s": run_s, "data_s": awp_data_s + orc_data_s, "fc5_moved": moved,
        "lr": opt.lr,
    }


def profile(torch, fn, label, top=10):
    """Kernel time by name over one call of ``fn`` (torch.profiler): device
    busy time is the sum of the CUDA kernels' own durations (one stream,
    so they do not overlap), idle share is the rest of the call's wall.
    Returns ``{kernel name: ms}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    check(busy_ms > 0, f"{label}: the profiler saw no device time")
    say(f"   profile {label}: wall {wall_ms:.2f} ms, kernels {busy_ms:.2f} ms "
        f"({len(rows)} kernel names, {sum(e.count for e in rows)} launches), idle share "
        f"{1 - busy_ms / wall_ms:.1%}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        say(f"   profile: {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:80]}")
    return {e.key: e.self_device_time_total / 1e3 for e in rows}


def profile_step(torch, step, storage, mom, data, batch, lr):
    """Profile one warm CNN train step (after one unprofiled warm-up)."""
    from repro_torch import random as jr

    imgs, labels = data.batch(batch, 10_000)
    b = {"images": imgs, "labels": labels}
    float(step(storage, mom, b, lr, jr.PRNGKey(7))[2]["loss"])
    by_name = profile(
        torch, lambda: float(step(storage, mom, b, lr, jr.PRNGKey(8))[2]["loss"]),
        "oracle:2 step",
    )
    packing = sum(ms for k, ms in by_name.items() if "bitpack" in k or "bitunpack" in k)
    monitor = sum(ms for k, ms in by_name.items() if "l2norm" in k)
    say(f"   profile oracle:2 step: bitpack+bitunpack {packing:.3f} ms, l2norm_sq "
        f"{monitor:.3f} ms")


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
# phase 6: the flash prefill kernel against its plain version
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet: 67 TFLOP/s fp32 on the CUDA cores (the kernel
# runs fp32 FMAs, TF32 off).
FP32_FLOP_PER_S = 67e12
# (B, H, Kv, Sq, Sk, q_offset): qwen3-1.7b's heads (hd 128), at the timed
# lengths, phase 7's prefill lengths (512 at B=1 and 2, 384, 256) and a
# continuation; then the work list's edges: the continuation at B=2 (every
# unit split into pieces), S=1024 (units of 1 to 16 tiles, those above 9
# cut in two), and G=1 and G=4 (units of one head and of four)
FLASH_SHAPES = (
    (1, 16, 8, 128, 128, 0),
    (1, 16, 8, 512, 512, 0),
    (1, 16, 8, 2048, 2048, 0),
    (1, 16, 8, 384, 384, 0),
    (1, 16, 8, 256, 256, 0),
    (1, 16, 8, 128, 512, 384),
    (2, 16, 8, 512, 512, 0),
    (2, 16, 8, 128, 512, 384),
    (1, 16, 8, 1024, 1024, 0),
    (1, 8, 8, 256, 256, 0),
    (1, 32, 8, 192, 320, 128),
)
FLASH_TIMED = (128, 512, 2048)  # Sq = Sk, B = 1, q_offset = 0
FLASH_TOL = 1e-5


def flash_bound(B, H, Kv, Sq, Sk, q_offset, hd=128):
    """Least time for the causal attention these inputs need: the larger
    of the FLOPs of the unmasked (q, k) pairs (2·hd for q·k and 2·hd for
    p·v each) at the fp32 peak, and q, k, v and out moved once at the HBM
    rate. Returns (ms, "operations" or "bytes")."""
    rows = [min(q_offset + r + 1, Sk) for r in range(Sq)]
    flops = 4 * hd * B * H * sum(rows)
    nbytes = 4 * hd * (2 * B * H * Sq + 2 * B * Kv * Sk)
    t_ops, t_bytes = flops / FP32_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_flash(torch, device):
    """Kernel vs plain version at every FLASH_SHAPES case; times at
    FLASH_TIMED. Returns {Sq: row} with the S = Sq = Sk numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill

    gen = torch.Generator(device=device).manual_seed(6)
    out = {}
    for B, H, Kv, Sq, Sk, off in FLASH_SHAPES:
        q = torch.randn((B, H, Sq, 128), generator=gen, device=device)
        k = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        v = torch.randn((B, Kv, Sk, 128), generator=gen, device=device)
        got = flash_prefill(q, k, v, q_offset=off)
        again = flash_prefill(q, k, v, q_offset=off)
        # the plain version's 128-row tiles need Sq and Sk to be multiples
        block = 128 if Sq % 128 == 0 and Sk % 128 == 0 else 64
        want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=block, block_k=block)
        err = float((got - want).abs().max())
        torch.cuda.synchronize()
        label = f"B={B} H={H} Kv={Kv} Sq={Sq} Sk={Sk} q_offset={off}"
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash {label}: max |err| {err:.3e} > {FLASH_TOL}")
        check(torch.equal(got, again), f"flash {label}: two calls gave other bits")
        line = f"   flash {label}: max |kernel - plain| {err:.3e}; two calls bit-equal"
        if B == 1 and H == 16 and Sq == Sk and off == 0 and Sq in FLASH_TIMED:
            eager = time_cuda(torch, lambda: flash_prefill(q, k, v))
            ms = time_graph(torch, [lambda: flash_prefill(q, k, v)], reps=10)
            plain = time_cuda(torch, lambda: ref.flash_prefill_ref(q, k, v),
                              iters=5)
            lib = time_cuda(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
            bound, by = flash_bound(B, H, Kv, Sq, Sk, off)
            out[Sq] = {"ms": ms, "eager_ms": eager, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            line += (f"; kernel {ms * 1e3:.1f} us in a CUDA graph ({eager * 1e3:.1f} us "
                     f"eager), plain {plain * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us, bound "
                     f"{bound * 1e3:.1f} us ({by}, {bound / ms:.0%} of it)")
        say(line)
    return out


# ---------------------------------------------------------------------------
# phase 7: full-width qwen3-1.7b served through the continuous-batching engine
# ---------------------------------------------------------------------------

SERVE_LENS, SERVE_GEN, SERVE_SLOTS = (512, 512, 384, 256, 200), 16, 2


def _wrappers():
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.l2norm import l2norm_sq
    from repro_torch.kernels.paged_attend import paged_attend

    return {"bitpack": bitpack, "bitunpack": bitunpack, "flash_prefill": flash_prefill,
            "paged_attend": paged_attend, "l2norm_sq": l2norm_sq}


def counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def watch_flash(torch, seen):
    """Route the model's flash calls through a recorder that keeps the
    inputs and output of the first launch at each distinct (q shape, k
    shape, q_offset) in ``seen``; :func:`check_seen_flash` then holds them
    to the plain version. Only copies are taken inside the run, so its
    timings keep the kernel's pace. Returns the undo function."""
    from repro_torch.models import attention

    kernel = attention.flash_prefill

    def recorded(q, k, v, *, q_offset=0):
        out = kernel(q, k, v, q_offset=q_offset)
        key = (tuple(q.shape), tuple(k.shape), int(q_offset))
        if key not in seen:
            seen[key] = {"inputs": (q.clone(), k.clone(), v.clone()), "out": out.clone()}
        return out

    attention.flash_prefill = recorded
    return lambda: setattr(attention, "flash_prefill", kernel)


def check_seen_flash(seen):
    """The plain version on each recorded launch's own inputs: the main
    path's real shapes and data, within FLASH_TOL."""
    from repro_torch.kernels import ref

    for key, rec in seen.items():
        if "max_abs_err" in rec:
            continue
        (q, k, v), (_, _, off) = rec.pop("inputs"), key
        err = float((rec.pop("out") - ref.flash_prefill_ref(q, k, v, q_offset=off)).abs().max())
        rec["max_abs_err"] = err
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash on the main path, q {key[0]} k {key[1]} q_offset {off}: "
              f"max |err| {err:.3e} > {FLASH_TOL}")
        say(f"   flash on the main path, q {key[0]} k {key[1]} q_offset {off}: "
            f"max |kernel - plain| {err:.3e}")


def instrument(engine, timings):
    """Host-clock each admission and decode tick of ``engine`` (both end in
    the d2h copy of the sampled ids, which waits for the device) and hold
    every logit it samples from to be finite."""
    import torch

    admit, tick, sample = engine.admit, engine.decode_tick, engine._sample

    def timed_admit(req):
        t0 = time.perf_counter()
        admit(req)
        timings["admit"].append((len(req.prompt_ids), time.perf_counter() - t0))

    def timed_tick():
        active = engine.active_slots
        t0 = time.perf_counter()
        tick()
        if active:
            timings["decode"].append(time.perf_counter() - t0)

    def checked_sample(logits):
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        return sample(logits)

    engine.admit, engine.decode_tick, engine._sample = timed_admit, timed_tick, checked_sample


def top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, req):
    """Greedy decode of one request (batch 1) with each step's top-2 logit
    gap: what a diverging stream is checked against."""
    from repro_torch.serve.step import make_decode_step, make_prefill_step

    S, dev = len(req.prompt_ids), storage["embed"].device
    pre = make_prefill_step(cfg, mesh_cfg, None, spec_tree, plan=plan,
                            cache_capacity=S + req.max_new)
    dec = make_decode_step(cfg, mesh_cfg, None, spec_tree, plan=plan)
    logits, caches = pre(storage, {"tokens": torch.tensor([req.prompt_ids], device=dev)})
    toks, gaps = [], []
    for i in range(req.max_new):
        top = torch.topk(logits[0, -1, : cfg.vocab_size], 2)
        toks.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))
        if i + 1 < req.max_new:
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            pos = torch.tensor(S + i, dtype=torch.int32, device=dev)
            logits, caches = dec(storage, caches, {"tokens": tok, "pos": pos})
    return toks, gaps


def serve_path(torch, device, *, cfg=None, lens=SERVE_LENS, gen=SERVE_GEN):
    """Full-width qwen3-1.7b through the serve twin's functions. Returns
    the measurements; raises on a failed check. Launch counts, the
    memory peak and the profile are read on a card only, so that
    ``serve_path(torch, torch.device("cpu"), cfg=reduced(...), lens=...)``
    rehearses the phase on the CPU with the plain versions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist.spec import DIST
    from repro_torch.launch.serve import build_requests, check_wire, setup
    from repro_torch.plan import PrecisionPlan
    from repro_torch.serve.engine import ServeEngine, generate_static
    from repro_torch.utils.trees import tree_leaves

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh_cfg, spec_tree, storage = setup(cfg, seed=0, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    requests = build_requests(lens, gen, cfg.vocab_size)
    cap = max(lens) + gen
    n_params = sum(x.numel() for x in [storage[k] for k in storage if k != "groups"]
                   + [x for g in storage["groups"] for x in tree_leaves(g)])
    # materializations per forward: each stacked DIST leaf once per layer,
    # each top-level DIST leaf once; placement packs each leaf once, whole
    per_forward = sum(s.reps for g in spec_tree["groups"] for s in tree_leaves(g)
                      if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
    per_place = sum(1 for g in spec_tree["groups"] for s in tree_leaves(g)
                    if s.kind == DIST) + sum(
        1 for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST)
    # the reference's viability rule for these prompts (device, hd, length)
    viable = [on_card and cfg.head_dim % 128 == 0 and S % 128 == 0 for S in lens]
    say(f"   {cfg.name}: {n_params:,} fp32 parameters ({n_params * 4 / 1e9:.2f} GB), "
        f"init {setup_s:.2f} s; {per_forward} DIST materializations per forward, "
        f"{per_place} per placement")

    launches, out, seen = {}, {}, {}
    unwatch = watch_flash(torch, seen)
    zero_counts()
    t0 = time.perf_counter()
    static = generate_static(cfg, mesh_cfg, None, spec_tree, storage, requests, plan=plan)
    static_s = time.perf_counter() - t0
    launches["static"] = counts()
    check_seen_flash(seen)
    groups = sorted(set(lens))
    forwards = len(groups) + len(groups) * (gen - 1)
    want = {"flash_prefill": cfg.num_layers * sum(v for S, v in dict(zip(lens, viable)).items()),
            "bitpack": per_forward * forwards * on_card, "paged_attend": 0, "l2norm_sq": 0}
    want["bitunpack"] = want["bitpack"]
    check(launches["static"] == want, f"static: launches {launches['static']}, expected {want}")
    say(f"   static reference: {len(groups)} groups in {static_s:.2f} s; launches "
        f"{launches['static']}")

    for ws in (False, True):
        label = "engine, weight-stationary" if ws else "engine"
        timings = {"admit": [], "decode": []}
        zero_counts()
        sync()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=SERVE_SLOTS, cache_capacity=cap,
                             weight_stationary=ws)
        instrument(engine, timings)
        results = engine.run(requests)
        wall = time.perf_counter() - t0
        got = counts()
        launches[label] = got
        check_seen_flash(seen)
        summary = engine.wire_summary()
        analytic = check_wire(engine, plan, requests)
        diverged = [r for r in requests if results[r.rid].tokens != static[r.rid]]
        for r in diverged:
            toks, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
            t = next(i for i, (a, b) in enumerate(zip(results[r.rid].tokens, static[r.rid]))
                     if a != b)
            say(f"   DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at step {t}: "
                f"engine {results[r.rid].tokens[t]}, static {static[r.rid][t]}, batch-1 "
                f"greedy {toks[t]}, top-2 logit gap {gaps[t]:.3e}")
        check(not diverged, f"{label}: streams of {[r.rid for r in diverged]} differ "
                            "from the static reference")
        admissions = summary["admissions"]
        packed = admissions * per_forward + (per_place if ws else
                                             summary["decode_steps"] * per_forward)
        want = {"flash_prefill": cfg.num_layers * sum(viable), "bitpack": packed * on_card,
                "bitunpack": packed * on_card, "paged_attend": 0, "l2norm_sq": 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        new_tokens = sum(len(r.tokens) for r in results.values())
        dec = sorted(timings["decode"])
        by_len = {}
        for S, t in timings["admit"]:
            by_len.setdefault(S, []).append(t * 1e3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        say(f"   {label}: {summary['steps']} steps ({summary['decode_steps']} decode, "
            f"{admissions} admissions) in {wall:.2f} s, {new_tokens} tokens, "
            f"{new_tokens / wall:.1f} tokens/s; streams equal to the static reference")
        say(f"   {label}: admission (prefill + insert + first id) ms by prompt length "
            f"{ {S: [round(x, 2) for x in v] for S, v in sorted(by_len.items())} }")
        say(f"   {label}: decode ms/step median {dec[len(dec) // 2] * 1e3:.2f} "
            f"(min {dec[0] * 1e3:.2f}, max {dec[-1] * 1e3:.2f}, {len(dec)} steps)")
        say(f"   {label}: host_device {summary['host_device']} B == serve_host_device_bytes "
            f"{analytic['total']} B at {summary['token_width']} B/id; launches {got}; "
            f"memory peak {peak / 2**30:.2f} GiB")
        out[label] = {"wall_s": wall, "tokens": new_tokens, "decode_ms": dec[len(dec) // 2] * 1e3,
                      "admit_ms": by_len, "peak": peak, "engine": engine,
                      "streams": {k: r.tokens for k, r in results.items()}}

    unwatch()
    # every prefill shape the kernel took was held to the plain version
    want_shapes = {(b, S) for S, v in zip(lens, viable) if v for b in (1, lens.count(S))}
    got_shapes = {(key[0][0], key[0][2]) for key in seen}
    check(got_shapes == want_shapes,
          f"flash shapes held to the plain version {sorted(got_shapes)}, expected "
          f"{sorted(want_shapes)}")
    if on_card:
        engine = out["engine"]["engine"]  # the non-stationary engine, warm
        engine.begin_stream()
        first, second = requests[0], requests[1]  # both of the longest length
        engine.admit(first)
        by_name = profile(torch, lambda: engine.admit(second),
                          f"admission of a {len(second.prompt_ids)}-token prompt")
        say(f"   profile: flash_prefill {sum(ms for k, ms in by_name.items() if 'flash' in k):.3f}"
            " ms of the admission")
        profile(torch, engine.decode_tick, "decode step (2 slots)")
    for o in out.values():
        del o["engine"]
    return {"launches": launches, "runs": out, "static_s": static_s,
            "flash_err": max((r["max_abs_err"] for r in seen.values()), default=0.0),
            # what phase 9 reuses: the weights are built once
            "cfg": cfg, "setup": (mesh_cfg, spec_tree, storage), "plan": plan,
            "requests": requests,
            "static": static, "per_forward": per_forward}


# ---------------------------------------------------------------------------
# phase 8: the paged decode kernel against its plain version
# ---------------------------------------------------------------------------

# Another summation order than the plain version's (per-row dots, shuffle
# trees) in fp32 on O(1) outputs: on an H100 the kernel differed by at most
# 6.0e-7 on unit normals and 1.2e-6 on the main path's own inputs.
PAGED_TOL = 2e-6
# (B, Kv, G, page, table width, pool rows, lengths): phase 9's shape
# (qwen3-1.7b's heads, page 64, 9-page table, 18 pages + the trash row) at
# the lengths that cross page edges, a slot of length 0, and the largest;
# then page 8 with G = 1 and 4, so that the fold h = kv * G + g is held;
# then the split's edges on 132 SMs: one-page splits at lengths on their
# edges and the full table, a table wider than the live pages (splits past
# them empty), and B=16 at 64 pages (2 splits of 32 pages) at and across a
# split's edge
PAGED_CASES = (
    (2, 8, 2, 64, 9, 19, (528, 0)),
    (2, 8, 2, 64, 9, 19, (1, 63)),
    (2, 8, 2, 64, 9, 19, (64, 65)),
    (2, 8, 2, 64, 9, 19, (200, 528)),
    (3, 8, 1, 8, 66, 199, (528, 9, 0)),
    (3, 8, 4, 8, 66, 199, (8, 527, 1)),
    (2, 8, 2, 64, 9, 19, (576, 128)),
    (3, 8, 2, 64, 20, 61, (65, 129, 0)),
    (16, 8, 2, 64, 64, 1025, (2048, 2049) * 8),
)
# input copies a cold-L2 timing rotates through: 10 x the main path's
# 10 MB of pools is twice the 50 MB L2
COLD_COPIES = 10
PAGED_TIMED = (
    ("main path", (2, 8, 2, 64, 9, 19, (528, 528))),
    ("4096 tokens", (16, 8, 2, 64, 64, 1025, (4096,) * 16)),
)


def paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths):
    """Unit normals; each slot's live pages at distinct random pool rows
    (a permuted table), its unused entries at the trash row ``P - 1``."""
    q = torch.randn((B, Kv, G, 128), generator=gen, device=device)
    k_pool = torch.randn((P, page, Kv, 128), generator=gen, device=device)
    v_pool = torch.randn((P, page, Kv, 128), generator=gen, device=device)
    rows = torch.randperm(P - 1, generator=gen, device=device)[: B * width].reshape(B, width)
    table = torch.full((B, width), P - 1, dtype=torch.int32, device=device)
    for b, n in enumerate(lengths):
        live = -(-n // page) if n else width  # a slot of length 0 walks them all
        table[b, :live] = rows[b, :live].to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, table, lens


def paged_bound(B, Kv, G, page, width, lengths, hd=128):
    """Least time for these inputs: K and V of the rows they attend (a slot
    of length L >= 1 needs L rows, one of length 0 all ``width * page``),
    q read once and out written once, at the HBM rate; the G/2 FLOPs a
    byte are far below the fp32 ridge. Returns ms."""
    rows = sum(min(n, width * page) if n else width * page for n in lengths)
    nbytes = 4 * hd * (2 * Kv * rows + 2 * B * Kv * G)
    return nbytes / HBM_BYTES_PER_S * 1e3


def gather_sdpa(torch, q, k_pool, v_pool, table, lengths):
    """The library yardstick: ``k_pool[table]`` gather, then fp32
    ``scaled_dot_product_attention`` with a length mask (two calls; no
    single PyTorch call reads through a page table). Length >= 1 only."""
    import torch.nn.functional as F

    B, Kv, G, hd = q.shape
    idx = table.to(torch.int64)
    k = k_pool[idx].reshape(B, -1, Kv, hd).transpose(1, 2)
    v = v_pool[idx].reshape(B, -1, Kv, hd).transpose(1, 2)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < lengths[:, None].to(torch.int64)
    out = F.scaled_dot_product_attention(q.reshape(B, Kv * G, 1, hd), k, v,
                                         attn_mask=mask[:, None, None, :], enable_gqa=True)
    return out.reshape(B, Kv, G, hd)


def check_paged(torch, device):
    """Kernel vs plain version at every PAGED_CASES case (and on a permuted
    pool, where the output must not change); times at PAGED_TIMED. Returns
    {label: row}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attend import paged_attend

    gen = torch.Generator(device=device).manual_seed(8)
    err = 0.0
    for B, Kv, G, page, width, P, lengths in PAGED_CASES:
        args = paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
        got = paged_attend(*args)
        again = paged_attend(*args)
        e = float((got - ref.paged_attend_ref(*args)).abs().max())
        q, kp, vp, table, lens = args
        perm = torch.randperm(P, generator=gen, device=device)
        inv = torch.argsort(perm).to(torch.int32)
        moved = paged_attend(q, kp[perm], vp[perm], inv[table.to(torch.int64)], lens)
        torch.cuda.synchronize()
        label = f"B={B} Kv={Kv} G={G} page={page} width={width} lengths={list(lengths)}"
        check(math.isfinite(e) and e <= PAGED_TOL,
              f"paged_attend {label}: max |err| {e:.3e} > {PAGED_TOL}")
        check(torch.equal(moved, got), f"paged_attend {label}: a permuted pool changed the output")
        check(torch.equal(again, got), f"paged_attend {label}: two calls gave other bits")
        err = max(err, e)
        say(f"   paged_attend {label}: max |kernel - plain| {e:.3e}; permuted pool: equal; "
            "two calls bit-equal")
    out = {}
    for label, (B, Kv, G, page, width, P, lengths) in PAGED_TIMED:
        args = paged_inputs(torch, device, gen, B, Kv, G, page, width, P, lengths)
        got = paged_attend(*args)
        e = float((got - ref.paged_attend_ref(*args)).abs().max())
        lib_err = float((gather_sdpa(torch, *args) - got).abs().max())
        check(math.isfinite(e) and e <= PAGED_TOL, f"paged_attend {label}: max |err| {e:.3e}")
        err = max(err, e)
        eager = time_cuda(torch, lambda: paged_attend(*args))
        warm = time_graph(torch, [lambda: paged_attend(*args)], reps=10)
        # cold: a rotation over copies of the pools (the 4096-token pools,
        # 537 MB, are cold by themselves)
        copies = [args] + [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                           for _ in range(COLD_COPIES - 1 if P < 100 else 0)]
        cold = time_graph(torch, [lambda a=a: paged_attend(*a) for a in copies])
        del copies
        plain = time_cuda(torch, lambda: ref.paged_attend_ref(*args), iters=5)
        lib = time_cuda(torch, lambda: gather_sdpa(torch, *args))
        bound = paged_bound(B, Kv, G, page, width, lengths)
        out[label] = {"ms": cold, "warm_ms": warm, "eager_ms": eager, "plain_ms": plain,
                      "gather_sdpa_ms": lib, "bound_ms": bound, "max_abs_err": e}
        say(f"   paged_attend {label} (B={B} Kv={Kv} G={G}, {width} pages of {page}, lengths "
            f"{lengths[0]}): kernel in a CUDA graph {cold * 1e3:.1f} us with the L2 cold, "
            f"{warm * 1e3:.1f} us warm ({eager * 1e3:.1f} us eager), plain {plain * 1e3:.1f} "
            f"us, gather+sdpa {lib * 1e3:.1f} us (within {lib_err:.1e} of the kernel), bound "
            f"{bound * 1e3:.1f} us (bytes, {bound / cold:.0%} of it cold); max |err| {e:.3e}")
    out["max_abs_err"] = err
    return out


# ---------------------------------------------------------------------------
# phase 9: full-width qwen3-1.7b served through the paged engine
# ---------------------------------------------------------------------------

PAGE = 64
# a 256-token (4-page) shared prefix plus tails of 64, 100 and 128 tokens
SHARED_PREFIX, SHARED_TAILS, SHARED_CAPACITY = 256, (64, 100, 128), 400
# a shared-prefix stream may leave the static reference only where the
# reference's top-2 logits are this close (the card test's FULL_TOL): the
# shared pages hold bits the 320-token prefill (attend_tiled) wrote, not
# the ones the slot's own prefill (flash) would have
NEAR_TIE = 1e-3


def watch_paged(torch, seen, every):
    """Route the model's paged_attend calls through a recorder that keeps
    copies of the inputs and output of the first launch at each distinct
    shape and of every ``every``-th launch after it (with ``every`` a
    multiple of the layer count, layer 0 of every few decode steps, so the
    lengths a run reaches); :func:`check_seen_paged` holds them to the
    plain version. Returns the undo function."""
    from repro_torch.models import attention

    kernel, calls = attention.paged_attend, [0]

    def recorded(q, k_pool, v_pool, page_table, lengths):
        out = kernel(q, k_pool, v_pool, page_table, lengths)
        key = tuple(tuple(t.shape) for t in (q, k_pool, page_table))
        if key not in {k for k, _ in seen} or calls[0] % every == 0:
            seen.append((key, {"inputs": tuple(t.clone() for t in
                                               (q, k_pool, v_pool, page_table, lengths)),
                               "out": out.clone()}))
        calls[0] += 1
        return out

    attention.paged_attend = recorded
    return lambda: setattr(attention, "paged_attend", kernel)


def check_seen_paged(seen):
    """The plain version on each recorded launch's own inputs, within
    PAGED_TOL; returns the largest error."""
    from repro_torch.kernels import ref

    err, shapes = 0.0, set()
    for key, rec in seen:
        if "max_abs_err" not in rec:
            inputs = rec.pop("inputs")
            rec["max_abs_err"] = float((rec.pop("out") - ref.paged_attend_ref(*inputs))
                                       .abs().max())
            check(math.isfinite(rec["max_abs_err"]) and rec["max_abs_err"] <= PAGED_TOL,
                  f"paged_attend on the main path, shapes {key}: max |err| "
                  f"{rec['max_abs_err']:.3e} > {PAGED_TOL}")
        err = max(err, rec["max_abs_err"])
        shapes.add(key)
    say(f"   paged_attend on the main path: {len(seen)} launches at shapes (q, pool, table) "
        f"{sorted(shapes)} held to the plain version, max |kernel - plain| {err:.3e}")
    return err


def report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r, got, want):
    """Print where a stream left the reference and the reference's batch-1
    top-2 logit gap there; returns that gap."""
    t = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    toks, gaps = top2_gaps(torch, cfg, mesh_cfg, spec_tree, storage, plan, r)
    say(f"   DIVERGED request {r.rid} (prompt {len(r.prompt_ids)}) at step {t}: "
        f"paged {got[t]}, reference {want[t]}, batch-1 greedy {toks[t]}, "
        f"top-2 logit gap {gaps[t]:.3e}")
    return gaps[t]


def paged_path(torch, device, phase7, *, page=PAGE, shared=SHARED_PREFIX,
               tails=SHARED_TAILS, shared_cap=SHARED_CAPACITY):
    """Full-width qwen3-1.7b through ``ServeEngine(paged=True)`` on phase
    7's weights (``phase7``, :func:`serve_path`'s result). Two runs: phase
    7's requests, held to phase 7's static and contiguous-engine streams
    exactly; and a shared-prefix run whose three requests are resident at
    once, held to ``serve_paged_kv_bytes`` and to ``generate_static`` (a
    divergence passes only at a reference top-2 gap below ``NEAR_TIE``:
    the shared pages hold the first writer's bits). Returns the
    measurements; raises on a failed check. Launch counts, the memory peak
    and the profile are read on a card only, so the phase rehearses on the
    CPU at a reduced config with a smaller ``page``, ``shared`` and
    ``tails``."""
    from repro_torch.launch.serve import build_requests, check_wire
    from repro_torch.roofline.analysis import serve_paged_kv_bytes
    from repro_torch.serve.engine import ServeEngine, generate_static

    mesh_cfg, spec_tree, storage = phase7["setup"]
    plan, per_forward = phase7["plan"], phase7["per_forward"]
    cfg = phase7["cfg"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = phase7["requests"][0].max_new
    flash_ok = on_card and cfg.head_dim % 128 == 0
    out, seen = {}, []
    gc.collect()  # phase 7's engines (reference cycles through instrument())
    # layer 0 of every 8th decode step: ~10 MB of copies each
    unwatch = watch_paged(torch, seen, 8 * cfg.num_layers)

    def run(label, requests, cap, slots, static):
        timings = {"admit": [], "decode": []}
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        zero_counts()
        sync()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, mesh_cfg, None, spec_tree, storage, plan=plan,
                             max_slots=slots, cache_capacity=cap, paged=True, page_size=page)
        instrument(engine, timings)
        results = engine.run(requests)  # finish() audits the pages
        wall = time.perf_counter() - t0
        got = counts()
        summary = engine.wire_summary()
        analytic = check_wire(engine, plan, requests)
        check(summary["page_table_entries"] == slots * -(-cap // page),
              f"{label}: {summary['page_table_entries']} page-table entries")
        audit = engine.pages.audit()
        check(audit["live"] == 0 and audit["allocs"] == audit["releases"],
              f"{label}: page audit {audit}")
        buckets = [-(-len(r.prompt_ids) // page) * page for r in requests]
        misses = len(set(buckets))
        check((summary["prefill_misses"], summary["prefill_hits"]) ==
              (misses, len(buckets) - misses),
              f"{label}: prefill buckets {summary['prefill_misses']} first seen, "
              f"{summary['prefill_hits']} seen before; expected {misses}")
        steps = summary["decode_steps"]
        packed = (summary["admissions"] + steps) * per_forward * on_card
        want = {"flash_prefill": cfg.num_layers * sum(flash_ok and S % 128 == 0 for S in buckets),
                "paged_attend": cfg.num_layers * steps * on_card,
                "bitpack": packed, "bitunpack": packed, "l2norm_sq": 0}
        check(got == want, f"{label}: launches {got}, expected {want}")
        new_tokens = sum(len(r.tokens) for r in results.values())
        dec = sorted(timings["decode"])
        by_len = {}
        for S, t in timings["admit"]:
            by_len.setdefault(S, []).append(t * 1e3)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        say(f"   {label}: {summary['steps']} steps ({steps} decode, "
            f"{summary['admissions']} admissions) in {wall:.2f} s, {new_tokens} tokens, "
            f"{new_tokens / wall:.1f} tokens/s")
        say(f"   {label}: admission (pad + prefill + page insert + first id) ms by prompt "
            f"length { {S: [round(x, 2) for x in v] for S, v in sorted(by_len.items())} }")
        say(f"   {label}: decode ms/step median {dec[len(dec) // 2] * 1e3:.2f} "
            f"(min {dec[0] * 1e3:.2f}, max {dec[-1] * 1e3:.2f}, {len(dec)} steps)")
        say(f"   {label}: host_device {summary['host_device']} B (page table "
            f"{summary['page_table']} B) == serve_host_device_bytes {analytic['total']} B; "
            f"buckets {summary['prefill_misses']} first seen, {summary['prefill_hits']} seen "
            f"before; launches {got}; memory peak {peak / 2**30:.2f} GiB")
        res = engine.kv_residency()
        say(f"   {label}: page audit {audit}; peak {res['pages_peak']} pages of "
            f"{res['bytes_per_page']} B ({res['kv_bytes_peak'] / 1e6:.1f} MB), pool "
            f"{(engine.num_pages + 1) * res['bytes_per_page'] / 1e6:.1f} MB")
        out[label] = {"wall_s": wall, "tokens": new_tokens, "decode_ms": dec[len(dec) // 2] * 1e3,
                      "admit_ms": by_len, "peak": peak, "launches": got, "residency": res}
        streams = {k: r.tokens for k, r in results.items()}
        diverged = [r for r in requests if streams[r.rid] != static[r.rid]]
        return engine, streams, diverged

    # run 1: phase 7's requests, 2 slots, capacity 512 + 16
    requests = phase7["requests"]
    cap = max(len(r.prompt_ids) for r in requests) + gen
    engine, streams, diverged = run("paged engine", requests, cap, SERVE_SLOTS,
                                    phase7["static"])
    for r in diverged:
        report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                          streams[r.rid], phase7["static"][r.rid])
    check(not diverged, f"paged engine: streams of {[r.rid for r in diverged]} differ from "
                        "the static reference")
    contiguous = phase7["runs"]["engine"]["streams"]
    check(streams == contiguous, "paged engine: streams differ from the contiguous engine's")
    say("   paged engine: streams equal to the static reference and the contiguous engine")

    # run 2: the shared prefix, every request resident at once
    sreqs = build_requests(tails, gen, cfg.vocab_size, shared_prefix=shared)
    t0 = time.perf_counter()
    sstatic = generate_static(cfg, mesh_cfg, None, spec_tree, storage, sreqs, plan=plan)
    say(f"   static reference for the shared-prefix requests (prompts "
        f"{[len(r.prompt_ids) for r in sreqs]}): {time.perf_counter() - t0:.2f} s")
    _, sstreams, sdiverged = run("shared-prefix engine", sreqs, shared_cap, len(sreqs), sstatic)
    for r in sdiverged:
        gap = report_divergence(torch, cfg, mesh_cfg, spec_tree, storage, plan, r,
                                sstreams[r.rid], sstatic[r.rid])
        check(gap < NEAR_TIE, f"shared-prefix engine: request {r.rid} diverged at a top-2 "
                              f"gap of {gap:.3e} >= {NEAR_TIE}")
    analytic = serve_paged_kv_bytes(cfg, page_size=page,
                                    requests=[(len(r.prompt_ids), gen) for r in sreqs],
                                    shared_prefix_len=shared)
    res = out["shared-prefix engine"]["residency"]
    check((res["pages_peak"], res["bytes_per_page"]) ==
          (analytic["pages"], analytic["bytes_per_page"]),
          f"shared-prefix engine: peak {res['pages_peak']} pages of {res['bytes_per_page']} B, "
          f"serve_paged_kv_bytes {analytic}")
    say(f"   shared-prefix engine: peak {res['pages_peak']} pages == serve_paged_kv_bytes "
        f"({analytic['shared_pages']} shared + {analytic['private_pages']} private, "
        f"{analytic['kv_bytes_resident']} B); {len(sreqs) - len(sdiverged)} of {len(sreqs)} "
        "streams equal to the static reference")
    unwatch()
    if on_card:
        check(seen, "no paged_attend launch was recorded")
        engine.begin_stream()  # run 1's engine, warm, without the recorder
        for r in requests[:SERVE_SLOTS]:
            engine.admit(r)
        engine.decode_tick()
        by_name = profile(torch, engine.decode_tick, f"paged decode step ({SERVE_SLOTS} slots)")
        say(f"   profile: paged_attend "
            f"{sum(ms for k, ms in by_name.items() if 'paged_attend' in k):.3f} ms of the step")
    err = check_seen_paged(seen) if seen else 0.0
    launches = {k: sum(o["launches"][k] for o in out.values()) for k in counts()}
    return {"runs": out, "launches": launches, "paged_err": err, "analytic": analytic,
            "diverged": len(sdiverged)}



# ---------------------------------------------------------------------------
# phase 10: the l2norm kernel against its plain version
# ---------------------------------------------------------------------------

# Another summation order than the plain version's (torch.sum's tree) over
# up to 311 M squares in fp32: the bar of tests/test_kernels.py.
L2_RTOL = 1e-5
QWEN3_GATE = 7 * 2_048 * 6_144  # a stacked gate of one precision group
L2_SIZES = (1, 127, 32_769, 20_000_000, QWEN3_GATE, ALEXNET_DIST, QWEN3_EMBED)
# Table II/III's profile size (benchmarks/run.py), qwen3's stacked gate, its embed
L2_TIMED = (20_000_000, QWEN3_GATE, QWEN3_EMBED)


def l2norm_cases(torch, device):
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(10)
    for n in L2_SIZES:
        yield f"normal n={n}", torch.randn(n, generator=gen, device=device)
    base = torch.randn(32_772, generator=gen, device=device)
    yield "unaligned view n=32768", base[1:32_769]
    special = np.array(SPECIAL_BITS, dtype=np.uint32).view(np.float32)
    with np.errstate(invalid="ignore"):
        small = special[np.isfinite(special) & (np.abs(special) < 1e18)]
    yield "special, finite squares", torch.from_numpy(np.tile(small, 37)).to(device)
    yield "special, with inf", torch.from_numpy(special[~np.isnan(special)].copy()).to(device)
    yield "special, with nan", torch.from_numpy(np.tile(special, 37)).to(device)


def check_l2norm(torch, device):
    """Kernel vs plain version on every case (rtol L2_RTOL; inf and NaN
    where the plain version has them), two calls bit-equal; times at
    L2_TIMED beside the plain version, ``torch.dot(x, x)`` (one cuBLAS
    call computing the same Σw²) and the bound. Returns {n: row} and the
    largest |kernel - plain| over the finite cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.l2norm import l2norm_sq

    out, max_err = {}, 0.0
    for label, w in l2norm_cases(torch, device):
        got, again, want = l2norm_sq(w), l2norm_sq(w), ref.l2norm_sq_ref(w)
        torch.cuda.synchronize()
        check(bool((got.view(torch.int32) == again.view(torch.int32)).all()),
              f"l2norm {label}: two calls differ ({float(got)!r}, {float(again)!r})")
        k, p = float(got), float(want)
        if math.isfinite(p):
            err = abs(k - p)
            check(err <= L2_RTOL * abs(p), f"l2norm {label}: kernel {k!r}, plain {p!r}")
            max_err = max(max_err, err)
            line = f"   l2norm {label}: {k:.9g} vs plain {p:.9g}, rel err {err / (abs(p) or 1):.2e}"
        else:
            check(math.isnan(k) == math.isnan(p) and (math.isnan(p) or k == p),
                  f"l2norm {label}: kernel {k!r}, plain {p!r}")
            line = f"   l2norm {label}: {k!r} as the plain version"
        if w.numel() in L2_TIMED:
            n = w.numel()
            ms = time_cuda(torch, lambda: l2norm_sq(w))
            plain = time_cuda(torch, lambda: ref.l2norm_sq_ref(w), iters=5)
            lib = time_cuda(torch, lambda: torch.dot(w, w))
            bound = 4 * n / HBM_BYTES_PER_S * 1e3  # each input read once
            out[n] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound}
            line += (f"; kernel {ms * 1e3:.1f} us ({4 * n / ms / 1e6:.0f} GB/s), plain "
                     f"{plain * 1e3:.1f} us, torch.dot {lib * 1e3:.1f} us, bound "
                     f"{bound * 1e3:.1f} us ({bound / ms:.0%} of it)")
        say(line + "; two calls bit-equal")
    return out, max_err


# ---------------------------------------------------------------------------
# phase 11: full-width qwen3-1.7b A²DTWP training
# ---------------------------------------------------------------------------

LM_BATCH, LM_SEQ = 8, 128  # the training launcher's defaults
# the launcher's default rate: a 4-step baseline sweep of the launcher at
# full width kept the loss finite at 0.005, 0.05, 0.5 and 5 (PERF.md)
LM_LR = 0.05


def watch_monitor(torch, seen, every):
    """Route the AWP monitor's kernel calls through a recorder that keeps a
    copy of the input and output of every ``every``-th call: with
    ``every`` = the monitor calls of one step, layer group 0's first leaf
    of each step. Returns the undo function."""
    from repro_torch.kernels import ops

    kernel, calls = ops._l2norm_kernel, [0]

    def recorded(w):
        out = kernel(w)
        if calls[0] % every == 0:
            seen.append((w.clone(), out.clone()))
        calls[0] += 1
        return out

    ops._l2norm_kernel = recorded
    return lambda: setattr(ops, "_l2norm_kernel", kernel)


def watch_packing(torch, seen):
    """Route the materialization's Bitpack and Bitunpack launches through
    recorders that keep a copy of the input and output of the first launch
    of each kernel at each (length, round_to) in ``seen`` — qwen3's embed,
    gate/up/down, wq/wo and wk/wv at every format the run reaches; the keys
    stay in ``seen`` once checked. Returns the undo function."""
    from repro_torch.kernels import ops

    pack, unpack = ops._bitpack_kernel, ops._bitunpack_kernel

    def record(name, rt, x, out):
        key = (name, x.numel() // (rt if name == "bitunpack" else 1), rt)
        if key not in seen:
            seen[key] = (x.clone(), out.clone())

    def packed(w, rt):
        out = pack(w, rt)
        record("bitpack", rt, w, out)
        return out

    def unpacked(planes):
        out = unpack(planes)
        record("bitunpack", planes.shape[0], planes, out)
        return out

    ops._bitpack_kernel, ops._bitunpack_kernel = packed, unpacked

    def undo():
        ops._bitpack_kernel, ops._bitunpack_kernel = pack, unpack

    return undo


def check_seen_packing(torch, seen):
    """The plain versions on each recorded launch's own input: planes
    byte-equal to ``bitpack_ref``, words bit-equal to ``bitunpack_ref``.
    Frees the copies and keeps the keys."""
    from repro_torch.kernels import ref

    for key, rec in seen.items():
        if rec is None:
            continue
        (name, n, rt), (x, out) = key, rec
        want = ref.bitpack_ref(x, rt) if name == "bitpack" else ref.bitunpack_ref(x)
        check(word_err(torch, out, want) == 0,
              f"{name} on the main path, n={n} round_to={rt}: differs from its plain version")
        seen[key] = None


def lm_train_path(torch, device, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ, lr=LM_LR):
    """Full-width qwen3-1.7b trained through ``Trainer`` and
    ``make_train_step``: the AWP plan forced to widen every 2 steps, then
    ``oracle:2`` steps. Returns the measurements; raises on a failed
    check. Launch counts, the monitor and packing records, the memory
    peak and the profile are read on a card only, so the phase rehearses on the CPU at
    a reduced config."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_lm_batch
    from repro_torch.dist.spec import DIST, MeshCfg, dist_elems_per_group
    from repro_torch.kernels import ref
    from repro_torch.launch.train import setup
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.plan import PrecisionPlan
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import make_train_step
    from repro_torch.utils.trees import tree_leaves

    cfg = cfg or get_config("qwen3-1.7b")
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    mesh_cfg = MeshCfg()
    spec_tree, storage, mom = setup(cfg, mesh_cfg, device=device)
    sync()
    setup_s = time.perf_counter() - t0
    nrt = cfg.num_groups + 1
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    group_dist = [s for g in spec_tree["groups"] for s in tree_leaves(g) if s.kind == DIST]
    top_dist = [k for k in spec_tree if k != "groups" and spec_tree[k].kind == DIST]
    # materializations a step: every stacked DIST leaf once per layer and
    # every top-level one once in the forward; under remat the backward
    # runs each layer again, its leaves included
    per_forward = sum(s.reps for s in group_dist) + len(top_dist)
    recomputed = sum(s.reps for s in group_dist) if cfg.remat else 0
    n_monitor = len(group_dist) + len(top_dist)
    n_params = sum(x.numel() for x in tree_leaves(storage))
    say(f"   {cfg.name}: {n_params:,} fp32 parameters, init {setup_s:.2f} s; per step "
        f"{per_forward} + {recomputed} (remat) DIST materializations, {n_monitor} monitor "
        f"calls; batch {batch} x seq {seq}, lr {lr:g}")

    opt = SGDConfig(lr=lr, momentum=0.9, weight_decay=1e-4)
    shapes = {"tokens": (batch, seq), "labels": (batch, seq)}

    def trainer_for(plan):
        def builder(rts):
            return make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes,
                                   plan=plan.with_round_tos(rts))
        return Trainer(builder, nrt, plan=plan, dist_elems_per_group=elems)

    # forced to widen, as in phase 4: 8 -> 16 -> 24 -> 32 bits at steps 3, 5, 7
    awp_plan = PrecisionPlan.build(nrt, round_to=4, schedule="awp", awp_threshold=1.0,
                                   awp_interval=2)
    oracle_plan = PrecisionPlan.build(nrt, round_to=2)
    awp, oracle = trainer_for(awp_plan), trainer_for(oracle_plan)
    # the copies of a step's first monitor call and of its first packing
    # launches at each new (length, round_to) are held to the plain
    # versions after the step, then freed; the memory peak is read over
    # the steps that took no packing copy
    seen, packs, errs, peaks = [], {}, [], []
    unwatch = watch_monitor(torch, seen, n_monitor)
    unwatch_packing = watch_packing(torch, packs)
    data_s = check_s = 0.0
    zero_counts()
    sync()
    t_run = time.perf_counter()
    for i in range(AWP_STEPS + ORACLE_STEPS):
        t0 = time.perf_counter()
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, i, device=device)
        data_s += time.perf_counter() - t0
        trainer = awp if i < AWP_STEPS else oracle
        n_packs = len(packs)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        storage, mom, _ = trainer.run_step(storage, mom, {"tokens": tokens, "labels": labels}, lr)
        if on_card and len(packs) == n_packs:
            peaks.append(torch.cuda.max_memory_allocated())
        t0 = time.perf_counter()
        for w, out in seen:
            p, k = float(ref.l2norm_sq_ref(w)), float(out)
            check(abs(k - p) <= L2_RTOL * abs(p), f"step {i}: monitor call on the main path: "
                                                  f"kernel {k!r}, plain {p!r}")
            errs.append(abs(k - p))
        seen.clear()
        check_seen_packing(torch, packs)
        check_s += time.perf_counter() - t0
    sync()
    run_s = time.perf_counter() - t_run - check_s
    got = counts()
    unwatch()
    unwatch_packing()
    peak = max(peaks, default=0)

    records = awp.records + oracle.records
    losses = [r.loss for r in records]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss in {losses}")
    for r, plan in [(r, awp_plan) for r in awp.records] + [(r, oracle_plan) for r in oracle.records]:
        want = plan.with_round_tos(r.round_tos).wire_table(elems, 1)["total"]
        check(r.wire_bytes == want, f"step {r.step}: wire {r.wire_bytes} != plan {want}")
    check(all(len(set(r.round_tos)) == 1 for r in records), "groups widened apart")
    packed = sum(r.round_tos[0] < 4 for r in records) * (per_forward + recomputed) * on_card
    want = {"bitpack": packed, "bitunpack": packed, "flash_prefill": 0, "paged_attend": 0,
            "l2norm_sq": n_monitor * len(records) * on_card}
    check(got == want, f"launches {got}, expected {want}")
    if on_card:
        check(len(errs) == len(records), f"{len(errs)} monitor calls recorded, "
                                         f"{len(records)} steps")
        # every DIST length at every packed format the run reached
        lengths = {x[0].numel() for g, gs in zip(storage["groups"], spec_tree["groups"])
                   for x, s in zip(tree_leaves(g), tree_leaves(gs)) if s.kind == DIST}
        lengths |= {storage[k].numel() for k in top_dist}
        rts = {r.round_tos[0] for r in records} - {4}
        want_keys = {(k, n, rt) for k in ("bitpack", "bitunpack") for n in lengths for rt in rts}
        check(set(packs) == want_keys, f"packing launches checked {sorted(packs)}, "
                                       f"expected {sorted(want_keys)}")
    for r in records:
        say(f"   step {r.step:2d} round_to {r.round_tos[0]} loss {r.loss:.5f} "
            f"wire {r.wire_bytes} B  {r.wall_s * 1e3:.1f} ms"
            f"{'  (first at these formats)' if r.recompiled else ''}")
    warm = sorted(r.wall_s for r in records if not r.recompiled)
    say(f"   AWP bits history {awp.bits_history}")
    say(f"   launches {got}; layer group 0's first monitor call of each step within "
        f"{max(errs, default=0.0):.3e} of its plain version ({len(errs)} steps)")
    say(f"   bitpack/bitunpack on the main path equal to their plain versions at "
        f"{len(packs)} (kernel, length, round_to): {sorted(packs)}")
    say(f"   step ms (host clock to the loss sync): median of warm steps "
        f"{warm[len(warm) // 2] * 1e3:.2f}; run {run_s:.2f} s without the checks' "
        f"{check_s:.2f} s, batch synthesis {data_s:.2f} s; memory peak of the "
        f"{len(peaks)} steps with no packing copy {peak / 2**30:.2f} GiB")
    profiled = {}
    if on_card:
        step = make_train_step(cfg, mesh_cfg, None, spec_tree, opt, shapes, plan=oracle_plan)
        tokens, labels = synthetic_lm_batch(cfg.vocab_size, batch, seq, 10_000, device=device)
        b = {"tokens": tokens, "labels": labels}
        float(step(storage, mom, b, lr)[2]["loss"])  # warm
        by_name = profile(torch, lambda: float(step(storage, mom, b, lr)[2]["loss"]),
                          "qwen3-1.7b oracle:2 train step")
        busy = sum(by_name.values())
        profiled = {
            "busy_ms": busy,
            "l2norm_ms": sum(ms for k, ms in by_name.items() if "l2norm" in k),
            "packing_ms": sum(ms for k, ms in by_name.items()
                              if "bitpack" in k or "bitunpack" in k),
        }
        say(f"   profile train step: l2norm_sq {profiled['l2norm_ms']:.3f} ms "
            f"({profiled['l2norm_ms'] / busy:.2%} of kernel time), bitpack+bitunpack "
            f"{profiled['packing_ms']:.3f} ms ({profiled['packing_ms'] / busy:.2%})")
    return {"awp": awp, "oracle": oracle, "launches": got, "peak": peak,
            "monitor_err": max(errs, default=0.0), "profile": profiled}

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
    time_qwen3_packing(torch, device)

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
        f"{run['launches']['bitunpack']} ({run['n_dist']} packed leaves per step), "
        f"l2norm_sq {run['launches']['l2norm_sq']} ({run['n_monitor']} monitored leaves "
        "per step)")
    say(f"   top-5 error after {len(rts)} steps: {run['top5']:.4f}; fc5 master moved by "
        f"{run['fc5_moved']:.3e} of its norm (lr {run['lr']:g})")
    say(f"   step ms (host clock to the loss sync): median of warm steps "
        f"{sorted(warm)[len(warm) // 2] * 1e3:.2f}, all {[round(r.wall_s * 1e3, 2) for r in awp.records + oracle.records]}")
    say(f"   set-up {run['setup_s']:.2f} s, run {run['run_s']:.2f} s of which batch "
        f"synthesis on the host {run['data_s']:.2f} s")

    say("phase 5: reference — reduced AlexNet on the card vs the CPU")
    reference_check(torch, device)

    say("phase 6: flash prefill kernel vs its plain version on the card")
    flash = check_flash(torch, device)

    say(f"phase 7: main path — full-width qwen3-1.7b served, prompts {list(SERVE_LENS)}, "
        f"+{SERVE_GEN} tokens, {SERVE_SLOTS} slots")
    serve = serve_path(torch, device)
    served = {k: sum(run[k] for run in serve["launches"].values())
              for k in ("bitpack", "bitunpack", "flash_prefill")}
    say(f"   launches over phase 7's three runs: {served}; flash on the main path within "
        f"{serve['flash_err']:.3e} of its plain version")

    say("phase 8: paged decode kernel vs its plain version on the card")
    paged = check_paged(torch, device)

    say(f"phase 9: main path — full-width qwen3-1.7b served through the paged engine, "
        f"page {PAGE}: phase 7's requests, then a {SHARED_PREFIX}-token shared prefix with "
        f"tails {list(SHARED_TAILS)}")
    paged_run = paged_path(torch, device, serve)
    del serve
    for k in served:
        served[k] += paged_run["launches"][k]
    say(f"   launches over phase 9's two runs: {paged_run['launches']}")

    say("phase 10: l2norm kernel vs its plain version on the card")
    l2, l2_err = check_l2norm(torch, device)

    gc.collect()  # phases 7 and 9's weights and engines
    torch.cuda.empty_cache()
    say(f"phase 11: main path — full-width qwen3-1.7b A²DTWP training, batch {LM_BATCH} x "
        f"seq {LM_SEQ}")
    lm = lm_train_path(torch, device)
    bits = [(s, b[0]) for s, b in lm["awp"].bits_history]
    check(bits == [(0, 8), (3, 16), (5, 24), (7, 32)], f"bits history {lm['awp'].bits_history}")
    for k in served:
        served[k] += lm["launches"][k]

    kernels = []
    for name, src, replaces in (
        ("bitpack", "src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:52"),
        ("bitunpack", "src/repro_torch/csrc/bitunpack.cu", "src/repro/kernels/bitunpack.py:30"),
    ):
        t = times[(name, 2)]  # fc5 at round_to=2 (bf16), the oracle:2 format
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": run["launches"][name] + served[name], "max_abs_err": float(err[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
        })
    f512 = flash[512]
    kernels.append({
        "name": "flash_prefill", "route": "cuda", "source": "src/repro_torch/csrc/flash_prefill.cu",
        "replaces": "src/repro/kernels/flash_prefill.py:110",
        "launches": served["flash_prefill"], "max_abs_err": f512["max_abs_err"],
        "ms": f512["ms"], "plain_ms": f512["plain_ms"], "bound_ms": f512["bound_ms"],
        "bound_by": f512["bound_by"], "library_ms": f512["library_ms"],
    })
    pm = paged["main path"]  # no single PyTorch call reads through a page table
    kernels.append({
        "name": "paged_attend", "route": "cuda", "source": "src/repro_torch/csrc/paged_attend.cu",
        "replaces": "src/repro/kernels/paged_attention.py:98",
        "launches": paged_run["launches"]["paged_attend"],
        "max_abs_err": max(paged["max_abs_err"], paged_run["paged_err"]),
        "ms": pm["ms"], "plain_ms": pm["plain_ms"], "bound_ms": pm["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
    })
    t = l2[QWEN3_EMBED]  # the main path's largest monitored leaf
    kernels.append({
        "name": "l2norm_sq", "route": "cuda", "source": "src/repro_torch/csrc/l2norm.cu",
        "replaces": "src/repro/kernels/l2norm.py:31",
        "launches": run["launches"]["l2norm_sq"] + lm["launches"]["l2norm_sq"],
        "max_abs_err": max(l2_err, lm["monitor_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
