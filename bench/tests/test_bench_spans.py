"""The program's spans in a trace (``bench/spantrace.py``) on synthetic
events, the span readers, and a CPU trace of each mini cell."""
from __future__ import annotations

import random
import types

import pytest

from bench import devtrace, spantrace
from conftest import ROOT, mini_cell

from repro_torch.utils.spans import SPANS

E = spantrace.Event
STEP = devtrace.STEP_RANGE


def _work():
    """Two traced steps of device work, its launches and host ops, and no
    span."""
    ev = [E(STEP, False, 0, 100, 1), E(STEP, False, 100, 200, 2)]
    corr = 1000
    for base in (0, 100):
        for k, (t, s, e, name) in enumerate([(5, 10, 30, "sgemm"), (12, 30, 35, "bitpack_vec4"),
                                             (40, 45, 60, "Memcpy DtoH"), (70, 75, 90, "add")]):
            corr += 1
            launch = "cudaMemcpyAsync" if name.startswith("Memcpy") else "cudaLaunchKernel"
            ev.append(E(launch, False, base + t, base + t + 1, corr))
            ev.append(E(name, True, base + s, base + e, corr))
            ev.append(E(f"aten::op{k}", False, base + t - 1, base + t + 2, corr - 900))
    return ev


def _spans():
    """The program's spans over the two steps, on the host and as the
    device annotations CUDA adds (with ids that collide with launches')."""
    ev = []
    for base in (0, 100):
        for name, s, e in [("train.step", 2, 95), ("train.forward", 3, 20),
                           ("transport.materialize", 11, 14), ("optim.sgd", 38, 65),
                           ("train.loss_sync", 66, 94)]:
            ev.append(E(name, False, base + s, base + e, 1001 + base // 100))
            ev.append(E(name, True, base + s + 5, base + e + 3, 1002))
    return ev


def test_annotations_leave_the_device_readings_unchanged():
    bare = spantrace.reduce(_work(), {})
    full = spantrace.reduce(_work() + _spans(), {})
    for field in ("steps", "window_s", "busy_s", "kernel_s", "kernel_n", "gaps"):
        assert getattr(full, field) == getattr(bare, field), field
    assert full.launches == 6 and full.kernel_n["sgemm"] == 2
    assert not set(full.kernel_s) & set(SPANS) and full.busy_s == pytest.approx(110e-6)


def test_kernels_go_to_the_span_of_their_launch_and_gaps_to_the_span_open():
    tr = spantrace.reduce(_work() + _spans(), {"transport.bytes": 24})
    rows = {n: r for n, r in tr.spans.items() if r["calls"] or r["device_s"] or r["idle_s"]}
    # sgemm launched at 5 inside train.forward; bitpack at 12 inside the
    # materialisation; the copy at 40 and add at 70 by their launches
    assert rows["train.forward"]["device_s"] == pytest.approx(2 * 20e-6)
    assert rows["transport.materialize"]["device_s"] == pytest.approx(2 * 5e-6)
    assert rows["optim.sgd"]["device_s"] == pytest.approx(2 * 15e-6)
    assert rows["optim.sgd"]["launches"] == 0  # a copy is not a launch
    assert rows["train.loss_sync"]["launches"] == 2
    assert rows["train.step"]["calls"] == 2 and rows["transport.materialize"]["calls"] == 2
    # gaps: [0,10) at 0 (no span yet), [35,45) at 35 (train.step), [60,75)
    # at 60 (optim.sgd), [90,110) at 90 (loss sync), [135,145), [160,175), [190,200)
    idle = dict(tr.idle_by_span)
    assert idle == pytest.approx({"none": 10e-6, "train.step": 20e-6, "optim.sgd": 30e-6,
                                  "train.loss_sync": 30e-6})
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)
    assert tr.counters == {"transport.bytes": 24}


def test_a_kernel_without_its_launch_goes_to_none():
    ev = [e for e in _work() + _spans() if not (e.name == "cudaLaunchKernel" and e.corr == 1001)]
    tr = spantrace.reduce(ev, {})
    assert tr.spans["none"]["device_s"] == pytest.approx(20e-6)
    assert tr.spans["none"]["launches"] == 1


def test_the_span_table_holds_what_the_traced_steps_launched():
    """Device timestamps ahead of the host's: the step before the window
    runs on into it and the last step's work runs past its end. The
    device-clock readings see the first and lose the second; the spans
    see the work the traced steps launched."""
    ev = [E(STEP, False, 100, 200, 1), E("optim.sgd", False, 50, 90, 2),
          E("awp.monitor", False, 110, 190, 3),
          E("cudaLaunchKernel", False, 60, 61, 10), E("k_before", True, 95, 130, 10),
          E("cudaLaunchKernel", False, 150, 151, 11), E("k_last", True, 205, 275, 11)]
    tr = spantrace.reduce(ev, {})
    assert tr.kernel_n == {"k_before": 1}
    assert tr.spans["optim.sgd"]["launches"] == 0
    assert tr.spans["awp.monitor"]["launches"] == 1
    assert tr.spans["awp.monitor"]["device_s"] == pytest.approx(70e-6)


def test_a_launch_on_another_thread_inside_a_span_opened_there():
    """The remat forward: autograd's thread materialises a weight while
    the caller waits in ``train.backward``; the caller's spans hold it."""
    ev = [E(STEP, False, 0, 100, 1), E("train.step", False, 1, 99, 2),
          E("train.backward", False, 10, 90, 3), E("transport.materialize", False, 20, 30, 4),
          E("cudaLaunchKernel", False, 25, 26, 50), E("bitunpack_vec4", True, 27, 40, 50),
          E("cudaLaunchKernel", False, 50, 51, 51), E("dgrad", True, 52, 80, 51)]
    tr = spantrace.reduce(ev, {})
    assert tr.spans["transport.materialize"]["device_s"] == pytest.approx(13e-6)
    assert tr.spans["train.backward"]["device_s"] == pytest.approx(28e-6)
    # gaps at 0 (before train.step), 40 and 80 (in train.backward)
    assert dict(tr.idle_by_span) == pytest.approx({"none": 27e-6, "train.backward": 32e-6})


@pytest.mark.parametrize("drift", [0.0, 60.0, -30.0])
def test_gaps_are_read_on_the_host_clock_whatever_the_device_drift(drift):
    """The device's timestamps off the host's by ``drift``: each kernel
    still goes to its launch's span, and the gap after the kernel
    launched in ``A`` (the card idles until ``B``'s launch) to ``A``."""
    ev = [E(STEP, False, 0, 1000, 1), E("train.step", False, 10, 990, 2),
          E("optim.sgd", False, 100, 200, 3), E("awp.monitor", False, 300, 400, 4),
          E("cudaLaunchKernel", False, 105, 106, 10), E("cudaLaunchKernel", False, 310, 311, 11),
          E("cudaLaunchKernel", False, 320, 321, 12)]
    ev += [E(n, True, s + drift, e + drift, c) for n, s, e, c in
           [("k1", 110, 150, 10), ("k2", 312, 350, 11), ("k3", 350, 500, 12)]]
    tr = spantrace.reduce(ev, {})
    assert tr.spans["optim.sgd"]["device_s"] == pytest.approx(40e-6)
    assert tr.spans["awp.monitor"]["device_s"] == pytest.approx(188e-6)
    idle = dict(tr.idle_by_span)
    assert idle["optim.sgd"] == pytest.approx(162e-6)
    assert set(idle) == {"none", "optim.sgd", "train.step"}
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_every_gap_is_put_down_to_a_span():
    """More gaps than ``devtrace.NAMED_GAPS``: none is left as ``other``."""
    n = 3 * devtrace.NAMED_GAPS
    ev = [E(STEP, False, 0, 10 * n + 10, 1), E("train.step", False, 0, 10 * n + 10, 2)]
    for i in range(n):
        ev.append(E("cudaLaunchKernel", False, 10 * i + 1, 10 * i + 2, 100 + i))
        ev.append(E("k", True, 10 * i + 3, 10 * i + 8, 100 + i))
    tr = spantrace.reduce(ev, {})
    assert dict(tr.idle_by_span) == pytest.approx({"train.step": tr.window_s - tr.busy_s})
    assert tr.spans["train.step"]["launches"] == n


def test_the_sweep_finds_the_innermost_open_span():
    rng = random.Random(7)

    def tree(lo, hi, depth, out):
        t = lo
        while depth and t < hi - 2:
            s = rng.uniform(t, hi - 2)
            e = rng.uniform(s + 1, min(hi, s + (hi - lo) / 2))
            out.append((s, e, f"s{len(out)}"))
            tree(s, e, depth - 1, out)
            t = e + rng.uniform(0, 3)

    spans = []
    tree(0, 1000, 4, spans)
    times = [rng.uniform(-10, 1010) for _ in range(2000)] + [s for s, _, _ in spans]
    got = spantrace._innermost(spans, times)
    for t, name in zip(times, got):
        open_ = [sp for sp in spans if sp[0] <= t <= sp[1]]
        want = max(open_, key=lambda sp: (sp[0], -sp[1]))[2] if open_ else spantrace.NONE
        assert name == want


READERS = {"sgd_ms_per_step": ("optim.sgd", "device_s", 1e3),
           "sgd_launches_per_step": ("optim.sgd", "launches", 1.0),
           "loss_ms_per_step": ("model.loss", "device_s", 1e3),
           "materialize_ms_per_step": ("transport.materialize", "device_s", 1e3),
           "monitor_span_ms_per_step": ("awp.monitor", "device_s", 1e3)}


@pytest.mark.parametrize("name", [*READERS, "transport_gb_per_step"])
def test_span_readers(name):
    from bench import harness

    read = harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py").read
    table = {n: {"calls": 4, "device_s": 0.02, "launches": 440, "idle_s": 0.0} for n in SPANS}
    trace = types.SimpleNamespace(steps=4, spans=table, counters={"transport.bytes": 6.2e9})
    if name == "transport_gb_per_step":
        want = 1.55
    else:
        _, field, scale = READERS[name]
        want = table[READERS[name][0]][field] / 4 * scale
    assert read(types.SimpleNamespace(trace=trace)) == pytest.approx(want)
    assert read(types.SimpleNamespace(trace=None)) is None
    # a trace of the devtrace kind (no spans, no counters), and one whose span read 0
    plain = devtrace.Trace(steps=4, window_s=1.0, busy_s=0.5, kernel_s={}, kernel_n={},
                           gaps=[])
    assert read(types.SimpleNamespace(trace=plain)) is None
    empty = dict.fromkeys(("calls", "device_s", "launches", "idle_s"), 0)
    bare = types.SimpleNamespace(steps=4, spans={n: empty for n in SPANS}, counters={})
    assert read(types.SimpleNamespace(trace=bare)) is None


@pytest.mark.parametrize("name", ["vgg-a.adt16", "vgg-a.fp32", "qwen3-1.7b.adt16"])
def test_a_cpu_trace_of_each_mini_cell_carries_its_spans(name):
    cell = mini_cell(name)
    out = spantrace.trace_cell(cell, 2**31 + 9, "cpu")
    spans = out["spans"]
    assert set(spans) == {*SPANS, spantrace.NONE} and out["device"] == "cpu"
    for span in ("train.step", "train.loss_sync", "train.forward", "model.loss",
                 "train.backward", "optim.sgd", "awp.monitor"):
        assert spans[span]["calls"] == 1, span
    assert spans["transport.materialize"]["calls"] > 0
    # the CPU has no device time: one gap, the whole window
    assert [n for n, _ in out["idle_by_span"]] == [spantrace.NONE]
    assert out["idle_by_span"][0][1] == pytest.approx(out["window_s"])
    bytes_ = out["counters"].get("transport.bytes", 0)
    assert (bytes_ > 0) == name.endswith("adt16")
    assert ("transport_gb_per_step" in out["metrics"]) == name.endswith("adt16")
