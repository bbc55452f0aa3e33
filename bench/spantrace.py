"""The program's own spans and counters in traced steps
(``repro_torch.utils.spans``), reduced in memory.

The reduction (:func:`reduce`) is a pure function of the profiler's
events. It reads the device's work as ``bench/devtrace.py`` does, with
every event named in ``spans.SPANS`` taken as an annotation, not as work,
on the host and on the device (under CUDA each ``record_function`` range
also appears on the device, spanning the kernels launched in it), so
``busy_s``, ``kernel_s``, ``kernel_n`` and ``gaps`` read what they read
with the spans off. Then:

- each device kernel, copy and set that the traced steps launched goes
  to the innermost span open when it was launched: the host runtime call
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) with the kernel's
  correlation id;
- each idle gap of the card goes to the innermost span open when it
  began, every gap included, its start read on the host's clock through
  the launch of the work that ends it (:func:`_gap_starts`);

on any host thread: the spans nest in time across autograd's device
thread, since the caller blocks inside ``train.backward``. What no span
holds goes to ``none``. Both attributions lean on host timestamps and
correlation ids alone: the device's timestamps drift from the host's, by
up to tens of ms within one profiled run on an H100, so the
device-clock window that ``kernel_n`` reads can take in the tail of the
step before it or lose the last step's, and the span table cannot.

    PYTHONPATH=src python3 -m bench.spantrace --workload vgg-a.adt16 --seed 7

runs the cell's set-up as ``bench/run.py`` does (no window, no check),
traces steps as ``devtrace.trace_steps`` does with the spans on, and
prints one JSON line: each span's calls, device ms, launches and idle ms
a step, the idle time by span, the counters a step, the share of device
time launched under ``train.step``, and every per-layer metric of the
cell and of the span readers (``bench/metrics/``) read from the trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import sys
import time
import types
from typing import NamedTuple

from bench import devtrace

NONE = "none"
# the host's CUDA API calls (cuda*, cu*): a launch, copy or set carries
# the correlation id of the device work it enqueues
LAUNCH = re.compile(r"^cu(da)?[A-Z]")
# the span readers of bench/metrics/ (not yet entries of BENCHMARK.json)
SPAN_METRICS = ("sgd_ms_per_step", "sgd_launches_per_step", "loss_ms_per_step",
                "materialize_ms_per_step", "monitor_span_ms_per_step",
                "transport_gb_per_step")


class Event(NamedTuple):
    name: str
    device: bool  # a kernel, copy, set or annotation on the card
    start: float  # µs, the profiler's clock
    end: float
    corr: int  # correlation id (a launch's and its device work's)


@dataclasses.dataclass
class SpanTrace(devtrace.Trace):
    # span -> {"calls", "device_s", "launches", "idle_s"} over the traced
    # steps, with NONE for what no span holds
    spans: dict
    idle_by_span: list  # [(span, idle seconds)], longest first
    counters: dict  # the program's counters over the traced steps


def per_step(run, span: str, field: str):
    """``field`` of ``span`` a traced step, or None where the run was not
    traced, its trace has no spans, or the span read 0."""
    spans = getattr(run.trace, "spans", None)
    value = (spans or {}).get(span, {}).get(field, 0)
    return value / run.trace.steps if value > 0 else None


def counter_per_step(run, name: str):
    """Counter ``name`` a traced step, or None (as :func:`per_step`)."""
    counters = getattr(run.trace, "counters", None)
    value = (counters or {}).get(name, 0)
    return value / run.trace.steps if value > 0 else None


def _innermost(spans, times) -> list:
    """The innermost of ``spans`` (``(start, end, name)``, nested in time)
    open at each of ``times``, or NONE: one sort and one sweep."""
    out = [NONE] * len(times)
    ivs = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, j = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(ivs) and ivs[j][0] <= t:
            while stack and stack[-1][1] < ivs[j][0]:
                stack.pop()
            stack.append(ivs[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def _gap_starts(gaps, work, launched, lo) -> list:
    """Each gap's start on the host's clock. The card idles only on an
    empty queue, so the work that ends a gap was launched as the gap
    ended: its launch less the gap's length. (The device's timestamps
    drift from the host's by up to tens of ms within one profiled
    run, so they are not compared with the host's directly.) A gap
    without such work, the window's last, takes the previous gap's
    offset; one that starts with the window starts there."""
    first = {}
    for e, t in zip(work, launched):
        if t >= 0 and (e.start not in first or t < first[e.start]):
            first[e.start] = t
    out, offset = [], 0.0
    for s, e in gaps:
        if e in first:
            offset = e - first[e]
        out.append(s if s == lo else s - offset)
    return out


def reduce(events, counters: dict, names=None) -> SpanTrace:
    """The traced steps (the ``bench.step`` ranges) of ``events``, with
    the spans ``names`` (default ``spans.SPANS``) as annotations."""
    if names is None:
        from repro_torch.utils.spans import SPANS as names
    skip = set(names) | {devtrace.STEP_RANGE}
    ranges = [e for e in events if e.name == devtrace.STEP_RANGE and not e.device]
    if not ranges:
        raise RuntimeError("the profiler recorded no traced step")
    lo = min(e.start for e in ranges)
    hi = max(e.end for e in ranges)
    dev, host, work = [], [], []
    kernel_s: dict = {}
    kernel_n: dict = {}
    for e in events:
        if e.name in skip:
            continue
        if e.device:
            if e.end <= lo or e.start >= hi:
                continue
            dev.append((max(e.start, lo), min(e.end, hi)))
            work.append(e)
            if not devtrace._is_copy(e.name):
                kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (e.end - e.start) / 1e6
                kernel_n[e.name] = kernel_n.get(e.name, 0) + 1
        else:
            host.append((e.start, e.end, e.name))
    busy, gaps = devtrace._union_and_gaps(dev, lo, hi)

    held = [(e.start, e.end, e.name) for e in events if e.name in names and not e.device]
    table = {n: {"calls": 0, "device_s": 0.0, "launches": 0, "idle_s": 0.0}
             for n in (*names, NONE)}
    for s, _, name in held:
        if lo <= s < hi:
            table[name]["calls"] += 1
    launch = {e.corr: e.start for e in events if not e.device and LAUNCH.match(e.name)}
    # the span table holds the work the traced steps launched, read on the
    # host's clock; work whose launch is unknown, where the card ran it
    own, own_at = [], []
    for e in events:
        t = launch.get(e.corr)
        if e.device and e.name not in skip and (
                lo <= t < hi if t is not None else e.end > lo and e.start < hi):
            own.append(e)
            own_at.append(-1.0 if t is None else t)
    for e, name in zip(own, _innermost(held, own_at)):
        row = table[name]
        row["device_s"] += (e.end - e.start) / 1e6
        row["launches"] += 0 if devtrace._is_copy(e.name) else 1
    at = [launch.get(e.corr, -1.0) for e in work]
    for (s, e), name in zip(gaps, _innermost(held, _gap_starts(gaps, work, at, lo))):
        table[name]["idle_s"] += (e - s) / 1e6
    idle = sorted(((n, r["idle_s"]) for n, r in table.items() if r["idle_s"] > 0),
                  key=lambda kv: -kv[1])
    return SpanTrace(steps=len(ranges), window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                     kernel_s=kernel_s, kernel_n=kernel_n,
                     gaps=devtrace._name_gaps(gaps, host), spans=table,
                     idle_by_span=idle, counters=dict(counters))


def profiler_events(prof) -> list[Event]:
    """The profiler's events as :class:`Event` s (``FunctionEvent.id`` is
    the correlation id of a launch and of its device work)."""
    from torch.autograd import DeviceType

    return [Event(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
                  e.time_range.end, e.id) for e in prof.events()]


def trace_spans(step, first: int, torch) -> SpanTrace:
    """``devtrace.trace_steps``'s traced steps with the program's spans
    and counters on, the counters reset after the profiler's warm-up."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.utils import spans

    with spans.enabled(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                  acc_events=True) as prof:
        step(first)
        spans.reset()
        n, t0 = 1, time.perf_counter()
        while n <= devtrace.MIN_STEPS or time.perf_counter() - t0 < devtrace.MIN_SECONDS:
            with record_function(devtrace.STEP_RANGE):
                step(first + n)
            n += 1
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        counters = spans.counters()
    return reduce(profiler_events(prof), counters)


def result(c, tr: SpanTrace) -> dict:
    """The line's fields: the trace by span, a step at a time, and the
    per-layer metrics of the cell and of :data:`SPAN_METRICS`."""
    from bench import harness

    ctx = types.SimpleNamespace(
        trace=tr, transport_bytes_per_step=c.kind.transport_bytes_per_step(c.doc, c.mix))
    metrics = {}
    for m in c.per_layer:
        if m["name"] != "step_mfu":  # needs the window's step time
            metrics[m["name"]] = m["read"](ctx)
    for name in SPAN_METRICS:
        metrics[name] = harness.load_module(
            harness.ROOT / "bench" / "metrics" / f"{name}.py").read(ctx)
    per = 1e3 / tr.steps
    device_s = sum(r["device_s"] for r in tr.spans.values())
    return {
        "workload": c.name, "steps": tr.steps, "window_s": tr.window_s, "busy_s": tr.busy_s,
        "metrics": {k: v for k, v in metrics.items() if v is not None},
        "spans": {n: {"calls": r["calls"] / tr.steps, "device_ms": r["device_s"] * per,
                      "launches": r["launches"] / tr.steps, "idle_ms": r["idle_s"] * per}
                  for n, r in tr.spans.items()},
        "idle_by_span": [[n, s] for n, s in tr.idle_by_span],
        "idle_gaps": [[k[:120], s] for k, s in tr.gaps[:10]],
        "counters": {k: v / tr.steps for k, v in tr.counters.items()},
        "in_step_pct": (100.0 * (1.0 - tr.spans[NONE]["device_s"] / device_s)
                        if device_s > 0 else None),
    }


def trace_cell(c, seed: int, device) -> dict:
    """Set-up as ``harness.run_cell``'s (the weights, the checked warm
    steps), then :func:`trace_spans`; :func:`result`'s fields."""
    import torch

    cuda = torch.device(device).type == "cuda"
    prog = c.kind.Program(c.doc, c.mix, seed, device)
    steps = c.mix["check_steps"]
    for i in range(steps):
        prog.step(i)
    out = result(c, trace_spans(prog.step, steps, torch))
    out["device"] = torch.cuda.get_device_name(0) if cuda else "cpu"
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("spantrace: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels.build import library

    library()
    for name in args.workload:
        print(json.dumps(trace_cell(harness.load_cell(name), args.seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
