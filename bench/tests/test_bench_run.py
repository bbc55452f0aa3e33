"""A run of a cell on the CPU at a reduced size: the result's line, the
check against the reference, the planted faults, discovery by name and
the import check."""
from __future__ import annotations

import ast
import json
import math
import shutil
import sys
import time

import pytest

from bench import compare, devtrace, harness, readings
from conftest import ROOT, mini_cell

CELLS = ["vgg-a.adt16", "vgg-a.fp32", "qwen3-1.7b.adt16"]


def _run(cell, seed=2**31 + 5, trace=False):
    return harness.run_cell(cell, seed, 0.5, trace, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_result_line_shape(name):
    out = _run(mini_cell(name))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"step_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for v in out["check"].values():
        assert set(v) == {"value", "limit"} and 0 <= v["value"] <= v["limit"]
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_planted_faults_come_out_not_correct(name, fault):
    """A step fed half its batch, or one that returns its state unchanged,
    under the cell's own limits."""
    cell = mini_cell(name)
    r = readings.reading(cell, 11, fault, "cpu")
    ok, check = compare.judge(r["numbers"], cell.limits)
    assert not ok, check


def test_a_nan_fails_every_number():
    ref = {"losses": [1.0], "monitor": [[1.0]], "grad1": {"a": 1.0}, "update3": {"a": 1.0}}
    bad = {"losses": [math.nan], "monitor": [[math.nan]], "grad1": {"a": math.nan},
           "update3": {"a": math.nan}}
    values = compare.numbers(bad, ref)
    assert all(v == math.inf for v in values.values())
    assert compare.judge(values, {k: 1.0 for k in values})[0] is False


def test_a_leaf_one_side_lacks_fails():
    ref = {"losses": [1.0], "monitor": [[1.0]], "grad1": {"a": 1.0, "b": 1.0},
           "update3": {"a": 1.0, "b": 1.0}}
    prog = dict(ref, grad1={"a": 1.0})
    assert compare.numbers(prog, ref)["grad1"] == math.inf


def test_discovery_of_new_files_by_name(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    entries, with no file that is there edited."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc = json.loads((ROOT / "bench/configs/vgg-a.json").read_text())
    doc.update(name="vgg-a-tiny", layers=[["conv", 8, 3, 1], ["pool"], ["fc", 16]],
               image_size=8, num_classes=4, compress_min_size=128)
    (tmp_path / "bench/configs/vgg-a-tiny.json").write_text(json.dumps(doc))
    mix = json.loads((ROOT / "bench/traffic/adt16.json").read_text())
    mix.update(round_to=3, batch={"cnn": {"images": 2}}, pool=2)
    (tmp_path / "bench/traffic/adt24.json").write_text(json.dumps(mix))
    (tmp_path / "bench/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.steps)\n")
    (tmp_path / "bench/limits/vgg-a-tiny.adt24.json").write_text(
        json.dumps({"loss1": 1e-4, "grad1": 1e-3}))
    bench["configs"].append({"name": "vgg-a-tiny", "source": doc["source"],
                             "file": "bench/configs/vgg-a-tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "vgg-a-tiny.adt24", "config": "vgg-a-tiny",
                               "traffic": "adt24", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["vgg-a-tiny.adt24"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("vgg-a-tiny.adt24", tmp_path)
    out = _run(cell)
    assert out["correct"] and out["metrics"]["steps_done"]["value"] == out["attempted"]
    assert set(out["check"]) == {"loss1", "grad1"}
    with pytest.raises(harness.BenchError):
        harness.load_cell("no-such.cell", tmp_path)


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    assert "repro_torch" in sys.modules
    monkeypatch.setattr(sys, "modules", dict(sys.modules))
    for m in [m for m in sys.modules if m.split(".")[0] in harness.BANNED]:
        del sys.modules[m]
    assert harness.banned_modules() == []
    sys.modules["repro_torchvision"] = sys.modules["json"]
    sys.modules["jaxtyping"] = sys.modules["json"]
    assert harness.banned_modules() == []
    sys.modules["jax.numpy"] = sys.modules["json"]
    sys.modules["repro"] = sys.modules["json"]
    assert harness.banned_modules() == ["jax", "repro"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & harness.BANNED
    if "reference" in path.parts:
        assert "repro_torch" not in tops, "the reference imports the program"


def test_the_reference_dropout_masks_are_the_programs():
    import torch

    from bench.reference import threefry
    from repro_torch import random as jr

    for seed, data in ((0, 0), (2**31 - 1, 8), (12345, 9)):
        k = threefry.fold_in(threefry.key(seed), data)
        assert k == jr.fold_in(jr.PRNGKey(seed), data)
        mask = threefry.keep_mask(k, 0.5, (64, 4096), "cpu")
        assert torch.equal(mask, jr.bernoulli(k, 0.5, (64, 4096)))


def test_union_and_idle_gaps():
    busy, gaps = devtrace._union_and_gaps([(2, 4), (3, 6), (8, 9)], 0, 10)
    assert busy == 5 and gaps == [(0, 2), (6, 8), (9, 10)]
    host = [(0, 10, "step"), (5, 7, "aten::mm"), (8.5, 9.5, "sync")]
    named = dict(devtrace._name_gaps(gaps, host))
    assert named == {"step": 2e-6, "aten::mm": 2e-6, "sync": 1e-6}


def test_the_traced_steps_on_the_cpu_see_no_device_time():
    import torch

    seen = []
    tr = devtrace.trace_steps(lambda i: seen.append(i) or torch.ones(64).sum(), 7, torch)
    assert seen[0] == 7 and tr.steps == len(seen) - 1 >= devtrace.MIN_STEPS
    assert tr.busy_s == 0 and tr.launches == 0 and tr.window_s > 0


def test_per_layer_readers_on_a_synthetic_trace():
    """The kernels as the profiler names them on the card (templates in an
    anonymous namespace), through every per-layer reader."""
    import types

    kernels = {
        "void (anonymous namespace)::bitpack_vec4<2>(float4 const*, uchar4*, long long)": 0.002,
        "void (anonymous namespace)::bitunpack_scalar<2>(unsigned char const*, float*, long)": 0.002,
        "void (anonymous namespace)::l2norm_final<true>(float const*, int, float*)": 0.001,
        "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8": 0.3,
    }
    tr = devtrace.Trace(steps=2, window_s=1.0, busy_s=0.75, kernel_s=kernels,
                        kernel_n=dict.fromkeys(kernels, 5), gaps=[])
    assert tr.launches_of(devtrace.TRANSPORT) == 10 and tr.launches_of(devtrace.MONITOR) == 5
    run = types.SimpleNamespace(trace=tr, transport_bytes_per_step=3.35e9, step_s=0.1,
                                flops_per_step=3.35e12, setup_s=1.0, steps=5)
    want = {"transport_ms_per_step": 2.0, "transport_roofline_pct": 50.0,
            "monitor_ms_per_step": 0.5, "launches_per_step": 10.0, "device_idle_pct": 25.0,
            "step_mfu": 100.0 * 33.5 / 67, "step_ms": 100.0, "setup_s": 1.0}
    for name, value in want.items():
        got = harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py").read(run)
        assert got == pytest.approx(value), name
    untraced = types.SimpleNamespace(trace=None, transport_bytes_per_step=0.0)
    for name in ("transport_ms_per_step", "transport_roofline_pct", "monitor_ms_per_step",
                 "launches_per_step", "device_idle_pct"):
        assert harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py").read(
            untraced) is None
