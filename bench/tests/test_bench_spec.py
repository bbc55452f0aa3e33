"""``BENCHMARK.json`` against the contract's shapes: names, units, keys,
references between entries, files, bounds and the check's time budget."""
from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keep_to_their_keys_and_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    key = {"configs": "config", "workloads": "workload"}.get(section, section)
    for e in entries:
        allowed = KEYS[key] | ({"workloads"} if section in ("end_to_end", "per_layer") else set())
        assert KEYS[key] <= set(e) <= allowed, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_cells_name_known_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        doc = json.loads((ROOT / c["file"]).read_text())
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert sorted(doc["reduced"]) == sorted(c["reduced"]) and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
            assert k in doc, k


def test_metrics_bounds_moves_and_readers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_of_files_under_paths():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
