"""Serving at tp > 1: the launcher twin against the reference launcher, the
launcher on a weight-stationary 2×2 mesh, and a CPU rehearsal of
``chip_smoke.py`` phase 14 (the step and engine parity is in
``tests/test_torch_tp_serve.py``).

The reference launcher runs in a subprocess (``python -m
repro.launch.serve --static``) with 4 emulated host devices; the port's
launcher spawns 2 gloo ranks (one CPU thread each) from the reference's
weights, ``init_params(cfg, PRNGKey(0), tp=2)`` of reduced qwen3-1.7b,
converted. The printed streams must be equal.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys

import jax
import numpy as np
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models.init import init_params as j_init_params
from repro_torch.configs.registry import get_config, reduced

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH = ["--arch", "qwen3-1.7b", "--reduced", "--prompt-lens", "16,12,16", "--gen", "4"]


def _env(devices: int = 0) -> dict:
    env = dict(os.environ)
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _streams(text):
    return re.findall(r"^  req(\d+): (\[.*\])$", text, flags=re.M)


def test_launcher_twin_at_1x2_prints_reference_streams(capsys):
    """``--mesh 1x2 --check-static --device cpu`` from the reference's
    weights: two gloo ranks; the engine's streams equal the port's static
    run and the reference launcher's ``--static`` streams at the same mesh;
    the measured wire equals ``serve_wire_table`` (its own line)."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.launch import serve as tlaunch

    proc = subprocess.Popen([sys.executable, "-m", "repro.launch.serve", *LAUNCH,
                             "--mesh", "1x2", "--static"], env=_env(4),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        params, _ = j_init_params(j_reduced(j_get_config("qwen3-1.7b")), jax.random.PRNGKey(0),
                                  tp=2)
        params = convert_lm_params(reduced(get_config("qwen3-1.7b")),
                                   jax.tree_util.tree_map(np.asarray, params), device="cpu",
                                   tp=2)
        results = tlaunch.main([*LAUNCH, "--mesh", "1x2", "--check-static", "--device", "cpu"],
                               params=params)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference launcher failed:\n{stderr[-3000:]}"
    out = capsys.readouterr().out
    assert len(_streams(stdout)) == 3 and _streams(out) == _streams(stdout)
    assert sorted(results) == [0, 1, 2] and all(len(r.tokens) == 4 for r in results.values())
    assert "check-static: 3 streams equal to the static reference" in out
    assert "[OK against serve_wire_table]" in out and "logits" in out


def test_launcher_serves_a_weight_stationary_2x2_mesh():
    """``python -m repro_torch.launch.serve --reduced --mesh 2x2
    --weight-stationary --check-static --device cpu`` exits 0: four ranks,
    one slot a data rank, the placement gathered once."""
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH,
                           "--mesh", "2x2", "--weight-stationary", "--max-slots", "2",
                           "--check-static", "--device", "cpu"], env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "check-static: 3 streams equal to the static reference" in proc.stdout
    assert "[OK against serve_wire_table]" in proc.stdout
    assert "placement wire (once): {'weights':" in proc.stdout


def test_chip_smoke_tp_serve_phase_rehearses_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` phase 14 at reduced width on the CPU, after phase
    7's rehearsal: two ranks at 1×2 and four at 2×2 (plain versions; launch
    counts, packing records and the profile are read on a card only) pass
    the streams, logits, hashes, wire and host<->device checks."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    cfg = reduced(get_config("qwen3-1.7b"))
    served = chip_smoke.serve_path(torch, torch.device("cpu"), cfg=cfg,
                                   lens=(32, 32, 24, 16, 12), gen=5)
    out = chip_smoke.tp_serve_path(torch, torch.device("cpu"), served, cfg=cfg, b_gen=3)
    assert [len(out["meshes"][m]) for m in ("1x2", "2x2")] == [2, 4]
    runs = out["meshes"]["1x2"][0]["runs"]
    assert list(runs) == [r["label"] for r in chip_smoke.TPS_RUNS_A]
    decode = [runs[k]["wire_by_forward"]["decode"]["activations"]
              for k in ("act2 engine", "engine")]
    assert decode[0] * 2 == decode[1]  # packed at round_to 2
    text = capsys.readouterr().out
    assert text.count("engines as their static runs") == 2 and "DIVERGED" not in text
