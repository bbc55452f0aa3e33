"""FSDP×TP training of the dense LM: the wire accounting, the launcher twin
against the reference launcher, and a CPU rehearsal of ``chip_smoke.py``
phase 13 (the step parity is in ``tests/test_torch_tp.py``).

The reference launcher runs in a subprocess (``python -m
repro.launch.train``) with 4 emulated host devices; the port's launcher
spawns 4 gloo ranks (one CPU thread each) from the reference's weights,
``init_params(cfg, PRNGKey(0), tp=2)`` of reduced qwen3-1.7b, converted.
The printed loss, wire-reduction, wire by plan entry and AWP lines must be
equal; ``wire_table``'s activation rows equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.models.init import init_params as j_init_params
from repro.plan import PrecisionPlan as JPlan
from repro_torch.configs.registry import get_config, reduced
from repro_torch.plan import PrecisionPlan
from repro_torch.train.step import COLLECTIVE_CLASSES

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LAUNCH = ["--arch", "qwen3-1.7b", "--reduced", "--mesh", "2x2", "--steps", "2",
          "--seq", "32", "--policy", "oracle:2"]


@pytest.mark.parametrize("kw", [
    dict(round_to=2), dict(round_to=2, act_round_to=2), dict(round_to=3, act_round_to=3,
                                                             seq_parallel=True),
    dict(round_to=2, seq_parallel=True), dict(round_to=1, grad_round_to=2, act_round_to=2),
], ids=["rt2", "act2", "act3-seq", "seq", "grad2-act2"])
def test_tp_wire_table_equals_reference(kw):
    """``wire_table`` at tp 2 and 4 with activation boundaries: the
    reference's rows (``activations`` as all-reduces, ``seq_boundary`` as
    gather/scatter pairs) and totals."""
    elems = [1_433_600, 1_433_600, 131_072]
    t, j = PrecisionPlan.build(3, **kw), JPlan.build(3, **kw)
    for n in (1, 2, 4):
        for tp in (1, 2, 4):
            for act in ((0, 0), (32_768, 14), (4 * 32 * 256, 20)):
                got = t.wire_table(elems, n, tp=tp, act_elems=act[0], act_collectives=act[1])
                want = j.wire_table(elems, n, tp=tp, act_elems=act[0], act_collectives=act[1])
                assert got == want, (n, tp, act)


def test_tp_boundaries_count_the_step():
    """Reduced qwen3 (2 layers, MLP on): 2 blocks a layer, so 2·4 + 2
    boundaries; under remat the backward runs every block's enter and the
    attention blocks' exits again."""
    from repro_torch.train.step import remat_tp_collectives, tp_boundaries

    tcfg = reduced(get_config("qwen3-1.7b"))
    assert tp_boundaries(tcfg) == 10 and remat_tp_collectives(tcfg) == (0, 0)
    assert remat_tp_collectives(dataclasses.replace(tcfg, remat=True)) == (4, 2)


def _figures(text):
    done = re.search(r"done: loss (\S+)  wire-reduction (\S+)  recompiles (\d+)", text)
    lines = [ln for ln in text.splitlines() if ln.startswith(("wire by plan entry", "AWP:"))]
    return done.groups(), lines


def test_launcher_twin_prints_reference_figures(capsys):
    """``--mesh 2x2 --reduced --device cpu`` from the reference's weights:
    four gloo ranks; the reference launcher's loss, wire-reduction, wire by
    plan entry and AWP lines; the measured wire equal to
    ``step_wire_table`` (its own line)."""
    from repro_torch.convert import convert_lm_params
    from repro_torch.launch import train as tlaunch

    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", "repro.launch.train", *LAUNCH], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        params, _ = j_init_params(j_reduced(j_get_config("qwen3-1.7b")), jax.random.PRNGKey(0),
                                  tp=2)
        params = jax.tree_util.tree_map(np.asarray, params)
        tcfg = reduced(get_config("qwen3-1.7b"))
        s = tlaunch.main([*LAUNCH, "--device", "cpu"],
                         params=convert_lm_params(tcfg, params, device="cpu", tp=2))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference launcher failed:\n{stderr[-3000:]}"
    out = capsys.readouterr().out
    assert _figures(out) == _figures(stdout)
    assert "[OK against step_wire_table]" in out
    assert len(s["losses"]) == 2 and s["measured"][0]["activations"] > 0
    for measured, table in zip(s["measured"], s["step_tables"], strict=True):
        assert {k: measured.get(k, 0) for k in COLLECTIVE_CLASSES} == {
            k: table[k] for k in COLLECTIVE_CLASSES}


def test_chip_smoke_tp_phase_rehearses_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` phase 13 at reduced width (remat on, as at full
    width) on the CPU: four gloo ranks (plain versions; launch counts,
    packing records and the profile are read on a card only) pass checks
    (a) and (c)-(f)."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke

    tcfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), remat=True)
    out = chip_smoke.tp_train_path(torch, torch.device("cpu"), cfg=tcfg, batch=8, seq=32)
    assert out["seq_bits"] and out["seq_gap"] == 0.0
    assert out["loss_gap"] <= chip_smoke.TP_LOSS_RTOL
    assert out["norm_gap"] <= chip_smoke.TP_NORM_RTOL
    assert out["move_gap"] <= chip_smoke.TP_MOVE_RTOL
    assert len(out["ranks"]) == chip_smoke.TP_DP * chip_smoke.TP_TP
    assert capsys.readouterr().out.count("(== table)") == len(chip_smoke.TP_STEPS)
