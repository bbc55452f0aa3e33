"""The rest of dense-LM training: gradient accumulation, the launcher's
``--accum`` / ``--grad-mode stochastic`` / ``--bf16`` against the
reference launcher, AdamW, the input shapes and the ``train_lm`` twin.

Inputs are the reference's weights (``init_params(cfg, PRNGKey(0))``,
converted) and batches (``synthetic_lm_batch``). Tolerances:

* ``accum_steps`` 2 against the reference's one step: loss rtol 1e-6 and
  the update within one ulp of the leaf's largest weight plus 1e-8 (the
  train-step bars of ``tests/test_torch_train_lm.py``: the micro-batches'
  gradients are summed in the same order); against ``accum_steps`` 1,
  ``scenario_perf_levers.py``'s bars, 2e-4 at the first step and 2e-3 at
  the second.
* The launchers, two steps from the same weights: losses within rtol
  1e-5 (fp32), 1e-4 (bf16: 8-bit activations rounded at other places;
  seen 2.0e-5 at 2×2); the wire and AWP lines equal.
* AdamW: five steps within rtol 1e-5 (the same fp32 formulas, ``b ** t``
  with ``t`` an fp32 tensor; XLA:CPU contracts some multiply-adds into
  FMAs, which moves mu, nu and the weights by a few ulps).
* The ``train_lm`` twin's ``cpu-demo``, 30 steps: the AWP history, wire
  reduction and recompiles equal the reference example's; the printed
  losses within 5e-4 relative. Its first 26 steps run at 8-bit weights
  (no mantissa bits): both packages truncate exactly, but a master that
  fp32 sums in another order leave on the other side of a power of two
  truncates to the neighbouring one, and the flips add up. Seen per step:
  2.3e-7 at step 0, 1e-5 by step 7, at most 3.3e-4 (step 25).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import shapes as jshapes
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import reduced as j_reduced
from repro.data.pipeline import synthetic_lm_batch as j_batch
from repro.dist.spec import MeshCfg as JMesh
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.models.init import init_params as j_init_params
from repro.optim import adamw as jadamw
from repro.optim.sgd import SGDConfig as JSGD
from repro.optim.sgd import init_momentum as j_init_momentum
from repro.plan import PrecisionPlan as JPlan
from repro.train import step as jstep
from repro_torch.configs import base as tbase
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.registry import get_config, get_shape, reduced
from repro_torch.convert import convert_lm_params
from repro_torch.dist.spec import MeshCfg, build_spec_tree
from repro_torch.launch import train as tlaunch
from repro_torch.launch import train_lm
from repro_torch.models.init import init_params
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train import step as tstep

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LR, B, S = 0.05, 8, 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _paths(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = j_reduced(j_get_config("qwen3-1.7b")), reduced(get_config("qwen3-1.7b"))
    params, metas = j_init_params(jcfg, jax.random.PRNGKey(0), tp=1)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    _, tmetas = init_params(tcfg, device="meta")
    tspec = build_spec_tree(convert_lm_params(tcfg, np_params, device="cpu"), tmetas, MeshCfg())
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, np_params=np_params,
                jspec=j_build_spec_tree(params, metas, JMesh(tp=1, dp=1)), tspec=tspec)


def _port_steps(s, plan, steps=2):
    tp = convert_lm_params(s["tcfg"], s["np_params"], device="cpu")
    fn = tstep.make_train_step(s["tcfg"], MeshCfg(), None, s["tspec"],
                               SGDConfig(lr=LR, momentum=0.9, weight_decay=1e-4),
                               {"tokens": (B, S), "labels": (B, S)}, plan=plan)
    mom, losses = init_momentum(tp), []
    for i in range(steps):
        t, l = j_batch(512, B, S, i)
        tp, mom, m = fn(tp, mom, {"tokens": torch.from_numpy(np.array(t)),
                                  "labels": torch.from_numpy(np.array(l))}, LR)
        losses.append(float(m["loss"]))
    return tp, losses


def test_accum_step_matches_reference(setup):
    s = setup
    nrt = s["jcfg"].num_groups + 1
    shapes = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    jfn = jstep.make_train_step(s["jcfg"], JMesh(tp=1, dp=1), None, s["jspec"],
                                JSGD(lr=LR, momentum=0.9, weight_decay=1e-4), shapes,
                                plan=JPlan.build(nrt, round_to=2, accum_steps=2))
    st = jax.tree_util.tree_map(jnp.copy, s["params"])
    t, l = j_batch(512, B, S, 0)
    jnew, _, jm = jfn(st, j_init_momentum(st), {"tokens": t, "labels": l}, LR)
    tnew, losses = _port_steps(s, PrecisionPlan.build(nrt, round_to=2, accum_steps=2), 1)
    np.testing.assert_allclose(losses[0], float(jm["loss"]), rtol=1e-6)
    old, jp, tp = _paths(s["np_params"]), _paths(jnew), _paths(tnew)
    for k in jp:
        atol = 1e-8 + float(np.spacing(np.abs(old[k]).max()))
        np.testing.assert_allclose(tp[k] - old[k], jp[k] - old[k], rtol=0, atol=atol, err_msg=k)


def test_accum_two_equals_accum_one_within_scenario_bars(setup):
    """``scenario_perf_levers.py``: two steps at ``accum_steps`` 2 and 1."""
    nrt = setup["jcfg"].num_groups + 1
    _, one = _port_steps(setup, PrecisionPlan.build(nrt, accum_steps=1))
    _, two = _port_steps(setup, PrecisionPlan.build(nrt, accum_steps=2))
    assert abs(one[0] - two[0]) < 2e-4 and abs(one[1] - two[1]) < 2e-3, (one, two)


# ---------------------------------------------------------------------------
# the launchers against the reference's
# ---------------------------------------------------------------------------

LAUNCH_CASES = {
    "accum": (["--accum", "2"], 1, 1e-5),
    # at 4 data ranks: the reference's donated step does not compile at dp 2
    # under jax 0.9.0 (ROADMAP reference caveats), and the noise is drawn
    # over each rank's shard, so both must shard alike
    "stochastic-4x1": (["--grad-mode", "stochastic", "--mesh", "4x1", "--grad-round-to", "2"],
                       4, 1e-5),
    "bf16": (["--bf16"], 1, 1e-4),
    "bf16-2x2": (["--bf16", "--mesh", "2x2"], 4, 1e-4),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launcher_flags_match_reference_launcher(case, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` against ``python -m
    repro.launch.train`` with the same flags (two steps, ``oracle:2``,
    batch 8 × 32), the port from the reference's weights: the losses
    within the case's rtol, the wire and AWP lines equal."""
    flags, devices, rtol = LAUNCH_CASES[case]
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "2", "--seq", "32",
            "--policy", "oracle:2", *flags]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = tmp_path / "ref.json"
    proc = subprocess.Popen([sys.executable, "-m", "repro.launch.train", *argv,
                             "--losses-out", str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        tp = 2 if "2x2" in case else 1
        params, _ = j_init_params(j_reduced(j_get_config("qwen3-1.7b")), jax.random.PRNGKey(0),
                                  tp=tp)
        s = tlaunch.main([*argv, "--device", "cpu"], params=convert_lm_params(
            reduced(get_config("qwen3-1.7b")), jax.tree_util.tree_map(np.asarray, params),
            device="cpu", tp=tp))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference launcher failed:\n{stderr[-3000:]}"
    np.testing.assert_allclose(s["losses"], json.loads(out.read_text())["losses"], rtol=rtol)
    text = capsys.readouterr().out

    def lines(t):
        return [ln for ln in t.splitlines() if ln.startswith(("wire by plan entry", "AWP:"))]

    assert lines(text) == lines(stdout)
    if devices > 1:
        assert "[OK against step_wire_table]" in text


# ---------------------------------------------------------------------------
# AdamW, shapes
# ---------------------------------------------------------------------------


def test_adamw_five_steps_match_reference():
    rng = np.random.default_rng(0)
    P = {"a": rng.normal(size=(7, 5)).astype(np.float32),
         "b": rng.normal(size=(3,)).astype(np.float32)}
    wd = {"a": 1.0, "b": 0.0}
    jp = {k: jnp.asarray(v) for k, v in P.items()}
    js = jadamw.init_adamw(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in P.items()}
    ts = tadamw.init_adamw(tp)
    jcfg, tcfg = jadamw.AdamWConfig(), tadamw.AdamWConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    upd = jax.jit(lambda p, g, st, lr: jadamw.adamw_update(p, g, st, wd, jcfg, lr))
    for i in range(5):
        G = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in P.items()}
        jp, js = upd(jp, {k: jnp.asarray(v) for k, v in G.items()}, js, 1e-3)
        tp, ts = tadamw.adamw_update(tp, {k: torch.from_numpy(v) for k, v in G.items()}, ts,
                                     wd, tcfg, 1e-3)
        assert int(ts["t"]) == int(js["t"]) == i + 1 and ts["t"].dtype == torch.int32
        for k in P:
            for got, want in ((tp[k], jp[k]), (ts["mu"][k], js["mu"][k]),
                              (ts["nu"][k], js["nu"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)


def test_input_shapes_and_specs_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.INPUT_SHAPES.items()}
    for cfg in (get_config("qwen3-1.7b"), reduced(get_config("qwen3-1.7b"))):
        jcfg = j_get_config("qwen3-1.7b") if cfg.d_model > 256 else \
            j_reduced(j_get_config("qwen3-1.7b"))
        for name, shape in tbase.INPUT_SHAPES.items():
            got = tshapes.input_specs(cfg, shape)
            want = jshapes.input_specs(jcfg, jbase.INPUT_SHAPES[name])
            assert got.keys() == want.keys()
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
            assert tshapes.applicable(cfg, shape) == jshapes.applicable(jcfg,
                                                                       jbase.INPUT_SHAPES[name])
        assert get_shape("decode_32k") == tbase.INPUT_SHAPES["decode_32k"]
    with pytest.raises(KeyError):
        get_shape("nope")


# ---------------------------------------------------------------------------
# the train_lm twin
# ---------------------------------------------------------------------------


def _example():
    """``examples/train_lm.py`` as a module (its ``build_preset``)."""
    return runpy.run_path(os.path.join(ROOT, "examples", "train_lm.py"))


@pytest.mark.parametrize("preset", ["cpu-demo", "8dev", "100m"])
def test_presets_match_the_example(preset):
    jcfg, jmesh, *jrest = _example()["build_preset"](preset)
    tcfg, tmesh, *trest = train_lm.build_preset(preset)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tmesh.tp, tmesh.dp, tmesh.pods, tmesh.compress_min_size) == \
        (jmesh.tp, jmesh.dp, jmesh.pods, jmesh.compress_min_size)
    assert trest == jrest


def test_cpu_demo_matches_the_example(tmp_path, capsys):
    """30 steps of ``cpu-demo`` (AWP widens at step 26) from the example's
    weights: the example's AWP history, wire reduction and recompiles, and
    its printed losses."""
    argv = sys.argv
    sys.argv = ["train_lm.py", "--preset", "cpu-demo", "--steps", "30",
                "--ckpt", str(tmp_path / "ckpt.npz")]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "examples", "train_lm.py"), run_name="__main__")
    finally:
        sys.argv = argv
    ref = buf.getvalue()
    cfg, *_ = train_lm.build_preset("cpu-demo")
    params, _ = j_init_params(j_reduced(j_get_config("qwen3-1.7b"), layers=4),
                              jax.random.PRNGKey(0), tp=1)
    s = train_lm.main(["--preset", "cpu-demo", "--steps", "30", "--device", "cpu"],
                      params=convert_lm_params(cfg, jax.tree_util.tree_map(np.asarray, params),
                                               device="cpu"))
    out = capsys.readouterr().out

    def figures(t):
        final = re.search(r"final loss (\S+)  wire reduction (\S+)  recompiles (\d+)", t)
        step = re.search(r"step   25  loss (\S+)  rts (.*?)  wire (\S+)", t)
        awp = [ln for ln in t.splitlines() if ln.startswith("AWP history")]
        return final.groups(), step.groups(), awp

    (tl, tw, tr_), (ts, trt, tsw), tawp = figures(out)
    (jl, jw, jr), (js, jrt, jsw), jawp = figures(ref)
    assert (tw, tr_, trt, tsw, tawp) == (jw, jr, jrt, jsw, jawp)
    assert len(tawp) == 1 and "(26, (16, 16, 16))" in tawp[0]
    for a, b in ((tl, jl), (ts, js)):  # 4 printed decimals: 5e-5 of rounding on each side
        assert abs(float(a) - float(b)) <= 5e-4 * float(b) + 1e-4, (a, b)
    assert len(s["losses"]) == 30 and out.splitlines()[0] == ref.splitlines()[0]


def test_twin_writes_no_checkpoint(tmp_path, capsys):
    """At a mesh preset the twin wrote no checkpoint until ROADMAP item 9b;
    now ``8dev``'s eight ranks gather theirs to rank 0, which writes the
    4x2 mesh's global storage at full width, as the reference's
    ``examples/train_lm.py`` does (the reference loads it:
    ``test_torch_mesh_io.py``)."""
    from repro_torch.checkpoint.sharded import leaf_entries, manifest_bytes, read_meta
    from repro_torch.dist.spec import build_spec_tree, storage_shape
    from repro_torch.models.init import init_params

    path = str(tmp_path / "lm.npz")
    train_lm.main(["--preset", "8dev", "--steps", "1", "--device", "cpu", "--ckpt", path])
    assert f"checkpoint -> {path}" in capsys.readouterr().out
    d = str(tmp_path / "lm.ckpt")
    meta = read_meta(d)
    cfg, mcfg, *_ = train_lm.build_preset("8dev")
    shapes, metas = init_params(cfg, device="meta", tp=mcfg.tp)
    specs = dict(leaf_entries(build_spec_tree(shapes, metas, mcfg)))
    assert meta["step"] == 1 and meta["awp"]["history"]
    for name in ("storage", "opt"):
        for e in meta["trees"][name]:
            assert tuple(e["shape"]) == storage_shape(specs[e["path"]], mcfg), e["path"]
            assert not e["tiered"]  # full width, as the reference's
    sizes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d) if f.endswith(".bin"))
    assert manifest_bytes(meta)["total"] == sizes


# ---------------------------------------------------------------------------
# chip_smoke.py phase 16, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_phase16_rehearses_on_cpu(monkeypatch, capsys):
    """``chip_smoke.py`` phase 16 at reduced widths on the CPU (plain
    versions; launch counts, memory peaks and the kernel checks are read
    on a card only): (a) accumulation within its bars, (b) the stochastic
    planes drawn twice and held to the host's, a rerun bit-equal, (c) two
    AlexNet ranks with stochastic gradients, two runs bit-equal, (d) bf16
    training within its bar of fp32, (e) the bf16 engines' streams equal
    to the static run's, paged to contiguous."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    from repro_torch.models.cnn import ALEXNET, reduced_cnn

    cpu = torch.device("cpu")
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b"), layers=4), remat=True)
    out = chip_smoke.lm_features_path(
        torch, cpu, cfg=cfg, batch=4, seq=32,
        dp_cfg=reduced_cnn(ALEXNET, num_classes=10, in_hw=32), dp_batch=8, dp_min_size=256)
    assert len(out["bf16"]["losses"]) == chip_smoke.BF16_STEPS
    served = chip_smoke.serve_path(torch, cpu, cfg=reduced(get_config("qwen3-1.7b")),
                                   lens=(32, 32, 24, 16, 12), gen=5)
    bf = chip_smoke.bf16_serve_path(torch, cpu, served, page=8)
    assert bf["runs"]["engine"] and bf["runs"]["paged engine"] == bf["runs"]["engine"]
    text = capsys.readouterr().out
    for tag in ("(a) accum 2 against 1", "(b) stochastic", "(c) 2 ranks", "(d) bf16",
                "(e) bf16 paged engine"):
        assert tag in text, tag
