"""The data-motion audit: the port's recorder and auditor against the
reference's jaxpr auditor.

The reference's outputs come from one subprocess of this file: the
reference's ``repro.audit.__main__.run_sweep`` with 8 emulated host
devices (as ``tests/scenarios/scenario_audit.py`` runs it) over
``SWEEPS``: three archs (reduced), train / prefill / decode / place,
meshes 1×2, 2×1, 2×2, plans rt2 and awp_widened, the psum layout, and the
MoE ``ep`` layout (arctic-480b), written to one JSON file. The port audits the same combos as rank 0 of a
fake process group (nothing allocated) while the reference traces. Exact, class by class: the recorded ring wire
bytes equal the reference's ``jaxpr_bytes`` and the analytic bytes its
``analytic_bytes``, but where the port's structure differs by design
(``repro_torch.audit.audit``'s docstring): a serve step's ``logits``
gathers (the reference's ``out_specs`` need none), a MoE train step's
aux all-reduce over the data ranks, and under ``ep`` the reference's
backward all-reduce that F2 drops. A wrong plan is rejected naming the
class; a wrong label is caught; no audit leaves a process group behind.

The full-width dry run (``python -m repro_torch.launch.dryrun --arch
qwen3-1.7b --shape train_4k``: rank 0 of a fake world of 256) runs in a
second child, started first and beside the reference's sweeps; its plan
and model FLOPs are the reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.registry import get_config as j_get_config
from repro.launch.dryrun import plan_for_combo as j_plan_for_combo
from repro.roofline.analysis import model_flops_estimate as j_model_flops

from repro_torch.audit import AuditError, audit_step, recording
from repro_torch.audit.__main__ import audit_combo
from repro_torch.audit.cases import build_case, make_plan, parse_mesh
from repro_torch.configs.registry import get_config, reduced
from repro_torch.transport.policy import ring_wire_bytes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# (archs, kinds, meshes, plans): one reference sweep each, all in one child:
# qwen3-1.7b over the whole cross product, mixtral-8x7b (its ``tp`` MoE
# layout) and llama-3.2-vision-90b at rt2 on every mesh and awp_widened at
# 2×2, arctic-480b for the MoE ``ep`` layout
KINDS = ("train", "prefill", "decode", "place")
SWEEPS = ((("qwen3-1.7b",), KINDS, ("1x2", "2x1", "2x2"), ("rt2", "awp_widened")),
          (("mixtral-8x7b", "llama-3.2-vision-90b"), KINDS, ("1x2", "2x1", "2x2"), ("rt2",)),
          (("mixtral-8x7b", "llama-3.2-vision-90b"), KINDS, ("2x2",), ("awp_widened",)),
          (("arctic-480b",), ("train", "prefill"), ("1x2", "2x2"), ("rt2",)))
COMBOS = [c for sweep in SWEEPS for c in itertools.product(*sweep)]
GLOBAL_BATCH = 4
DRY_ARGV = ["--arch", "qwen3-1.7b", "--shape", "train_4k"]
# the dry run's child reports its own peak resident memory
DRY_CODE = ("import resource, runpy\n"
            "try:\n"
            "    runpy.run_module('repro_torch.launch.dryrun', run_name='__main__', "
            "alter_sys=True)\n"
            "finally:\n"
            "    print('MAXRSS_KB', resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)\n")


@pytest.fixture(scope="module")
def dry_run(tmp_path_factory):
    """The full-width dry run in a child process, started before the module's
    other tests run and read at the end."""
    out = str(tmp_path_factory.mktemp("dryrun") / "dry.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", DRY_CODE, *DRY_ARGV, "--json", out],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def result():
        if not box:
            try:
                stdout, stderr = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
            assert proc.returncode == 0, f"dry run failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
            with open(out) as f:
                box["result"] = json.load(f)[0]
            box["maxrss"] = int(re.search(r"MAXRSS_KB (\d+)", stdout).group(1)) * 1024
        return box

    yield result
    if proc.poll() is None:
        proc.kill()


def test_dry_run_starts(dry_run):
    """Starts the child first (this file's tests run in order)."""
    assert callable(dry_run)


# the child: the sweeps through the reference's ``run_sweep``, one JSON list
_REF_SWEEPS = """
import json, sys
from repro.audit.__main__ import run_sweep
results = []
for archs, kinds, meshes, plans in json.loads(sys.argv[2]):
    out, n_failed = run_sweep(archs, kinds, meshes, plans, seq_parallel="off", verbose=False)
    assert n_failed == 0, n_failed
    results += out
with open(sys.argv[1], "w") as f:
    json.dump(results, f)
"""


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    """``(reference reports, port reports)`` by combo: the reference's
    sweeps in one subprocess while the port audits in this process."""
    out = str(tmp_path_factory.mktemp("audit") / "ref.json")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", _REF_SWEEPS, out, json.dumps(SWEEPS)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {}
        for arch, kind, mesh, plan_name in COMBOS:
            mesh_cfg = parse_mesh(mesh)
            plan = make_plan(plan_name, reduced(get_config(arch)).num_groups + 1)
            port[arch, kind, mesh, plan_name] = audit_combo(arch, kind, mesh_cfg, plan,
                                                            global_batch=GLOBAL_BATCH)
            assert not dist.is_initialized()
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, f"reference failed:\n{stdout[-3000:]}\n{stderr[-3000:]}"
    with open(out) as f:
        ref = {(r["arch"], r["kind"], r["mesh"], r["plan"]): r["report"] for r in json.load(f)}
    return ref, port


def _port_only(arch, kind, mesh, plan_name) -> dict:
    """The bytes by which a class of the port differs from the reference's
    program in a train step: the MoE aux loss's all-reduce over the data
    ranks (``metrics``, the port's alone), and under the ``ep`` layout at
    tp > 1 the reference's ``psum_enter`` before the token split, whose
    backward all-reduce of a layer's ``(B / dshards, S, d)`` cotangent the
    port drops (ROADMAP Queue 3, F2: the reference's gradients come out
    tp times too large there). The logits gathers are their own class."""
    cfg, mesh_cfg = reduced(get_config(arch)), parse_mesh(mesh)
    out = {}
    if kind != "train" or not cfg.num_experts:
        return out
    if mesh_cfg.dshards > 1:
        out["metrics"] = ring_wire_bytes("all-reduce", 4, mesh_cfg.dshards)
    if cfg.moe_impl == "ep" and mesh_cfg.tp > 1:
        act = make_plan(plan_name, cfg.num_groups + 1).activations
        elems = GLOBAL_BATCH // mesh_cfg.dshards * 32 * cfg.d_model
        out["activations"] = -cfg.num_layers * act.all_reduce_wire_bytes(elems, mesh_cfg.tp)
    return out


@pytest.mark.parametrize("arch,kind,mesh,plan", COMBOS)
def test_recorded_bytes_equal_reference_jaxpr_bytes(audits, arch, kind, mesh, plan):
    ref, port = audits
    want, got = ref[arch, kind, mesh, plan], port[arch, kind, mesh, plan]
    assert want["ok"] and got.ok, got.violations
    extra = _port_only(arch, kind, mesh, plan)
    classes = {k: v for k, v in got.classes.items() if k != "logits"}
    assert sorted(classes) == sorted(want["classes"])
    for name, c in classes.items():
        w = want["classes"][name]
        assert round(c.recorded_bytes) == w["jaxpr_bytes"] + extra.get(name, 0), name
        assert round(c.analytic_bytes) == w["analytic_bytes"] + extra.get(name, 0), name
        assert c.structural == w["structural"], name
    mesh_cfg = parse_mesh(mesh)
    sharded = GLOBAL_BATCH >= mesh_cfg.dshards
    gathers = (kind in ("prefill", "decode")) * ((mesh_cfg.tp > 1) + (mesh_cfg.dshards > 1
                                                                        and sharded))
    assert (got.classes["logits"].calls if "logits" in got.classes else 0) == gathers


def test_wrong_plan_is_rejected_naming_the_class():
    """Run under rt4 (fp32 gathers and reduce-scatters), audit against rt2:
    the weights moved at 4 B an element where 2 B planes were promised."""
    mesh_cfg = parse_mesh("2x1")
    n = reduced(get_config("qwen3-1.7b")).num_groups + 1
    with recording(mesh_cfg) as rec:
        case = build_case("qwen3-1.7b", "train", mesh_cfg, make_plan("rt4", n), mesh=rec.mesh)
        report = audit_step(case.step, case.args, make_plan("rt2", n), mesh_cfg=mesh_cfg,
                            mesh=rec.mesh, spec_tree=case.spec_tree, kind="train")
    assert not dist.is_initialized()
    assert not report.ok
    with pytest.raises(AuditError) as e:
        report.raise_if_failed()
    assert e.value.report is report
    assert any(v.startswith("weights: ") and "at 4 B/elem" in v for v in report.violations)
    assert any(v.startswith("gradients: ") for v in report.violations)


def test_a_label_that_disagrees_is_a_violation():
    """The attribution reads dtype, shape and group; a call labelled
    ``weights`` that moves a metric's all-reduce is caught."""
    from repro_torch.audit.audit import audit_calls

    mesh_cfg = parse_mesh("2x1")
    n = reduced(get_config("qwen3-1.7b")).num_groups + 1
    with recording(mesh_cfg) as rec:
        case = build_case("qwen3-1.7b", "train", mesh_cfg, make_plan("rt2", n), mesh=rec.mesh)
        case.step(*case.args)
        calls = rec.records
        bad = [dataclasses.replace(c, traffic="weights") if c.traffic == "metrics" else c
               for c in calls]
        good = audit_calls(calls, case.plan, mesh_cfg=mesh_cfg, mesh=rec.mesh,
                           spec_tree=case.spec_tree, kind="train")
        wrong = audit_calls(bad, case.plan, mesh_cfg=mesh_cfg, mesh=rec.mesh,
                            spec_tree=case.spec_tree, kind="train")
    assert good.ok, good.violations
    assert [v for v in wrong.violations if v.startswith("label 'weights'")]


@pytest.mark.parametrize("plan_name", ["rt2", "rt4", "awp_widened"])
def test_cnn_train_step_at_dp2_audits(plan_name):
    """The ``cnn_train`` kind (the CNN layout, ``groups_info``): reduced
    AlexNet's step at dp 2 moves what the plan says, class by class (the
    reference's audit builds no CNN case)."""
    import torch

    from repro_torch import random as trandom
    from repro_torch.audit.cases import make_plan
    from repro_torch.dist.spec import MeshCfg, leaf_to_local
    from repro_torch.models.cnn import ALEXNET, init_cnn, reduced_cnn
    from repro_torch.optim.sgd import SGDConfig
    from repro_torch.train import cnn_step
    from repro_torch.utils.trees import tree_map

    cfg = reduced_cnn(ALEXNET)
    mesh_cfg = MeshCfg(dp=2, compress_min_size=256)
    shapes, metas, groups_info = init_cnn(cfg, 0, device="meta")
    plan = make_plan(plan_name, groups_info[1])
    with recording(mesh_cfg) as rec:
        spec = cnn_step.build_cnn_spec_tree(shapes, metas, mesh_cfg)
        storage = tree_map(lambda s, x: leaf_to_local(torch.zeros(x.shape), s, mesh_cfg, 0),
                           spec, shapes)
        step = cnn_step.make_cnn_train_step(cfg, mesh_cfg, spec, groups_info, SGDConfig(),
                                            plan=plan, mesh=rec.mesh)
        batch = {"images": torch.zeros(8, 32, 32, 3), "labels": torch.zeros(8, dtype=torch.int64)}
        report = audit_step(step, (storage, tree_map(torch.zeros_like, storage), batch, 0.1,
                                   trandom.PRNGKey(0)), plan, mesh_cfg=mesh_cfg, mesh=rec.mesh,
                            spec_tree=spec, kind="cnn_train", groups_info=groups_info)
    assert report.ok, report.violations
    elems = cnn_step.cnn_dist_elems(spec, groups_info, mesh_cfg)
    table = plan.wire_table(elems, 2)
    assert set(report.classes) == {"weights", "gradients", "grad_sync", "metrics"}
    for k in ("weights", "gradients"):
        assert round(report.classes[k].recorded_bytes) == table[k] > 0


# ---------------------------------------------------------------------------
# the dry run (the child started first)
# ---------------------------------------------------------------------------


def test_dry_run_full_width_matches_reference_plan_and_flops(dry_run):
    """qwen3-1.7b ``train_4k`` at 16×16 as rank 0 of 256, in one CPU process:
    the reference's plan and model FLOPs; the step's 28 layers recorded
    (the weights' and gradients' planes per ``wire_table``); its peak
    on the rank far above what the process ever held (nothing allocated)."""
    got = dry_run()
    r = got["result"]
    jcfg = j_get_config("qwen3-1.7b")
    jplan = j_plan_for_combo(jcfg, J_SHAPES["train_4k"], 2)
    assert r["plan"] == jplan.to_json_dict()
    assert r["roofline"]["model_flops"] == j_model_flops(jcfg, J_SHAPES["train_4k"], 256)
    assert r["mesh"] == "16x16" and r["roofline"]["flops"] > r["roofline"]["model_flops"]
    split = r["roofline"]["collectives"]["per_plan_entry"]
    assert split["weights"] > 0 and split["gradients"] > 0
    assert r["memory"]["peak_bytes"] > 8 * got["maxrss"]  # ~26.7 GB on the rank
