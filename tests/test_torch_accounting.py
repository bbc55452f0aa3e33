"""Accounting and tooling: the port against the JAX reference.

Pure arithmetic, exact: the chunk sweep (``plan/sweep.py``) with the
reference's hardware constants passed in, over a grid and the
reference's own edge cases; ``model_flops_estimate`` for every arch,
shape and chip count; ``param_shapes`` at full width; ``--chunks auto``'s
choice against the count the reference's ``plan_from_args`` prints. Then
the port's own: ``dist.comm``'s records under the recorder (every
function, its payload's dtype and shape and the group's ranks, no read of
a fake tensor's storage) and ``roofline/cost.py`` on a small step (the
full-width dry run is in ``test_torch_audit.py``, beside the audit's
reference sweep). No reference subprocess: the reference's functions
here do not trace.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import math
import re
import warnings

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.train as jlaunch
from repro.configs.base import INPUT_SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import get_config as j_get_config
from repro.dist.spec import build_spec_tree as j_build_spec_tree
from repro.models.init import param_shapes as j_param_shapes
from repro.plan import sweep as jsweep
from repro.roofline.analysis import model_flops_estimate as j_model_flops
from repro.transport import policy_for as j_policy_for

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import ARCHS, get_config, reduced
from repro_torch.dist import comm
from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group
from repro_torch.launch import train as tlaunch
from repro_torch.models.init import param_shapes
from repro_torch.plan import CHUNK_CANDIDATES, modeled_gather_time, pick_chunks, sweep_chunks
from repro_torch.roofline import analysis as A
from repro_torch.transport import policy_for

# the reference's hardware constants, passed to the port's sweep
J_HW = dict(hbm_bw=jsweep.HBM_BW, link_bw=jsweep.ICI_BW, latency=jsweep.COLLECTIVE_LATENCY)
S_LOCS = (0, 1, 6, 7, 1000, 1 << 16, 3 * (1 << 18), 1 << 20, 77_791_232, 155_582_464,
          1_048_583)
AXES = (1, 2, 4, 8, 16, 256)
CANDIDATES = (CHUNK_CANDIDATES, (1, 3, 5), (2, 4), (16,))


# ---------------------------------------------------------------------------
# plan/sweep.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rt", [1, 2, 3, 4])
def test_sweep_equals_reference_over_a_grid(rt):
    """``modeled_gather_time``, ``sweep_chunks`` and ``pick_chunks`` equal the
    reference's exactly (the same float operations) at its constants."""
    jpol, tpol = j_policy_for(rt), policy_for(rt)
    for s_loc in S_LOCS:
        for n in AXES:
            for c in (1, 2, 3, 4, 8, 16):
                if s_loc:
                    assert (modeled_gather_time(s_loc, n, tpol, c, **J_HW)
                            == jsweep.modeled_gather_time(s_loc, n, jpol, c)), (s_loc, n, c)
            for cands in CANDIDATES:
                assert sweep_chunks(s_loc, n, rt, cands, **J_HW) == jsweep.sweep_chunks(
                    s_loc, n, rt, cands), (s_loc, n, cands)
                assert pick_chunks(s_loc, n, rt, cands, **J_HW) == jsweep.pick_chunks(
                    s_loc, n, rt, cands), (s_loc, n, cands)


def test_sweep_reference_edge_cases():
    """The reference's own cases (``tests/test_plan.py``), on the port's
    sweep at the reference's constants and at the port's."""
    for hw in (J_HW, {}):
        table = sweep_chunks(1 << 20, 8, 2, **hw)
        assert set(table) == {1, 2, 4, 8, 16}
        best = pick_chunks(1 << 20, 8, 2, **hw)
        assert table[best] == min(table.values())
        assert set(sweep_chunks(6, 2, 2, **hw)) == {1, 2}  # non-dividing excluded
        assert pick_chunks(0, 8, **hw) == 1
        assert pick_chunks(1 << 20, 1, **hw) == 1
        assert pick_chunks(7, 8, **hw) == 1  # prime shard: nothing divides
        pol = policy_for(2)
        assert (modeled_gather_time(1 << 20, 8, pol, best, **hw)
                <= 3 * modeled_gather_time(1 << 20, 8, pol, 1, **hw))
    assert pick_chunks(1 << 20, 8, 2, **J_HW) == jsweep.pick_chunks(1 << 20, 8, 2)


def test_port_constants_are_the_cards():
    """The sweep's defaults are the port's constants, kept in one place, and
    none is a TPU figure (819 GB/s, 50 GB/s, 197 TFLOP/s, 5 us)."""
    pol = policy_for(2)
    assert modeled_gather_time(1 << 20, 8, pol, 2) == modeled_gather_time(
        1 << 20, 8, pol, 2, hbm_bw=A.HBM_BW, link_bw=A.LINK_BW, latency=A.COLLECTIVE_LATENCY)
    assert (A.PEAK_FLOPS_FP32, A.PEAK_FLOPS_BF16, A.HBM_BW) == (67e12, 989e12, 3.35e12)
    for v in (A.HBM_BW, A.LINK_BW, A.COLLECTIVE_LATENCY, A.PEAK_FLOPS_FP32, A.PEAK_FLOPS_BF16):
        assert v not in (819e9, 50e9, 197e12, 5e-6)


# ---------------------------------------------------------------------------
# --chunks auto
# ---------------------------------------------------------------------------

AUTO_CASES = [("qwen3-1.7b", "16x16"), ("qwen3-1.7b", "2x2"), ("qwen3-1.7b", "2x16x16"),
              ("mixtral-8x7b", "16x16"), ("llama-3.2-vision-90b", "16x16"),
              ("xlstm-1.3b", "4x1")]
POLICIES = ("awp", "oracle:1", "oracle:2", "oracle:3", "baseline")


def _args(policy):
    return argparse.Namespace(plan="", policy=policy, chunks="auto", grad_round_to=4,
                              grad_mode="nearest", act_round_to=4, seq_parallel=False,
                              bf16=False, accum=1, awp_threshold=1e-3, awp_interval=25)


@pytest.mark.parametrize("arch,mesh", AUTO_CASES, ids=lambda x: str(x))
def test_chunks_auto_equals_reference_launcher(arch, mesh):
    """At the reference's constants the port's ``--chunks auto`` choice is the
    count the reference's ``plan_from_args`` prints, for each policy; the
    port's launcher prints the choice at its own constants."""
    jmesh, tmesh = jlaunch.parse_mesh(mesh), tlaunch.parse_mesh(mesh)
    jshapes, jmetas = j_param_shapes(j_get_config(arch), tp=jmesh.tp)
    jspec = j_build_spec_tree(jshapes, jmetas, jmesh)
    cfg = get_config(arch)
    shapes, metas = param_shapes(cfg, tp=tmesh.tp)
    spec = build_spec_tree(shapes, metas, tmesh)
    nrt = cfg.num_groups + 1
    for policy in POLICIES:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jplan = jlaunch.plan_from_args(_args(policy), nrt, jspec, jmesh)
        want = int(re.search(r"--chunks auto -> (\d+) \(roofline sweep, s_loc=(\d+)\)",
                             buf.getvalue()).group(1))
        rt = 1 if policy == "awp" else (4 if policy == "baseline" else int(policy[-1]))
        assert tlaunch.auto_chunks(spec, tmesh, rt, **J_HW)[0] == want == jplan.chunks, policy
        said = []
        plan = tlaunch.plan_from_args(_args(policy), nrt, spec, tmesh, say=said.append)
        got, s_loc = tlaunch.auto_chunks(spec, tmesh, rt)
        assert said == [f"--chunks auto -> {got} (roofline sweep, s_loc={s_loc})"]
        assert plan.chunks == got


# ---------------------------------------------------------------------------
# model_flops_estimate, param_shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_estimate_equals_reference(arch):
    assert sorted(ARCHS) == sorted(J_ARCHS) and sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for chips in (1, 256, 512):
            assert A.model_flops_estimate(cfg, shape, chips) == j_model_flops(
                jcfg, J_SHAPES[name], chips), (name, chips)


def _flat(tree, prefix=""):
    """``{jax keystr: leaf}`` of a port tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}['{key}']").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shapes_equal_reference_at_full_width(arch):
    """Every leaf's shape and dtype at full width and tp 1 and 16, on the
    ``meta`` device (nothing allocated)."""
    for tp in (1, 16):
        jp, _ = j_param_shapes(j_get_config(arch), tp=tp)
        want = {jax.tree_util.keystr(p): (tuple(x.shape), str(np.dtype(x.dtype)))
                for p, x in jax.tree_util.tree_leaves_with_path(jp)}
        tp_tree, _ = param_shapes(get_config(arch), tp=tp)
        got = _flat(tp_tree)
        assert all(x.device.type == "meta" for x in got.values())
        assert {k: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
                for k, x in got.items()} == want, tp


# ---------------------------------------------------------------------------
# dist.comm's records
# ---------------------------------------------------------------------------


def test_comm_records_under_the_recorder():
    """Every ``comm`` function as rank 2 of a fake world of 4: each record
    holds its payload's dtype and shape (what ``nbytes`` counts), the
    group's global ranks and an all-reduce's op; no call reads a fake
    tensor's storage (a warning is an error here), and the group is gone
    afterwards."""
    from repro_torch.audit.record import recording

    first = len(comm.LOG)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*data pointer.*")
        with recording(MeshCfg(dp=2, tp=2), rank=2) as rec:
            pair = rec.mesh.fsdp  # ranks 0 and 2
            x = torch.zeros(3, 5)
            comm.all_gather(x, pair, axis=1, traffic="weights")
            comm.all_to_all(torch.zeros(2, 6, dtype=torch.uint8), pair, axis=0,
                            traffic="relayout")
            comm.reduce_scatter(torch.zeros(8, 3), pair, axis=0, traffic="gradients")
            comm.all_reduce(torch.zeros(4, 2), rec.mesh.model, traffic="loss", op="max")
            comm.all_reduce(torch.zeros(()), None, traffic="metrics")
            comm.gather(torch.zeros(7, dtype=torch.int32), traffic="checkpoint")
            comm.scatter(None, torch.zeros(2, 2), traffic="checkpoint")
    assert not dist.is_initialized()
    got = [(r.kind, r.traffic, r.dtype, r.shape, r.group, r.op, r.nbytes, r.group_size)
           for r in rec.records]
    assert got == [
        ("all-gather", "weights", "float32", (3, 10), (0, 2), "", 120, 2),
        ("all-to-all", "relayout", "uint8", (2, 6), (0, 2), "", 12, 2),
        ("reduce-scatter", "gradients", "float32", (8, 3), (0, 2), "", 96, 2),
        ("all-reduce", "loss", "float32", (4, 2), (2, 3), "max", 32, 2),
        ("all-reduce", "metrics", "float32", (), (0, 1, 2, 3), "sum", 4, 4),
        ("gather", "checkpoint", "int32", (4, 7), (0, 1, 2, 3), "", 112, 4),
        ("scatter", "checkpoint", "float32", (4, 2, 2), (0, 1, 2, 3), "", 64, 4),
    ]
    assert all(math.prod(r.shape) * torch.empty((), dtype=getattr(torch, r.dtype))
               .element_size() == r.nbytes for r in rec.records)
    assert len(comm.LOG) == first  # the recording's calls left the global log


def test_recorder_tears_down_after_an_error():
    from repro_torch.audit.record import recording

    with pytest.raises(ZeroDivisionError):
        with recording(MeshCfg(tp=2)):
            assert dist.is_initialized()
            raise ZeroDivisionError
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="outside the mesh"):
        with recording(MeshCfg(tp=2), rank=2):
            pass
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# roofline/cost.py and roofline_from_run
# ---------------------------------------------------------------------------


def test_count_cost_of_a_matmul_and_a_step():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.audit.cases import build_case, make_plan
    from repro_torch.audit.record import recording
    from repro_torch.roofline.cost import count_bytes, count_cost, count_flops

    a, b = torch.ones(4, 8), torch.ones(8, 16)
    assert count_flops(torch.mm, a, b) == 2 * 4 * 8 * 16
    assert count_bytes(torch.mm, a, b) == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    assert count_bytes(lambda: a.view(32)) == 0  # a view moves nothing
    cfg = reduced(get_config("qwen3-1.7b"))
    mesh_cfg = MeshCfg(dp=2, tp=2)
    plan = make_plan("rt2", cfg.num_groups + 1)
    with recording(mesh_cfg) as rec:
        case = build_case("qwen3-1.7b", "train", mesh_cfg, plan, mesh=rec.mesh, cfg=cfg)
        with FlopCounterMode(display=False) as fc:
            case.step(*case.args)
        n = len(rec.records)
        cost = count_cost(case.step, *case.args)
        calls = rec.records[n:]
    assert cost.flops == fc.get_total_flops() > 0 and cost.bytes > 0
    shape = InputShape("audit", 32, 4, "train")
    geo = {"dist_elems_per_group": dist_elems_per_group(case.spec_tree, mesh_cfg,
                                                          cfg.num_groups + 1),
           "gather_axis_size": 2}
    rf = A.roofline_from_run(cost, calls, A.model_flops_estimate(cfg, shape, 4), plan=plan,
                             plan_geometry=geo)
    wire = sum(comm.wire_by_traffic(calls).values())
    assert rf.wire_bytes == wire and rf.collective_s == wire / A.LINK_BW
    assert rf.compute_s == cost.flops / A.PEAK_FLOPS_FP32
    assert rf.memory_s == cost.bytes / A.HBM_BW
    assert rf.dominant == "collective"  # gloo's rate against the card's
    split = rf.collectives["per_plan_entry"]
    table = plan.wire_table(geo["dist_elems_per_group"], 2)
    assert split["weights"] == table["weights"] and split["measured_wire"] == round(wire)
    # the packed-plane residue is the TP region's planes (and the loss's)
    planes = sum(comm.wire_by_traffic([c for c in calls if c.dtype == "uint8"]).values())
    assert split["plane_residue"] == round(planes - table["weights"] - table["gradients"])
