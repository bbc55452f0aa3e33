"""The benchmark's frozen FLOP counts held against the port's own
counters at the cells' shapes: ``roofline.cost.count_flops`` over a real
VGG-A step on the CPU (one image; the count is linear in the batch), and
``model_flops_estimate`` and ``count_flops`` on fake tensors for
qwen3-1.7b at 2 x 2048."""
from __future__ import annotations

import json

import pytest

from bench import inputs, yardstick
from conftest import ROOT


def _doc(name):
    return json.loads((ROOT / f"bench/configs/{name}.json").read_text())


def test_vgg_a_forward_flops_per_image():
    fwd = yardstick.cnn_forward_flops(_doc("vgg-a"))
    assert len(fwd) == 11
    assert sum(fwd) == pytest.approx(15.23e9, rel=2e-3)  # 7.6 G multiply-adds


def test_vgg_a_step_flops_against_count_flops():
    import torch

    from repro_torch.roofline.cost import count_flops

    doc = _doc("vgg-a")
    mix = json.loads((ROOT / "bench/traffic/adt16.json").read_text())
    mix["batch"]["cnn"]["images"], mix["pool"] = 1, 1
    kind = __import__("bench.kinds.cnn", fromlist=["Program"])
    prog = kind.Program(doc, mix, 3, "cpu")
    torch.set_num_threads(8)
    counted = count_flops(prog.step, 0)
    assert yardstick.cnn_step_flops(doc, 1) == pytest.approx(counted, rel=1e-3)


def test_qwen3_step_flops_against_the_ports_counts():
    from repro_torch.audit.cases import build_case
    from repro_torch.audit.record import recording
    from repro_torch.configs.base import InputShape
    from repro_torch.dist.spec import MeshCfg
    from repro_torch.plan import PrecisionPlan
    from repro_torch.roofline.analysis import model_flops_estimate
    from repro_torch.roofline.cost import count_flops

    from bench.kinds import lm

    doc = _doc("qwen3-1.7b")
    cfg = lm.model_config(doc)
    ours = yardstick.lm_step_flops(doc, 2 * 2048)
    assert ours == model_flops_estimate(cfg, InputShape("cell", 2048, 2, "train"), 1)
    assert yardstick.lm_params(doc) == cfg.active_params() == 1_720_451_072
    plan = PrecisionPlan.build(cfg.num_groups + 1, round_to=2)
    with recording(MeshCfg()) as rec:
        case = build_case(cfg.name, "train", MeshCfg(), plan, mesh=rec.mesh, cfg=cfg,
                          seq_len=2048, global_batch=2)
        counted = count_flops(case.step, *case.args)
    # count_flops adds attention's products and the recomputed forward
    assert 1.0 < counted / ours < 1.5


def test_transport_bytes():
    vgg, qwen = _doc("vgg-a"), _doc("qwen3-1.7b")
    assert yardstick.cnn_dist_elems(vgg) == sum(
        n for n in (s[2][0] * s[2][1] * (s[2][2] * s[2][3] if len(s[2]) == 4 else 1)
                    for s in inputs.cnn_layers(vgg)) if n >= 65536)
    assert yardstick.transport_bytes(10, 2) == 10 * 12
    assert yardstick.transport_bytes(10, 4) == 0
    assert yardstick.lm_dist_elems(qwen) == yardstick.lm_params(qwen)
