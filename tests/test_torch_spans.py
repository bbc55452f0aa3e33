"""The port's trace spans and its transfer counter (``repro_torch.utils.spans``)
on CPU train steps of a mini AlexNet and of reduced qwen3-1.7b.

Off (the default), ``span`` hands back one shared no-op context and the
profiler sees none of the spans. On, one ``Trainer.run_step`` records
every span once at its place in the step, each nested as the module's
table says (innermost enclosing span by time; on the CPU autograd runs
on the caller's thread), and ``transport.bytes`` counts each ``DIST``
element's pack and unpack: ``2 × (4 + round_to)`` bytes, the group
leaves twice under ``remat`` (the recomputed forward packs them again);
``attention.tiled_train`` counts the LM's attention calls (every layer,
twice under ``remat``; on the CPU none takes the flash route).
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import random as jr
from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import synthetic_lm_batch
from repro_torch.dist.spec import MeshCfg, build_spec_tree, dist_elems_per_group
from repro_torch.models import cnn as tc
from repro_torch.models.init import init_params
from repro_torch.optim.sgd import SGDConfig, init_momentum
from repro_torch.plan import PrecisionPlan
from repro_torch.train.cnn_step import build_cnn_spec_tree, cnn_dist_elems, make_cnn_train_step
from repro_torch.train.loop import Trainer
from repro_torch.train.step import make_train_step
from repro_torch.utils import spans

B, S = 2, 16
CASES = ["cnn", "lm", "lm-remat"]
# span -> the span it runs inside (None: the root)
PARENTS = {
    "train.step": {None},
    "train.loss_sync": {"train.step"},
    "train.forward": {"train.step"},
    "model.loss": {"train.forward"},
    "train.backward": {"train.step"},
    "optim.sgd": {"train.step"},
    "awp.monitor": {"train.step"},
}
# the CNN step materialises every layer before its forward; the LM inside
# it, and again in the backward's recomputed forward under remat
MATERIALIZE_PARENTS = {"cnn": {"train.step"}, "lm": {"train.forward"},
                       "lm-remat": {"train.forward", "train.backward"}}


@pytest.fixture(autouse=True)
def _fresh_counters():
    spans.reset()
    yield
    spans.reset()


def _cnn_job(round_to):
    cfg = tc.reduced_cnn(tc.ALEXNET)
    params, metas, groups_info = tc.init_cnn(cfg, 0, device="cpu")
    mesh_cfg = MeshCfg(compress_min_size=256)
    spec_tree = build_cnn_spec_tree(params, metas, mesh_cfg)
    num_groups = groups_info[1]
    plan = PrecisionPlan.build(num_groups, round_to=round_to)
    trainer = Trainer(lambda rts: make_cnn_train_step(
        cfg, mesh_cfg, spec_tree, groups_info, SGDConfig(), plan=plan.with_round_tos(rts)),
        num_groups, plan=plan)
    gen = torch.Generator().manual_seed(0)
    batch = {"images": torch.randn(B, cfg.in_hw, cfg.in_hw, 3, generator=gen),
             "labels": torch.randint(0, cfg.num_classes, (B,), generator=gen)}
    state = [params, init_momentum(params)]
    elems = cnn_dist_elems(spec_tree, groups_info, mesh_cfg)

    def step():
        state[:] = trainer.run_step(*state, batch, 0.01, jr.PRNGKey(0))[:2]

    return step, sum(elems)


def _lm_job(round_to, remat):
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")), remat=remat)
    params, metas = init_params(cfg, 0, "cpu")
    mesh_cfg = MeshCfg()
    spec_tree = build_spec_tree(params, metas, mesh_cfg)
    nrt = cfg.num_groups + 1
    plan = PrecisionPlan.build(nrt, round_to=round_to)
    shapes = {"tokens": (B, S), "labels": (B, S)}
    trainer = Trainer(lambda rts: make_train_step(
        cfg, mesh_cfg, None, spec_tree, SGDConfig(), shapes, plan=plan.with_round_tos(rts)),
        nrt, plan=plan)
    tokens, labels = synthetic_lm_batch(cfg.vocab_size, B, S, 0, device="cpu")
    batch = {"tokens": tokens, "labels": labels}
    state = [params, init_momentum(params)]
    elems = dist_elems_per_group(spec_tree, mesh_cfg, nrt)
    # the group leaves are packed again in the remat forward; the
    # top-level ones (embedding, head) only in the forward
    packed = (2 if remat else 1) * sum(elems[:-1]) + elems[-1]

    def step():
        state[:] = trainer.run_step(*state, batch, 0.01)[:2]

    step.attention_calls = (2 if remat else 1) * cfg.num_layers
    return step, packed


def _job(case, round_to=2):
    if case == "cnn":
        return _cnn_job(round_to)
    return _lm_job(round_to, remat=case == "lm-remat")


def _profiled_spans(step):
    """``[(name, start, end)]`` of the profiler's events named in SPANS."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name in spans.SPANS]


def _parent(ev, evs):
    """The innermost other span whose interval holds ``ev``'s."""
    holders = [f for f in evs if f is not ev and f[1] <= ev[1] and ev[2] <= f[2]]
    return max(holders, key=lambda f: (f[1], -f[2]))[0] if holders else None


def test_off_span_is_one_shared_object_and_nothing_is_recorded():
    step, _ = _job("cnn")
    assert len({id(spans.span(n)) for n in spans.SPANS}) == 1
    assert _profiled_spans(step) == []
    assert spans.counters() == {}


@pytest.mark.parametrize("case", CASES)
def test_spans_nest_where_the_step_places_them(case):
    step, _ = _job(case)
    step()  # the first step at these formats builds the step function
    with spans.enabled():
        evs = _profiled_spans(step)
    want = dict(PARENTS, **{"transport.materialize": MATERIALIZE_PARENTS[case]})
    got: dict = {}
    for ev in evs:
        got.setdefault(ev[0], set()).add(_parent(ev, evs))
    assert got == want
    for name in ("train.step", "train.loss_sync", "train.forward", "model.loss",
                 "train.backward", "optim.sgd", "awp.monitor"):
        assert sum(ev[0] == name for ev in evs) == 1, name


@pytest.mark.parametrize("case,round_to", [("cnn", 2), ("cnn", 3), ("lm", 1), ("lm", 2),
                                           ("lm-remat", 2)])
def test_transport_bytes_counts_every_pack_and_unpack(case, round_to):
    step, packed = _job(case, round_to)
    step()
    assert spans.counters() == {}
    with spans.enabled():
        step()
    want = {"transport.bytes": packed * 2 * (4 + round_to)}
    if case != "cnn":
        want["attention.tiled_train"] = step.attention_calls
    assert spans.counters() == want


def test_the_32_bit_baseline_counts_no_transfer_bytes():
    step, _ = _job("cnn", round_to=4)
    with spans.enabled():
        step()
    assert spans.counters() == {}


def test_enabled_restores_the_previous_state():
    off = spans.span("train.step")
    with spans.enabled():
        assert spans.span("train.step") is not off
        with spans.enabled(False):
            assert spans.span("train.step") is off
            spans.add("transport.bytes", 5)
        spans.add("transport.bytes", 7)
        with pytest.raises(RuntimeError):
            with spans.enabled(False):
                raise RuntimeError
        assert spans.span("train.step") is not off
        with pytest.raises(ValueError):
            spans.span("no.such.span")
        with pytest.raises(ValueError):
            spans.add("no.such.counter", 1)
    assert spans.span("train.step") is off
    spans.add("transport.bytes", 11)
    assert spans.counters() == {"transport.bytes": 7}
    spans.reset()
    assert spans.counters() == {}
