"""Host-side plan, policy and AWP controller: port == reference exactly."""
import json

import numpy as np
import pytest
import torch

from repro.core.awp import AWPConfig as JAWPConfig
from repro.core.awp import AWPController as JAWPController
from repro.core.awp import oracle_round_to as j_oracle
from repro.plan import PrecisionPlan as JPlan
from repro_torch.core.awp import AWPConfig, AWPController, oracle_round_to
from repro_torch.core.formats import TransferFormat, bits_to_bytes
from repro_torch.dist.spec import MeshCfg
from repro_torch.plan import PrecisionPlan
from repro_torch.transport import CompressionPolicy


def _norm_sequence(num_groups, steps, seed):
    """Σw² trajectories that mostly shrink, with noise and plateaus."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1.0, 10.0, num_groups)
    rates = rng.normal(-3e-3, 4e-3, (steps, num_groups))
    rates[rng.random((steps, num_groups)) < 0.2] = 0.0
    norms = base * np.cumprod(1.0 + rates, axis=0)
    return norms ** 2


@pytest.mark.parametrize(
    "threshold, interval, initial_bits",
    [(-2e-3, 3, 8), (-1e-3, 1, 8), (1e-3, 2, 16), (-5e-3, 5, 8)],
)
def test_awp_controller_same_state_and_history(threshold, interval, initial_bits):
    seq = _norm_sequence(6, 80, seed=interval)
    j = JAWPController(6, JAWPConfig(threshold, interval, initial_bits=initial_bits))
    t = AWPController(6, AWPConfig(threshold, interval, initial_bits=initial_bits))
    for norms_sq in seq:
        assert j.update(norms_sq) == t.update(norms_sq)
    assert j.history == t.history
    np.testing.assert_array_equal(j.state.bits, t.state.bits)
    np.testing.assert_array_equal(j.state.counters, t.state.counters)
    np.testing.assert_array_equal(j.state.prev_norms, t.state.prev_norms)
    assert j.state.step == t.state.step
    assert j.bytes_saved_fraction() == t.bytes_saved_fraction()


def test_formats_and_oracle():
    assert [bits_to_bytes(b) for b in (1, 8, 9, 16, 24, 31, 40)] == [1, 1, 2, 2, 3, 4, 4]
    assert TransferFormat(2).name == "bf16"
    assert oracle_round_to(9, 2) == j_oracle(9, 2)


def _plans(mod):
    build = mod.build
    return [
        build(9, round_to=2),
        build(9, round_to=1, schedule="awp", awp_threshold=-1e-3, awp_interval=7),
        build(4, round_to=3, act_round_to=2),
        mod(weights=({"round_to": 1}, {"round_to": 4, "mode": "nearest"})),
        build(9, round_to=2, grad_round_to=2),
        build(9, round_to=1, grad_round_to=3, grad_mode="truncate", chunks=2),
    ]


@pytest.mark.parametrize("idx", range(6))
def test_plan_json_loads_across_packages(idx):
    tp, jp = _plans(PrecisionPlan)[idx], _plans(JPlan)[idx]
    assert tp.to_json() == jp.to_json()
    assert JPlan.from_json(tp.to_json()).to_json() == jp.to_json()
    assert PrecisionPlan.from_json(jp.to_json()) == tp
    assert tp.needs_rng == jp.needs_rng


@pytest.mark.parametrize("idx", range(6))
def test_wire_table_equal(idx):
    """The host→device table (one device) and the sharded all-gather /
    reduce-scatter table (2, 4 and 8 shards; training and not) equal the
    reference's."""
    tp, jp = _plans(PrecisionPlan)[idx], _plans(JPlan)[idx]
    elems = [88_936_448 // 9 * (i + 1) for i in range(tp.num_weight_groups)]
    for rts in ([1] * tp.num_weight_groups, [2, 3] * 5):
        rts = rts[: tp.num_weight_groups]
        for n in (1, 2, 4, 8):
            for training in (True, False):
                a = tp.with_round_tos(rts).wire_table(elems, n, training=training)
                b = jp.with_round_tos(rts).wire_table(elems, n, training=training)
                assert a == b, (n, training)


PORTED_FIELDS = (dict(accum_steps=2), dict(dtype="bf16"))


@pytest.mark.parametrize("kw", [
    dict(kv_migration={"round_to": 2}), dict(env_overrides={"mlstm_chunk": 64}),
    dict(weight_publish={"round_to": 1}), *PORTED_FIELDS,
])
def test_unported_plan_fields_raise(kw):
    """A reference plan that sets a field the port has no code for is
    refused, not silently run at the default (``mlstm_chunk``: an env
    override of the unported xLSTM family; ``kv_migration`` and
    ``weight_publish``: the fleet's). ``int8_kv`` and ``sampling``, once
    refused here, load (``tests/test_torch_sampling.py``); so do
    ``accum_steps`` and ``dtype`` since the train step runs them: their
    cases hold the loaded plan's JSON to the reference's, byte for byte,
    and the compute dtype it gives."""
    d = JPlan.build(9, round_to=2).to_json_dict()
    d.update(kw)
    text = JPlan.from_json_dict(d).to_json()
    if kw in PORTED_FIELDS:
        t = PrecisionPlan.from_json(text)
        assert t.to_json() == text
        assert (t.accum_steps, t.compute_dtype) == (
            kw.get("accum_steps", 1), torch.bfloat16 if "dtype" in kw else torch.float32)
        return
    with pytest.raises(NotImplementedError):
        PrecisionPlan.from_json(text)


@pytest.mark.parametrize("kw", [
    dict(seq_parallel=True), dict(env_overrides={"attn_chunk": 64, "causal_skip": False}),
    dict(act_round_to=2, seq_parallel=True),
], ids=["seq_parallel", "env_overrides", "act-seq"])
def test_layout_plan_fields_load_and_save_as_the_reference(kw):
    """The layout fields the FSDP×TP slice ported (``seq_parallel``,
    ``env_overrides``, and ``seq_boundary`` beside ``activations``) load
    from the reference's JSON and save to it, and reach the ``Env``."""
    j = JPlan.build(9, round_to=2, **kw)
    d = j.to_json_dict()
    d["seq_boundary"] = {"round_to": 3, "grad_round_to": 3, "mode": "nearest",
                         "grad_mode": "nearest", "impl": "auto", "chunks": 1}
    t = PrecisionPlan.from_json_dict(d)
    assert t.to_json_dict() == JPlan.from_json_dict(d).to_json_dict()
    env = t.make_env(MeshCfg())
    assert (env.seq_parallel, env.seq_policy.round_to) == (j.seq_parallel, 3)
    assert env.attn_chunk == dict(j.env_overrides).get("attn_chunk", 1024)


def test_alexnet_wire_bytes_at_each_width():
    """One AlexNet step moves its 88,936,448 DIST elements at round_to bytes."""
    plan = PrecisionPlan.build(9, round_to=1)
    elems = [0, 307200, 663552, 1327104, 884736, 51380224, 16777216, 16777216, 819200]
    assert sum(elems) == 88_936_448
    for rt in (1, 2, 3, 4):
        assert plan.with_round_tos((rt,) * 9).wire_table(elems, 1)["total"] == 88_936_448 * rt


def test_policy_validation():
    with pytest.raises(ValueError):
        CompressionPolicy(impl="pallas")
    with pytest.raises(ValueError):
        CompressionPolicy(round_to=5)
    assert CompressionPolicy(impl="cuda").impl == "cuda"
