"""Host-side plan, policy and AWP controller: port == reference exactly."""
import json

import numpy as np
import pytest

from repro.core.awp import AWPConfig as JAWPConfig
from repro.core.awp import AWPController as JAWPController
from repro.core.awp import oracle_round_to as j_oracle
from repro.plan import PrecisionPlan as JPlan
from repro_torch.core.awp import AWPConfig, AWPController, oracle_round_to
from repro_torch.core.formats import TransferFormat, bits_to_bytes
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
    ]


@pytest.mark.parametrize("idx", range(4))
def test_plan_json_loads_across_packages(idx):
    tp, jp = _plans(PrecisionPlan)[idx], _plans(JPlan)[idx]
    assert tp.to_json() == jp.to_json()
    assert JPlan.from_json(tp.to_json()).to_json() == jp.to_json()
    assert PrecisionPlan.from_json(jp.to_json()) == tp
    assert tp.needs_rng == jp.needs_rng


@pytest.mark.parametrize("idx", range(4))
def test_wire_table_equal(idx):
    tp, jp = _plans(PrecisionPlan)[idx], _plans(JPlan)[idx]
    elems = [88_936_448 // 9 * (i + 1) for i in range(tp.num_weight_groups)]
    for rts in ([1] * tp.num_weight_groups, [2, 3] * 5):
        rts = rts[: tp.num_weight_groups]
        a = tp.with_round_tos(rts).wire_table(elems, 1)
        b = jp.with_round_tos(rts).wire_table(elems, 1)
        assert a == b
    with pytest.raises(NotImplementedError):
        tp.wire_table(elems, 2)


@pytest.mark.parametrize("kw", [
    dict(grad_round_to=2), dict(chunks=2), dict(seq_parallel=True),
    dict(accum_steps=2), dict(dtype="bf16"),
])
def test_unported_plan_fields_raise(kw):
    """A reference plan that sets a field the port has no code for is
    refused, not silently run at the default."""
    with pytest.raises(NotImplementedError):
        PrecisionPlan.from_json(JPlan.build(9, round_to=2, **kw).to_json())


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
