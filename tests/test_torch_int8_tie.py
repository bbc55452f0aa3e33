"""The int8 tie rule of ``chip_smoke.py`` phase 15 (e), on the CPU.

Phase 15 (e) holds the 1×2 sampled int8-KV engine to the 1×2 static run.
The static run prefills the two 512-token prompts as a batch of 2 and the
engine each alone, so on the card every K and V differs by ulps (cuBLAS's
row bits depend on the row count) and a code whose ``x / scale`` sits on a
rounding midpoint moves by a whole step. ``tools/int8_probe.py`` printed
the parting on an H100 at 4 layers: request 0 at token 6, 179 / 223
flipped codes on ranks 0 / 1, each within 8.4e-3 / 1.37e-2 code steps of
a midpoint, and the draw 1.405e-4 (static) and 1.445e-4 (engine) of
``cw[-1]`` from its nearest CDF step. ``int8_tie`` admits a parting only
within those margins (``INT8_TIE_MIDPOINT`` 1.4e-2, ``INT8_TIE_DRAW``
1.5e-4).

Here: the rule's arithmetic at the printed margins (admitted) and just
past them (refused); the mechanism, a one-ulp move of a value at a
midpoint flipping its int8 code; ``draw_distance`` at a constructed row
whose nearest CDF step is a known share of ``cw[-1]`` from the draw; and
``int8_probe_report`` on recorded quantizations with one code flipped by
hand.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from repro_torch.models.attention import _quantize_kv  # noqa: E402
from repro_torch.plan import SamplingParams  # noqa: E402
from repro_torch.serve.sampling import uniform_for  # noqa: E402

# the parting tools/int8_probe.py printed (rank 0's margins; both ranks' gaps)
PRINTED = {"diverged": (0, 6), "static_margin": (0.1132226, 474890.0, 1.405040e-4),
           "engine_margin": (0.1129413, 473710.0, 1.444608e-4),
           "mid_gaps": [8.381e-3, 1.3728e-2]}


def _case(**kw):
    return {**PRINTED, **kw}


def test_rule_admits_the_printed_parting():
    assert c.INT8_TIE_MIDPOINT == 1.4e-2 and c.INT8_TIE_DRAW == 1.5e-4
    assert c.int8_tie(PRINTED)
    assert c.int8_tie(_case(mid_gaps=[8.381e-3, None]))  # a flip on one rank only


@pytest.mark.parametrize("change", [
    {"static_margin": (0.11, 474890.0, 1.51e-4)},   # a draw past the margin
    {"engine_margin": (0.11, 473710.0, 2e-3)},
    {"mid_gaps": [8.381e-3, 1.41e-2]},             # a flip off a midpoint
    {"mid_gaps": [0.3, 1.3728e-2]},
    {"mid_gaps": [None, None]},                    # a parting with no int8 flip
])
def test_rule_refuses_past_the_margins(change):
    assert not c.int8_tie(_case(**change))


def test_midpoint_gap_of_printed_flips():
    """Printed flips (``x / scale`` in each run) lie within the bound; a
    value a code step away from its midpoint does not."""
    for ya, yb in ((37.4999504, 37.5), (4.5000043, 4.499999), (-62.4999924, -62.5000114),
                   (9.5002251, 9.4999571), (-1.5001575, -1.4999908)):
        assert min(c.midpoint_gap(ya), c.midpoint_gap(yb)) <= c.INT8_TIE_MIDPOINT
    assert c.midpoint_gap(37.3) == pytest.approx(0.2)
    assert c.midpoint_gap(-12.0) == pytest.approx(0.5)


def test_one_ulp_at_a_midpoint_flips_a_code():
    """The reference's quantizer (``_quantize_kv``): a value at x / scale =
    37.5 rounds half to even (38), one ulp below it rounds to 37; the scale
    (the row's amax / 127) is the same in both."""
    row = np.zeros(128, np.float32)
    row[0] = 127.0
    row[1] = 37.5
    q, s = _quantize_kv(torch.from_numpy(row))
    assert float(s) == 1.0 and int(q[1]) == 38
    row[1] = np.nextafter(np.float32(37.5), np.float32(0))
    q2, s2 = _quantize_kv(torch.from_numpy(row))
    assert float(s2) == 1.0 and int(q2[1]) == 37


def test_draw_distance_at_the_printed_margin():
    """A row whose CDF step lies 1.405e-4 of cw[-1] from the draw: two ids
    at probabilities u ± 1.405e-4 around it (the rest of the mass far
    away); ``draw_distance`` reads the margin back."""
    seed, step, vocab = 100, 6, 8
    u = float(uniform_for([seed], [step])[0])
    s = SamplingParams(temperature=1.0, top_p=1.0, top_k=0, seed=seed)
    p0 = u + 1.405e-4
    probs = np.full(vocab, (1 - p0) / (vocab - 1))
    probs[0] = p0
    logits = torch.from_numpy(np.log(probs).astype(np.float32))
    d = c.draw_distance(torch, logits, vocab, s, step)
    assert d == pytest.approx(1.405e-4, rel=2e-3)
    assert d <= c.INT8_TIE_DRAW


def test_probe_report_finds_a_flipped_code():
    """``int8_probe_report`` on two recorded runs of one request (a prefill
    of 4 tokens and a decode step at 1 layer): equal records give no
    parting; with the engine's stream parting at token 1 and one code of
    the prefill's K flipped at a midpoint, the report counts that flip,
    its gap to the midpoint and the margins of both runs' rows."""
    rng = np.random.default_rng(0)
    S, Kv, hd, vocab = 4, 2, 8, 16
    x = torch.from_numpy(rng.normal(0, 1, (1, S, Kv, hd)).astype(np.float32))
    xd = torch.from_numpy(rng.normal(0, 1, (1, Kv, hd)).astype(np.float32))
    req = c.sampled_requests([type("R", (), {"rid": 0, "prompt_ids": (1, 2, 3, 4),
                                             "max_new": 3})()])[0]

    v = torch.from_numpy(rng.normal(0, 1, (1, S, Kv, hd)).astype(np.float32))

    def record(x):  # K then V of one layer; a tag object a forward
        tag_p, tag_d = ("prefill", (0,), S), ("decode", {0: (0, S)})
        return [(tag_p, x, *_quantize_kv(x)), (tag_p, v, *_quantize_kv(v)),
                (tag_d, xd, *_quantize_kv(xd)), (tag_d, xd, *_quantize_kv(xd))]

    probes = {"static": record(x), "engine": record(x)}
    key = (req.sampling.seed & 0xFFFFFFFF,)
    rows = {label: {key + (i,): rng.normal(0, 1, vocab).astype(np.float32) for i in range(3)}
            for label in ("static", "engine")}
    rows["engine"] = {k: v.copy() for k, v in rows["static"].items()}
    streams = {"static": {0: [5, 6, 7]}, "engine": {0: [5, 6, 7]}}
    assert c.int8_probe_report(torch, type("C", (), {"vocab_size": vocab})(), [req], 1,
                               streams, probes, rows)["cases"] == []
    # flip one K code of position 2 by moving its value onto the other side of .5
    xe = x.clone()
    _, sc = _quantize_kv(x)
    xe[0, 2, 1, 3] = (np.floor(float(x[0, 2, 1, 3] / sc[0, 2, 1])) + 0.5001) * sc[0, 2, 1]
    xs = x.clone()
    xs[0, 2, 1, 3] = (np.floor(float(x[0, 2, 1, 3] / sc[0, 2, 1])) + 0.4999) * sc[0, 2, 1]
    probes = {"static": record(xs), "engine": record(xe)}
    streams["engine"] = {0: [5, 9, 7]}
    rep = c.int8_probe_report(torch, type("C", (), {"vocab_size": vocab})(), [req], 1,
                              streams, probes, rows)
    (case,) = rep["cases"]
    assert case["diverged"] == (0, 1) and case["flips"] == 1
    assert case["mid_gap"] < 2e-4
    assert case["static_margin"] == case["engine_margin"]
    assert any("1 int8 codes" in line for line in rep["lines"])
