"""The numbers that decide ``correct``: the program's readings of its first
training steps against the plain reference's, each number beside its
limit. A cell's limits file (``bench/limits/<cell>.json``) names the
numbers it compares.

- ``loss``: the largest relative gap of a step's loss; ``loss1`` the
  first step's.
- ``grad1``: the first step's gradient, leaf by leaf: the gap between the
  two norms over the reference's norm of that leaf or of the median leaf,
  whichever is larger; the worst leaf.
- ``update3``: the same of each leaf's change over the checked steps,
  leaving out the leaves whose reference gradient is under a thousandth
  of the median leaf's (they move by round-off alone).
- ``monitor``: the largest relative gap of a group's sum of squares after
  a step's update.

A number that is not finite, or a leaf that one side lacks, fails.
"""
from __future__ import annotations

import math
import statistics

STILL = 1e-3  # a leaf whose gradient is under this share of the median's


def _worst(gaps) -> float:
    """The largest gap; inf where any is not finite (NaN never wins a max)."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(x) for x in gaps) else math.inf


def _leaf_gaps(prog: dict, ref: dict, keep) -> list[float]:
    if set(prog) != set(ref):
        return [math.inf]
    names = [k for k in ref if keep(k)]
    med = statistics.median(ref[k] for k in names)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in names]


def numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``{number: value}`` of two sets of readings (``reference.common``)."""
    g = ref["grad1"]
    still = STILL * statistics.median(g.values())
    loss = _worst(abs(p - r) / abs(r)
                  for p, r in zip(prog["losses"], ref["losses"], strict=True))
    monitor = _worst(abs(p - r) / abs(r)
                     for ps, rs in zip(prog["monitor"], ref["monitor"], strict=True)
                     for p, r in zip(ps, rs, strict=True))
    return {
        "loss": loss,
        "loss1": _worst([abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])]),
        "grad1": _worst(_leaf_gaps(prog["grad1"], g, lambda k: True)),
        "update3": _worst(_leaf_gaps(prog["update3"], ref["update3"],
                                     lambda k: g.get(k, 0.0) >= still)),
        "monitor": monitor,
    }


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {number: {"value", "limit"}})`` over the numbers that
    ``limits`` names."""
    if not limits:
        raise ValueError("a cell's limits name no number")
    check = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in check.values())
    return ok, check
