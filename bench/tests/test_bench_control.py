"""On the card, at each cell's own size: the control (the reference with
TF32 on, in the program's place) comes out not correct under the cell's
limits, and the program comes out correct. Skips without a card.

    python -m pytest bench/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest

from bench import compare, harness, readings

CELLS = ["vgg-a.adt16", "vgg-a.fp32", "qwen3-1.7b.adt16"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, cuda_device):
    from repro_torch.kernels.build import library

    library()
    cell = harness.load_cell(name)
    control = readings.reading(cell, 3_000_000_101, "control", cuda_device)
    program = readings.reading(cell, 3_000_000_102, "program", cuda_device)
    assert not compare.judge(control["numbers"], cell.limits)[0], control["numbers"]
    assert compare.judge(program["numbers"], cell.limits)[0], program["numbers"]
