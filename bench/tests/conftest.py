"""Shared pieces of the benchmark's own tests (run from the repo root:
``python -m pytest bench/tests``). Cells are cut to CPU sizes here; the
cells as committed run only on the card."""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

MINI_CNN = {
    "layers": [["conv", 8, 3, 1], ["pool"], ["conv", 16, 3, 1], ["pool"],
               ["fc", 32], ["fc", 32]],
    "image_size": 16, "num_classes": 10, "compress_min_size": 256,
}
MINI_LM = {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 4,
    "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
    "vocab_size": 256, "compress_min_size": 256, "num_precision_groups": 2,
}


def shrink(cell):
    """The cell at a CPU size: the same kind, mix and limits."""
    if cell.doc["kind"] == "cnn":
        cell.doc.update(MINI_CNN)
        cell.mix["batch"]["cnn"]["images"] = 4
    else:
        cell.doc.update(MINI_LM)
        cell.mix["batch"]["lm"] = {"sequences": 2, "seq_len": 32}
    cell.mix["pool"] = 4
    return cell


def mini_cell(name: str, root=ROOT):
    return shrink(harness.load_cell(name, root))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
