"""The launcher twin of examples/awp_cnn_repro.py runs on the CPU when asked."""
import pytest
import torch

from repro_torch.launch import awp_cnn_repro


def test_launcher_runs_three_policies_on_cpu(capsys):
    results = awp_cnn_repro.main(
        ["--net", "alexnet", "--steps", "2", "--batch", "8", "--device", "cpu"]
    )
    assert set(results) == {"baseline", "oracle:2", "awp"}
    assert results["baseline"]["wire_reduction"] == 0.0
    assert results["oracle:2"]["wire_reduction"] == 0.5
    # AWP starts at 8 bits: a quarter of the fp32 bytes until it widens
    assert results["awp"]["wire_reduction"] == 0.75
    assert results["awp"]["bits_history"][0] == (0, (8,) * 9)
    for r in results.values():
        assert r["steps"] == 2 and len(r["curve"]) == 1 and len(r["losses"]) == 2
    assert "A2DTWP weight-motion reduction" in capsys.readouterr().out


def test_launcher_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        awp_cnn_repro.main(["--steps", "1"])
