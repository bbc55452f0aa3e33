"""The port's CUDA kernels on the card (marker ``cuda``; skipped without one).

Run on a machine with an NVIDIA Hopper GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensor: planes byte-equal, unpack bit-equal.
"""
import pytest
import torch

pytestmark = pytest.mark.cuda

SIZES = [1, 2, 127, 4096, 32_769, 1_000_003]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("round_to", [1, 2, 3, 4])
def test_kernels_match_plain_versions(device, n, round_to):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    gen = torch.Generator(device=device).manual_seed(n)
    w = torch.randn(n, generator=gen, device=device) * 5.0
    launches = bitpack.launches
    planes = bitpack(w, round_to)
    assert bitpack.launches == launches + 1
    assert torch.equal(planes, ref.bitpack_ref(w, round_to))
    back = bitunpack(planes)
    torch.cuda.synchronize()
    assert torch.equal(back.view(torch.int32), ref.bitunpack_ref(planes).view(torch.int32))


def test_unaligned_view_takes_the_scalar_path(device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.bitpack import bitpack
    from repro_torch.kernels.bitunpack import bitunpack

    base = torch.randn(4100, device=device)
    w = base[1:4097]
    planes = bitpack(w, 3)
    assert torch.equal(planes, ref.bitpack_ref(w, 3))
    buf = torch.empty(3 * 4096 + 1, dtype=torch.uint8, device=device)
    shifted = buf[1:].view(3, 4096).copy_(planes)  # contiguous, 1 byte off
    out = bitunpack(shifted)
    assert torch.equal(out.view(torch.int32), ref.bitunpack_ref(planes).view(torch.int32))


def test_straight_through_quantize_on_card(device):
    from repro_torch.transport import CompressionPolicy
    from repro_torch.transport import transport as T

    w = torch.randn(300, 70, device=device, requires_grad=True)
    q = T.quantize(w, CompressionPolicy(round_to=1))
    q.sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
