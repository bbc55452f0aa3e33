"""flash_prefill: the port's plain version, wrapper and dispatch against
the JAX package, and the CUDA kernel against its plain version on the
card (marker ``cuda``).

Inputs are numpy-seeded unit normals. Tolerance atol 2e-5 between the
packages, as the reference holds its kernel to dense softmax attention
(``tests/test_kernels.py``): the same online-softmax algebra, summed in
another order by XLA and PyTorch. On the card the kernel is held to its
plain version within 1e-5.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as j_flash
from repro.kernels.flash_prefill import flash_prefill_ref as j_flash_ref
from repro.models.attention import attend_tiled as j_attend_tiled
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.models import attention as ta

ATOL = 2e-5

# (B, H, Kv, Sq, Sk, hd, q_offset): the reference's kernel test shapes
# (q tile ending the kv sequence) and its q_offset case
FLASH_CASES = [
    (1, 2, 1, 256, 256, 128, 0),
    (2, 4, 2, 128, 384, 128, 256),
    (1, 2, 2, 128, 256, 128, 128),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(B, H, Kv, Sq, Sk, hd, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0, 1, s).astype(np.float32)
                 for s in ((B, H, Sq, hd), (B, Kv, Sk, hd), (B, Kv, Sk, hd)))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_version_matches_reference_kernel_and_oracle(case):
    *shape, off = case
    q, k, v = _qkv(*shape, seed=5)
    got = ref.flash_prefill_ref(*map(torch.from_numpy, (q, k, v)), q_offset=off).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kern = j_flash(jq, jk, jv, causal=True, q_offset=off, interpret=True)
    oracle = j_flash_ref(jq, jk, jv, causal=True, q_offset=off)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATOL, rtol=0)


def test_wrapper_on_a_cpu_tensor_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 128, 256, 128, seed=2))
    launches = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=128)
    want = ref.flash_prefill_ref(q, k, v, q_offset=128)
    assert torch.equal(got, want)
    assert flash_prefill.launches == launches  # no kernel ran


@pytest.mark.parametrize("causal,window,chunk,Sq,Sk,off", [
    (True, None, 16, 64, 64, 0),
    (True, None, 32, 32, 96, 64),    # continuation: q ends the kv sequence
    (False, None, 16, 32, 40, 0),    # short kv: padded to a chunk multiple
    (True, 24, 16, 64, 64, 0),       # windowed
    (True, None, 64, 64, 64, 0),     # one chunk
])
def test_attend_tiled_matches_reference(causal, window, chunk, Sq, Sk, off):
    rng = np.random.default_rng(Sq + Sk + chunk)
    B, Kv, G, hd = 2, 2, 3, 32
    q = rng.normal(0, 1, (B, Sq, Kv, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off, chunk=chunk)
    got = ta.attend_tiled(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    want = np.asarray(j_attend_tiled(*map(jnp.asarray, (q, k, v)), **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("G,off", [(2, 0), (4, 128)])
def test_plain_version_through_the_fold_matches_attend_tiled(G, off):
    """``_flash_prefill_call`` folds ``(B,S,Kv,G,hd)`` into ``(B, Kv*G, S,
    hd)`` with ``h = kv*G + g``; with G > 1 a wrong fold gives other heads."""
    rng = np.random.default_rng(G)
    B, S, Kv, hd = 2, 128, 2, 128
    Sk = S + off
    q = torch.from_numpy(rng.normal(0, 1, (B, S, Kv, G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (B, Sk, Kv, hd)).astype(np.float32))
    got = ta._flash_prefill_call(q, k, v, q_offset=off)
    want = ta.attend_tiled(q, k, v, causal=True, window=None, q_offset=off, chunk=128)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


def _fake(shape, device):
    return types.SimpleNamespace(shape=shape, device=torch.device(device))


@pytest.mark.parametrize("device,hd,Sq,Sk,window,pos,want", [
    ("cuda", 128, 256, 256, None, 0, True),
    ("cuda", 256, 128, 384, None, 0, True),
    ("cpu", 128, 256, 256, None, 0, False),      # the reference: not on its chip
    ("cuda", 64, 256, 256, None, 0, False),      # hd % 128
    ("cuda", 128, 200, 200, None, 0, False),     # untiled length
    ("cuda", 128, 256, 256, 64, 0, False),       # window
    ("cuda", 128, 256, 256, None, "per-slot", False),
])
def test_viability_rule(device, hd, Sq, Sk, window, pos, want):
    qg, k = _fake((1, Sq, 2, 2, hd), device), _fake((1, Sk, 2, hd), device)
    pos = torch.zeros(3, dtype=torch.int32) if pos == "per-slot" else pos
    assert ta._flash_prefill_viable(True, window, False, pos, qg, k) is want
    assert not ta._flash_prefill_viable(False, None, False, 0, qg, k)
    assert not ta._flash_prefill_viable(True, None, True, 0, qg, k)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


# (B, H, Kv, Sq, Sk, q_offset): qwen3's heads at chip_smoke's lengths, a
# continuation, batch 2, and untiled-by-128 lengths
CARD_CASES = [
    (1, 16, 8, 128, 128, 0),
    (1, 16, 8, 512, 512, 0),
    (1, 16, 8, 128, 512, 384),
    (2, 16, 8, 256, 256, 0),
    (1, 4, 4, 192, 320, 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_version_on_card(cuda_device, case):
    B, H, Kv, Sq, Sk, off = case
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(B, H, Kv, Sq, Sk, 128, seed=Sq))
    launches = flash_prefill.launches
    got = flash_prefill(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    assert flash_prefill.launches == launches + 1
    if Sq % 128 or Sk % 128:
        want = ref.flash_prefill_ref(q, k, v, q_offset=off, block_q=64, block_k=64)
    else:
        want = ref.flash_prefill_ref(q, k, v, q_offset=off)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = (torch.zeros(s, device=cuda_device) for s in
               ((1, 2, 128, 128), (1, 1, 128, 128), (1, 1, 128, 128)))
    launches = flash_prefill.launches
    with pytest.raises(ValueError):
        flash_prefill(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_prefill(q[..., :64].contiguous(), k[..., :64].contiguous(), v[..., :64].contiguous())
    with pytest.raises(ValueError):
        flash_prefill(q[:, :, :100], k, v)
    with pytest.raises(ValueError):
        flash_prefill(q.transpose(2, 3), k, v)
    # contiguous but 4 bytes off a float4 boundary
    flat = torch.zeros(q.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        flash_prefill(flat[1:].view(q.shape), k, v)
    assert flash_prefill.launches == launches
