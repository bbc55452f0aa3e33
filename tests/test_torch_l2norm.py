"""AWP monitor Σw²: the port's ``l2norm_sq`` against the JAX reference.

The reference's Pallas kernel ``l2norm_sq_2d`` runs in interpret mode
(what ``resolve_interpret`` picks off-TPU), its ``ops.l2norm_sq`` pads to
``(rows, 128)`` tiles of 512 rows first; the port's wrapper takes its plain
version ``ref.l2norm_sq_ref`` for CPU tensors and reads any length as it
is. Tolerance rtol 1e-5, the bar of ``tests/test_kernels.py``: fp32 sums
of up to 262,144 squares in another order. The CUDA kernel is held to the
same plain version on the card (marker ``cuda``; ``chip_smoke.py`` phase
10 at the main path's sizes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -m cuda tests/test_torch_l2norm.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.l2norm import l2norm_sq_2d
from repro_torch.kernels import ops, ref
from repro_torch.kernels.l2norm import l2norm_sq

RTOL = 1e-5
SHAPES_2D = [(512, 128), (2048, 128)]  # tests/test_kernels.py
# odd lengths, no tile multiple, several ranks
SHAPES = [(1,), (7,), (127,), (130,), (32_769,), (40_000,), (64, 33), (3, 5, 7),
          (2, 256, 129)]
SPECIAL_BITS = np.array(  # as tests/test_torch_kernels.py
    [
        0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000,
        0xFF800000, 0x00000001, 0x807FFFFF, 0x00400000, 0x7FC00000,
        0x7F800001, 0xFFFFFFFF, 0x7FBADBAD, 0x7F7FFFFF, 0xFF7FFFFF,
        0x3FFFFFFF, 0x00FFFFFF, 0xFFFF0000,
    ],
    dtype=np.uint32,
)


def _rand(shape, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_plain_version_matches_jax_kernel(shape):
    w = _rand(shape, seed=3, scale=0.1)
    want = float(l2norm_sq_2d(jnp.asarray(w), interpret=True))
    for got in (ref.l2norm_sq_ref(torch.from_numpy(w)), l2norm_sq(torch.from_numpy(w)),
                ops.l2norm_sq(torch.from_numpy(w), impl="ref")):
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ops_matches_jax_ops_on_any_shape(shape):
    w = _rand(shape, seed=sum(shape), scale=2.0)
    pallas = float(jops.l2norm_sq(jnp.asarray(w)))  # padded tiles, interpret mode
    plain = float(jops.l2norm_sq(jnp.asarray(w), impl="ref"))
    got = ops.l2norm_sq(torch.from_numpy(w))  # auto: the plain version on the CPU
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), pallas, rtol=RTOL)
    np.testing.assert_allclose(float(got), plain, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float16, np.float64])
def test_other_dtypes_are_summed_in_float32(dtype):
    w = _rand((33, 17), seed=5).astype(dtype)
    want = float(jops.l2norm_sq(jnp.asarray(w), impl="ref"))
    got = ops.l2norm_sq(torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL)


def test_non_contiguous_input():
    w = _rand((64, 96), seed=9)
    got = ops.l2norm_sq(torch.from_numpy(w).t())
    np.testing.assert_allclose(float(got), float(jref.l2norm_sq_ref(jnp.asarray(w))), rtol=RTOL)


@pytest.mark.parametrize("case", ["finite", "inf", "nan"])
def test_special_values_match_jax(case):
    special = SPECIAL_BITS.view(np.float32)
    with np.errstate(invalid="ignore"):
        keep = {"finite": np.isfinite(special) & (np.abs(special) < 1e18),
                "inf": ~np.isnan(special),
                "nan": np.ones(special.shape, bool)}[case]
    w = np.tile(special[keep], 5)
    want = float(jops.l2norm_sq(jnp.asarray(w)))
    got = float(ops.l2norm_sq(torch.from_numpy(w)))
    if case == "finite":
        np.testing.assert_allclose(got, want, rtol=RTOL)
    else:
        assert (np.isnan(got), got if case == "inf" else 0) == \
            (np.isnan(want), want if case == "inf" else 0)


def test_empty_tensor_sums_to_zero():
    assert float(ops.l2norm_sq(torch.zeros(0))) == 0.0
    assert float(jref.l2norm_sq_ref(jnp.zeros((0,), jnp.float32))) == 0.0


def test_impl_choices():
    w = torch.from_numpy(_rand((10,)))
    with pytest.raises(ValueError, match="cuda"):
        ops.l2norm_sq(w, impl="cuda")  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        ops.l2norm_sq(w, impl="pallas")
    with pytest.raises(ValueError, match="float32"):
        l2norm_sq(w.double())
    launches = l2norm_sq.launches
    l2norm_sq(w)
    assert l2norm_sq.launches == launches  # the plain version is no launch


# ---------------------------------------------------------------------------
# on the card (marker ``cuda``; skipped without one)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 127, 4096, 32_769, 1_000_003, 20_000_000])
def test_kernel_matches_plain_version_on_card(cuda_device, n):
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    base = torch.randn(n + 1, generator=gen, device=cuda_device)
    for w in (base[:n], base[1:]):  # the float4 path and the scalar path
        launches = l2norm_sq.launches
        got, again = l2norm_sq(w), ops.l2norm_sq(w)
        assert l2norm_sq.launches == launches + 2
        want = ref.l2norm_sq_ref(w)
        torch.cuda.synchronize()
        assert got.shape == () and got.device == w.device
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # deterministic
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    w = torch.randn(64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        l2norm_sq(w.t())
    with pytest.raises(ValueError, match="float32"):
        l2norm_sq(w.half())
    # ops makes both acceptable first
    np.testing.assert_allclose(float(ops.l2norm_sq(w.t())), float(ref.l2norm_sq_ref(w)),
                               rtol=RTOL)
    assert float(l2norm_sq(torch.zeros(0, device=cuda_device))) == 0.0
