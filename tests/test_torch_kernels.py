"""Port kernels vs the JAX reference: byte planes, unpack, rounding modes.

The JAX Bitpack/Bitunpack kernels run in interpret mode (what
``resolve_interpret`` picks off-TPU); the port's wrappers take their plain
PyTorch versions for CPU tensors. Planes and unpacked words must be
exactly equal. The CUDA kernels themselves are held against the same plain
versions on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.bitpack import bitpack_2d
from repro.kernels.bitunpack import bitunpack_2d
from repro.transport import CompressionPolicy as JPolicy
from repro.transport import transport as jT
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitpack import bitpack
from repro_torch.kernels.bitunpack import bitunpack
from repro_torch.transport import CompressionPolicy
from repro_torch.transport import transport as tT

SHAPES_2D = [(256, 128), (512, 128), (1024, 128)]  # tests/test_kernels.py
ROUND_TOS = [1, 2, 3, 4]
FLAT_SIZES = [1, 127, 32769]

# ±0, ±1, ±inf (tests/test_kernels.py), subnormals, NaN payloads, ±FLT_MAX
SPECIAL_BITS = np.array(
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


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("round_to", ROUND_TOS)
def test_bitpack_matches_jax_kernel(shape, round_to):
    w = _rand(shape, seed=round_to)
    want = np.asarray(bitpack_2d(jnp.asarray(w), round_to, interpret=True))
    np.testing.assert_array_equal(bitpack(_t(w), round_to).numpy(), want)
    np.testing.assert_array_equal(ref.bitpack_ref(_t(w), round_to).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES_2D)
@pytest.mark.parametrize("round_to", ROUND_TOS)
def test_bitunpack_matches_jax_kernel(shape, round_to):
    w = _rand(shape, seed=17 + round_to, scale=3.0)
    planes = np.asarray(jref.bitpack_ref(jnp.asarray(w), round_to))
    want = np.asarray(bitunpack_2d(jnp.asarray(planes), interpret=True))
    got = bitunpack(_t(planes)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", FLAT_SIZES)
@pytest.mark.parametrize("round_to", ROUND_TOS)
def test_odd_flat_sizes_match_jax_pallas_transport(n, round_to):
    """Exact-shape planes of any length, against the reference transport
    forced onto its Pallas path (pad to 256x128 tiles, slice back)."""
    w = _rand((n,), seed=n + round_to, scale=2.0)
    want = np.asarray(jT.pack_planes(jnp.asarray(w), round_to, impl="pallas"))
    got = tT.pack_planes(_t(w), round_to)
    assert got.shape == (round_to, n)
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(jT.unpack_planes(jnp.asarray(want), impl="pallas"))
    np.testing.assert_array_equal(_bits(tT.unpack_planes(got).numpy()), _bits(back))


@pytest.mark.parametrize("round_to", ROUND_TOS)
def test_special_values_bit_equal(round_to):
    w = SPECIAL_BITS.view(np.float32)
    want = np.asarray(jref.bitpack_ref(jnp.asarray(w), round_to))
    planes = bitpack(_t(w), round_to)
    np.testing.assert_array_equal(planes.numpy(), want)
    q_want = np.asarray(bitunpack_2d(
        jnp.asarray(np.pad(want, ((0, 0), (0, 256 * 128 - w.size)))).reshape(
            round_to, 256, 128
        ),
        interpret=True,
    )).reshape(-1)[: w.size]
    np.testing.assert_array_equal(_bits(bitunpack(planes).numpy()), _bits(q_want))
    # truncation is a mask on the word: low bytes zero, kept bytes intact
    mask = np.uint32((0xFFFFFFFF << (8 * (4 - round_to))) & 0xFFFFFFFF)
    np.testing.assert_array_equal(
        _bits(ref.quantize_ref(_t(w), round_to).numpy()), SPECIAL_BITS & mask
    )


@pytest.mark.parametrize("round_to", [1, 2, 3])
def test_nearest_mode_matches_jax(round_to):
    # random words plus the saturating edge (0xFFFFFFFF-ish NaN payloads)
    w = np.concatenate([_rand((4096,), seed=5, scale=7.0), SPECIAL_BITS.view(np.float32)])
    want = np.asarray(jref.quantize_ref(jnp.asarray(w), round_to, mode="nearest"))
    got = ref.quantize_ref(_t(w), round_to, mode="nearest").numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got_ops = ops.quantize(_t(w), round_to, mode="nearest").numpy()
    np.testing.assert_array_equal(_bits(got_ops), _bits(want))


def test_round_to_2_is_bfloat16_truncation():
    w = _rand((4096,), seed=9, scale=10.0)
    q = ops.quantize(_t(w), 2).numpy()
    np.testing.assert_array_equal(_bits(q), _bits(w) & np.uint32(0xFFFF0000))
    # and equal to bf16 round-toward-zero, widened back
    trunc = (_t(w).view(torch.int32) & ~0xFFFF).view(torch.float32)
    np.testing.assert_array_equal(_bits(q), _bits(trunc.to(torch.bfloat16).float().numpy()))


def test_round_to_4_is_identity():
    w = _t(_rand((1000,), seed=5))
    assert ops.quantize(w, 4) is w
    assert tT.quantize(w, CompressionPolicy(round_to=4)) is w


def test_quantize_matches_jax_and_is_straight_through():
    w = _rand((64, 33), seed=3)
    pol = CompressionPolicy(round_to=2)
    want = np.asarray(jT.quantize(jnp.asarray(w), JPolicy(round_to=2)))
    x = _t(w).requires_grad_(True)
    q = tT.quantize(x, pol)
    np.testing.assert_array_equal(_bits(q.detach().numpy()), _bits(want))
    g = torch.from_numpy(_rand((64, 33), seed=4))
    (q * g).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), g.numpy())


def test_dispatch_rules():
    cpu = torch.device("cpu")
    assert ops.resolve_impl("auto", "truncate", cpu) == "ref"
    assert ops.resolve_impl("ref", "truncate", cpu) == "ref"
    assert ops.resolve_impl("auto", "nearest", torch.device("cuda")) == "ref"
    assert ops.resolve_impl("auto", "truncate", torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError):
        ops.resolve_impl("cuda", "truncate", cpu)
    with pytest.raises(ValueError):
        tT.pack_planes(torch.zeros(4), 2, impl="cuda")
    with pytest.raises(ValueError):
        ops.resolve_impl("pallas", "truncate", cpu)


def test_cpu_wrappers_never_count_launches():
    before = (bitpack.launches, bitunpack.launches)
    bitunpack(bitpack(torch.ones(10), 2))
    assert (bitpack.launches, bitunpack.launches) == before


def test_stochastic_mode_not_ported():
    """Refused until ``repro_torch.random.randint`` was bit-exact; now the
    stochastic planes are the reference's byte for byte
    (``tests/test_torch_stochastic.py`` holds them over seeds and widths),
    and without a key the plain version refuses, as the reference's."""
    import jax
    from repro.kernels import ref as jref
    from repro_torch import random as tr

    w = np.random.default_rng(3).normal(size=(5, 33)).astype(np.float32)
    got = ref.bitpack_ref(torch.from_numpy(w), 2, mode="stochastic", key=tr.PRNGKey(4))
    want = jref.bitpack_ref(w, 2, mode="stochastic", key=jax.random.PRNGKey(4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="key"):
        ref.bitpack_ref(torch.ones(4), 2, mode="stochastic")


def test_bad_inputs_raise():
    with pytest.raises(ValueError):
        bitpack(torch.ones(4, dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        bitpack(torch.ones(4), 5)
    with pytest.raises(ValueError):
        bitunpack(torch.ones((2, 4), dtype=torch.int32))
