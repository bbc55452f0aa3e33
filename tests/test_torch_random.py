"""repro_torch.random (threefry-2x32) bit-equal to jax.random."""
import jax
import numpy as np
import pytest

from repro_torch import random as tr

SEEDS = [0, 1, 42, 1000, 2**31 - 1, -5]
SHAPES = [(), (1,), (7,), (5, 7), (64, 32), (3, 4, 5)]


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tr.PRNGKey(seed)
    assert _key(jk) == tk
    for data in (0, 1, 7, 0xAD7, 2**32 - 1):
        assert _key(jax.random.fold_in(jk, data)) == tr.fold_in(tk, data)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_bernoulli(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tk = tr.fold_in(tr.PRNGKey(seed), 3)
    np.testing.assert_array_equal(
        tr.bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64),
    )
    np.testing.assert_array_equal(
        tr.uniform(tk, shape).numpy().view(np.uint32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.uint32),
    )
    for p in (0.5, 0.9):
        np.testing.assert_array_equal(
            tr.bernoulli(tk, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)),
        )


@pytest.mark.parametrize("step", [0, 3, 17])
def test_cumulative_dropout_fold_chain(step):
    """models/cnn.py re-folds the key cumulatively: key = fold_in(key, n)
    for each fc layer n (5, 6, 7 in AlexNet)."""
    jk = jax.random.PRNGKey(1000 + step)
    tk = tr.PRNGKey(1000 + step)
    for n in (5, 6, 7):
        jk = jax.random.fold_in(jk, n)
        tk = tr.fold_in(tk, n)
        assert _key(jk) == tk
        np.testing.assert_array_equal(
            tr.bernoulli(tk, 0.5, (8, 4096)).numpy(),
            np.asarray(jax.random.bernoulli(jk, 0.5, (8, 4096))),
        )


def test_seed_out_of_int32_range_raises():
    with pytest.raises(OverflowError):
        tr.PRNGKey(2**31)
