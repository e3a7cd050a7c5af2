"""The port's threefry (`prng.py`) against `jax.random` under the suite's
pin of the legacy stream (`jax_threefry_partitionable=False`, conftest).

Keys, splits, random bits and uniforms are bitwise equal. `gumbel` takes
two logarithms, and XLA's and torch's float32 `log` differ by up to one
ulp each (held below); the composed draw is held to 2 ulp of max(|g|, 1),
since near g = 0 an ulp of the inner log moves g by far more of its own
ulps. `categorical` gives equal draws on the seeded cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_example_tpu_torch import prng

SEEDS = [0, 1, 42, 2 ** 31 - 1, 123456789]
EPS = float(np.finfo(np.float32).eps)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_legacy_stream_is_pinned():
    assert jax.config.jax_threefry_partitionable is False


@pytest.mark.parametrize("seed", SEEDS + [2 ** 33 + 5])
def test_keys_are_bitwise(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_is_bitwise(seed, num):
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num).numpy(),
                                  np.asarray(jax.random.split(jk, num)))
    # a batch of keys splits row by row, as vmap(split) in the reference
    keys = jax.random.split(jk, 4)
    np.testing.assert_array_equal(prng.split(torch.tensor(np.asarray(keys).astype(np.int64)),
                                             num).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(keys)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(7,), (3, 5), (64,), (2, 33)])
def test_bits_and_uniform_are_bitwise(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    ju = np.asarray(jax.random.uniform(jk, shape))
    tu = prng.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
    ju = np.asarray(jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(prng.uniform(tk, shape, -2.0, 3.0).numpy(), ju)


def test_logs_differ_by_at_most_one_ulp():
    u = prng.uniform(prng.PRNGKey(0), (100000,), minval=prng._F32_TINY).numpy()
    assert _ulps(np.asarray(jnp.log(u)), torch.log(torch.tensor(u)).numpy()).max() <= 1
    y = -torch.log(torch.tensor(u)).numpy()
    assert _ulps(np.asarray(jnp.log(y)), torch.log(torch.tensor(y)).numpy()).max() <= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp(seed):
    shape = (4, 1000)
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
    assert (np.abs(got - want) <= 2 * EPS * np.maximum(np.abs(want), 1.0)).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_draws_are_equal(seed):
    logits = np.random.default_rng(seed % 1000).normal(size=(6, 64)).astype(np.float32) * 2
    jk = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.categorical(prng.PRNGKey(seed), torch.tensor(logits)).numpy(),
                                  np.asarray(jax.random.categorical(jk, logits)))
    keys = jax.random.split(jk, 6)
    want = jax.vmap(lambda k, row: jax.random.categorical(k, row))(keys, logits)
    got = prng.categorical(torch.tensor(np.asarray(keys).astype(np.int64)), torch.tensor(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_rejects_mismatched_key_batches():
    with pytest.raises(ValueError, match="batch"):
        prng.categorical(torch.zeros(3, 2, dtype=torch.int64), torch.zeros(4, 8))
