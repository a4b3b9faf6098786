"""The port's threefry2x32 (``pycatkin_tpu_torch.ops.prng``) against
``jax.random`` on the same seeds: keys, splits (the solver's chained
split at every attempt included) and float64 uniforms bitwise equal,
one key and a batch of lane keys (``jax.vmap``) alike."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu_torch.ops import prng

SEEDS = (0, 1, 17, 2**40 + 5)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def test_jax_runs_partitionable_threefry():
    """The configuration the port reproduces."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert jax.config.jax_threefry_partitionable
    assert np.asarray(_jkey(0)).dtype == np.uint32


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_match_jax(seed):
    k = prng.prng_key(seed)
    assert k.dtype == torch.int64
    assert np.array_equal(k.numpy(), np.asarray(_jkey(seed)))
    for num in (2, 3, 64, 4096):
        got = prng.split(k, num)
        assert got.shape == (num, 2)
        assert np.array_equal(got.numpy(),
                              np.asarray(jax.random.split(_jkey(seed), num)))


def test_split_rows_do_not_depend_on_the_count():
    """A rescue key depends on its lane's position in the failed list
    only, however far that list is padded."""
    k = prng.prng_key(17)
    assert torch.equal(prng.split(k, 4096)[:64], prng.split(k, 64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (21,), (32,), (5, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_uniform_matches_jax(seed, shape):
    got = prng.uniform(prng.prng_key(seed), shape)
    want = jax.random.uniform(_jkey(seed), shape, dtype=jnp.float64)
    assert got.dtype == torch.float64 and got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert bool(((got >= 0.0) & (got < 1.0)).all())


def test_chained_attempt_splits_match_jax():
    """``key, sub = split(key)`` at every attempt, then a uniform draw
    from ``sub``: the solver's restart sequence, five attempts deep."""
    jk, tk = _jkey(0), prng.prng_key(0)
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        pair = prng.split(tk)
        tk, tsub = pair[0], pair[1]
        assert np.array_equal(tk.numpy(), np.asarray(jk))
        assert np.array_equal(
            prng.uniform(tsub, (21,)).numpy(),
            np.asarray(jax.random.uniform(jsub, (21,), dtype=jnp.float64)))


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_batched_keys_match_vmap(seed):
    L = 48
    jkeys = jax.random.split(_jkey(seed), L)
    tkeys = prng.split(prng.prng_key(seed), L)
    want_split = jax.vmap(lambda k: jax.random.split(k))(jkeys)
    got_split = prng.split(tkeys)
    assert got_split.shape == (L, 2, 2)
    assert np.array_equal(got_split.numpy(), np.asarray(want_split))
    want_u = jax.vmap(lambda k: jax.random.uniform(
        k, (21,), dtype=jnp.float64))(jkeys)
    assert np.array_equal(prng.uniform(tkeys, (21,)).numpy(),
                          np.asarray(want_u))
