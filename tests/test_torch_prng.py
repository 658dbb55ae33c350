"""utils/prng.py against `jax.random` on the CPU, bit for bit: keys from
seeds (negative seeds and seeds of 2**32 and above included), `split`,
`bits` and `uniform`, and `jax.random.choice` with the RANSAC
probabilities of modular_slam_tpu/ops/pnp.py:209-215 over masks of 1 to
2048 rows with none, one, two or a random count of valid rows; a batched
draw equals its per-row draws and JAX's `vmap`; the float32 sum and
prefix sum of the mapping follow XLA:CPU's order; and the PRNG flags the
tests run under are the ones the module implements.

Examples are drawn by hypothesis, derandomized (the same examples every
run) and with no example database."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from modular_slam_tpu_torch.utils import prng

N_HYP = 128
EXAMPLES = settings(max_examples=30, deadline=None, derandomize=True,
                    database=None,
                    suppress_health_check=[HealthCheck.too_slow])

SEEDS = st.one_of(
    st.sampled_from([0, 1, 7, -1, -7, 2 ** 31, 2 ** 32 - 1, 2 ** 32,
                     2 ** 32 + 7, -2 ** 32, 2 ** 63 - 1, -2 ** 63]),
    st.integers(-2 ** 40, 2 ** 40),
    st.integers(-2 ** 63, 2 ** 63 - 1))


def _pnp_probs(valid):
    """modular_slam_tpu/ops/pnp.py:211-212."""
    probs = valid.astype(jnp.float32) + 1e-9
    return probs / jnp.sum(probs)


@jax.jit
def _jax_choice(key, valid):
    return jax.random.choice(key, valid.shape[-1], shape=(N_HYP, 3),
                             replace=True, p=_pnp_probs(valid))


def _mask(n: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    valid = np.zeros(n, bool)
    if kind == "one":
        valid[rng.integers(n)] = True
    elif kind == "two":
        valid[rng.choice(n, size=min(2, n), replace=False)] = True
    elif kind == "random":
        valid = rng.random(n) < rng.random()
    return valid


def test_the_scheme_is_the_one_implemented():
    """The module reproduces threefry2x32 in the partitionable scheme with
    x64 off, jax 0.9.0's defaults: the flags the tests run under."""
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert bool(jax.config.jax_threefry_partitionable) \
        is prng.THREEFRY_PARTITIONABLE
    assert bool(jax.config.jax_enable_x64) is prng.ENABLE_X64


@EXAMPLES
@given(seed=SEEDS, num=st.sampled_from([1, 2, 3, 16]),
       rows=st.sampled_from([1, 7, N_HYP]))
def test_keys_split_bits_and_uniform_are_jax_s(seed, num, rows):
    key, jkey = prng.prng_key(seed), jax.random.PRNGKey(seed)
    assert key.dtype == np.uint32 and key.shape == (2,)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    np.testing.assert_array_equal(prng.split(key),
                                  np.asarray(jax.random.split(jkey)))
    np.testing.assert_array_equal(prng.split(key, num),
                                  np.asarray(jax.random.split(jkey, num)))
    np.testing.assert_array_equal(
        prng.random_bits(key, (rows, 3)),
        np.asarray(jax.random.bits(jkey, (rows, 3), jnp.uint32)))
    u = prng.uniform(key, (rows, 3))
    assert u.dtype == np.float32
    np.testing.assert_array_equal(
        u.view(np.uint32),
        np.asarray(jax.random.uniform(jkey, (rows, 3))).view(np.uint32))


def test_seeds_outside_int64_raise_as_in_jax():
    for seed in (2 ** 63, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            jax.random.PRNGKey(seed)
        with pytest.raises(OverflowError):
            prng.prng_key(seed)
    # numpy integers and int32 views of a key are taken as JAX takes them
    np.testing.assert_array_equal(prng.prng_key(np.int64(-3)),
                                  np.asarray(jax.random.PRNGKey(-3)))
    key = prng.prng_key(-5)
    np.testing.assert_array_equal(prng.split(key.view(np.int32)),
                                  prng.split(key))


@EXAMPLES
@given(n=st.integers(1, 2048),
       kind=st.sampled_from(["none", "one", "two", "random"]),
       seed=st.integers(0, 2 ** 32 - 1))
def test_choice_rows_is_jax_choice(n, kind, seed):
    valid = _mask(n, kind, seed)
    key = prng.split(prng.prng_key(seed))[1]
    want = np.asarray(_jax_choice(key, valid))
    got = prng.choice_rows(key, torch.from_numpy(valid), N_HYP)
    assert got.dtype == torch.int64 and tuple(got.shape) == (N_HYP, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "none":
        assert valid[got.numpy()].all()


@pytest.mark.parametrize("n", [1, 16, 17, 300, 512, 2048])
def test_batched_draws_equal_per_row_draws_and_jax_vmap(n):
    """Keys [B, 2] and masks [B, N] -> [B, n_hyp, 3], row b what key b
    gives mask b alone; the `Uniforms` of the keys give the same rows."""
    masks = np.stack([_mask(n, kind, 11 + b) for b, kind in
                      enumerate(["none", "one", "two", "random", "random"])])
    keys = prng.split(prng.prng_key(n), len(masks))
    got = prng.choice_rows(keys, torch.from_numpy(masks), N_HYP)
    assert tuple(got.shape) == (len(masks), N_HYP, 3)
    for b in range(len(masks)):
        assert torch.equal(got[b], prng.choice_rows(
            keys[b], torch.from_numpy(masks[b]), N_HYP))
    want = jax.jit(jax.vmap(_jax_choice))(keys, masks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = prng.device_uniforms(keys, N_HYP, "cpu")
    assert torch.equal(prng.choice_rows(drawn, torch.from_numpy(masks),
                                        N_HYP), got)
    assert torch.equal(prng.choice_rows(drawn[2], torch.from_numpy(masks[2]),
                                        N_HYP), got[2])


@EXAMPLES
@given(n=st.integers(1, 5000), seed=st.integers(0, 2 ** 32 - 1))
def test_sum_and_prefix_sum_follow_xla_cpu_order(n, seed):
    """The mapping's float32 normalization and CDF, bit for bit, on values
    of wide range (where any other order of the adds rounds otherwise)."""
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * np.exp(rng.normal(0.0, 3.0, n))).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        prng._sum_last(t).numpy().view(np.uint32),
        np.asarray(jax.jit(jnp.sum)(x)).view(np.uint32))
    np.testing.assert_array_equal(
        prng._cumsum_last(t).numpy().view(np.uint32),
        np.asarray(jax.jit(jnp.cumsum)(x)).view(np.uint32))
    # and the normalized probabilities of a mask of that length
    valid = rng.random(n) < 0.5
    p = torch.from_numpy(valid).to(torch.float32) + prng._EPS
    np.testing.assert_array_equal(
        (p / prng._sum_last(p)).numpy().view(np.uint32),
        np.asarray(jax.jit(_pnp_probs)(valid)).view(np.uint32))
