"""The port's Hamming 2-NN matcher and dedupe
(modular_slam_tpu_torch/ops/match.py) against the JAX package: its Pallas
kernel (interpreted off the TPU) and its XLA formulation.  On the CPU the
port runs the plain version of kernel K2; the tile-merge epilogue that
follows the CUDA kernel is fed the Pallas kernel's per-tile triples."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import MatcherConfig
from modular_slam_tpu.ops import match as jm
from modular_slam_tpu.ops import match_pallas as jmp
from modular_slam_tpu.types import Matches as JMatches
from modular_slam_tpu_torch.ops import match as tm
from modular_slam_tpu_torch.types import Matches

CFG = MatcherConfig()


def _problem(seed, nq=128, nl=512, planted=32):
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 2, (nq, 256)) * 2 - 1).astype(np.int8)
    t = (rng.integers(0, 2, (nl, 256)) * 2 - 1).astype(np.int8)
    rows = rng.choice(nl, planted, replace=False)
    qs = rng.choice(nq, planted, replace=False)
    t[rows] = q[qs]
    # a few exact ties: two landmarks equal to one query
    t[rows[:4] ^ 1] = q[qs[:4]]
    qv = rng.random(nq) > 0.1
    tv = rng.random(nl) > 0.1
    return q, qv, t, tv


def _port(q, qv, t, tv):
    return tm.match_descriptors(*(torch.from_numpy(np.asarray(x))
                                  for x in (q, qv, t, tv)), CFG)


def _assert_same(jmatch, tmatch):
    valid = np.asarray(jmatch.valid)
    np.testing.assert_array_equal(tmatch.valid.numpy(), valid)
    np.testing.assert_array_equal(tmatch.lm_slot.numpy()[valid],
                                  np.asarray(jmatch.lm_slot)[valid])
    np.testing.assert_array_equal(tmatch.distance.numpy()[valid],
                                  np.asarray(jmatch.distance)[valid])


@pytest.mark.parametrize("seed,nq,nl", [(0, 128, 512), (1, 64, 640)])
def test_match_matches_pallas_and_xla(seed, nq, nl):
    """nl=640 gives the Pallas kernel five tiles of 128."""
    q, qv, t, tv = _problem(seed, nq, nl)
    got = _port(q, qv, t, tv)
    args = tuple(jnp.asarray(x) for x in (q, qv, t, tv))
    _assert_same(jm.match_descriptors(*args, CFG), got)
    _assert_same(jmp.match_descriptors_pallas(*args, CFG), got)
    assert got.valid.sum() >= 16


def test_match_batched_matches_vmap():
    probs = [_problem(s, nq=32, nl=256) for s in (3, 4, 5)]
    q, qv, t, tv = (np.stack([p[i] for p in probs]) for i in range(4))
    got = _port(q, qv, t, tv)
    ref = jax.vmap(lambda a, b, c, d: jmp.match_descriptors_pallas(
        a, b, c, d, CFG))(*(jnp.asarray(x) for x in (q, qv, t, tv)))
    for i in range(len(probs)):
        _assert_same(JMatches(*(x[i] for x in ref)),
                     Matches(*(x[i] for x in got)))


def test_tile_merge_of_pallas_tiles_matches_plain():
    """The CUDA path's epilogue (merge_tiles + ratio test) on the Pallas
    kernel's per-tile triples gives the plain matcher's result."""
    q, qv, t, tv = _problem(7, nq=64, nl=640)
    best_t, idx_t, second_t = jmp._match_tiles(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(tv), 128,
        interpret=True)
    best, idx, second = tm.merge_tiles(
        *(torch.from_numpy(np.array(x)) for x in (best_t, idx_t,
                                                    second_t)))
    merged = tm._ratio_test(best, second, idx, torch.from_numpy(qv), CFG)
    plain = tm.match_descriptors_plain(
        *(torch.from_numpy(x) for x in (q, qv, t, tv)), CFG)
    assert torch.equal(merged.valid, plain.valid)
    v = plain.valid
    assert torch.equal(merged.lm_slot[v], plain.lm_slot[v])
    assert torch.equal(merged.distance[v], plain.distance[v])


@pytest.mark.parametrize("n", [64, 2100])
def test_dedupe_matches_exact(n):
    """Collisions on the train side with equal distances: the lower query
    index wins.  n=2100 takes the scatter-min branch."""
    rng = np.random.default_rng(n)
    slot = rng.integers(0, n // 4, n).astype(np.int32)
    dist = (rng.integers(0, 40, n) * 0.5).astype(np.float32)
    dist[1::7] = dist[0]  # many exact distance ties
    valid = rng.random(n) > 0.2
    ref = jm.dedupe_matches(JMatches(jnp.asarray(slot), jnp.asarray(dist),
                                     jnp.asarray(valid)), n // 4)
    got = tm.dedupe_matches(Matches(torch.from_numpy(slot),
                                    torch.from_numpy(dist),
                                    torch.from_numpy(valid)), n // 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert 0 < got.valid.sum() < valid.sum()


def test_cpu_tensors_never_reach_the_kernel():
    from modular_slam_tpu_torch.ops.kernels import HAMMING_2NN

    before = HAMMING_2NN.launches
    q, qv, t, tv = _problem(0, 8, 16, 4)
    _port(q, qv, t, tv)
    assert HAMMING_2NN.launches == before
    with pytest.raises(ValueError):
        tm.hamming_2nn_tiles(torch.from_numpy(q), torch.from_numpy(t),
                             torch.from_numpy(tv))
