"""The port's Hamming 2-NN matcher and dedupe
(modular_slam_tpu_torch/ops/match.py) against the JAX package: its Pallas
kernel (interpreted off the TPU) and its XLA formulation.  On the CPU the
port runs the plain versions of kernel K2 and of its merge kernel: the
per-split triples the CUDA kernel computes, built in plain torch on the
kernel's split plan, and the merge of those triples (also fed the Pallas
kernel's per-tile triples).  The kernels themselves are held against
these plain versions by chip_smoke.py on the card."""

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
    from modular_slam_tpu_torch.ops.kernels import HAMMING_2NN, HAMMING_MERGE

    before = (HAMMING_2NN.launches, HAMMING_MERGE.launches)
    q, qv, t, tv = _problem(0, 8, 16, 4)
    _port(q, qv, t, tv)
    assert (HAMMING_2NN.launches, HAMMING_MERGE.launches) == before
    q, qv, t, tv = (torch.from_numpy(x) for x in (q, qv, t, tv))
    with pytest.raises(ValueError):
        tm.hamming_2nn_splits(q, t, tv)
    with pytest.raises(ValueError):
        tm.match_descriptors_cuda(q, qv, t, tv, CFG)


def _split_problem(nq, nl, n_splits, seed=11):
    """Planted matches, exact duplicates of the best row in a later split
    (ties across splits: the first index must win, and second == best
    rejects the match) and, with more than one split, a split whose rows
    are all invalid."""
    rng = np.random.default_rng(seed)
    q = (rng.integers(0, 2, (nq, 256)) * 2 - 1).astype(np.int8)
    t = (rng.integers(0, 2, (nl, 256)) * 2 - 1).astype(np.int8)
    n_plant = min(nq, nl) // 2
    rows = rng.choice(nl, n_plant, replace=False)
    t[rows] = q[:n_plant]
    flips = rng.integers(0, 256, (n_plant, 4))
    t[rows[:, None], flips] *= -1
    tv = rng.random(nl) > 0.1
    cps, S = tm.hamming_split_plan(nl, n_splits)
    w = cps * tm.HAMMING_CHUNK
    for r in rows[: n_plant // 4]:       # duplicate into the next split
        dup = r + w
        if dup < nl:
            t[dup] = t[r]
            tv[dup] = tv[r]
    if S > 1:
        tv[w: 2 * w] = False
    qv = rng.random(nq) > 0.05
    return q, qv, t, tv, cps, S


@pytest.mark.parametrize("n_splits", [1, 3, 32])
@pytest.mark.parametrize("nq,nl", [(1, 1), (37, 640), (512, 16000)])
def test_split_triples_merged_equal_jax(nq, nl, n_splits):
    """The arithmetic of kernel K2 and its merge kernel: per-split triples
    on the kernel's split plan (chunks of 128), merged in split order and
    ratio-tested, equal the JAX matcher exactly."""
    q, qv, t, tv, cps, S = _split_problem(nq, nl, n_splits)
    assert (S - 1) * cps * tm.HAMMING_CHUNK < nl <= S * cps * tm.HAMMING_CHUNK
    best_s, idx_s, second_s = tm.hamming_2nn_splits_plain(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tv), cps)
    assert tuple(best_s.shape) == (S, nq)
    best, idx, second = tm.merge_tiles(best_s, idx_s, second_s)
    got = tm._ratio_test(best, second, idx, torch.from_numpy(qv), CFG)
    ref = jm.match_descriptors(*(jnp.asarray(x) for x in (q, qv, t, tv)),
                               CFG)
    _assert_same(ref, got)
    np.testing.assert_array_equal(got.lm_slot.numpy(),
                                  np.asarray(ref.lm_slot))
    if nq > 1:
        assert got.valid.sum() > 0


def _decode(key, base):
    """csrc/hamming_2nn.cu `to_distance` and the index of a key."""
    dot = key >> 16
    d = torch.where(dot == -32767, torch.full(dot.shape, 1e9),
                    (256 - dot).to(torch.float32) * 0.5)
    return d, (base + 65535 - (key & 0xFFFF)).to(torch.int32)


@pytest.mark.parametrize("nq,nl,n_splits", [(1, 1, 1), (37, 640, 3),
                                            (64, 1000, 32)])
def test_split_keys_decode_to_plain_triples(nq, nl, n_splits):
    """Kernel K2's epilogue arithmetic: per column the key dot * 65536 +
    (65535 - column in the split) (invalid: dot = -32767; past L: INT_MIN),
    the two largest keys of a split decode to the plain triple (best,
    first index, second) exactly, ties included."""
    q, _, t, tv, cps, S = _split_problem(nq, nl, n_splits, seed=12)
    qt, tt, tvt = (torch.from_numpy(x) for x in (q, t, tv))
    dot = (qt.long() @ tt.long().T)                        # [nq, nl]
    w = cps * tm.HAMMING_CHUNK
    col = torch.arange(nl)
    rev = 65535 - (col % w)
    key = torch.where(tvt, dot * 65536 + rev, -32767 * 65536 + rev)
    key = torch.nn.functional.pad(key, (0, S * w - nl), value=-2**31)
    key = key.reshape(nq, S, w)
    floor = torch.full((nq, S, 1), -32767 * 65536)         # Top2.second
    top = torch.topk(torch.cat([key, floor], -1), 2, dim=-1).values
    assert top.abs().max() < 2**31
    base = torch.arange(S)[None, :] * w
    best, idx = _decode(top[..., 0], base)
    second, _ = _decode(top[..., 1], base)
    ref = tm.hamming_2nn_splits_plain(qt, tt, tvt, cps)
    for got, want in zip((best, idx, second), ref):
        assert torch.equal(got.transpose(0, 1), want)


def test_match_per_candidate_masks_over_shared_rows():
    """Loop verification's shape (loop/detector.py): one query set and one
    set of landmark rows under a [B, L] mask, as `jax.vmap` over the mask
    alone; on the card this is one K2 launch with a batch stride of 0 for
    the rows."""
    q, qv, t, _ = _problem(8, nq=64, nl=640)
    rng = np.random.default_rng(9)
    masks = rng.random((3, 640)) > np.array([[0.1], [0.5], [0.9]])
    got = _port(q, qv, t, masks)
    assert tuple(got.valid.shape) == (3, 64)
    ref = jax.vmap(lambda m: jmp.match_descriptors_pallas(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(t), m, CFG))(
        jnp.asarray(masks))
    for i in range(3):
        _assert_same(JMatches(*(x[i] for x in ref)),
                     Matches(*(x[i] for x in got)))
    assert got.valid[0].sum() > got.valid[2].sum()
    cps, S = tm.hamming_split_plan(640, 3)
    splits = tm.hamming_2nn_splits_plain(*(torch.from_numpy(x)
                                           for x in (q, t, masks)), cps)
    assert tuple(splits[0].shape) == (3, S, 64)
    for i in range(3):
        one = tm.hamming_2nn_splits_plain(*(torch.from_numpy(x) for x in
                                            (q, t, masks[i])), cps)
        for a, b in zip(splits, one):
            assert torch.equal(a[i], b)
