"""The port's map lifecycle (modular_slam_tpu_torch/map/lifecycle.py)
against the JAX package on the CPU: culling, eviction, compaction with its
slot remaps, and duplicate fusion, all exact — every field of the arena,
the remaps and the fusion counts — on seeded arenas built with numpy and
on the cases of tests/test_lifecycle.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.map import lifecycle as jlc
from modular_slam_tpu.map.arena import MapArena as JArena
from modular_slam_tpu_torch.map import lifecycle as tlc
from modular_slam_tpu_torch.map.arena import MapArena as TArena


def _arena(seed, K=16, L=256, O=1024, D=32, n_kf=12, n_lm=200, per_kf=40,
           holes=True):
    """Numpy fields of a consistent arena: n_kf keyframes, each observing
    per_kf distinct landmarks drawn near its own index (so neighbours
    share landmarks and some landmarks are seen once); with `holes`, a
    few invalid keyframes, landmarks and observations."""
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=(K, 3)) * 0.1
    th = np.linalg.norm(aa, axis=1, keepdims=True)
    q = np.concatenate([np.cos(th / 2), np.sin(th / 2) * aa / th], 1)
    kf_valid = np.arange(K) < n_kf
    lm_valid = np.arange(L) < n_lm
    obs_kf, obs_lm = [], []
    for k in range(n_kf):
        lo = int(k * (n_lm - per_kf) / max(n_kf - 1, 1))
        lms = rng.choice(np.arange(lo, lo + per_kf), per_kf // 2,
                         replace=False)
        obs_kf += [k] * len(lms)
        obs_lm += lms.tolist()
    n_obs = len(obs_kf)
    obs_valid = np.zeros(O, bool)
    obs_valid[:n_obs] = True
    if holes:
        kf_valid[rng.choice(n_kf - 2, 2, replace=False) + 1] = False
        lm_valid[rng.choice(n_lm, 10, replace=False)] = False
        obs_valid[rng.choice(n_obs, 15, replace=False)] = False
    ok_kf = np.zeros(O, np.int32)
    ok_lm = np.zeros(O, np.int32)
    ok_kf[:n_obs], ok_lm[:n_obs] = obs_kf, obs_lm
    inc = np.zeros((K, L), bool)
    live = obs_valid & kf_valid[ok_kf] & lm_valid[ok_lm]
    inc[ok_kf[live], ok_lm[live]] = True
    return dict(
        kf_q=q.astype(np.float32),
        kf_t=rng.normal(size=(K, 3)).astype(np.float32),
        kf_time=np.arange(K, dtype=np.float32) / 30,
        kf_valid=kf_valid,
        lm_pos=rng.normal(size=(L, 3)).astype(np.float32),
        lm_desc=rng.choice(np.array([-1, 1], np.int8), size=(L, D)),
        lm_valid=lm_valid, inc=inc, obs_kf=ok_kf, obs_lm=ok_lm,
        obs_uv=rng.uniform(0, 300, (O, 2)).astype(np.float32),
        obs_depth=rng.uniform(0.5, 3, O).astype(np.float32),
        obs_valid=obs_valid,
        n_kf=np.int32(n_kf), n_lm=np.int32(n_lm), n_obs=np.int32(n_obs))


def _both(fields):
    return (JArena(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TArena(**{k: torch.from_numpy(np.array(v))
                      for k, v in fields.items()}))


def _assert_equal(tarena, jarena):
    for f in JArena._fields:
        got = getattr(tarena, f).numpy()
        want = np.asarray(getattr(jarena, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("protect", [0, 30, 256])
def test_cull_landmarks_exact(seed, protect):
    ja, ta = _both(_arena(seed))
    _assert_equal(tlc.cull_landmarks(ta, 2, protect),
                  jlc.cull_landmarks(ja, 2, protect))
    np.testing.assert_array_equal(tlc.landmark_obs_counts(ta).numpy(),
                                  np.asarray(jlc.landmark_obs_counts(ja)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_live,protect", [(4, 2), (6, 4), (8, 4),
                                              (12, 4), (2, 4)])
def test_evict_keyframes_exact(seed, max_live, protect):
    """Age ties never happen (distinct slots), redundancy scores tie
    often: the stable sort keeps the older victim first, as JAX."""
    ja, ta = _both(_arena(seed, per_kf=16 if seed == 2 else 40))
    got = tlc.evict_keyframes(ta, max_live, protect)
    _assert_equal(got, jlc.evict_keyframes(ja, max_live, protect))
    assert int(got.kf_valid.sum()) == max(
        min(int(ta.kf_valid.sum()), max_live), min(protect, max_live - 1) + 1)


def test_evict_redundant_keyframes_first():
    """tests/test_lifecycle.py:96: six keyframes seeing the same 16
    landmarks are all redundant; the gauge and the newest 2 survive."""
    f = _arena(3, K=8, L=64, O=256, n_kf=6, n_lm=16, per_kf=32, holes=False)
    obs = np.stack(np.meshgrid(np.arange(6), np.arange(16), indexing="ij"),
                   -1).reshape(-1, 2)
    f["obs_kf"][:96], f["obs_lm"][:96] = obs[:, 0], obs[:, 1]
    f["obs_valid"][:] = np.arange(256) < 96
    f["inc"][:] = False
    f["inc"][:6, :16] = True
    f["n_obs"] = np.int32(96)
    ja, ta = _both(f)
    got = tlc.evict_keyframes(ta, max_live=4, protect=2)
    _assert_equal(got, jlc.evict_keyframes(ja, max_live=4, protect=2))
    assert got.kf_valid[:6].tolist() == [True, False, False, True, True,
                                         True]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_maintenance_compacts_exactly(seed):
    """The engine's maintenance — cull, evict, compact — on both: every
    field and both remaps equal."""
    ja, ta = _both(_arena(seed))

    def chain(lc, a):
        a = lc.cull_landmarks(a, 2, 0)
        a = lc.evict_keyframes(a, max_live=6)
        return lc.compact_arena(a)

    jarena, jmaps = jax.jit(lambda a: chain(jlc, a))(ja)
    tarena, tmaps = chain(tlc, ta)
    _assert_equal(tarena, jarena)
    np.testing.assert_array_equal(tmaps.kf.numpy(), np.asarray(jmaps.kf))
    np.testing.assert_array_equal(tmaps.lm.numpy(), np.asarray(jmaps.lm))
    n = int(tarena.n_kf)
    assert tarena.kf_valid[:n].all() and not tarena.kf_valid[n:].any()
    # nothing to drop: compaction is the identity on the live prefix
    again, maps = tlc.compact_arena(tarena)
    _assert_equal(again, jlc.compact_arena(jarena)[0])
    assert torch.equal(maps.kf[:n], torch.arange(n, dtype=torch.int32))


def _fusion_arena(seed, n_dup=8, third=False, two_to_one=False):
    """kf0 observes n_dup originals; kf1 observes near-copies of them
    (same descriptors, 1 cm off) plus a few of its own; `third` adds a
    keyframe observing duplicate 0 and original 0; `two_to_one` makes
    duplicate 1 a second copy of original 0."""
    rng = np.random.default_rng(seed)
    f = _arena(seed, K=8, L=64, O=256, n_kf=0, n_lm=0, holes=False)
    D = f["lm_desc"].shape[1]
    orig = rng.normal(size=(n_dup, 3)).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n_dup, D))
    dup_pos = orig + np.float32(0.01)
    dup_desc = desc.copy()
    if two_to_one:
        dup_pos[1] = orig[0] + np.float32(0.02)
        dup_desc[1] = desc[0]
    own = rng.normal(size=(3, 3)).astype(np.float32)
    own_desc = rng.choice(np.array([-1, 1], np.int8), size=(3, D))
    pos = np.concatenate([orig, dup_pos, own])
    n_lm = len(pos)
    f["lm_pos"][:n_lm] = pos
    f["lm_desc"][:n_lm] = np.concatenate([desc, dup_desc, own_desc])
    f["lm_valid"][:n_lm] = True
    obs = [(0, i) for i in range(n_dup)]
    obs += [(1, n_dup + i) for i in range(n_dup + 3)]
    if third:
        obs += [(2, n_dup), (2, 0)]
    n_kf = 3 if third else 2
    f["kf_valid"][:n_kf] = True
    f["n_kf"], f["n_lm"], f["n_obs"] = (np.int32(n_kf), np.int32(n_lm),
                                        np.int32(len(obs)))
    for o, (k, lm) in enumerate(obs):
        f["obs_kf"][o], f["obs_lm"][o] = k, lm
        f["obs_valid"][o] = True
        f["inc"][k, lm] = True
    return f


@pytest.mark.parametrize("case,expect", [
    ({}, 8), ({"third": True}, 7), ({"two_to_one": True}, 7)])
@pytest.mark.parametrize("max_dist,max_hamming", [(0.05, 0), (0.1, 40)])
def test_fuse_duplicate_landmarks_exact(case, expect, max_dist, max_hamming):
    """tests/test_lifecycle.py's fusion cases: plain duplicates, a third
    keyframe observing a source and its target (that pair is skipped),
    and two duplicates of one original (mutual best: one fuses)."""
    ja, ta = _both(_fusion_arena(5, **case))
    jf, jn = jlc.fuse_duplicate_landmarks(ja, jnp.int32(1), jnp.int32(0),
                                          max_dist=max_dist,
                                          max_hamming=max_hamming)
    tf, tn = tlc.fuse_duplicate_landmarks(ta, 1, 0, max_dist=max_dist,
                                          max_hamming=max_hamming)
    _assert_equal(tf, jf)
    assert int(tn) == int(jn) == expect


@pytest.mark.parametrize("seed", [0, 1])
def test_fuse_on_random_arena_exact(seed):
    """Neighbouring keyframes of a random arena: random descriptors, so
    fusion is driven by the distance gate alone at a loose Hamming
    bound."""
    ja, ta = _both(_arena(seed))
    for a, b in ((3, 4), (5, 2)):
        jf, jn = jlc.fuse_duplicate_landmarks(ja, jnp.int32(a),
                                              jnp.int32(b), max_dist=0.8,
                                              max_hamming=256)
        tf, tn = tlc.fuse_duplicate_landmarks(ta, a, b, max_dist=0.8,
                                              max_hamming=256)
        _assert_equal(tf, jf)
        assert int(tn) == int(jn)
