"""The port's map arena (modular_slam_tpu_torch/map/arena.py) against the
JAX package: every insertion, including the drop-on-overflow policy and
the saturating counters, the covisibility queries and counts, and the
masked write-back of BA results — all exact."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from modular_slam_tpu.config import MapConfig
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.map import arena as ja
from modular_slam_tpu_torch.geometry.se3 import Pose as TPose
from modular_slam_tpu_torch.map import arena as ta
from modular_slam_tpu_torch.utils.state import arena_from_numpy

# small pools so that every pool overflows within a few insertions
CFG = MapConfig(max_keyframes=4, max_landmarks=24, max_observations=40,
                descriptor_bits=256)
N = 10


def _assert_arena_equal(tarena, jarena):
    for f in ja.MapArena._fields:
        np.testing.assert_array_equal(getattr(tarena, f).numpy(),
                                      np.asarray(getattr(jarena, f)),
                                      err_msg=f)


def _step(rng, k, N=N):
    pose_q = rng.normal(size=4).astype(np.float32)
    pose_q /= np.linalg.norm(pose_q)
    pose_t = rng.normal(size=3).astype(np.float32)
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    desc = (rng.integers(0, 2, (N, 256)) * 2 - 1).astype(np.int8)
    uv = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    depth = rng.uniform(0, 3, N).astype(np.float32)
    new = rng.random(N) > 0.3
    obs_old = rng.random(N) > 0.4
    old_slots = rng.permutation(max(k * 3, N))[:N].astype(np.int32)
    return pose_q, pose_t, pos, desc, uv, depth, new, obs_old, old_slots


def test_insertions_with_overflow_match_jax():
    rng = np.random.default_rng(0)
    jarena = ja.empty_arena(CFG)
    tarena = ta.empty_arena(CFG)
    _assert_arena_equal(tarena, jarena)
    for k in range(6):  # K=4: the last two keyframes are dropped
        (q, t, pos, desc, uv, depth, new, obs_old,
         old_slots) = _step(rng, k)
        time = np.float32(k * 0.1)
        jarena, jkf = ja.add_keyframe(jarena, JPose(jnp.asarray(q),
                                                    jnp.asarray(t)),
                                      jnp.float32(time))
        tarena, tkf = ta.add_keyframe(tarena, TPose(torch.from_numpy(q),
                                                    torch.from_numpy(t)),
                                      torch.tensor(time))
        assert int(tkf) == int(jkf)
        # re-observations of existing slots (some out of range -> dropped)
        jarena = ja.add_observations(
            jarena, jkf, jnp.asarray(old_slots), jnp.asarray(uv),
            jnp.asarray(depth), jnp.asarray(desc), jnp.asarray(obs_old))
        tarena = ta.add_observations(
            tarena, tkf, torch.from_numpy(old_slots), torch.from_numpy(uv),
            torch.from_numpy(depth), torch.from_numpy(desc),
            torch.from_numpy(obs_old))
        # new landmarks (L=24 overflows on the fourth step) + observations
        jarena, jslots = ja.add_landmarks(jarena, jnp.asarray(pos),
                                          jnp.asarray(desc), jnp.asarray(new))
        tarena, tslots = ta.add_landmarks(tarena, torch.from_numpy(pos),
                                          torch.from_numpy(desc),
                                          torch.from_numpy(new))
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        jarena = ja.add_observations(jarena, jkf, jslots, jnp.asarray(uv),
                                     jnp.asarray(depth), jnp.asarray(desc),
                                     jnp.asarray(new))
        tarena = ta.add_observations(tarena, tkf, tslots,
                                     torch.from_numpy(uv),
                                     torch.from_numpy(depth),
                                     torch.from_numpy(desc),
                                     torch.from_numpy(new))
        _assert_arena_equal(tarena, jarena)
    # every pool saturated
    assert int(tarena.n_kf) == CFG.max_keyframes
    assert int(tarena.n_lm) == CFG.max_landmarks
    assert int(tarena.n_obs) == CFG.max_observations


def _random_arena(seed, K=12, L=60):
    rng = np.random.default_rng(seed)
    cfg = MapConfig(max_keyframes=K, max_landmarks=L, max_observations=8)
    jarena = ja.empty_arena(cfg)
    inc = rng.random((K, L)) < 0.06
    kf_valid = np.arange(K) < K - 2
    lm_valid = rng.random(L) > 0.1
    inc &= kf_valid[:, None]
    jarena = jarena._replace(inc=jnp.asarray(inc),
                             kf_valid=jnp.asarray(kf_valid),
                             lm_valid=jnp.asarray(lm_valid),
                             n_kf=jnp.int32(K - 2))
    return jarena, arena_from_numpy(
        ja.MapArena(*(np.asarray(x) for x in jarena)))


def test_khop_and_visible_landmarks_match_jax():
    for seed in range(4):
        jarena, tarena = _random_arena(seed)
        for slot in (0, 3, 11):
            for depth in (0, 1, 2, 5):
                jmask = ja.khop_keyframes(jarena, jnp.int32(slot), depth)
                tmask = ta.khop_keyframes(tarena, torch.tensor(slot), depth)
                np.testing.assert_array_equal(tmask.numpy(),
                                              np.asarray(jmask))
                np.testing.assert_array_equal(
                    ta.visible_landmarks(tarena, tmask).numpy(),
                    np.asarray(ja.visible_landmarks(jarena, jmask)))


@pytest.mark.parametrize("enable,n", [(False, N), (True, N), (True, 30)])
def test_gated_insertions(enable, n):
    """The tracker's masked keyframe branch: every insert under a 0-d
    `enable` tensor.  False leaves the arena bit-identical (counters
    included); True equals the JAX inserts, overflow and drops included,
    also with batches larger than the landmark pool (n=30 > L=24)."""
    rng = np.random.default_rng(1)
    jarena = ja.empty_arena(CFG)
    tarena = ta.empty_arena(CFG)
    on = torch.tensor(enable)
    for k in range(6):
        (q, t, pos, desc, uv, depth, new, obs_old,
         old_slots) = _step(rng, k, n)
        before = [x.clone() for x in tarena]
        tarena, tkf = ta.add_keyframe(
            tarena, TPose(torch.from_numpy(q), torch.from_numpy(t)),
            torch.tensor(np.float32(k)), enable=on)
        tarena = ta.add_observations(
            tarena, tkf, torch.from_numpy(old_slots), torch.from_numpy(uv),
            torch.from_numpy(depth), torch.from_numpy(desc),
            torch.from_numpy(obs_old), enable=on)
        tarena, tslots = ta.add_landmarks(tarena, torch.from_numpy(pos),
                                          torch.from_numpy(desc),
                                          torch.from_numpy(new), enable=on)
        tarena = ta.add_observations(
            tarena, tkf, tslots, torch.from_numpy(uv),
            torch.from_numpy(depth), torch.from_numpy(desc),
            torch.from_numpy(new), enable=on)
        if not enable:
            assert all(torch.equal(a, b) for a, b in zip(before, tarena))
            assert bool((tslots == CFG.max_landmarks).all())
            continue
        jarena, jkf = ja.add_keyframe(jarena, JPose(jnp.asarray(q),
                                                    jnp.asarray(t)),
                                      jnp.float32(k))
        jarena = ja.add_observations(
            jarena, jkf, jnp.asarray(old_slots), jnp.asarray(uv),
            jnp.asarray(depth), jnp.asarray(desc), jnp.asarray(obs_old))
        jarena, jslots = ja.add_landmarks(jarena, jnp.asarray(pos),
                                          jnp.asarray(desc), jnp.asarray(new))
        jarena = ja.add_observations(jarena, jkf, jslots, jnp.asarray(uv),
                                     jnp.asarray(depth), jnp.asarray(desc),
                                     jnp.asarray(new))
        assert int(tkf) == int(jkf)
        np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
        _assert_arena_equal(tarena, jarena)


def _covis_scene():
    """The JAX package's covisibility scene (tests/test_map.py): kf0 sees
    landmarks {0, 1}, kf1 {1, 2}, kf2 {2, 3}, kf3 {5} (isolated), built
    with the JAX inserts; -> (JAX arena, port arena)."""
    cfg = MapConfig(max_keyframes=8, max_landmarks=32, max_observations=64,
                    descriptor_bits=256)
    rng = np.random.default_rng(0)

    def desc(n):
        return jnp.asarray((rng.integers(0, 2, (n, 256)) * 2 - 1)
                           .astype(np.int8))

    a = ja.empty_arena(cfg)
    a, _ = ja.add_landmarks(a, jnp.zeros((6, 3)), desc(6), jnp.ones(6, bool))
    for kf, lms in [(0, [0, 1]), (1, [1, 2]), (2, [2, 3]), (3, [5, 0])]:
        a, slot = ja.add_keyframe(a, JPose(jnp.array([1.0, 0, 0, 0]),
                                           jnp.array([float(kf), 0, 0])),
                                  jnp.float32(kf))
        a = ja.add_observations(a, slot, jnp.array(lms, jnp.int32),
                                jnp.zeros((2, 2)), jnp.ones(2), desc(2),
                                jnp.array([True, kf != 3]))
    return a, arena_from_numpy(ja.MapArena(*(np.asarray(x) for x in a)))


def test_covis_counts_match_jax():
    jarena, tarena = _covis_scene()
    got = ta.covis_counts(tarena)
    ref = np.asarray(ja.covis_counts(jarena))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[0, 1] == 1 and ref[1, 2] == 1 and ref[0, 2] == 0
    assert ref[3, 3] == 1 and ref[3, :3].sum() == 0
    for seed in range(2):
        jarena, tarena = _random_arena(seed)
        np.testing.assert_array_equal(ta.covis_counts(tarena).numpy(),
                                      np.asarray(ja.covis_counts(jarena)))


def test_apply_backend_update_matches_jax():
    jarena, tarena = _covis_scene()
    rng = np.random.default_rng(1)
    K, L = tarena.max_keyframes, tarena.max_landmarks
    kf_q = rng.normal(size=(K, 4)).astype(np.float32)
    kf_t = rng.normal(size=(K, 3)).astype(np.float32)
    lm_pos = rng.normal(size=(L, 3)).astype(np.float32)
    kf_mask = rng.random(K) > 0.5
    lm_mask = rng.random(L) > 0.5
    before = [x.clone() for x in tarena]
    got = ta.apply_backend_update(tarena, *map(torch.from_numpy, (
        kf_q, kf_t, lm_pos, kf_mask, lm_mask)))
    ref = ja.apply_backend_update(jarena, *map(jnp.asarray, (
        kf_q, kf_t, lm_pos, kf_mask, lm_mask)))
    _assert_arena_equal(got, ref)
    for x, y in zip(tarena, before):      # the old arena is not written
        assert torch.equal(x, y)
