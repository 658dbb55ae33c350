"""The port's RANSAC-PnP (modular_slam_tpu_torch/ops/pnp.py) against the
JAX package, fed the minimal-sample indices that `jax.random.choice`
draws inside the JAX version (pnp.py:210-215): equal inlier masks and
counts, poses within 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import PnpConfig, tiny_test_config
from modular_slam_tpu.geometry import camera as jcam
from modular_slam_tpu.geometry import se3 as jse3
from modular_slam_tpu.ops import pnp as jpnp
from modular_slam_tpu_torch.geometry import camera as tcam
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.ops import pnp as tpnp


def _jax_indices(key, valid, n_hyp):
    """The triplets ransac_pnp draws from `key` (pnp.py:210-215)."""
    probs = valid.astype(jnp.float32) + 1e-9
    probs = probs / jnp.sum(probs)
    return np.array(jax.random.choice(key, valid.shape[0], (n_hyp, 3),
                                      replace=True, p=probs))


def _problem(seed, n=96, outliers=0.25):
    cfg = tiny_test_config()
    rng = np.random.default_rng(seed)
    cam = jcam.camera_from_config(cfg.camera)
    q = np.asarray(jse3.quat_from_axis_angle(
        jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32))))
    t = rng.normal(0, 0.05, 3).astype(np.float32)
    pose = jse3.Pose(jnp.asarray(q), jnp.asarray(t))
    uv = rng.uniform(10, [150, 110], (n, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 3.0, n).astype(np.float32)
    pts_cam = np.array(jcam.backproject(cam, jnp.asarray(uv),
                                        jnp.asarray(depth)))
    pts_world = np.asarray(jse3.pose_apply(pose, jnp.asarray(pts_cam)))
    pts_world = pts_world + rng.normal(0, 0.002, pts_world.shape).astype(
        np.float32)
    bad = rng.random(n) < outliers
    pts_world[bad] += rng.normal(0, 0.5, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) > 0.1
    return cfg, pts_world, uv, pts_cam, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_pnp_matches_jax_with_replayed_draws(seed):
    cfg, pts_world, uv, pts_cam, valid = _problem(seed)
    pcfg = PnpConfig(n_hypotheses=32)
    key = jax.random.PRNGKey(seed)
    init = jse3.identity_pose()
    ref = jpnp.ransac_pnp(jcam.camera_from_config(cfg.camera),
                          jnp.asarray(pts_world), jnp.asarray(uv),
                          jnp.asarray(pts_cam), jnp.asarray(valid), init, key,
                          pcfg)
    idx = _jax_indices(key, jnp.asarray(valid), pcfg.n_hypotheses)

    def replay(v, n_hyp):
        assert n_hyp == pcfg.n_hypotheses
        return torch.from_numpy(idx)

    got = tpnp.ransac_pnp(tcam.camera_from_config(cfg.camera),
                          torch.from_numpy(pts_world), torch.from_numpy(uv),
                          torch.from_numpy(pts_cam), torch.from_numpy(valid),
                          Pose(torch.tensor([1.0, 0, 0, 0]), torch.zeros(3)),
                          replay, pcfg)
    assert bool(ref.ok) and bool(got.ok)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 40
    np.testing.assert_allclose(got.pose.q.numpy(), np.asarray(ref.pose.q),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(ref.pose.t),
                               rtol=0, atol=1e-4)


def test_multinomial_sampler_is_seeded_and_uses_valid_rows():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    a = tpnp.MultinomialSampler(5)(valid, 16)
    b = tpnp.MultinomialSampler(5)(valid, 16)
    assert a.shape == (16, 3) and torch.equal(a, b)
    assert set(a.flatten().tolist()) <= {3, 17, 40}
