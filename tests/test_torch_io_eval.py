"""The port's host-side trajectory writer, timestamp association and ATE
(numpy-only) against the JAX package: equal files, equal pairs, equal
statistics."""

import numpy as np
import jax.numpy as jnp
import torch

from modular_slam_tpu.eval.ate import ate_rmse as jate_rmse
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.io.associate import associate as jassociate
from modular_slam_tpu.io.trajectory import TumTrajectoryWriter as JWriter
from modular_slam_tpu_torch.eval.ate import ate_rmse
from modular_slam_tpu_torch.geometry.se3 import Pose
from modular_slam_tpu_torch.io.associate import associate
from modular_slam_tpu_torch.io.trajectory import (TumTrajectoryWriter,
                                                  trajectory_array)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    return q, t


def test_tum_writer_writes_the_jax_file(tmp_path):
    q, t = _poses(5, 0)
    stamps = np.arange(5) / 30.0
    with TumTrajectoryWriter(str(tmp_path / "port.txt")) as w:
        for k in range(5):
            w.write(stamps[k], Pose(torch.from_numpy(q[k]),
                                    torch.from_numpy(t[k])))
    with JWriter(str(tmp_path / "jax.txt")) as w:
        for k in range(5):
            w.write(stamps[k], JPose(jnp.asarray(q[k]), jnp.asarray(t[k])))
    assert ((tmp_path / "port.txt").read_text()
            == (tmp_path / "jax.txt").read_text())
    rows = trajectory_array([(stamps[k], Pose(torch.from_numpy(q[k]),
                                              torch.from_numpy(t[k])))
                             for k in range(5)])
    np.testing.assert_allclose(
        rows, np.loadtxt(tmp_path / "jax.txt"), rtol=0, atol=5e-7)


def test_associate_and_ate_match_jax():
    rng = np.random.default_rng(1)
    a = np.sort(rng.uniform(0, 10, 200))
    b = np.sort(np.concatenate([a[::2] + rng.normal(0, 0.01, 100),
                                rng.uniform(0, 10, 50)]))
    assert associate(a, b) == jassociate(a, b)
    assert associate(a, b, offset=0.005, max_difference=0.01) == \
        jassociate(a, b, offset=0.005, max_difference=0.01)

    q, t = _poses(40, 2)
    gt = np.concatenate([np.arange(40)[:, None] / 30.0, t, q[:, 1:],
                         q[:, :1]], axis=1).astype(np.float64)
    est = gt.copy()
    est[:, 1:4] += rng.normal(0, 0.01, (40, 3))
    for scale in (False, True):
        assert ate_rmse(est, gt, with_scale=scale) == \
            jate_rmse(est, gt, with_scale=scale)
