"""Trajectory export in TUM and KITTI formats, and the TUM reader
(counterpart of modular_slam_tpu/io/trajectory.py):
- TUM: `timestamp x y z qx qy qz qw` per line;
- KITTI: the row-major 3x4 [R|t] per line."""

from __future__ import annotations

from typing import IO, Optional

import numpy as np

import torch

from modular_slam_tpu_torch.geometry.se3 import Pose, quat_to_matrix
from modular_slam_tpu_torch.io.tum import _read_trajectory_file


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class TumTrajectoryWriter:
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO] = open(path, "w")

    def write(self, timestamp: float, pose: Pose) -> None:
        q = _np(pose.q)  # wxyz
        t = _np(pose.t)
        self._f.write(
            f"{timestamp:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
            f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class KittiTrajectoryWriter:
    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO] = open(path, "w")

    def write(self, timestamp: float, pose: Pose) -> None:
        # the rotation in float32, as the JAX writer computes it
        q = torch.as_tensor(_np(pose.q), dtype=torch.float32)
        R = quat_to_matrix(q).numpy().astype(np.float64)
        m = np.concatenate([R, _np(pose.t)[:, None]], axis=1).reshape(-1)
        self._f.write(" ".join(f"{v:.9f}" for v in m) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tum_trajectory(path: str) -> np.ndarray:
    """Read a TUM trajectory file -> [N, 8] (t x y z qx qy qz qw)."""
    return _read_trajectory_file(path)


def trajectory_array(trajectory) -> np.ndarray:
    """[(timestamp, Pose)] -> [N, 8] TUM rows, as the writer orders them."""
    rows = []
    for ts, p in trajectory:
        q, t = _np(p.q), _np(p.t)
        rows.append([ts, t[0], t[1], t[2], q[1], q[2], q[3], q[0]])
    return np.array(rows, dtype=np.float64).reshape(-1, 8)
