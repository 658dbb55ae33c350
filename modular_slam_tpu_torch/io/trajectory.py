"""Trajectory export in TUM format (counterpart of the TUM writer in
modular_slam_tpu/io/trajectory.py): `timestamp x y z qx qy qz qw`."""

from __future__ import annotations

from typing import IO, Optional

import numpy as np

from modular_slam_tpu_torch.geometry.se3 import Pose


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


def trajectory_array(trajectory) -> np.ndarray:
    """[(timestamp, Pose)] -> [N, 8] TUM rows, as the writer orders them."""
    rows = []
    for ts, p in trajectory:
        q, t = _np(p.q), _np(p.t)
        rows.append([ts, t[0], t[1], t[2], q[1], q[2], q[3], q[0]])
    return np.array(rows, dtype=np.float64).reshape(-1, 8)
