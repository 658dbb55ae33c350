"""Synthetic RGB-D sequences with exact ground truth, numpy-only
(counterpart of `PlaneSceneGenerator` in modular_slam_tpu/eval/synthetic.py,
which imports jax).

A textured plane at z = plane_z is viewed by a moving pinhole camera and
rendered by exact ray-plane intersection.  The quaternion helpers below
repeat the JAX package's float32 arithmetic, so for the same seed and
poses both generators render the same frames (a test holds them equal).
Poses are `Pose` NamedTuples of float32 numpy arrays (q wxyz, t).
`depth_noise` adds the JAX generator's per-pixel Gaussian depth noise, drawn
from the same generator (`default_rng(seed + 1)`) in the same order, so
odometry accumulates drift for loop closure to correct.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from modular_slam_tpu_torch.config import CameraConfig
from modular_slam_tpu_torch.geometry.se3 import Pose

_F32 = np.float32


def _quat_normalize(q: np.ndarray) -> np.ndarray:
    n = np.sqrt(np.sum(q * q, dtype=_F32))
    q = q / np.maximum(n, _F32(1e-8))
    return -q if q[0] < 0 else q


def quat_from_axis_angle(aa: np.ndarray) -> np.ndarray:
    """so(3) vector [3] -> float32 quaternion (wxyz)."""
    aa = np.asarray(aa, _F32)
    theta2 = np.sum(aa * aa, dtype=_F32)
    small = theta2 < 1e-12
    theta = np.sqrt(_F32(1.0) if small else theta2)
    half = _F32(0.5) * theta
    if small:
        k = _F32(0.5) - theta2 / _F32(48.0)
        w = _F32(1.0) - theta2 / _F32(8.0)
    else:
        k = np.sin(half) / theta
        w = np.cos(half)
    return _quat_normalize(np.concatenate([[w], k * aa]).astype(_F32))


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """float32 quaternion (wxyz) -> float32 rotation matrix [3, 3]."""
    w, x, y, z = (_F32(v) for v in q)
    one, two = _F32(1.0), _F32(2.0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.array([
        one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
        two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
        two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
    ], _F32).reshape(3, 3)


def _texture(size: int, seed: int) -> np.ndarray:
    """High-contrast blobby texture with plenty of corners."""
    rng = np.random.default_rng(seed)
    tex = np.full((size, size), 128.0, np.float32)
    n = (size // 8) ** 2
    ys = rng.integers(0, size - 12, n)
    xs = rng.integers(0, size - 12, n)
    for y, x in zip(ys, xs):
        s = int(rng.integers(3, 10))
        tex[y:y + s, x:x + s] = float(rng.uniform(0, 255))
    try:
        import cv2

        tex = cv2.GaussianBlur(tex, (3, 3), 0.8)
    except ImportError:
        pass
    return tex


class PlaneSceneGenerator:
    """Render RGB-D frames of a textured plane from arbitrary poses."""

    def __init__(self, camera: CameraConfig | None = None,
                 plane_z: float = 2.0, texture_ppm: float = 400.0,
                 texture_size: int = 4096, seed: int = 0,
                 depth_noise: float = 0.0):
        self.camera = camera or CameraConfig()
        self.plane_z = plane_z
        self.ppm = texture_ppm  # texture pixels per meter
        self.tex = _texture(texture_size, seed)
        self.depth_noise = depth_noise  # meters, per pixel
        self._noise_rng = np.random.default_rng(seed + 1)

    # -- trajectories ---------------------------------------------------------
    def trajectory(self, n_frames: int, step_t=(0.02, 0.0, 0.0),
                   step_rot=(0.0, 0.0, 0.0)) -> List[Pose]:
        return [Pose(q=quat_from_axis_angle(np.array(step_rot) * k),
                     t=np.asarray(np.array(step_t) * k, _F32))
                for k in range(n_frames)]

    def loop_trajectory(self, n_frames: int, radius: float = 0.6,
                        center=(0.0, 0.0)) -> List[Pose]:
        """Closed circular loop in the x-y plane facing the scene."""
        poses = []
        for k in range(n_frames):
            a = 2.0 * np.pi * k / n_frames
            t = np.asarray([center[0] + radius * np.sin(a),
                            center[1] + radius * (1.0 - np.cos(a)), 0.0], _F32)
            poses.append(Pose(q=np.asarray([1.0, 0.0, 0.0, 0.0], _F32), t=t))
        return poses

    def yaw_trajectory(self, n_frames: int, step_yaw_deg: float = 1.5,
                       step_t=(0.0, 0.0, 0.0)) -> List[Pose]:
        """Incremental yaw, optionally with translation."""
        return [Pose(q=quat_from_axis_angle(
                         [0.0, np.deg2rad(step_yaw_deg) * k, 0.0]),
                     t=np.asarray(np.array(step_t) * k, _F32))
                for k in range(n_frames)]

    def sequence(self, poses: List[Pose]):
        """Yield (rgb, depth, timestamp) frames at 30 Hz."""
        for k, p in enumerate(poses):
            rgb, depth = self.render(p)
            yield rgb, depth, float(k) / 30.0

    # -- rendering ------------------------------------------------------------
    def render(self, pose: Pose) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb [H,W,3] uint8, depth [H,W] float32 meters)."""
        cam = self.camera
        H, W = cam.height, cam.width
        R = quat_to_matrix(np.asarray(pose.q, _F32)).astype(np.float64)
        t = np.asarray(pose.t, np.float64)

        us, vs = np.meshgrid(np.arange(W, dtype=np.float64),
                             np.arange(H, dtype=np.float64))
        dirs_cam = np.stack(
            [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
             np.ones_like(us)], axis=-1)
        dirs_world = dirs_cam @ R.T
        rz = dirs_world[..., 2]
        lam = (self.plane_z - t[2]) / np.where(np.abs(rz) < 1e-9, 1e-9, rz)
        hit = lam > 0.05
        pts = t[None, None, :] + lam[..., None] * dirs_world

        tex_x = pts[..., 0] * self.ppm + self.tex.shape[1] / 2
        tex_y = pts[..., 1] * self.ppm + self.tex.shape[0] / 2
        inside = (hit & (tex_x >= 0) & (tex_x < self.tex.shape[1] - 1)
                  & (tex_y >= 0) & (tex_y < self.tex.shape[0] - 1))

        x0 = np.clip(tex_x.astype(np.int64), 0, self.tex.shape[1] - 2)
        y0 = np.clip(tex_y.astype(np.int64), 0, self.tex.shape[0] - 2)
        fx_ = np.clip(tex_x - x0, 0, 1)
        fy_ = np.clip(tex_y - y0, 0, 1)
        t00 = self.tex[y0, x0]
        t01 = self.tex[y0, x0 + 1]
        t10 = self.tex[y0 + 1, x0]
        t11 = self.tex[y0 + 1, x0 + 1]
        val = (t00 * (1 - fx_) * (1 - fy_) + t01 * fx_ * (1 - fy_)
               + t10 * (1 - fx_) * fy_ + t11 * fx_ * fy_)
        gray = np.where(inside, val, 0.0).astype(np.float32)

        depth = np.where(inside, lam, 0.0).astype(np.float32)
        if self.depth_noise > 0.0:
            noise = self._noise_rng.normal(
                0.0, self.depth_noise, depth.shape).astype(np.float32)
            depth = np.where(depth > 0, np.maximum(depth + noise, 0.05), 0.0)
        rgb = np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)
        return rgb, depth
