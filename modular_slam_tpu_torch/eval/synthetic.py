"""Synthetic RGB-D sequences with exact ground truth, numpy-only
(counterpart of modular_slam_tpu/eval/synthetic.py, which imports jax).

- `PlaneSceneGenerator`: a textured plane at z = plane_z viewed by a
  moving pinhole camera, rendered by exact ray-plane intersection;
- `BoxSceneGenerator`: a back wall, a floor and textured boxes at several
  depths, ray-cast with a z-buffer (occlusion, parallax, several surface
  orientations);
- `DegradedScene`: any scene with photometric noise, exposure jitter,
  motion blur and a moving near distractor; ground truth stays exact.

The quaternion helpers below repeat the JAX package's float32 arithmetic,
so for the same seed and poses both packages render the same frames (a
test holds them equal).  Poses are `Pose` NamedTuples of float32 numpy
arrays (q wxyz, t).  `depth_noise` adds the JAX generators' per-pixel
Gaussian depth noise, drawn from the same generator (`default_rng(seed +
1)`) in the same order, so odometry accumulates drift for loop closure to
correct.  OpenCV, where installed, blurs the texture and the degraded
frames as in the JAX package; without it neither is blurred.
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


class _SceneBase:
    """Trajectory helpers and frame iteration shared by the scenes."""

    camera: CameraConfig

    def render(self, pose: Pose) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

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


class PlaneSceneGenerator(_SceneBase):
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


class DegradedScene(_SceneBase):
    """Degrades any scene's frames toward real sensor conditions, per frame:

    - a moving textured distractor pasted over the render at its own near
      depth (a dynamic object whose features match from frame to frame
      but whose 3D position contradicts the static world);
    - motion blur along a per-frame direction (where OpenCV is installed);
    - exposure jitter (multiplicative gain and additive bias) and
      photometric Gaussian noise.

    Ground-truth poses stay exact; only the observations degrade."""

    def __init__(self, base: _SceneBase, seed: int = 0,
                 noise_std: float = 4.0, exposure_jitter: float = 0.12,
                 blur_len: int = 5, distractor_size: int = 56,
                 distractor_speed: float = 9.0,
                 distractor_depth: float = 0.9):
        self.base = base
        self.camera = base.camera
        self.noise_std = noise_std
        self.exposure_jitter = exposure_jitter
        self.blur_len = int(blur_len)
        self.distractor_size = int(distractor_size)
        self.distractor_speed = float(distractor_speed)
        self.distractor_depth = float(distractor_depth)
        self._rng = np.random.default_rng(seed + 101)
        self._k = 0  # frame counter (render() is called once per frame)
        s = self.distractor_size
        self._sprite = _texture(max(s, 16), seed + 13)[:s, :s]

    def _blur_kernel(self, rng) -> np.ndarray:
        """A normalized line of blur_len taps at a random angle."""
        L = self.blur_len
        kern = np.zeros((L, L), np.float32)
        ang = float(rng.uniform(0, np.pi))
        c, s_ = np.cos(ang), np.sin(ang)
        for i in range(L):
            u = (i - (L - 1) / 2)
            kern[int(round((L - 1) / 2 + u * s_)),
                 int(round((L - 1) / 2 + u * c))] = 1.0
        return kern / kern.sum()

    def render(self, pose: Pose) -> Tuple[np.ndarray, np.ndarray]:
        rgb, depth = self.base.render(pose)
        gray = rgb[..., 0].astype(np.float32)
        H, W = gray.shape
        rng = self._rng
        k = self._k
        self._k += 1

        # the distractor bounces horizontally and drifts vertically
        s = self.distractor_size
        span_x = max(W - s, 1)
        x = int(abs((k * self.distractor_speed) % (2 * span_x) - span_x))
        y = int((H - s) * 0.25 + 0.5 * (H - s) * 0.5
                * (1 + np.sin(k * 0.21)))
        gray[y:y + s, x:x + s] = self._sprite
        depth = depth.copy()
        depth[y:y + s, x:x + s] = self.distractor_depth

        if self.blur_len > 1:
            try:
                import cv2
            except ImportError:
                cv2 = None
            if cv2 is not None:
                # the angle is drawn only when the blur runs, as in JAX
                gray = cv2.filter2D(gray, -1, self._blur_kernel(rng))

        gain = float(np.exp(rng.normal(0.0, self.exposure_jitter)))
        bias = float(rng.normal(0.0, 4.0))
        gray = gain * gray + bias
        if self.noise_std > 0:
            gray = gray + rng.normal(0.0, self.noise_std, gray.shape)
        gray = np.clip(gray, 0.0, 255.0).astype(np.float32)
        rgb = np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)
        return rgb, depth


class BoxSceneGenerator(_SceneBase):
    """A room: a back wall, a floor and textured boxes at several depths,
    ray-cast with a z-buffer.  Every pixel is an analytic ray-rectangle
    intersection, so ground truth stays exact, and the scene has depth
    layers, occlusion boundaries that move with parallax, and surfaces at
    several orientations (the plane has none of these).

    Rectangles are (origin, eu, ev, su, sv, tex_off): the surface spans
    origin + u*eu + v*ev for u in [0, su], v in [0, sv], each with its own
    window into the shared texture.  Camera convention: +z forward, +y
    down (the floor at +y)."""

    def __init__(self, camera: CameraConfig | None = None,
                 n_boxes: int = 6, texture_ppm: float = 400.0,
                 texture_size: int = 4096, seed: int = 0,
                 depth_noise: float = 0.0):
        self.camera = camera or CameraConfig()
        self.ppm = texture_ppm
        self.tex = _texture(texture_size, seed)
        self.depth_noise = depth_noise
        self._noise_rng = np.random.default_rng(seed + 1)
        rng = np.random.default_rng(seed + 7)

        ex = np.array([1.0, 0.0, 0.0])
        ey = np.array([0.0, 1.0, 0.0])
        ez = np.array([0.0, 0.0, 1.0])
        T = texture_size

        def off():
            return (float(rng.integers(0, T // 2)),
                    float(rng.integers(0, T // 2)))

        rects = [
            # back wall z = 3.2, floor y = +1.0
            (np.array([-5.0, -2.0, 3.2]), ex, ey, 10.0, 4.0, off()),
            (np.array([-5.0, 1.0, 0.3]), ex, ez, 10.0, 4.0, off()),
        ]
        for _ in range(n_boxes):
            s = float(rng.uniform(0.3, 0.6))        # footprint
            h = float(rng.uniform(0.4, 0.9))        # height
            xc = float(rng.uniform(-2.2, 2.2))
            zf = float(rng.uniform(1.3, 2.6))       # front face depth
            y_top = 1.0 - h                         # resting on the floor
            o = np.array([xc - s / 2, y_top, zf])
            # front face (facing the camera), top face, one side face
            rects.append((o, ex, ey, s, h, off()))
            rects.append((o, ex, ez, s, s, off()))
            side_x = xc + s / 2 if xc < 0 else xc - s / 2
            rects.append((np.array([side_x, y_top, zf]), ez, ey, s, h,
                          off()))
        self.rects = rects

    def render(self, pose: Pose) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb [H,W,3] uint8, depth [H,W] float32 meters), the nearest
        surface per pixel."""
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

        zbuf = np.full((H, W), np.inf)
        gray = np.zeros((H, W), np.float32)
        Th, Tw = self.tex.shape
        for (o, eu, ev, su, sv, (ox, oy)) in self.rects:
            n = np.cross(eu, ev)
            dn = dirs_world @ n
            lam = ((o - t) @ n) / np.where(np.abs(dn) < 1e-9, 1e-9, dn)
            pts = t[None, None, :] + lam[..., None] * dirs_world
            rel = pts - o
            u = rel @ eu
            v = rel @ ev
            hit = ((lam > 0.05) & (lam < zbuf)
                   & (u >= 0) & (u <= su) & (v >= 0) & (v <= sv))
            tex_x = np.clip(u * self.ppm + ox, 0, Tw - 1.001)
            tex_y = np.clip(v * self.ppm + oy, 0, Th - 1.001)
            x0 = tex_x.astype(np.int64)
            y0 = tex_y.astype(np.int64)
            fx_ = tex_x - x0
            fy_ = tex_y - y0
            val = (self.tex[y0, x0] * (1 - fx_) * (1 - fy_)
                   + self.tex[y0, x0 + 1] * fx_ * (1 - fy_)
                   + self.tex[y0 + 1, x0] * (1 - fx_) * fy_
                   + self.tex[y0 + 1, x0 + 1] * fx_ * fy_)
            gray = np.where(hit, val, gray).astype(np.float32)
            zbuf = np.where(hit, lam, zbuf)

        seen = np.isfinite(zbuf)
        # lam along a direction whose camera z is 1 is the camera z-depth
        depth = np.where(seen, zbuf, 0.0).astype(np.float32)
        if self.depth_noise > 0.0:
            noise = self._noise_rng.normal(
                0.0, self.depth_noise, depth.shape).astype(np.float32)
            depth = np.where(depth > 0, np.maximum(depth + noise, 0.05),
                             0.0)
        rgb = np.repeat(np.where(seen, gray, 0.0)[..., None], 3,
                        axis=-1).astype(np.uint8)
        return rgb, depth
