"""3D scene rendering: point clouds, landmark clouds, keyframe frusta,
trajectories (counterpart of modular_slam_tpu/viz/scene.py; numpy, and
matplotlib inside `render_scene`).

Reference parity: the OpenGL PointcloudViewer
(app/viewer/pointcloud_viewer.cpp — current-frame cloud, landmark
points, keyframe frusta with wireframe) and SlamThread's full-frame
RGB-D unprojection for display (slam_thread.cpp:125-161).  Rendered
headless with matplotlib (PNG snapshots); interactive live view is the
web viewer (viz/server.py); full-map export for external tools is PLY
(eval/ply.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from modular_slam_tpu_torch.config import CameraConfig


def pointcloud_from_rgbd(
    rgb: np.ndarray,
    depth: np.ndarray,
    cam: CameraConfig,
    pose_q: Optional[np.ndarray] = None,
    pose_t: Optional[np.ndarray] = None,
    stride: int = 4,
    max_depth: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Unproject an RGB-D frame to a colored world-space cloud.

    Mirrors SlamThread::pointCloudFromRgbd (slam_thread.cpp:125-161) but
    vectorized and subsampled by `stride`.  Returns (points [N,3] f32,
    colors [N,3] uint8).
    """
    d = np.asarray(depth, np.float32)[::stride, ::stride]
    c = np.asarray(rgb, np.uint8)[::stride, ::stride]
    h, w = d.shape
    vs, us = np.mgrid[0:h, 0:w].astype(np.float32)
    us = us * stride
    vs = vs * stride
    ok = (d > 0.0) & (d <= max_depth)
    z = d[ok]
    x = (us[ok] - cam.cx) * z / cam.fx
    y = (vs[ok] - cam.cy) * z / cam.fy
    pts = np.stack([x, y, z], axis=-1)
    if pose_q is not None and pose_t is not None:
        pts = _rotate(np.asarray(pose_q, np.float32), pts) + np.asarray(
            pose_t, np.float32)
    return pts.astype(np.float32), c[ok]


def _rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate [N,3] by a wxyz quaternion (numpy twin of se3.quat_rotate)."""
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return v @ R.T


def frustum_lines(
    pose_q: np.ndarray, pose_t: np.ndarray, cam: CameraConfig,
    scale: float = 0.1,
) -> np.ndarray:
    """Wireframe camera frustum as world-space segments [16, 2, 3]
    (KeyframesDrawable parity, pointcloud_viewer.cpp:258)."""
    x = scale * (cam.width / 2.0) / cam.fx
    y = scale * (cam.height / 2.0) / cam.fy
    apex = np.zeros(3, np.float32)
    corners = np.array([
        [-x, -y, scale], [x, -y, scale], [x, y, scale], [-x, y, scale],
    ], np.float32)
    pts = np.vstack([apex[None], corners])
    pts = _rotate(np.asarray(pose_q, np.float32), pts) + np.asarray(
        pose_t, np.float32)
    a, c0, c1, c2, c3 = pts
    segs = [
        (a, c0), (a, c1), (a, c2), (a, c3),
        (c0, c1), (c1, c2), (c2, c3), (c3, c0),
    ]
    return np.stack([np.stack(s) for s in segs])


def _host(x) -> np.ndarray:
    """A numpy copy of an arena field (a tensor of the port, on any
    device, or an array)."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def render_scene(
    path: str,
    arena=None,
    trajectory: Optional[np.ndarray] = None,
    cloud: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    cam: Optional[CameraConfig] = None,
    frustum_scale: float = 0.1,
    max_cloud_points: int = 60000,
    elev: float = -60.0,
    azim: float = -90.0,
) -> str:
    """Headless 3D snapshot: landmark cloud + keyframe frusta (+ optional
    current-frame colored cloud + trajectory line) -> PNG at `path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 6), dpi=110)
    ax = fig.add_subplot(111, projection="3d")

    if cloud is not None:
        pts, cols = cloud
        if len(pts) > max_cloud_points:
            sel = np.random.default_rng(0).choice(
                len(pts), max_cloud_points, replace=False)
            pts, cols = pts[sel], cols[sel]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2],
                   c=cols.astype(np.float32) / 255.0, s=0.3, linewidths=0)

    if arena is not None:
        lm = _host(arena.lm_pos)[_host(arena.lm_valid)]
        if len(lm):
            ax.scatter(lm[:, 0], lm[:, 1], lm[:, 2], c="#d4a017", s=1.5,
                       linewidths=0, label=f"{len(lm)} landmarks")
        if cam is not None:
            kf_valid = _host(arena.kf_valid)
            kf_q = _host(arena.kf_q)
            kf_t = _host(arena.kf_t)
            for i in np.flatnonzero(kf_valid):
                segs = frustum_lines(kf_q[i], kf_t[i], cam, frustum_scale)
                for s in segs:
                    ax.plot(s[:, 0], s[:, 1], s[:, 2], c="#2a6fdb", lw=0.6)

    if trajectory is not None and len(trajectory):
        t = np.asarray(trajectory, np.float32)
        ax.plot(t[:, 0], t[:, 1], t[:, 2], c="#c0392b", lw=1.2,
                label="trajectory")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.view_init(elev=elev, azim=azim)
    try:
        ax.set_box_aspect((1, 1, 1))
    except Exception:
        pass
    if arena is not None or trajectory is not None:
        ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path
