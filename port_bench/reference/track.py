"""Plain RGB-D PnP: the yardstick for the poses the port's matcher (K2
and its merge) and RANSAC-PnP give.

`refit_poses` is the Gauss-Newton optimum, for many frames at once, of
the configuration's hybrid residual on given correspondences: pixel
error in u and v, and 0.25 fx / z times the depth error, as the port's
PnP and BA define it.  `gate_misses` counts correspondences outside the
configuration's PnP gates (5 px, 0.25 m) at a pose.  Poses are compared
by where they put the camera centre and the corners of the view
(`view_points`, `pose_gap_m`).

`dtype` is the precision of the arithmetic: float64 for the reference,
bfloat16 for the control (its 6x6 solves in float32, which PyTorch's
solvers need).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class PnpSettings(NamedTuple):
    inlier_px: float = 5.0
    depth_inlier_m: float = 0.25
    depth_weight: float = 0.25


def _skew(p: Tensor) -> Tensor:
    z = torch.zeros_like(p[..., 0])
    return torch.stack([z, -p[..., 2], p[..., 1], p[..., 2], z, -p[..., 0],
                        -p[..., 1], p[..., 0], z], -1).reshape(*p.shape[:-1], 3, 3)


def rodrigues_batch(w: Tensor) -> Tensor:
    """Rotation vectors [M, 3] -> matrices [M, 3, 3] (no host read)."""
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    K = _skew(w / torch.clamp(th, min=1e-300))
    s, c = torch.sin(th)[..., None], torch.cos(th)[..., None]
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * K + (1 - c) * (K @ K)


def view_points(cam, depth_m: float = 2.0) -> np.ndarray:
    """The camera centre and the four corners of the view at `depth_m`,
    camera frame [5, 3]: where two poses put these is how far apart they
    are in what the camera sees."""
    fx, fy, cx, cy, w, h = cam
    xs = (np.array([0.0, w - 1.0]) - cx) / fx * depth_m
    ys = (np.array([0.0, h - 1.0]) - cy) / fy * depth_m
    return np.array([[0.0, 0.0, 0.0]] + [[x, y, depth_m] for x in xs for y in ys])


def pose_gap_m(R_a, t_a, R_b, t_b, pts: np.ndarray) -> float:
    """Largest distance between where two camera-to-world poses put the
    camera-frame points `pts`."""
    a = pts @ np.asarray(R_a, np.float64).T + np.asarray(t_a, np.float64)
    b = pts @ np.asarray(R_b, np.float64).T + np.asarray(t_b, np.float64)
    return float(np.max(np.linalg.norm(a - b, axis=1)))


def quat_to_matrix(q) -> np.ndarray:
    """wxyz quaternion -> rotation matrix, float64."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(np.asarray(q, np.float64))
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrices [..., 3, 3] -> wxyz quaternions [..., 4] (w >= 0)."""
    R = np.asarray(R, np.float64)
    out = np.empty(R.shape[:-2] + (4,))
    flat_R, flat_q = R.reshape(-1, 3, 3), out.reshape(-1, 4)
    for i, m in enumerate(flat_R):
        tr = np.trace(m)
        if tr > 0:
            s = np.sqrt(tr + 1.0) * 2
            q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                 (m[1, 0] - m[0, 1]) / s]
        elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
            s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
            q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
                 (m[0, 2] + m[2, 0]) / s]
        elif m[1, 1] > m[2, 2]:
            s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
            q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
                 (m[1, 2] + m[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
            q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                 (m[1, 2] + m[2, 1]) / s, 0.25 * s]
        q = np.asarray(q)
        flat_q[i] = -q if q[0] < 0 else q
    return out


def refit_poses(pw: Tensor, uv: Tensor, z: Tensor, w: Tensor, R_init: Tensor,
                t_init: Tensor, cam, iters: int = 20, depth_weight: float = 0.25,
                dtype: torch.dtype = torch.float64):
    """Gauss-Newton optima of the hybrid residual for M frames at once:
    landmarks pw [M, N, 3] seen at uv [M, N, 2] with depth z [M, N],
    weights w [M, N] (0 pads), from camera-to-world starts R_init
    [M, 3, 3], t_init [M, 3].  -> (R, t) camera-to-world, float64."""
    s = PnpSettings(depth_weight=depth_weight)
    cam_t = torch.tensor(cam, dtype=dtype, device=pw.device)
    pw, uv, z, w = pw.to(dtype), uv.to(dtype), z.to(dtype), w.to(dtype)
    R_cw = R_init.transpose(1, 2).to(dtype)
    t_cw = -torch.einsum("mij,mj->mi", R_cw, t_init.to(dtype))
    eye3 = torch.eye(3, dtype=dtype, device=pw.device)
    M, N = z.shape
    for _ in range(iters):
        pc = torch.einsum("mij,mnj->mni", R_cw, pw) + t_cw[:, None]
        inv_z = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
        u = pc[..., 0] * inv_z * cam_t[0] + cam_t[2]
        v = pc[..., 1] * inv_z * cam_t[1] + cam_t[3]
        w_d = s.depth_weight * cam_t[0] / torch.clamp(z, min=0.1)
        r = torch.stack([uv[..., 0] - u, uv[..., 1] - v, w_d * (z - pc[..., 2])], -1)
        fxz, fyz = cam_t[0] * inv_z, cam_t[1] * inv_z
        zero = torch.zeros_like(fxz)
        Jproj = torch.stack([
            torch.stack([fxz, zero, -fxz * pc[..., 0] * inv_z], -1),
            torch.stack([zero, fyz, -fyz * pc[..., 1] * inv_z], -1),
            torch.stack([zero, zero, w_d], -1)], -2)            # [M, N, 3, 3]
        Jxi = torch.cat([eye3.expand(M, N, 3, 3), -_skew(pc)], -1)
        J = -(Jproj @ Jxi)                                      # [M, N, 3, 6]
        Jw = J * w[..., None, None]
        H = torch.einsum("mnik,mnil->mkl", Jw, J).float() + 1e-6 * torch.eye(
            6, device=pw.device)
        g = torch.einsum("mnik,mni->mk", Jw, r).float()
        xi = -torch.linalg.solve(H, g)                          # [M, 6]
        dR = rodrigues_batch(xi[:, 3:].double()).to(dtype)
        R_cw = dR @ R_cw
        t_cw = torch.einsum("mij,mj->mi", dR, t_cw) + xi[:, :3].to(dtype)
    R_cw, t_cw = R_cw.double(), t_cw.double()
    R = R_cw.transpose(1, 2)
    return R, -torch.einsum("mij,mj->mi", R, t_cw)


def gate_misses(pw: Tensor, uv: Tensor, z: Tensor, w: Tensor, R: Tensor,
                t: Tensor, cam, s: PnpSettings = PnpSettings()) -> Tensor:
    """[M] count of the weighted correspondences (as `refit_poses` takes
    them) outside the PnP gates (5 px, 0.25 m) at camera-to-world poses
    (R [M, 3, 3], t [M, 3]), in float64."""
    d = torch.float64
    cam_t = torch.tensor(cam, dtype=d, device=pw.device)
    R_cw = R.to(d).transpose(1, 2)
    t_cw = -torch.einsum("mij,mj->mi", R_cw, t.to(d))
    pc = torch.einsum("mij,mnj->mni", R_cw, pw.to(d)) + t_cw[:, None]
    inv_z = 1.0 / torch.clamp(pc[..., 2], min=1e-6)
    du = uv[..., 0].to(d) - (pc[..., 0] * inv_z * cam_t[0] + cam_t[2])
    dv = uv[..., 1].to(d) - (pc[..., 1] * inv_z * cam_t[1] + cam_t[3])
    inside = ((pc[..., 2] > 0) & (du * du + dv * dv < s.inlier_px ** 2)
              & (torch.abs(pc[..., 2] - z.to(d)) < s.depth_inlier_m))
    return torch.sum((w > 0) & ~inside, dim=1)
