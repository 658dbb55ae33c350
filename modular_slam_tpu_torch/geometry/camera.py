"""Pinhole camera model on tensors (counterpart of
modular_slam_tpu/geometry/camera.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from modular_slam_tpu_torch.config import CameraConfig
from modular_slam_tpu_torch.geometry.se3 import Pose, pose_apply_inverse

Tensor = torch.Tensor


class Camera(NamedTuple):
    """Intrinsics as 0-d float32 tensors on the device, so every product
    with them is a float32 product as in the JAX package."""

    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    width: int
    height: int


def camera_from_config(cfg: CameraConfig, device="cpu") -> Camera:
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return Camera(fx=f32(cfg.fx), fy=f32(cfg.fy), cx=f32(cfg.cx),
                  cy=f32(cfg.cy), width=cfg.width, height=cfg.height)


def project(cam: Camera, pts_cam: Tensor) -> Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2]."""
    z = pts_cam[..., 2:3]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-12,
                              torch.full_like(z, 1e-12), z)
    xy = pts_cam[..., :2] * inv_z
    f = torch.stack([cam.fx, cam.fy])
    pp = torch.stack([cam.cx, cam.cy])
    return xy * f + pp


def project_world(cam: Camera, pose: Pose, pts_world: Tensor) -> Tensor:
    return project(cam, pose_apply_inverse(pose, pts_world))


def backproject(cam: Camera, uv: Tensor, depth: Tensor) -> Tensor:
    """Pixels [..., 2] + depth [...] -> camera-frame 3D points [..., 3]."""
    z = depth
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)


def is_visible(cam: Camera, pts_cam: Tensor) -> Tensor:
    """Projects inside the image and z > 0."""
    uv = project(cam, pts_cam)
    inside = ((uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
              & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height))
    return inside & (pts_cam[..., 2] > 0.0)
