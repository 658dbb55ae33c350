"""Observation overlay + depth colormap renderers (counterpart of
modular_slam_tpu/viz/overlay.py).

Reference parity:
- ImageViewer::drawObservations (image_viewer.cpp:27-58): red dot at each
  frame keypoint, blue dot at the projected matched landmark, green line
  connecting the pair.
- DepthImageViewer (depth_image_viewer.cpp:9-44): depth scaled between
  user min/max then COLORMAP_HOT.

The per-frame overlay *data* (keypoint <-> projected landmark pairs) is
computed on the device by re-running the tracking-path matcher (the
covisibility gating of frontend/tracker.py) against the current arena
and projecting the matched landmarks through the current pose.  On CUDA
tensors the matcher is kernel K2 and its merge (ops/match.py), which
equal the JAX overlay's XLA matcher exactly; on CPU tensors its plain
version.  Drawing is host-side numpy (no OpenCV/Qt dependency).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import (camera_from_config,
                                                    project_world)
from modular_slam_tpu_torch.map.arena import khop_keyframes, visible_landmarks
from modular_slam_tpu_torch.ops import match as match_ops

Tensor = torch.Tensor


class OverlayData(NamedTuple):
    """Matched observation pairs for one frame.

    kp_uv: [N, 2] float32 — keypoint pixels
    lm_uv: [N, 2] float32 — matched landmark projected through the pose
    valid: [N] bool
    """

    kp_uv: Tensor
    lm_uv: Tensor
    valid: Tensor


def make_overlay_fn(cfg: SlamConfig, device="cuda"):
    """(arena, state, feats) -> OverlayData, on `device` (the card unless
    the caller asks for the CPU)."""
    # imported here: io/tum.py reads PNGs through viz/png.py, and the
    # engine imports io/tum.py
    from modular_slam_tpu_torch.engine import _resolve_device

    cam = camera_from_config(cfg.camera, _resolve_device(device))

    def overlay(arena, state, feats):
        kps = feats.keypoints
        kf_mask = khop_keyframes(
            arena, state.ref_kf, cfg.tracker.covis_depth_tracking)
        lm_mask = visible_landmarks(arena, kf_mask)
        matches = match_ops.match_descriptors(
            feats.descriptors.unpacked, kps.valid, arena.lm_desc, lm_mask,
            cfg.matcher)
        matches = match_ops.dedupe_matches(matches, arena.max_landmarks)
        pts_world = arena.lm_pos[matches.lm_slot.long()]
        lm_uv = project_world(cam, state.pose, pts_world)
        inside = (
            (lm_uv[:, 0] >= 0) & (lm_uv[:, 0] < cam.width)
            & (lm_uv[:, 1] >= 0) & (lm_uv[:, 1] < cam.height)
        )
        return OverlayData(
            kp_uv=kps.uv, lm_uv=lm_uv, valid=matches.valid & inside)

    return overlay


# ---------------------------------------------------------------------------
# host-side drawing (numpy)
# ---------------------------------------------------------------------------

_RED = np.array([235, 64, 52], np.uint8)
_BLUE = np.array([66, 135, 245], np.uint8)
_GREEN = np.array([52, 199, 89], np.uint8)


def _draw_disk(img: np.ndarray, x: float, y: float, r: int,
               color: np.ndarray) -> None:
    h, w = img.shape[:2]
    xi, yi = int(round(x)), int(round(y))
    y0, y1 = max(0, yi - r), min(h, yi + r + 1)
    x0, x1 = max(0, xi - r), min(w, xi + r + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - yi) ** 2 + (xx - xi) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def _draw_line(img: np.ndarray, x0: float, y0: float, x1: float, y1: float,
               color: np.ndarray) -> None:
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * t).astype(np.int64)
    ys = np.round(y0 + (y1 - y0) * t).astype(np.int64)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


def draw_observations(
    rgb: np.ndarray,
    kp_uv: np.ndarray,
    lm_uv: np.ndarray,
    valid: np.ndarray,
    radius: int = 2,
) -> np.ndarray:
    """Render the observation overlay onto a copy of the RGB frame.

    Colors follow image_viewer.cpp:43-54: keypoint red, projected
    landmark blue, connecting line green.
    """
    out = np.array(rgb, dtype=np.uint8, copy=True)
    kp_uv = np.asarray(kp_uv)
    lm_uv = np.asarray(lm_uv)
    for i in np.flatnonzero(np.asarray(valid)):
        kx, ky = float(kp_uv[i, 0]), float(kp_uv[i, 1])
        lx, ly = float(lm_uv[i, 0]), float(lm_uv[i, 1])
        _draw_line(out, kx, ky, lx, ly, _GREEN)
        _draw_disk(out, kx, ky, radius, _RED)
        _draw_disk(out, lx, ly, radius, _BLUE)
    return out


def draw_keypoints(rgb: np.ndarray, uv: np.ndarray, valid: np.ndarray,
                   radius: int = 2) -> np.ndarray:
    """Keypoints only (bootstrap frames, detector debugging)."""
    out = np.array(rgb, dtype=np.uint8, copy=True)
    uv = np.asarray(uv)
    for i in np.flatnonzero(np.asarray(valid)):
        _draw_disk(out, float(uv[i, 0]), float(uv[i, 1]), radius, _RED)
    return out


def depth_colormap(
    depth: np.ndarray,
    dmin: Optional[float] = None,
    dmax: Optional[float] = None,
) -> np.ndarray:
    """HOT-colormapped depth image (depth_image_viewer.cpp:9-44 parity:
    linear rescale between min/max, then the HOT ramp
    black->red->yellow->white).  Invalid depth (<= 0) renders black."""
    d = np.asarray(depth, np.float32)
    validm = d > 0.0
    if dmin is None:
        dmin = float(d[validm].min()) if validm.any() else 0.0
    if dmax is None:
        dmax = float(d[validm].max()) if validm.any() else 1.0
    scale = max(dmax - dmin, 1e-9)
    x = np.clip((d - dmin) / scale, 0.0, 1.0)
    r = np.clip(3.0 * x, 0.0, 1.0)
    g = np.clip(3.0 * x - 1.0, 0.0, 1.0)
    b = np.clip(3.0 * x - 2.0, 0.0, 1.0)
    img = (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)
    img[~validm] = 0
    return img
