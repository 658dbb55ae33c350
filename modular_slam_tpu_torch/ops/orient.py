"""Intensity-centroid orientation (counterpart of
modular_slam_tpu/ops/orient.py; the patch-domain form only)."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from modular_slam_tpu_torch.utils.device import constant

Tensor = torch.Tensor

IC_RADIUS = 15  # 31 px patch


@lru_cache(maxsize=None)
def _mask_np(radius: int) -> np.ndarray:
    """[2r+1, 2r+1] 1.0 inside the discrete circle (u_max-style rows)."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    umax = np.floor(np.sqrt(radius * radius - ys.astype(np.float64) ** 2)
                    + 0.5)
    return (np.abs(xs) <= umax).astype(np.float32)


def ic_angle_from_patches(patches: Tensor, radius: int = IC_RADIUS) -> Tensor:
    """IC orientation [N] from patches [N, P, P] (P odd, P >= 2r+1,
    keypoint at the center): atan2 of the masked circular first moments
    of the unblurred patch."""
    P = patches.shape[-1]
    c = P // 2
    crop = patches[:, c - radius:c + radius + 1, c - radius:c + radius + 1]
    mask = constant(("ic_mask", radius), lambda: _mask_np(radius),
                    patches.device)
    coords = torch.arange(-radius, radius + 1, dtype=patches.dtype,
                          device=patches.device)
    w = crop * mask
    m10 = torch.sum(w * coords[None, None, :], dim=(1, 2))
    m01 = torch.sum(w * coords[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)
