"""Intensity-centroid orientation (counterpart of
modular_slam_tpu/ops/orient.py).

Reference: orb_impl::ic_angle over a 31px circular patch
(distributed_cv_feature.cpp:543-570, u_max_ rows :522-541), with an exact
atan2.  The detector uses the patch-domain form
(`ic_angle_from_patches`); `ic_angle` reads the patches from an image and
`moment_maps` gives the dense moments of every pixel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

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


def gather_patches(img: Tensor, yx: Tensor, size: int) -> Tensor:
    """Gather [N, size, size] patches centered at integer yx [N, 2] (y, x).

    Starts are clamped to the image, so callers must mask out keypoints
    whose patch would cross the border (detector border >= radius)."""
    h, w = img.shape
    r = size // 2
    d = torch.arange(size, device=img.device)
    sy = torch.clamp(yx[:, 0].long() - r, 0, h - size)
    sx = torch.clamp(yx[:, 1].long() - r, 0, w - size)
    rows = (sy[:, None] + d[None, :])[:, :, None]
    cols = (sx[:, None] + d[None, :])[:, None, :]
    return img[rows, cols]


def ic_angle(img: Tensor, yx: Tensor, radius: int = IC_RADIUS) -> Tensor:
    """IC orientation [N] (radians) for keypoints at integer yx [N, 2]."""
    return ic_angle_from_patches(gather_patches(img, yx, 2 * radius + 1),
                                 radius)


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


def moment_maps(img: Tensor, radius: int = IC_RADIUS) -> Tensor:
    """Dense IC moment maps, channels first: [2, H, W] = (m10, m01).

    The JAX package's row-strip prefix sums: per row offset dy the circle
    spans x in [-u(dy), u(dy)], and with P = prefix(I) and T = prefix(x*I)
    along x each strip sum is a difference of two shifted columns:
        m10(y,x) = sum_dy [T-window - x * P-window](y+dy, x)
        m01(y,x) = sum_dy dy * [P-window](y+dy, x)
    The shifts are rolls, which wrap: the fringe of radius + 1 pixels
    along each edge holds no moment and is never read (it lies inside the
    detector border)."""
    H, W = img.shape
    xs = torch.arange(W, dtype=img.dtype, device=img.device)
    # padded prefix sums: Cp[:, k] = sum img[:, :k]  ([H, W+1])
    Cp = F.pad(torch.cumsum(img, dim=1), (1, 0))
    Tp = F.pad(torch.cumsum(img * xs[None, :], dim=1), (1, 0))

    mask = _mask_np(radius)
    u_of = [int(mask[radius + dy].sum() // 2) for dy in range(radius + 1)]

    def window(Ap: Tensor, u: int) -> Tensor:
        """Ap[:, x+u+1] - Ap[:, x-u] for every x (strip sum over 2u+1)."""
        hi = torch.roll(Ap, -(u + 1), dims=1)[:, :W]
        lo = torch.roll(Ap, u, dims=1)[:, :W]
        return hi - lo

    strips = {}
    for u in sorted(set(u_of)):
        s = window(Cp, u)                       # sum I over the strip
        strips[u] = (s, window(Tp, u) - xs[None, :] * s)  # sum (x'-x) I

    m10 = torch.zeros_like(img)
    m01 = torch.zeros_like(img)
    for dy in range(-radius, radius + 1):
        s, mx = strips[u_of[abs(dy)]]
        if dy == 0:
            m10 = m10 + mx
        else:
            m10 = m10 + torch.roll(mx, -dy, dims=0)
            m01 = m01 + float(dy) * torch.roll(s, -dy, dims=0)
    return torch.stack([m10, m01], dim=0)
