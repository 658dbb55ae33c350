"""Rotated BRIEF-256 (counterpart of modular_slam_tpu/ops/brief.py).

Reference: steered BRIEF over a blurred level image with a 256-pair
pattern (distributed_cv_feature.cpp:572-630): each bit is
I(p + R(theta) a_i) < I(p + R(theta) b_i) with rotated, rounded offsets,
over the package's own deterministic pattern (ops/brief_pattern.py).

Two formulations, as in the JAX package:
- continuous rotation (`rotated_offsets`, `brief_descriptors` on one
  blurred image, `brief_from_atlas` on a pyramid atlas) — the reference
  semantics;
- angle-binned, the detector's: the angle is quantized to 32 bins (the
  ORB paper steers BRIEF with a 2*pi/30 lookup table) and the patch
  rounded to 8-bit intensities.  The JAX package turns every random
  access into MXU work: patches are cut with a one-hot column matmul
  (`extract_patches_matmul`) and the 512 rotated sample points are read
  with an int8 matmul against one-hot selectors per angle bin
  (`brief_matmul_from_patches`).  Both are exact copies of pixels, so
  here they are plain gathers: `extract_patches` and `brief_from_patches`
  give the same values and the same bits, and the JAX names are bound to
  them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from modular_slam_tpu_torch.ops.brief_pattern import PATTERN
from modular_slam_tpu_torch.ops.orient import gather_patches
from modular_slam_tpu_torch.utils.device import constant

Tensor = torch.Tensor

BRIEF_PATCH = 37      # rotated endpoint radius <= 13*sqrt(2) ~= 18.39
_R = BRIEF_PATCH // 2  # 18
N_ANGLE_BINS = 32


def rotated_offsets(angles: Tensor):
    """Rotate the pattern for each angle in float32, rounding half to
    even.  -> (ry1, rx1, ry2, rx2), each [N, 256] int32."""
    pat = constant(("brief_pattern",), lambda: PATTERN.astype(np.float32),
                   angles.device)                   # [256, 4] x1 y1 x2 y2
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
    rx1 = torch.round(cos * x1 - sin * y1).to(torch.int32)
    ry1 = torch.round(sin * x1 + cos * y1).to(torch.int32)
    rx2 = torch.round(cos * x2 - sin * y2).to(torch.int32)
    ry2 = torch.round(sin * x2 + cos * y2).to(torch.int32)
    return ry1, rx1, ry2, rx2


def brief_descriptors(blurred: Tensor, yx: Tensor, angles: Tensor) -> Tensor:
    """[N, 256] descriptor bits (uint8 0/1) with continuous rotation.

    blurred: [H, W] blurred level image
    yx:      [N, 2] int32 keypoint centers (y, x) in level coords
    angles:  [N] float32 IC angles (radians)"""
    ry1, rx1, ry2, rx2 = rotated_offsets(angles)
    patches = gather_patches(blurred, yx, BRIEF_PATCH)  # [N, 37, 37]
    flat = patches.reshape(patches.shape[0], -1)        # [N, 1369]
    idx1 = (ry1 + _R) * BRIEF_PATCH + (rx1 + _R)        # [N, 256]
    idx2 = (ry2 + _R) * BRIEF_PATCH + (rx2 + _R)
    v1 = torch.gather(flat, 1, idx1.long())
    v2 = torch.gather(flat, 1, idx2.long())
    return (v1 < v2).to(torch.uint8)


def brief_from_atlas(blur_atlas: Tensor, level: Tensor, yx: Tensor,
                     angles: Tensor) -> Tensor:
    """Descriptor bits [N, 256] with continuous rotation, by one flat
    gather from the padded blurred pyramid atlas [n_levels, H, W] at
    level [N] and level coords yx [N, 2].

    Off the atlas the bits follow the JAX version's `jnp.take` (its
    default fill mode): a flat index in [-n, 0) wraps to index + n, and
    one below -n or at n or above reads NaN, which compares false, so
    that bit is 0."""
    nlev, H, W = blur_atlas.shape
    ry1, rx1, ry2, rx2 = rotated_offsets(angles)
    base = level.long() * (H * W)
    y = yx[:, 0:1].long()
    x = yx[:, 1:2].long()
    idx1 = base[:, None] + (y + ry1) * W + (x + rx1)
    idx2 = base[:, None] + (y + ry2) * W + (x + rx2)
    flat = blur_atlas.reshape(-1)
    n = flat.shape[0]

    def take(idx):
        idx = torch.where(idx < 0, idx + n, idx)
        inside = (idx >= 0) & (idx < n)
        return flat[torch.where(inside, idx, 0)], inside

    v1, in1 = take(idx1)
    v2, in2 = take(idx2)
    return ((v1 < v2) & in1 & in2).to(torch.uint8)


@lru_cache(maxsize=None)
def _bin_sample_index_np(n_bins: int) -> np.ndarray:
    """[n_bins, 512] int64: for angle bin b, the flat index into the
    37x37 patch of sample s (s < 256: first endpoint of bit s; s >= 256:
    second endpoint of bit s-256) — the column-wise argmax of the JAX
    package's one-hot `_bin_selector_np`."""
    pat = np.asarray(PATTERN, np.float64)
    out = np.zeros((n_bins, 512), np.int64)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        c, s_ = np.cos(th), np.sin(th)
        x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
        rx1 = np.round(c * x1 - s_ * y1).astype(int)
        ry1 = np.round(s_ * x1 + c * y1).astype(int)
        rx2 = np.round(c * x2 - s_ * y2).astype(int)
        ry2 = np.round(s_ * x2 + c * y2).astype(int)
        out[b, :256] = (ry1 + _R) * BRIEF_PATCH + (rx1 + _R)
        out[b, 256:] = (ry2 + _R) * BRIEF_PATCH + (rx2 + _R)
    return out


def extract_patches(blur_atlas: Tensor, level: Tensor, yx: Tensor,
                    patch: int = BRIEF_PATCH) -> Tensor:
    """[N, patch^2] flattened patches centred at yx [N, 2] (y, x) of the
    given levels of blur_atlas [n_levels, H, W].

    Exact pixel copies.  A patch that leaves the atlas (only the padded,
    invalid candidates at yx = 0 do) reads clamped indices here, where the
    JAX version reads NaN or 0: compare such rows only where valid."""
    nlev, H, W = blur_atlas.shape
    r = patch // 2
    d = torch.arange(-r, r + 1, device=yx.device)
    rows = (level.long() * H + yx[:, 0].long())[:, None] + d[None, :]
    rows = rows.clamp(0, nlev * H - 1)                            # [N, p]
    cols = (yx[:, 1].long()[:, None] + d[None, :]).clamp(0, W - 1)  # [N, p]
    flat = rows[:, :, None] * W + cols[:, None, :]                # [N, p, p]
    return blur_atlas.reshape(-1)[flat.reshape(flat.shape[0], -1)]


def brief_from_patches(patches_flat: Tensor, angles: Tensor,
                       n_bins: int = N_ANGLE_BINS) -> Tensor:
    """Descriptor bits [N, 256] uint8 from blurred patches
    [N, BRIEF_PATCH^2] and IC angles [N].

    Same semantics as `brief_matmul_from_patches`: round the patch to
    8-bit intensities, pick one of `n_bins` angle bins, and compare the
    two endpoints of each pattern pair rotated by the bin's angle."""
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, which rounds differently
    step = constant(("brief_step", n_bins, angles.dtype),
                    lambda: torch.tensor(2.0 * np.pi / n_bins,
                                         dtype=angles.dtype), angles.device)
    b = torch.remainder(torch.round(angles / step).to(torch.int64), n_bins)
    pq = (torch.clamp(torch.round(patches_flat), 0.0, 255.0)
          - 128.0).to(torch.int8)
    sel = constant(("brief_sel", n_bins),
                   lambda: _bin_sample_index_np(n_bins),
                   patches_flat.device)[b]                         # [N, 512]
    v = torch.gather(pq, 1, sel)
    return (v[:, :256] < v[:, 256:]).to(torch.uint8)


# The JAX package's one-hot matmul formulations compute exactly these.
extract_patches_matmul = extract_patches
brief_matmul_from_patches = brief_from_patches


def brief_matmul(blur_atlas: Tensor, level: Tensor, yx: Tensor,
                 angles: Tensor, n_bins: int = N_ANGLE_BINS) -> Tensor:
    """Angle-binned descriptor bits [N, 256] uint8 from the padded blurred
    pyramid atlas: `brief_from_patches` of the keypoints' 37x37 patches.
    Bit-equal to `brief_from_atlas` on the rounded atlas wherever the
    angle lies on a bin centre."""
    pf = extract_patches(blur_atlas, level, yx)
    return brief_from_patches(pf, angles, n_bins)
