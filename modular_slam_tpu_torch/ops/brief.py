"""Angle-binned rotated BRIEF-256 (counterpart of
modular_slam_tpu/ops/brief.py).

The JAX package turns every random access into MXU work: patches are cut
with a one-hot column matmul (`extract_patches_matmul`) and the 512
rotated sample points are read with an int8 matmul against one-hot
selectors per angle bin (`brief_matmul_from_patches`).  Both are exact
copies of pixels, so here they are plain gathers: `extract_patches` and
`brief_from_patches` give the same values and the same bits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from modular_slam_tpu_torch.ops.brief_pattern import PATTERN
from modular_slam_tpu_torch.utils.device import constant

Tensor = torch.Tensor

BRIEF_PATCH = 37      # rotated endpoint radius <= 13*sqrt(2) ~= 18.39
_R = BRIEF_PATCH // 2  # 18
N_ANGLE_BINS = 32


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


def extract_patches(atlas: Tensor, level: Tensor, yx: Tensor,
                    patch: int = BRIEF_PATCH) -> Tensor:
    """[N, patch^2] flattened patches centred at yx [N, 2] (y, x) of the
    given levels of atlas [n_levels, H, W].

    Exact pixel copies.  A patch that leaves the atlas (only the padded,
    invalid candidates at yx = 0 do) reads clamped indices here, where the
    JAX version reads NaN or 0: compare such rows only where valid."""
    nlev, H, W = atlas.shape
    r = patch // 2
    d = torch.arange(-r, r + 1, device=yx.device)
    rows = (level.long() * H + yx[:, 0].long())[:, None] + d[None, :]
    rows = rows.clamp(0, nlev * H - 1)                            # [N, p]
    cols = (yx[:, 1].long()[:, None] + d[None, :]).clamp(0, W - 1)  # [N, p]
    flat = rows[:, :, None] * W + cols[:, None, :]                # [N, p, p]
    return atlas.reshape(-1)[flat.reshape(flat.shape[0], -1)]


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
