"""Image pyramid construction (counterpart of
modular_slam_tpu/ops/pyramid.py): 8 levels x1.2, each level resized from
the previous with bilinear interpolation.

`F.interpolate(bilinear, align_corners=False, antialias=False)` is the
counterpart of `jax.image.resize(method="linear", antialias=False)`.  The
two round differently: on a 640x480 chain they differ by <= 5e-5 inside
the image and by < 1e-3 at a few edge pixels of the small levels, where
JAX renormalises its one-sided triangle weights.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from modular_slam_tpu_torch.config import DetectorConfig

Tensor = torch.Tensor


def pyramid_shapes(h: int, w: int,
                   cfg: DetectorConfig) -> List[Tuple[int, int]]:
    shapes = [(h, w)]
    for lvl in range(1, cfg.n_levels):
        s = cfg.scale_factor ** lvl
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


def build_pyramid(gray: Tensor, cfg: DetectorConfig) -> List[Tensor]:
    """gray [H, W] float32 -> list of n_levels tensors, resize-chained."""
    h, w = gray.shape
    shapes = pyramid_shapes(h, w, cfg)
    levels = [gray]
    for lvl in range(1, cfg.n_levels):
        prev = levels[-1]
        levels.append(F.interpolate(
            prev[None, None], size=shapes[lvl], mode="bilinear",
            align_corners=False, antialias=False)[0, 0])
    return levels
