"""Image pyramid construction (counterpart of
modular_slam_tpu/ops/pyramid.py): 8 levels x1.2, each level resized from
the previous with bilinear interpolation.

`F.interpolate(bilinear, align_corners=False, antialias=False)` is the
counterpart of `jax.image.resize(method="linear", antialias=False)`.  Every
sample position lies strictly inside the previous level, so both blend
the same two pixels and no edge rule differs.  They differ by rounding:
within 1e-4 except along one row or column of a level, where XLA's fused
multiply-add and ATen round one sample position to neighbouring floats
(tests/test_torch_detector.py::test_pyramid_differences_are_sample_rounding).
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


def level_scale(cfg: DetectorConfig, level: int) -> float:
    return cfg.scale_factor ** level


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
