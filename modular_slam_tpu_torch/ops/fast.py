"""FAST-9/16 corner scoring (counterpart of modular_slam_tpu/ops/fast.py
and, for the kernel, ops/fast_pallas.py).

`fast_score_levels` (a list of images, the detector's pyramid) and
`fast_score` (one image) are the entry points.  On CUDA tensors they
launch the hand-written kernel `csrc/fast_score.cu` (kernel K1, which
replaces the Pallas kernel `fast_pallas.py::_fast_kernel`), once for all
the images; on CPU tensors they run `fast_score_plain`, the roll-ladder
formulation of the JAX package, which is also the kernel's oracle.  There
is no fallback between the two.

  d[k]   = I(p + circle[k]) - I(p)                  (16 rolled images)
  m9[k]  = min(d[k], ..., d[k+8])  circular
  bright = max_k m9[k];  dark = max_k min9(-d)[k]
  score  = max(bright, dark, 0)
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from modular_slam_tpu_torch.ops.kernels import FAST_SCORE

Tensor = torch.Tensor

# Bresenham circle of radius 3, 16 pixels, circular order (dy, dx);
# csrc/fast_score.cu holds the same table
FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def fast_score_plain(img: Tensor) -> Tensor:
    """FAST-9/16 score map of [..., H, W] float32 (edges wrap, as the
    JAX `fast_score` does with jnp.roll)."""
    ring = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                        for dy, dx in FAST_CIRCLE])
    d = ring - img[None]

    def min9(x: Tensor) -> Tensor:
        m = x
        for s in range(1, 9):
            m = torch.minimum(m, torch.roll(x, -s, dims=0))
        return m

    bright = torch.amax(min9(d), dim=0)
    dark = torch.amax(min9(-d), dim=0)
    return torch.clamp(torch.maximum(bright, dark), min=0.0)


# csrc/fast_score.cu: output tile edge and the most levels one launch takes
FAST_TILE = 32
FAST_MAX_LEVELS = 16


def fast_tile_table(shapes: Sequence[Tuple[int, int]]) -> List[int]:
    """Kernel K1's launch geometry: the prefix of the levels' tile counts
    (ceil(H/32) * ceil(W/32) each), n + 1 entries.  Block b of the launch
    computes tile b - first[l] of the level l with first[l] <= b <
    first[l + 1], tiles numbered row-major within a level."""
    first = [0]
    for h, w in shapes:
        first.append(first[-1] + (-(-h // FAST_TILE)) * (-(-w // FAST_TILE)))
    return first


def _check_level(img: Tensor) -> None:
    if not img.is_cuda:
        raise ValueError("fast_score_levels takes CUDA tensors")
    if img.dtype != torch.float32:
        raise TypeError(f"fast_score: float32 expected, got {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"fast_score: [H, W] or [B, H, W], got {img.shape}")
    if not img.is_contiguous():
        raise ValueError("fast_score: contiguous input expected")


def fast_score_levels_cuda(levels: Sequence[Tensor]) -> List[Tensor]:
    """Kernel K1: the score maps of every level in one launch.  Each
    level is [H, W] or [B, H, W] float32 CUDA, contiguous, with one B for
    all; at most FAST_MAX_LEVELS levels."""
    if not 1 <= len(levels) <= FAST_MAX_LEVELS:
        raise ValueError(f"fast_score: 1..{FAST_MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    for img in levels:
        _check_level(img)
    xs = [img if img.dim() == 3 else img[None] for img in levels]
    if len({x.shape[0] for x in xs}) != 1 or \
            len({x.device for x in xs}) != 1:
        raise ValueError("fast_score: levels differ in batch size or device")
    outs = [torch.empty_like(x) for x in xs]
    work = [(x, o) for x, o in zip(xs, outs) if x.numel()]
    if work:
        shapes = [tuple(x.shape[1:]) for x, _ in work]
        n = len(work)
        FAST_SCORE.launch(
            (ctypes.c_void_p * n)(*(x.data_ptr() for x, _ in work)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for _, o in work)),
            (ctypes.c_int * n)(*(h for h, _ in shapes)),
            (ctypes.c_int * n)(*(w for _, w in shapes)),
            (ctypes.c_int * (n + 1))(*fast_tile_table(shapes)),
            n, xs[0].shape[0],
            torch.cuda.current_stream(xs[0].device).cuda_stream)
    return [o if img.dim() == 3 else o[0] for img, o in zip(levels, outs)]


def fast_score_levels(levels: Sequence[Tensor]) -> List[Tensor]:
    """FAST-9/16 score maps of a list of images (the pyramid's levels).

    CUDA tensors: kernel K1, one launch for all.  CPU tensors: the plain
    version, level by level."""
    if levels and levels[0].is_cuda:
        return fast_score_levels_cuda(levels)
    for img in levels:
        if img.device.type != "cpu":
            raise ValueError(f"fast_score: no kernel for device {img.device}")
    return [fast_score_plain(img) for img in levels]


def fast_score_cuda(img: Tensor) -> Tensor:
    """Kernel K1 on one [H, W] or [B, H, W] float32 CUDA tensor."""
    return fast_score_levels_cuda([img])[0]


def fast_score(img: Tensor) -> Tensor:
    """FAST-9/16 corner score map [..., H, W] (0 where no corner at any
    t > 0); score > t  <=>  FAST-9 corner at strict threshold t.

    CUDA tensor: kernel K1.  CPU tensor: the plain version."""
    return fast_score_levels([img])[0]


def nms3x3(score: Tensor) -> Tensor:
    """3x3 non-maximum suppression: keep score where it is the
    neighbourhood max.  max_pool2d pads with -inf, like reduce_window
    "SAME" in the JAX version."""
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= neigh, score, torch.zeros_like(score))


def border_mask(h: int, w: int, border: int, dtype=torch.float32,
                device="cpu") -> Tensor:
    """[H, W] 1.0 inside the border margin, 0.0 outside."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    inside = ((ys >= border) & (ys < h - border)
              & (xs >= border) & (xs < w - border))
    return inside.to(dtype)
