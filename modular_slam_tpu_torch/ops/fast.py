"""FAST-9/16 corner scoring (counterpart of modular_slam_tpu/ops/fast.py
and, for the kernel, ops/fast_pallas.py).

`fast_score` is the entry point.  On a CUDA tensor it launches the
hand-written kernel `csrc/fast_score.cu` (kernel K1, which replaces the
Pallas kernel `fast_pallas.py::_fast_kernel`); on a CPU tensor it runs
`fast_score_plain`, the roll-ladder formulation of the JAX package, which
is also the kernel's oracle.  There is no fallback between the two.

  d[k]   = I(p + circle[k]) - I(p)                  (16 rolled images)
  m9[k]  = min(d[k], ..., d[k+8])  circular
  bright = max_k m9[k];  dark = max_k min9(-d)[k]
  score  = max(bright, dark, 0)
"""

from __future__ import annotations

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


def fast_score_cuda(img: Tensor) -> Tensor:
    """Kernel K1 on a [H, W] or [B, H, W] float32 CUDA tensor."""
    if not img.is_cuda:
        raise ValueError("fast_score_cuda takes a CUDA tensor")
    if img.dtype != torch.float32:
        raise TypeError(f"fast_score: float32 expected, got {img.dtype}")
    if img.dim() not in (2, 3):
        raise ValueError(f"fast_score: [H, W] or [B, H, W], got {img.shape}")
    if not img.is_contiguous():
        raise ValueError("fast_score: contiguous input expected")
    batched = img.dim() == 3
    x = img if batched else img[None]
    B, H, W = x.shape
    out = torch.empty_like(x)
    if B and H and W:
        FAST_SCORE.launch(x.data_ptr(), out.data_ptr(), B, H, W,
                          torch.cuda.current_stream(x.device).cuda_stream)
    return out if batched else out[0]


def fast_score(img: Tensor) -> Tensor:
    """FAST-9/16 corner score map [..., H, W] (0 where no corner at any
    t > 0); score > t  <=>  FAST-9 corner at strict threshold t.

    CUDA tensor: kernel K1.  CPU tensor: the plain version."""
    if img.is_cuda:
        return fast_score_cuda(img)
    if img.device.type != "cpu":
        raise ValueError(f"fast_score: no kernel for device {img.device}")
    return fast_score_plain(img)


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
