"""FAST-9/16 corner scoring (counterpart of modular_slam_tpu/ops/fast.py
and, for the kernel, ops/fast_pallas.py).

`fast_score_levels` (a list of images, the detector's pyramid) and
`fast_score` (one image) are the entry points.  On CUDA tensors they
launch the hand-written kernel `csrc/fast_score.cu` (kernel K1, which
replaces the Pallas kernel `fast_pallas.py::_fast_kernel`), once for all
the images; on CPU tensors they run `fast_score_plain`, the roll-ladder
formulation of the JAX package, which is also the kernel's oracle.  There
is no fallback between the two.  The launch is a `torch.library.custom_op`
with a vmap rule: `torch.func.vmap` of the detector (parallel/dp.py)
launches K1 once for a batch of sequences.

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


@torch.library.custom_op("mslam::fast_score_levels", mutates_args=(),
                         device_types="cuda")
def _fast_score_levels_op(levels: List[Tensor]) -> List[Tensor]:
    """Kernel K1 as an operator, so that `torch.func.vmap` batches it
    (`_fast_vmap`: one launch for the batch) where a ctypes launch would
    need `data_ptr()` of a batched tensor.  Levels [H, W] or [B, H, W]
    with one B (1 for [H, W]) and one device; a [H, W] level and its
    [1, H, W] form have one layout, so the outputs are allocated in the
    inputs' shapes."""
    B = {img.shape[0] if img.dim() == 3 else 1 for img in levels}
    if len(B) != 1 or len({img.device for img in levels}) != 1:
        raise ValueError("fast_score: levels differ in batch size or device")
    outs = [torch.empty_like(img) for img in levels]
    work = [(x, o) for x, o in zip(levels, outs) if x.numel()]
    if work:
        shapes = [tuple(x.shape[-2:]) for x, _ in work]
        n = len(work)
        FAST_SCORE.launch(
            (ctypes.c_void_p * n)(*(x.data_ptr() for x, _ in work)),
            (ctypes.c_void_p * n)(*(o.data_ptr() for _, o in work)),
            (ctypes.c_int * n)(*(h for h, _ in shapes)),
            (ctypes.c_int * n)(*(w for _, w in shapes)),
            (ctypes.c_int * (n + 1))(*fast_tile_table(shapes)),
            n, B.pop(), torch.cuda.current_stream(
                levels[0].device).cuda_stream)
    return outs


@_fast_score_levels_op.register_fake
def _(levels):
    return [torch.empty_like(img) for img in levels]


def _fast_vmap(info, in_dims, levels):
    """vmap rule of K1: the vmapped batch to dim 0, every level
    flattened to [N, H, W] (N the vmapped batch times any batch of the
    level itself), one launch, and the batch restored."""
    xs = [x.movedim(d, 0) if d is not None
          else x.expand(info.batch_size, *x.shape)
          for x, d in zip(levels, in_dims[0])]
    outs = _fast_score_levels_op(
        [x.reshape(-1, *x.shape[-2:]).contiguous() for x in xs])
    return [o.reshape(x.shape) for x, o in zip(xs, outs)], [0] * len(xs)


torch.library.register_vmap(_fast_score_levels_op, _fast_vmap)


def fast_score_levels_cuda(levels: Sequence[Tensor]) -> List[Tensor]:
    """Kernel K1: the score maps of every level in one launch.  Each
    level is [H, W] or [B, H, W] float32 CUDA, contiguous, with one B for
    all; at most FAST_MAX_LEVELS levels.  Under `torch.func.vmap` the
    vmapped batch joins B: still one launch."""
    if not 1 <= len(levels) <= FAST_MAX_LEVELS:
        raise ValueError(f"fast_score: 1..{FAST_MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    for img in levels:
        _check_level(img)
    return _fast_score_levels_op(list(levels))


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
