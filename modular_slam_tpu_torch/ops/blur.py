"""Separable Gaussian blur (counterpart of modular_slam_tpu/ops/blur.py):
`blur_patches` for the detector's keypoint patches, `gaussian_blur` for a
whole image.

Reference: 7x7 sigma=2 GaussianBlur with BORDER_REFLECT_101 before BRIEF
description (distributed_cv_feature.cpp:797-798).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from modular_slam_tpu_torch.utils.device import constant

Tensor = torch.Tensor


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band(P: int, ksize: int, sigma: float) -> np.ndarray:
    """Banded [P, Q] matrix: out[j] = sum_t k[t] * in[j + t]."""
    k = gaussian_kernel_1d(ksize, sigma)
    Q = P - 2 * (ksize // 2)
    B = np.zeros((P, Q), np.float32)
    for j in range(Q):
        B[j:j + ksize, j] = k
    return B


def blur_patches(patches: Tensor, ksize: int = 7,
                 sigma: float = 2.0) -> Tensor:
    """Valid-region separable Gaussian blur of patch stacks:
    [N, P, P] -> [N, P-2r, P-2r] (r = ksize//2), as two banded matmuls in
    full float32 (TF32 is off, see the package docstring)."""
    P = patches.shape[-1]
    B = constant(("blur_band", P, ksize, sigma),
                 lambda: _band(P, ksize, sigma), patches.device)
    hp = torch.einsum("nyi,ij->nyj", patches, B)      # [N, P, Q]
    return torch.einsum("niw,ij->njw", hp, B)         # [N, Q, Q]


def reflect_pad(img: Tensor, r: int) -> Tensor:
    """[H, W] -> [H + 2r, W + 2r], reflect-101 (the edge pixel not
    repeated): numpy's and `jnp.pad`'s "reflect"."""
    return F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0]


def gaussian_blur(img: Tensor, ksize: int = 7, sigma: float = 2.0) -> Tensor:
    """[H, W] float32 -> blurred [H, W]; reflect-101 borders like OpenCV.

    The JAX package's shifted multiply-adds in the same order, row pass
    then column pass (not `conv2d`, whose summation order differs and
    which reaches cuDNN on the card)."""
    k = gaussian_kernel_1d(ksize, sigma)
    r = ksize // 2
    h, w = img.shape
    padded = reflect_pad(img, r)
    tmp = sum(float(k[i]) * padded[:, i:i + w] for i in range(ksize))
    return sum(float(k[i]) * tmp[i:i + h, :] for i in range(ksize))
