"""Separable Gaussian blur of keypoint patches (counterpart of
modular_slam_tpu/ops/blur.py: `gaussian_kernel_1d`, `blur_patches`)."""

from __future__ import annotations

import numpy as np
import torch

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
