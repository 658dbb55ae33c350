"""Host frame -> device tensors (counterpart of
modular_slam_tpu/io/tum.py::frame_to_device).  The TUM dataset reader
itself is host-side work of a later slice (ROADMAP.md)."""

from __future__ import annotations

import numpy as np
import torch

from modular_slam_tpu_torch.types import LUMA_WEIGHTS, RgbdFrame
from modular_slam_tpu_torch.utils.device import constant, upload


def rgb_to_luma(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] float32 luma (frame.cpp:6-27 weights).

    Written as a chain of fused multiply-adds, r*w0 then + g*w1 then
    + b*w2: on the CPU this rounds exactly like the JAX package's
    tensordot, bit for bit (a float32 matmul does not)."""
    x = rgb.to(torch.float32)
    w = constant("luma_weights",
                 lambda: torch.tensor(LUMA_WEIGHTS, dtype=torch.float32),
                 rgb.device)
    g = x[..., 0] * w[0]
    g = torch.addcmul(g, x[..., 1], w[1])
    return torch.addcmul(g, x[..., 2], w[2])


def frame_to_device(rgb: np.ndarray, depth: np.ndarray, timestamp: float,
                    device="cpu") -> RgbdFrame:
    """Host numpy frame -> RgbdFrame on `device`, with luma grayscale;
    the copies to the card wait for nothing queued there."""
    rgb_d = upload(rgb, device)
    return RgbdFrame(
        rgb=rgb_d,
        gray=rgb_to_luma(rgb_d),
        depth=upload(np.asarray(depth, dtype=np.float32), device),
        timestamp=upload(np.asarray(timestamp, dtype=np.float32), device),
    )
