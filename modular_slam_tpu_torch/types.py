"""Core data contracts as NamedTuples of tensors.

Counterpart of modular_slam_tpu/types.py.  Everything is fixed-capacity
with validity masks, exactly as in the JAX package, so the two can be
compared field by field.

`Descriptors.packed` is int32 here, not uint32: torch's uint32 lacks
basic ops on the CPU.  The 32-bit patterns are the JAX array's
(`np.asarray(jax_packed).view(np.int32)`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from modular_slam_tpu_torch.geometry.se3 import Pose

Tensor = torch.Tensor

# RGB -> luma weights (the reference's toGrayScale, frame.cpp:6-27)
LUMA_WEIGHTS = (0.299, 0.587, 0.114)


class RgbdFrame(NamedTuple):
    """One RGB-D frame on the device.

    rgb:   [H, W, 3] uint8
    gray:  [H, W] float32 (luma, 0..255)
    depth: [H, W] float32 meters (0 = invalid)
    timestamp: 0-d float32 seconds
    """

    rgb: Tensor
    gray: Tensor
    depth: Tensor
    timestamp: Tensor


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set [N] with validity mask.

    uv:       [N, 2] float32 — level-0 pixel coords
    response: [N] float32 — detector score
    angle:    [N] float32 — IC angle in radians
    level:    [N] int32 — pyramid level (-1 where invalid)
    depth:    [N] float32 — meters sampled from the depth map (0 invalid)
    valid:    [N] bool
    """

    uv: Tensor
    response: Tensor
    angle: Tensor
    level: Tensor
    depth: Tensor
    valid: Tensor

    @property
    def capacity(self) -> int:
        """N, the fixed capacity (a Python int)."""
        return self.uv.shape[-2]


class Descriptors(NamedTuple):
    """BRIEF-256 descriptors.

    packed:   [N, 8] int32 — bit-packed (the uint32 bit patterns)
    unpacked: [N, 256] int8 — ±1, for Hamming matching
    """

    packed: Tensor
    unpacked: Tensor


class Features(NamedTuple):
    keypoints: Keypoints
    descriptors: Descriptors


class Matches(NamedTuple):
    """2-NN ratio-tested matches from frame keypoints to landmark slots.

    lm_slot:  [N] int32 — matched landmark arena slot (undefined when !valid)
    distance: [N] float32 — best Hamming distance
    valid:    [N] bool — passed ratio test + mask checks
    """

    lm_slot: Tensor
    distance: Tensor
    valid: Tensor


class TrackResult(NamedTuple):
    """Per-frame frontend output."""

    pose: Pose
    n_matches: Tensor       # int32 — ratio-test survivors with valid depth
    n_inliers: Tensor       # int32 — PnP inliers
    tracking_ok: Tensor     # bool
    new_keyframe: Tensor    # bool — a keyframe was added this frame
    kf_slot: Tensor         # int32 — new keyframe slot, -1 when none
    # bool — in-scan relocalization rescued this frame (the chunked path
    # with relocalization on; None elsewhere)
    relocalized: Tensor = None


def pack_bits(bits: Tensor) -> Tensor:
    """[..., 256] {0,1} -> [..., 8] int32, little-endian bit packing.

    Packed in int64 and narrowed, so each int32 holds the uint32 pattern
    of the JAX `pack_bits`."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], 8, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    # uint32 pattern -> the int32 with the same bits
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_bits(packed: Tensor) -> Tensor:
    """[..., 8] int32 (uint32 patterns) -> [..., 256] {0,1} uint8."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 256).to(torch.uint8)


def bits_to_pm1(bits: Tensor) -> Tensor:
    """{0,1} -> ±1 int8 (Hamming as a dot product: ham = (256 - a·b) / 2)."""
    return (bits.to(torch.int8) * 2 - 1).to(torch.int8)
