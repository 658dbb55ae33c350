"""The tracked step's matching and inlier classification in plain
PyTorch: the yardstick for the port's matcher (kernel K2 with its merge
kernel), its duplicate removal, its RANSAC-PnP's inliers and the arena's
inserts.

- `covis_masks`: for every keyframe as the reference keyframe, the
  landmarks the step matches against: those seen by a keyframe within
  `depth` covisibility hops (a hop: the landmarks the visited keyframes
  see, then every keyframe that sees one of them);
- `match_2nn`: the brute-force Hamming 2-NN over the masked landmarks,
  Lowe's ratio test and the largest distance, ties to the first landmark;
- `dedupe`: one keypoint per landmark, the nearest, ties to the first
  keypoint;
- `inside_gates`: the PnP gates (reprojection within `inlier_px` in
  front of the camera, depth within `depth_inlier_m`) at a pose.

Descriptors are +-1 int8 rows of 256; `dtype` is the precision of the
arithmetic (float64 for the reference, bfloat16 for the control).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def covis_masks(inc: Tensor, kf_valid: Tensor, lm_valid: Tensor,
                depth: int) -> Tensor:
    """[K, L] bool: row k holds the landmarks matched against when
    keyframe k is the reference (rows of invalid keyframes are empty).
    inc [K, L] bool incidence, kf_valid [K], lm_valid [L]."""
    f = torch.float32
    inc_f = inc.to(f)
    visited = torch.diag(kf_valid).to(f)                       # [K, K]
    for _ in range(depth):
        seen = (visited @ inc_f > 0).to(f)                     # [K, L]
        back = (seen @ inc_f.T > 0)                            # [K, K]
        visited = ((visited > 0) | back).to(f) * kf_valid.to(f)[None]
    return (visited @ inc_f > 0) & lm_valid[None]


def match_2nn(query: Tensor, query_valid: Tensor, train: Tensor,
              train_valid: Tensor, ratio: float, max_hamming: float,
              dtype: torch.dtype = torch.float64
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """(landmark [N] int64, distance [N], valid [N] bool) of each query
    row against the valid train rows."""
    nbits = query.shape[-1]
    dot = query.to(dtype) @ train.to(dtype).T
    d = ((nbits - dot) * 0.5).to(torch.float64)
    big = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    d = torch.where(train_valid[None], d, big)
    best, idx = torch.min(d, dim=1)
    # torch.min's index is not promised to be the first of equal minima
    idx = torch.argmax((d == best[:, None]).to(torch.int8), dim=1)
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), idx] = big
    second = torch.amin(d2, dim=1)
    ok = (query_valid & torch.isfinite(best) & (best <= max_hamming)
          & (best < ratio * second))
    return idx, best, ok


def dedupe(lm: Tensor, dist: Tensor, valid: Tensor) -> Tensor:
    """valid [N] with only the nearest keypoint (then the first) kept for
    each landmark."""
    n = lm.shape[0]
    order = torch.arange(n, device=lm.device)
    same = (lm[:, None] == lm[None, :]) & valid[None, :] & valid[:, None]
    better = same & ((dist[None, :] < dist[:, None])
                     | ((dist[None, :] == dist[:, None])
                        & (order[None, :] < order[:, None])))
    return valid & ~torch.any(better, dim=1)


def inside_gates(pw: Tensor, uv: Tensor, z: Tensor, R: Tensor, t: Tensor,
                 cam, inlier_px: float, depth_inlier_m: float,
                 dtype: torch.dtype = torch.float64) -> Tensor:
    """[N] bool: landmarks pw [N, 3] seen at uv [N, 2] with depth z [N]
    inside the gates at the camera-to-world pose (R [3, 3], t [3])."""
    fx, fy, cx, cy = cam
    R = R.to(dtype)
    pc = (pw.to(dtype) - t.to(dtype)) @ R
    inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    du = uv[:, 0].to(dtype) - (pc[:, 0] * inv_z * fx + cx)
    dv = uv[:, 1].to(dtype) - (pc[:, 1] * inv_z * fy + cy)
    return ((pc[:, 2] > 0) & (du * du + dv * dv < inlier_px ** 2)
            & (torch.abs(pc[:, 2] - z.to(dtype)) < depth_inlier_m))
