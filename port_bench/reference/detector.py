"""The ORB detector in plain PyTorch: the yardstick for the port's
detector and kernel K1.

A frozen copy of the algorithm the port runs (`ops/detector.py` with the
plain FAST score of `ops/fast.py`), written again here so that a later
change to the program cannot move it: an 8-level bilinear pyramid at
x1.2, FAST-9/16 scores, 3x3 non-maximum suppression, a 19 px border, the
per-cell FAST 20 -> 7 fallback in 32 px cells, the best candidate of each
cell, the global top 512 by a stable sort, the intensity-centroid angle
on a 31 px disc, a 7x7 sigma-2 Gaussian blur and angle-binned BRIEF-256
over the 8-bit blurred patch.  Ties break as `lax.top_k` does (first
maximum).

`dtype` is the precision of the image arithmetic (pyramid, scores,
angles, blur): float32 is the configuration's; the control runs it in
bfloat16.  Coordinates stay float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

FAST_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BRIEF_PATCH = 37
N_ANGLE_BINS = 32
IC_RADIUS = 15
PATTERN_SEED = 0x0B5E55ED


class DetectorSettings(NamedTuple):
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: int = 20
    fast_threshold_low: int = 7
    cell_size: int = 32
    border: int = 19
    max_keypoints: int = 512
    blur_ksize: int = 7
    blur_sigma: float = 2.0


class Keypoints(NamedTuple):
    uv: Tensor       # [N, 2] float32 level-0 pixels
    depth: Tensor    # [N] float32 metres sampled at the rounded uv
    valid: Tensor    # [N] bool
    bits: Tensor     # [N, 256] uint8 descriptor bits


def brief_pattern(n_pairs: int = 256) -> np.ndarray:
    """BRIEF G-II pairs (x1, y1, x2, y2): N(0, (31/5)^2) rounded and
    clipped to [-13, 13] from a fixed seed, a degenerate pair's x2 + 1."""
    rng = np.random.default_rng(PATTERN_SEED)
    pts = rng.normal(0.0, 31.0 / 5.0, size=(n_pairs, 4))
    pts = np.clip(np.round(pts), -13, 13).astype(np.int32)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] = np.clip(pts[same, 2] + 1, -13, 13)
    return pts


def _bin_sample_index(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    pat = brief_pattern().astype(np.float64)
    r = BRIEF_PATCH // 2
    out = np.zeros((n_bins, 512), np.int64)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        c, s = np.cos(th), np.sin(th)
        x1, y1, x2, y2 = pat[:, 0], pat[:, 1], pat[:, 2], pat[:, 3]
        out[b, :256] = ((np.round(s * x1 + c * y1).astype(int) + r) * BRIEF_PATCH
                        + np.round(c * x1 - s * y1).astype(int) + r)
        out[b, 256:] = ((np.round(s * x2 + c * y2).astype(int) + r) * BRIEF_PATCH
                        + np.round(c * x2 - s * y2).astype(int) + r)
    return out


def _disc_mask(radius: int) -> np.ndarray:
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    umax = np.floor(np.sqrt(radius * radius - ys.astype(np.float64) ** 2) + 0.5)
    return (np.abs(xs) <= umax).astype(np.float32)


def _blur_band(P: int, ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    Q = P - 2 * r
    B = np.zeros((P, Q), np.float32)
    for j in range(Q):
        B[j:j + ksize, j] = k
    return B


def fast_score(img: Tensor) -> Tensor:
    """FAST-9/16 score of [H, W]: the largest t for which 9 contiguous
    circle pixels are all brighter (or all darker) than the centre by
    more than t; 0 where none.  Edges wrap (they lie in the border)."""
    d = torch.stack([torch.roll(img, (-dy, -dx), dims=(-2, -1))
                     for dy, dx in FAST_CIRCLE]) - img[None]

    def min9(x):
        m = x
        for s in range(1, 9):
            m = torch.minimum(m, torch.roll(x, -s, dims=0))
        return m

    return torch.clamp(torch.maximum(torch.amax(min9(d), 0),
                                     torch.amax(min9(-d), 0)), min=0.0)


def _level_candidates(score: Tensor, s: DetectorSettings):
    h, w = score.shape
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= neigh, score, torch.zeros_like(score))
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inside = ((ys >= s.border) & (ys < h - s.border)
              & (xs >= s.border) & (xs < w - s.border))
    score = torch.where(inside & (score > s.fast_threshold_low), score,
                        torch.zeros_like(score))
    c = s.cell_size
    ncy, ncx = h // c, w // c
    blocks = score[:ncy * c, :ncx * c].reshape(ncy, c, ncx, c)
    cmax = torch.amax(blocks, dim=(1, 3), keepdim=True)
    keep = (cmax <= s.fast_threshold) | (blocks > s.fast_threshold)
    blocks = torch.where(keep, blocks, torch.zeros_like(blocks))
    flat = blocks.permute(0, 2, 1, 3).reshape(ncy * ncx, c * c)
    idx = torch.argmax(flat, dim=1)
    resp = flat.gather(1, idx[:, None])[:, 0]
    cell = torch.arange(ncy * ncx, device=score.device)
    y = (cell // ncx) * c + idx // c
    x = (cell % ncx) * c + idx % c
    return torch.stack([y, x], -1), resp


def detect(gray: Tensor, depth: Tensor, s: DetectorSettings = DetectorSettings(),
           dtype: torch.dtype = torch.float32) -> Keypoints:
    """Keypoints of one frame: gray [H, W] luma, depth [H, W] metres."""
    dev = gray.device
    H0, W0 = gray.shape
    levels = [gray.to(dtype)]
    for lvl in range(1, s.n_levels):
        sc = s.scale_factor ** lvl
        levels.append(F.interpolate(
            levels[-1][None, None], size=(int(round(H0 / sc)), int(round(W0 / sc))),
            mode="bilinear", align_corners=False, antialias=False)[0, 0])
    yx_all, resp_all, lvl_all = [], [], []
    for lvl, img in enumerate(levels):
        yx, resp = _level_candidates(fast_score(img), s)
        yx_all.append(yx)
        resp_all.append(resp.to(torch.float32))
        lvl_all.append(torch.full_like(resp, lvl, dtype=torch.int64))
    yx = torch.cat(yx_all)
    resp = torch.cat(resp_all)
    lvls = torch.cat(lvl_all)
    k = s.max_keypoints
    if resp.shape[0] < k:
        pad = k - resp.shape[0]
        yx = torch.cat([yx, yx.new_zeros((pad, 2))])
        resp = torch.cat([resp, resp.new_zeros((pad,))])
        lvls = torch.cat([lvls, lvls.new_zeros((pad,))])
    sresp, sel = torch.sort(resp, descending=True, stable=True)
    sresp, sel = sresp[:k], sel[:k]
    valid = sresp > 0.0
    yx, lvls = yx[sel], lvls[sel]

    r = s.blur_ksize // 2
    atlas = torch.stack([
        F.pad(F.pad(img[None, None], (r, r, r, r), mode="reflect")[0, 0],
              (0, W0 + 2 * r - img.shape[1] - 2 * r,
               0, H0 + 2 * r - img.shape[0] - 2 * r))
        for img in levels])                              # [L, H0+2r, W0+2r]
    P = BRIEF_PATCH + 2 * r
    nlev, Ha, Wa = atlas.shape
    d = torch.arange(-(P // 2), P // 2 + 1, device=dev)
    rows = ((lvls * Ha + yx[:, 0] + r)[:, None] + d[None]).clamp(0, nlev * Ha - 1)
    cols = ((yx[:, 1] + r)[:, None] + d[None]).clamp(0, Wa - 1)
    patches = atlas.reshape(-1)[rows[:, :, None] * Wa + cols[:, None, :]]

    c = P // 2
    crop = patches[:, c - IC_RADIUS:c + IC_RADIUS + 1,
                   c - IC_RADIUS:c + IC_RADIUS + 1]
    mask = torch.tensor(_disc_mask(IC_RADIUS), dtype=dtype, device=dev)
    coords = torch.arange(-IC_RADIUS, IC_RADIUS + 1, dtype=dtype, device=dev)
    wgt = crop * mask
    m10 = torch.sum(wgt * coords[None, None, :], dim=(1, 2))
    m01 = torch.sum(wgt * coords[None, :, None], dim=(1, 2))
    angles = torch.atan2(m01, m10)

    band = torch.tensor(_blur_band(P, s.blur_ksize, s.blur_sigma), dtype=dtype,
                        device=dev)
    bp = torch.einsum("niw,ij->njw", torch.einsum("nyi,ij->nyj", patches, band),
                      band)
    step = torch.tensor(2.0 * np.pi / N_ANGLE_BINS, dtype=angles.dtype,
                        device=dev)
    b = torch.remainder(torch.round(angles / step).to(torch.int64), N_ANGLE_BINS)
    pq = (torch.clamp(torch.round(bp.reshape(bp.shape[0], -1)), 0.0, 255.0)
          - 128.0).to(torch.int8)
    sel_idx = torch.as_tensor(_bin_sample_index(), device=dev)[b]
    v = torch.gather(pq, 1, sel_idx)
    bits = (v[:, :256] < v[:, 256:]).to(torch.uint8)

    scales = torch.tensor([s.scale_factor ** i for i in range(s.n_levels)],
                          dtype=torch.float32, device=dev)
    uv = yx.flip(-1).to(torch.float32) * scales[lvls][:, None]
    ix = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W0 - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H0 - 1)
    dep = torch.where(valid, depth.reshape(-1)[iy * W0 + ix],
                      torch.zeros((), dtype=torch.float32, device=dev))
    return Keypoints(uv=uv, depth=dep, valid=valid, bits=bits)
