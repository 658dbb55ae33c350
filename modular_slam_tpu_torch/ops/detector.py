"""ORB-style feature detection over an image pyramid (counterpart of
modular_slam_tpu/ops/detector.py).

pyramid -> FAST score maps of all levels (kernel K1 on the card, one
launch) -> 3x3 NMS,
border mask, low threshold -> per-cell threshold fallback -> per-cell
top-1 -> global top-k -> 43x43 raw patch per keypoint -> IC orientation
-> patch blur -> angle-binned BRIEF-256 -> level-0 coords + depth.
`detect_until` stops after a stage and returns its raw tensors.

Tie order follows `lax.top_k`, which prefers the lower index: the per-cell
top-1 is `argmax` (first maximum) and the global top-k a stable
descending sort.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from modular_slam_tpu_torch.config import DetectorConfig
from modular_slam_tpu_torch.ops.blur import blur_patches, reflect_pad
from modular_slam_tpu_torch.ops.brief import (BRIEF_PATCH, brief_from_patches,
                                              extract_patches)
from modular_slam_tpu_torch.ops.fast import (border_mask, fast_score_levels,
                                             nms3x3)
from modular_slam_tpu_torch.ops.orient import ic_angle_from_patches
from modular_slam_tpu_torch.ops.pyramid import build_pyramid
from modular_slam_tpu_torch.types import (Descriptors, Features, Keypoints,
                                          bits_to_pm1, pack_bits)
from modular_slam_tpu_torch.utils.device import constant

Tensor = torch.Tensor


def _cell_candidates(score: Tensor, cell: int,
                     top_per_cell: int) -> Tuple[Tensor, Tensor]:
    """Per-cell top-k of a score map -> (yx [C, 2] int32, resp [C]) with
    C = n_cells * top_per_cell; rows/cols past the last full cell are
    ignored."""
    h, w = score.shape
    ncy, ncx = h // cell, w // cell
    s = score[: ncy * cell, : ncx * cell]
    s = s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3)
    s = s.reshape(ncy * ncx, cell * cell)
    if top_per_cell == 1:
        idx = torch.argmax(s, dim=1, keepdim=True)
        resp = torch.gather(s, 1, idx)
    else:
        resp, idx = torch.sort(s, dim=1, descending=True, stable=True)
        resp, idx = resp[:, :top_per_cell], idx[:, :top_per_cell]

    cell_ids = torch.arange(ncy * ncx, device=score.device)
    cy = (cell_ids // ncx)[:, None] * cell
    cx = (cell_ids % ncx)[:, None] * cell
    y = cy + idx // cell
    x = cx + idx % cell
    yx = torch.stack([y.reshape(-1), x.reshape(-1)], dim=-1).to(torch.int32)
    return yx, resp.reshape(-1)


def _cell_threshold_fallback(score: Tensor, cell: int,
                             thr_high: float) -> Tensor:
    """Per cell: if the cell's max score exceeds thr_high, zero its
    sub-threshold scores (the reference's FAST 20 -> 7 per-cell retry)."""
    h, w = score.shape
    ncy, ncx = h // cell, w // cell
    blocks = score[: ncy * cell, : ncx * cell].reshape(ncy, cell, ncx, cell)
    cell_max = torch.amax(blocks, dim=(1, 3), keepdim=True)
    keep = (cell_max <= thr_high) | (blocks > thr_high)
    out = torch.where(keep, blocks, torch.zeros_like(blocks))
    score = score.clone()
    score[: ncy * cell, : ncx * cell] = out.reshape(ncy * cell, ncx * cell)
    return score


def _pad_to(img: Tensor, h: int, w: int) -> Tensor:
    return F.pad(img, (0, w - img.shape[1], 0, h - img.shape[0]))


CUTS = ("select", "atlas", "orient", "brief", "full")


def _detect_impl(gray: Tensor, depth: Tensor, cfg: DetectorConfig, cut: str):
    """The detect body, stopped after the stage `cut` names (one of
    CUTS): "full" gives the Features, the others a tuple of raw tensors,
    as the JAX package's `_detect_impl`."""
    if cut not in CUTS:
        raise ValueError(f"detect: cut must be one of {CUTS}, got {cut!r}")
    H0, W0 = gray.shape
    dev = gray.device
    levels = build_pyramid(gray, cfg)
    thr_low = float(cfg.fast_threshold_low)
    thr_high = float(cfg.fast_threshold)

    yx_all: List[Tensor] = []
    resp_all: List[Tensor] = []
    lvl_all: List[Tensor] = []
    scores = fast_score_levels(levels)     # kernel K1: one launch
    for lvl, (img, score) in enumerate(zip(levels, scores)):
        h, w = img.shape
        score = nms3x3(score) * border_mask(h, w, cfg.border, img.dtype, dev)
        score = torch.where(score > thr_low, score, torch.zeros_like(score))
        score = _cell_threshold_fallback(score, cfg.cell_size, thr_high)
        yx, resp = _cell_candidates(score, cfg.cell_size, cfg.max_per_cell)
        yx_all.append(yx)
        resp_all.append(resp)
        lvl_all.append(torch.full(resp.shape, lvl, dtype=torch.int32,
                                  device=dev))

    yx_c = torch.cat(yx_all)
    resp = torch.cat(resp_all)
    lvls = torch.cat(lvl_all)

    k = cfg.max_keypoints
    n_cand = resp.shape[0]
    if n_cand < k:  # small images: pad the candidate pool up to capacity
        pad = k - n_cand
        yx_c = torch.cat([yx_c, yx_c.new_zeros((pad, 2))])
        resp = torch.cat([resp, resp.new_zeros((pad,))])
        lvls = torch.cat([lvls, lvls.new_zeros((pad,))])

    # --- select the keypoint budget before descriptor work ---------------
    sel_resp, sel = torch.sort(resp, descending=True, stable=True)
    sel_resp, sel = sel_resp[:k], sel[:k]
    valid = sel_resp > 0.0
    yx_sel = yx_c[sel]
    lvl_sel = lvls[sel]
    if cut == "select":
        return yx_sel, lvl_sel, sel_resp

    # --- one raw (BRIEF 37 + blur halo 2*3 = 43)-wide patch per keypoint,
    # from levels reflect-padded by the blur radius ------------------------
    br = cfg.blur_ksize // 2
    atlas = torch.stack([
        _pad_to(reflect_pad(img, br), H0 + 2 * br, W0 + 2 * br)
        for img in levels])                          # [nlev, H0+6, W0+6]
    if cut == "atlas":
        return yx_sel, lvl_sel, sel_resp, atlas
    P = BRIEF_PATCH + 2 * br                         # 43
    patches = extract_patches(atlas, lvl_sel, yx_sel + br, patch=P)
    p2d = patches.reshape(-1, P, P)

    angles = ic_angle_from_patches(p2d)
    if cut == "orient":
        return yx_sel, lvl_sel, sel_resp, angles
    bp = blur_patches(p2d, cfg.blur_ksize, cfg.blur_sigma)  # [N, 37, 37]
    bits = brief_from_patches(bp.reshape(bp.shape[0], -1), angles)
    if cut == "brief":
        return yx_sel, lvl_sel, sel_resp, angles, bits

    # --- level-0 coords + depth -------------------------------------------
    scales = constant(
        ("level_scales", cfg.scale_factor, cfg.n_levels),
        lambda: torch.tensor([cfg.scale_factor ** i
                              for i in range(cfg.n_levels)],
                             dtype=torch.float32), dev)
    uv = yx_sel.flip(-1).to(torch.float32) * scales[lvl_sel.long()][:, None]
    ix = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W0 - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H0 - 1)
    d = depth.reshape(-1)[iy * W0 + ix]

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    kps = Keypoints(
        uv=uv,
        response=torch.where(valid, sel_resp, zero),
        angle=angles,
        level=torch.where(valid, lvl_sel, torch.full_like(lvl_sel, -1)),
        depth=torch.where(valid, d, zero),
        valid=valid,
    )
    desc = Descriptors(packed=pack_bits(bits), unpacked=bits_to_pm1(bits))
    return Features(keypoints=kps, descriptors=desc)


def detect_until(gray: Tensor, depth: Tensor, cfg: DetectorConfig, cut: str):
    """Run detect up to `cut` and return raw tensors: (yx, level,
    response) of the selected keypoints in level coords for "select",
    then the raw reflect-padded pyramid atlas for "atlas", the IC angles
    for "orient", angles and descriptor bits for "brief"; for "full"
    (uv, angle, depth, descriptors as ±1)."""
    out = _detect_impl(gray, depth, cfg, cut)
    if cut == "full":
        return (out.keypoints.uv, out.keypoints.angle, out.keypoints.depth,
                out.descriptors.unpacked)
    return out


def detect(gray: Tensor, depth: Tensor, cfg: DetectorConfig) -> Features:
    """Detect up to cfg.max_keypoints ORB features.

    gray:  [H, W] float32 luma
    depth: [H, W] float32 meters (0 invalid) — sampled per keypoint
    """
    return _detect_impl(gray, depth, cfg, "full")
