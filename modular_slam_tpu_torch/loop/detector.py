"""Loop detection: BoW candidate retrieval and geometric verification
(counterpart of modular_slam_tpu/loop/detector.py).

1. every new keyframe's BoW vector is written into a fixed-capacity
   database row-aligned with the arena keyframe slots;
2. candidate retrieval scores the query against the whole database in one
   matrix-vector product, masking temporally adjacent and map-connected
   keyframes;
3. geometric verification matches the current frame's descriptors against
   each candidate keyframe's observed landmarks and runs RANSAC-PnP; enough
   inliers give a loop edge with the measured pose.

The JAX pipeline verifies its `top_k` candidates under `jax.vmap`, and its
Pallas matcher takes the batch as a grid dimension.  Here
`geometric_verify` takes all candidates at once: one launch of kernel K2
and one of its merge on a CUDA arena, comparing the same queries with the
same landmark rows under one mask per candidate, with no copy of the rows.
Dedupe and RANSAC-PnP then run per candidate; a 0-d slot, as the JAX
function takes it, is verified as a batch of one.  Each candidate draws
its RANSAC triplets from its own key, as under JAX's `vmap`: the
candidates' draws go to the device in one upload and are mapped to rows
in one batched mapping (utils/prng.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import Camera, backproject
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_compose,
                                                 pose_inverse)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.ops.match import dedupe_matches, match_descriptors
from modular_slam_tpu_torch.ops.pnp import _ransac_from_rows, draw_rows
from modular_slam_tpu_torch.types import Features, Matches
from modular_slam_tpu_torch.utils.prng import Uniforms, as_key

Tensor = torch.Tensor


class LoopDatabase(NamedTuple):
    """Keyframe BoW vectors, row-aligned with arena keyframe slots."""

    hists: Tensor   # [K, V] float32, L2-normalized rows (0 when invalid)
    valid: Tensor   # [K] bool


def empty_database(max_keyframes: int, vocab_size: int,
                   device="cpu") -> LoopDatabase:
    return LoopDatabase(
        hists=torch.zeros((max_keyframes, vocab_size), dtype=torch.float32,
                          device=device),
        valid=torch.zeros((max_keyframes,), dtype=torch.bool, device=device))


def add_keyframe_bow(db: LoopDatabase, kf_slot: int,
                     hist: Tensor) -> LoopDatabase:
    """Write row kf_slot in place; a slot outside the pool is dropped."""
    if 0 <= kf_slot < db.valid.shape[0]:
        db.hists[kf_slot] = hist
        db.valid[kf_slot] = True
    return db


def query_candidates(
    db: LoopDatabase, query_hist: Tensor, query_slot: int,
    min_gap: int, top_k: int,
    gap_floor: Optional[int] = None,
    gap_fraction: Optional[float] = None,
    covis_counts: Optional[Tensor] = None,
    max_covis: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """-> (scores [top_k] float32, slots [top_k] int64): cosine similarity,
    masked to -1.

    With `gap_fraction` the slot-distance gap adapts to the live map,
    clip(round(frac * n_live), gap_floor, min_gap) (round half to even, as
    `jnp.round`); candidates sharing more than `max_covis` landmarks with
    the query are already connected to it through the map and are masked.
    Ties keep the lower slot first, as `lax.top_k`: masked scores tie at
    -1."""
    scores = db.hists @ query_hist                      # [K]
    K = scores.shape[0]
    slots = torch.arange(K, device=scores.device)
    if gap_fraction is not None:
        n_live = torch.sum(db.valid.to(torch.int32))
        gap = torch.clamp(
            torch.round(gap_fraction * n_live.to(torch.float32)).to(
                torch.int32),
            gap_floor if gap_floor is not None else 1, min_gap)
    else:
        gap = min_gap
    ok = db.valid & (torch.abs(slots - query_slot) >= gap)
    if covis_counts is not None and max_covis is not None:
        ok = ok & (covis_counts <= max_covis)
    scores = torch.where(ok, scores, torch.full_like(scores, -1.0))
    top, order = torch.sort(scores, descending=True, stable=True)
    return top[:top_k], order[:top_k]


class LoopVerification(NamedTuple):
    ok: Tensor          # bool — geometric verification passed
    n_inliers: Tensor   # int32
    pose: Pose          # Pose of the *query camera* implied by the
    # candidate's landmarks (world frame)


def _one_key(key):
    """A candidate's key as the key of a batch of one."""
    if callable(key):
        return key
    if isinstance(key, Uniforms):
        return Uniforms(key.u[None])
    return as_key(key)[None]


def geometric_verify(
    arena: MapArena,
    cand_kf: Tensor,
    feats: Features,
    cam: Camera,
    cfg: SlamConfig,
    key,
) -> LoopVerification:
    """Match the query features against each candidate keyframe's landmarks
    and solve the query pose from them.  cand_kf [B] keyframe slots ->
    (ok [B], n_inliers [B], query poses [B]); a 0-d slot -> 0-d ok and
    n_inliers and one pose.  `key` holds each candidate's PRNG key, [B, 2]
    ([2] for a 0-d slot), or stands in for them (ops/pnp.py: their
    `Uniforms`; a sampler, or a list of B samplers, drawing one mask at a
    time)."""
    if cand_kf.dim() == 0:
        ok, n_inliers, pose = geometric_verify(arena, cand_kf[None], feats,
                                               cam, cfg, _one_key(key))
        return LoopVerification(ok[0], n_inliers[0],
                                Pose(q=pose.q[0], t=pose.t[0]))
    kps = feats.keypoints
    cand = cand_kf.long()
    B = cand.shape[0]
    lm_mask = arena.inc[cand] & arena.lm_valid                 # [B, L]
    matches = match_descriptors(feats.descriptors.unpacked, kps.valid,
                                arena.lm_desc, lm_mask, cfg.matcher)
    pts_cam = backproject(cam, kps.uv, kps.depth)
    # cold start from each candidate keyframe's pose (same place revisited)
    init_q, init_t = arena.kf_q[cand], arena.kf_t[cand]
    deduped = [dedupe_matches(Matches(*(x[b] for x in matches)),
                              arena.max_landmarks) for b in range(B)]
    m_ok = [m.valid & (kps.depth > 0.0) for m in deduped]
    n_hyp = cfg.pnp.n_hypotheses
    if callable(key) or isinstance(key, list):
        samplers = key if isinstance(key, list) else [key] * B
        rows = [draw_rows(s, v, n_hyp) for s, v in zip(samplers, m_ok)]
    else:
        rows = draw_rows(key, torch.stack(m_ok), n_hyp)     # [B, H, 3]
    oks, inls, qs, ts = [], [], [], []
    for b in range(B):
        pnp = _ransac_from_rows(
            cam, arena.lm_pos[deduped[b].lm_slot.long()], kps.uv, pts_cam,
            m_ok[b], Pose(q=init_q[b], t=init_t[b]), rows[b], cfg.pnp)
        oks.append(pnp.ok & (pnp.n_inliers >= cfg.loop.min_inliers))
        inls.append(pnp.n_inliers)
        qs.append(pnp.pose.q)
        ts.append(pnp.pose.t)
    return LoopVerification(torch.stack(oks), torch.stack(inls),
                            Pose(q=torch.stack(qs), t=torch.stack(ts)))


def relative_pose(pose_from: Pose, pose_to: Pose) -> Pose:
    """T_from^-1 * T_to — the edge measurement convention of the pose
    graph (backend/posegraph.py)."""
    return pose_compose(pose_inverse(pose_from), pose_to)
