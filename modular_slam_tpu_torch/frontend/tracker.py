"""RGB-D feature-tracking frontend (counterpart of
modular_slam_tpu/frontend/tracker.py).

- first frame: identity-pose keyframe; every valid-depth keypoint becomes
  a landmark;
- later frames: match against the landmarks visible from the 2-hop
  covisibility neighbourhood of the reference keyframe, RANSAC-PnP
  warm-started at the current pose, min-matched gate;
- a keyframe is inserted on few inliers, on inliers weak against the
  reference keyframe, or when one is overdue; otherwise the reference
  keyframe may move to the best of its 5-hop neighbours by visibility vote.

The JAX version's `lax.cond`s read nothing back from the device, and
neither does this step: the keyframe branch's inserts run on every
tracked frame, gated by `enable=need_kf` (map/arena.py), beside the
better-reference vote, and `torch.where` picks between them; scalar
indices are 1-d `index_select`s.  Only the bootstrap choice is a host
decision: `track_frame(..., bootstrap=...)` takes it from the caller (the
engine keeps it as a flag), and reads `arena.n_kf` when it is not given.
A tracked frame's stages run in the spans `track.match`, `track.pnp` and
`track.keyframe` (utils/profiling.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import Camera, backproject
from modular_slam_tpu_torch.geometry.se3 import Pose, identity_pose, pose_apply
from modular_slam_tpu_torch.map.arena import (MapArena, add_keyframe,
                                              add_landmarks, add_observations,
                                              khop_keyframes,
                                              visible_landmarks)
from modular_slam_tpu_torch.ops.match import dedupe_matches, match_descriptors
from modular_slam_tpu_torch.ops.pnp import ransac_pnp
from modular_slam_tpu_torch.types import Features, TrackResult
from modular_slam_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


class TrackState(NamedTuple):
    pose: Pose          # current sensor pose (camera-to-world)
    ref_kf: Tensor      # int32 reference keyframe slot
    frame_idx: Tensor   # int32 — frames processed
    lost: Tensor        # bool — tracking currently lost
    # int32 — frames since the last keyframe insertion (None by default,
    # as in JAX; `initial_state` sets 0)
    since_kf: Tensor = None


def initial_state(device="cpu") -> TrackState:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TrackState(pose=identity_pose(device=device), ref_kf=i32(0),
                      frame_idx=i32(0),
                      lost=torch.tensor(False, device=device),
                      since_kf=i32(0))


def _count(mask: Tensor) -> Tensor:
    return torch.sum(mask.to(torch.int32), dtype=torch.int32)


def _pick(x: Tensor, i: Tensor) -> Tensor:
    """x[i] for a 0-d index tensor, gathered on the device (indexing with
    a 0-d tensor reads it back to the host)."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def _bootstrap(arena: MapArena, state: TrackState, feats: Features,
               cam: Camera, cfg: SlamConfig,
               time: Tensor) -> Tuple[MapArena, TrackState, TrackResult]:
    """First frame: identity-pose keyframe; valid-depth keypoints ->
    landmarks + observations."""
    kps = feats.keypoints
    dev = kps.uv.device
    pose = identity_pose(device=dev)
    arena, kf_slot = add_keyframe(arena, pose, time)

    has_depth = kps.valid & (kps.depth > 0.0)
    pts_world = backproject(cam, kps.uv, kps.depth)  # identity pose
    arena, lm_slots = add_landmarks(arena, pts_world,
                                    feats.descriptors.unpacked, has_depth)
    arena = add_observations(arena, kf_slot, lm_slots, kps.uv, kps.depth,
                             feats.descriptors.unpacked, has_depth)

    n = _count(has_depth)
    true = torch.ones((), dtype=torch.bool, device=dev)
    result = TrackResult(pose=pose, n_matches=n, n_inliers=n,
                         tracking_ok=true, new_keyframe=true,
                         kf_slot=kf_slot)
    new_state = TrackState(pose=pose, ref_kf=kf_slot,
                           frame_idx=state.frame_idx + 1,
                           lost=torch.zeros((), dtype=torch.bool, device=dev),
                           since_kf=torch.zeros_like(state.since_kf))
    return arena, new_state, result


def _track(arena: MapArena, state: TrackState, feats: Features, cam: Camera,
           cfg: SlamConfig, time: Tensor, key,
           match_fn=None, pnp_fn=None,
           ) -> Tuple[MapArena, TrackState, TrackResult]:
    kps = feats.keypoints
    desc = feats.descriptors.unpacked
    tcfg = cfg.tracker

    # injected components (models/components.py); None -> the built-ins
    if match_fn is None:
        match_fn = lambda q, qv, t, tv: match_descriptors(  # noqa: E731
            q, qv, t, tv, cfg.matcher)
    if pnp_fn is None:
        pnp_fn = lambda pw, uv, pc, v, init, k: ransac_pnp(  # noqa: E731
            cam, pw, uv, pc, v, init, k, cfg.pnp)

    with span("track.match"):
        # --- candidate landmarks: 2-hop covisibility of the reference KF -----
        kf_mask = khop_keyframes(arena, state.ref_kf,
                                 tcfg.covis_depth_tracking)
        lm_mask = visible_landmarks(arena, kf_mask)

        # --- 2-NN ratio matching against landmark descriptors (kernel K2) ----
        matches = match_fn(desc, kps.valid, arena.lm_desc, lm_mask)
        matches = dedupe_matches(matches, arena.max_landmarks)

        has_depth = kps.depth > 0.0
        m_ok = matches.valid & has_depth
        n_matches = _count(m_ok)

    with span("track.pnp"):
        # --- PnP -------------------------------------------------------------
        pts_world = arena.lm_pos[matches.lm_slot.long()]
        pts_cam = backproject(cam, kps.uv, kps.depth)
        pnp = pnp_fn(pts_world, kps.uv, pts_cam, m_ok, state.pose, key)

        enough = n_matches >= tcfg.min_matched_points
        ok = enough & pnp.ok
        pose = Pose(q=torch.where(ok, pnp.pose.q, state.pose.q),
                    t=torch.where(ok, pnp.pose.t, state.pose.t))
        n_inliers = torch.where(ok, pnp.n_inliers,
                                torch.zeros_like(pnp.n_inliers))

    with span("track.keyframe"):
        # --- keyframe policy: inlier floor | weak vs reference | overdue -----
        # (a reference slot of K, a keyframe the full pool dropped, reads row
        # K - 1 as the JAX gather clamps it)
        K, L = arena.max_keyframes, arena.max_landmarks
        ref_row = torch.clamp(state.ref_kf, max=K - 1)
        n_ref_obs = torch.sum(_pick(arena.inc, ref_row).to(torch.float32))
        weak_vs_ref = (n_inliers.to(torch.float32)
                       < tcfg.new_keyframe_inlier_ratio * n_ref_obs)
        overdue = (state.since_kf + 1) >= tcfg.max_kf_interval
        need_kf = ok & ((n_inliers < tcfg.new_keyframe_min_inliers)
                        | weak_vs_ref | overdue)

        # --- better-reference search: visibility voting over 5 hops, on the
        # arena before the keyframe branch's inserts (used when no keyframe)
        hop5 = khop_keyframes(arena, state.ref_kf,
                              tcfg.covis_depth_better_kf)
        # scatter with a sentinel row L, dropped by the slice
        slots = torch.where(pnp.inliers, matches.lm_slot.long(),
                            torch.full_like(matches.lm_slot.long(), L))
        inlier_lm = torch.zeros(L + 1, dtype=torch.float32,
                                device=slots.device).index_fill(0, slots, 1.0)
        votes = (arena.inc.to(torch.float32) @ inlier_lm[:L]).to(torch.int32)
        votes = torch.where(hop5 & arena.kf_valid, votes,
                            torch.full_like(votes, -1))
        best = torch.argmax(votes).to(torch.int32)
        ref = torch.where(_pick(votes, best) > 0, best, state.ref_kf)

        # --- the keyframe branch, masked by need_kf --------------------------
        arena, kf_slot = add_keyframe(arena, pose, time, enable=need_kf)
        # observations of inlier-matched landmarks from the new keyframe
        arena = add_observations(arena, kf_slot, matches.lm_slot, kps.uv,
                                 kps.depth, desc, pnp.inliers, enable=need_kf)
        # new landmarks from unmatched keypoints with near depth
        unmatched = (kps.valid & ~matches.valid & (kps.depth > 0.0)
                     & (kps.depth <= tcfg.new_landmark_max_depth))
        pts_w_new = pose_apply(pose, pts_cam)
        arena, lm_slots = add_landmarks(arena, pts_w_new, desc, unmatched,
                                        enable=need_kf)
        arena = add_observations(arena, kf_slot, lm_slots, kps.uv, kps.depth,
                                 desc, unmatched, enable=need_kf)
        kf_or_ref = torch.where(need_kf, kf_slot, ref)
        ref_kf = torch.where(ok, kf_or_ref, state.ref_kf)

    result = TrackResult(
        pose=pose, n_matches=n_matches, n_inliers=n_inliers,
        tracking_ok=ok, new_keyframe=need_kf,
        kf_slot=torch.where(need_kf, kf_or_ref,
                            torch.full_like(kf_or_ref, -1)))
    new_state = TrackState(
        pose=pose, ref_kf=ref_kf, frame_idx=state.frame_idx + 1, lost=~ok,
        since_kf=torch.where(need_kf, torch.zeros_like(state.since_kf),
                             state.since_kf + 1))
    return arena, new_state, result


def track_frame(arena: MapArena, state: TrackState, feats: Features,
                cam: Camera, cfg: SlamConfig, time: Tensor, key,
                match_fn=None, pnp_fn=None, *,
                bootstrap: Optional[bool] = None,
                ) -> Tuple[MapArena, TrackState, TrackResult]:
    """One frontend step: bootstrap on the first frame, track afterwards.
    `key` is the frame's PRNG key (utils/prng.py; or a stand-in,
    ops/pnp.py), from which a tracked frame draws its RANSAC triplets.
    `bootstrap` (keyword-only: the port's own parameter) says whether
    the arena is empty (the JAX step's
    `arena.n_kf == 0`); when None it is read from the device, and
    otherwise the step reads nothing back.

    `match_fn` / `pnp_fn` are injected components (models/components.py
    has the contracts); None uses the built-ins."""
    if bootstrap is None:
        bootstrap = int(arena.n_kf) == 0
    if bootstrap:
        return _bootstrap(arena, state, feats, cam, cfg, time)
    return _track(arena, state, feats, cam, cfg, time, key,
                  match_fn=match_fn, pnp_fn=pnp_fn)
