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

Each `lax.cond` of the JAX version is a Python branch here, on one scalar
read from the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import Camera, backproject
from modular_slam_tpu_torch.geometry.se3 import Pose, identity_pose, pose_apply
from modular_slam_tpu_torch.map.arena import (MapArena, add_keyframe,
                                              add_landmarks, add_observations,
                                              khop_keyframes,
                                              visible_landmarks)
from modular_slam_tpu_torch.ops.match import dedupe_matches, match_descriptors
from modular_slam_tpu_torch.ops.pnp import Sampler, ransac_pnp
from modular_slam_tpu_torch.types import Features, TrackResult

Tensor = torch.Tensor


class TrackState(NamedTuple):
    pose: Pose          # current sensor pose (camera-to-world)
    ref_kf: Tensor      # int32 reference keyframe slot
    frame_idx: Tensor   # int32 — frames processed
    lost: Tensor        # bool — tracking currently lost
    since_kf: Tensor    # int32 — frames since the last keyframe insertion


def initial_state(device="cpu") -> TrackState:
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return TrackState(pose=identity_pose(device=device), ref_kf=i32(0),
                      frame_idx=i32(0),
                      lost=torch.tensor(False, device=device),
                      since_kf=i32(0))


def _count(mask: Tensor) -> Tensor:
    return torch.sum(mask.to(torch.int32), dtype=torch.int32)


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
    true = torch.tensor(True, device=dev)
    result = TrackResult(pose=pose, n_matches=n, n_inliers=n,
                         tracking_ok=true, new_keyframe=true,
                         kf_slot=kf_slot)
    new_state = TrackState(pose=pose, ref_kf=kf_slot,
                           frame_idx=state.frame_idx + 1,
                           lost=torch.tensor(False, device=dev),
                           since_kf=torch.zeros_like(state.since_kf))
    return arena, new_state, result


def _track(arena: MapArena, state: TrackState, feats: Features, cam: Camera,
           cfg: SlamConfig, time: Tensor, sampler: Sampler,
           ) -> Tuple[MapArena, TrackState, TrackResult]:
    kps = feats.keypoints
    desc = feats.descriptors.unpacked
    tcfg = cfg.tracker

    # --- candidate landmarks: 2-hop covisibility of the reference KF ------
    kf_mask = khop_keyframes(arena, state.ref_kf, tcfg.covis_depth_tracking)
    lm_mask = visible_landmarks(arena, kf_mask)

    # --- 2-NN ratio matching against landmark descriptors (kernel K2) ----
    matches = match_descriptors(desc, kps.valid, arena.lm_desc, lm_mask,
                                cfg.matcher)
    matches = dedupe_matches(matches, arena.max_landmarks)

    has_depth = kps.depth > 0.0
    m_ok = matches.valid & has_depth
    n_matches = _count(m_ok)

    # --- PnP ---------------------------------------------------------------
    pts_world = arena.lm_pos[matches.lm_slot.long()]
    pts_cam = backproject(cam, kps.uv, kps.depth)
    pnp = ransac_pnp(cam, pts_world, kps.uv, pts_cam, m_ok, state.pose,
                     sampler, cfg.pnp)

    enough = n_matches >= tcfg.min_matched_points
    ok = enough & pnp.ok
    pose = Pose(q=torch.where(ok, pnp.pose.q, state.pose.q),
                t=torch.where(ok, pnp.pose.t, state.pose.t))
    n_inliers = torch.where(ok, pnp.n_inliers, torch.zeros_like(pnp.n_inliers))

    # --- keyframe policy: inlier floor | weak vs reference | overdue -------
    n_ref_obs = torch.sum(arena.inc[state.ref_kf.long()].to(torch.float32))
    weak_vs_ref = (n_inliers.to(torch.float32)
                   < tcfg.new_keyframe_inlier_ratio * n_ref_obs)
    overdue = (state.since_kf + 1) >= tcfg.max_kf_interval
    need_kf = ok & ((n_inliers < tcfg.new_keyframe_min_inliers)
                    | weak_vs_ref | overdue)

    if bool(need_kf):
        arena, kf_slot = add_keyframe(arena, pose, time)
        # observations of inlier-matched landmarks from the new keyframe
        arena = add_observations(arena, kf_slot, matches.lm_slot, kps.uv,
                                 kps.depth, desc, pnp.inliers)
        # new landmarks from unmatched keypoints with near depth
        unmatched = (kps.valid & ~matches.valid & (kps.depth > 0.0)
                     & (kps.depth <= tcfg.new_landmark_max_depth))
        pts_w_new = pose_apply(pose, pts_cam)
        arena, lm_slots = add_landmarks(arena, pts_w_new, desc, unmatched)
        arena = add_observations(arena, kf_slot, lm_slots, kps.uv, kps.depth,
                                 desc, unmatched)
        kf_or_ref = kf_slot
    else:
        # better-reference search: visibility voting over 5 hops
        L = arena.max_landmarks
        hop5 = khop_keyframes(arena, state.ref_kf, tcfg.covis_depth_better_kf)
        # scatter with a sentinel row L, dropped by the slice
        slots = torch.where(pnp.inliers, matches.lm_slot.long(),
                            torch.full_like(matches.lm_slot.long(), L))
        inlier_lm = torch.zeros(L + 1, dtype=torch.float32,
                                device=slots.device)
        inlier_lm[slots] = 1.0
        votes = (arena.inc.to(torch.float32) @ inlier_lm[:L]).to(torch.int32)
        votes = torch.where(hop5 & arena.kf_valid, votes,
                            torch.full_like(votes, -1))
        best = torch.argmax(votes).to(torch.int32)
        kf_or_ref = torch.where(votes[best.long()] > 0, best, state.ref_kf)
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
                cam: Camera, cfg: SlamConfig, time: Tensor, sampler: Sampler,
                ) -> Tuple[MapArena, TrackState, TrackResult]:
    """One frontend step: bootstrap on the first frame, track afterwards.
    `sampler` draws the RANSAC triplets (ops/pnp.py) and is called once
    per tracked frame."""
    if int(arena.n_kf) == 0:
        return _bootstrap(arena, state, feats, cam, cfg, time)
    return _track(arena, state, feats, cam, cfg, time, sampler)
