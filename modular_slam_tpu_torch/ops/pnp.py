"""Batched RANSAC pose estimation + Gauss-Newton polish (counterpart of
modular_slam_tpu/ops/pnp.py).

A fixed batch of minimal hypotheses — 3-point rigid alignments of the
depth-backprojected observations onto their landmarks — is scored in
parallel by reprojection + depth-agreement inlier counts; hypothesis 0 is
the warm-start pose.  The best one is polished by damped Gauss-Newton on
the hybrid residual (2D reprojection rows + a disparity-scaled depth row).

The minimal-sample indices come from a `sampler(valid, n_hyp) ->
[n_hyp, 3]` argument: `jax.random` draws cannot be reproduced in torch, so
the parity tests replay the JAX draws through it, and `MultinomialSampler`
is the default.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from modular_slam_tpu_torch.config import PnpConfig
from modular_slam_tpu_torch.geometry.camera import Camera, project
from modular_slam_tpu_torch.geometry.se3 import (Pose, _cross,
                                                 matrix_to_quat,
                                                 pose_compose, pose_inverse,
                                                 quat_conjugate,
                                                 quat_normalize, quat_rotate,
                                                 quat_to_matrix, se3_exp)

Tensor = torch.Tensor
Sampler = Callable[[Tensor, int], Tensor]


class PnpResult(NamedTuple):
    pose: Pose          # camera-to-world
    inliers: Tensor     # [N] bool
    n_inliers: Tensor   # int32
    ok: Tensor          # bool — found a pose with >= min_points inliers


class MultinomialSampler:
    """Default RANSAC sampler: 3·n_hyp draws with replacement, uniform over
    the valid rows (the probabilities of pnp.py:211-212), on the CPU from
    an explicit generator, so a seed gives the same triplets for a CPU and
    a CUDA run of the same frames.  Duplicate indices within a triplet are
    degenerate and score out, as in the JAX package."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)

    def __call__(self, valid: Tensor, n_hyp: int) -> Tensor:
        probs = valid.cpu().to(torch.float32) + 1e-9  # normalizable if none
        idx = torch.multinomial(probs / torch.sum(probs), 3 * n_hyp,
                                replacement=True,
                                generator=self.generator)
        return idx.reshape(n_hyp, 3).to(valid.device)


def _triad(p1: Tensor, p2: Tensor, p3: Tensor) -> Tensor:
    """Orthonormal frames [..., 3, 3] (columns) from 3 points; degenerate
    sets give garbage that is scored out downstream."""
    e1 = p2 - p1
    e1 = e1 / torch.clamp(torch.linalg.vector_norm(e1, dim=-1, keepdim=True),
                          min=1e-9)
    e2 = p3 - p1
    e2 = e2 - torch.sum(e2 * e1, dim=-1, keepdim=True) * e1
    e2 = e2 / torch.clamp(torch.linalg.vector_norm(e2, dim=-1, keepdim=True),
                          min=1e-9)
    e3 = _cross(e1, e2)
    return torch.stack([e1, e2, e3], dim=-1)


def _align3(cam_pts: Tensor, world_pts: Tensor) -> Pose:
    """Rigid camera-to-world transforms from 3 correspondences
    [..., 3, 3] (point, xyz)."""
    bw = _triad(world_pts[..., 0, :], world_pts[..., 1, :],
                world_pts[..., 2, :])
    bc = _triad(cam_pts[..., 0, :], cam_pts[..., 1, :], cam_pts[..., 2, :])
    R = bw @ bc.transpose(-1, -2)
    q = matrix_to_quat(R)
    cw = torch.mean(cam_pts, dim=-2)
    ww = torch.mean(world_pts, dim=-2)
    t = ww - torch.einsum("...ij,...j->...i", R, cw)
    return Pose(q=q, t=t)


def _reproj_errors(cam: Camera, pose: Pose, pts_world: Tensor,
                   uv: Tensor) -> tuple:
    """Squared pixel errors, positive-depth mask and predicted camera
    depth; a batch of poses [H, 4]/[H, 3] gives [H, N]."""
    qi = quat_conjugate(quat_normalize(pose.q))
    pc = quat_rotate(qi[..., None, :], pts_world - pose.t[..., None, :])
    uv_hat = project(cam, pc)
    err2 = torch.sum((uv_hat - uv) ** 2, dim=-1)
    return err2, pc[..., 2] > 0.0, pc[..., 2]


def _inlier_mask(cam: Camera, pose: Pose, pts_world: Tensor, uv: Tensor,
                 z_meas: Tensor, valid: Tensor, thresh2: float,
                 z_thresh: float) -> Tensor:
    err2, front, z_pred = _reproj_errors(cam, pose, pts_world, uv)
    ok = valid & front & (err2 < thresh2)
    if z_thresh > 0.0:
        ok = ok & (torch.abs(z_pred - z_meas) < z_thresh)
    return ok


def _gauss_newton_polish(cam: Camera, pose0: Pose, pts_world: Tensor,
                         uv: Tensor, z_meas: Tensor, weights: Tensor,
                         iters: int, depth_weight: float) -> Pose:
    """Damped GN on the hybrid residual, left-multiplicative update of
    the camera-from-world transform T_cw; returns camera-to-world."""
    w_d = depth_weight * cam.fx / torch.clamp(z_meas, min=0.1)
    dev, dt = pts_world.device, pts_world.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    tcw = pose_inverse(pose0)
    for _ in range(iters):
        R = quat_to_matrix(tcw.q)
        pc = (pts_world @ R.T) + tcw.t
        z = torch.clamp(pc[:, 2], min=1e-6)
        inv_z = 1.0 / z
        x, y = pc[:, 0], pc[:, 1]
        uv_hat = torch.stack([x * inv_z * cam.fx + cam.cx,
                              y * inv_z * cam.fy + cam.cy], dim=-1)
        r2d = uv - uv_hat
        r = torch.cat([r2d, (w_d * (z_meas - pc[:, 2]))[:, None]], dim=-1)

        fxz = cam.fx * inv_z
        fyz = cam.fy * inv_z
        zero = torch.zeros_like(fxz)
        Jp = torch.stack([
            torch.stack([fxz, zero, -fxz * x * inv_z], dim=-1),
            torch.stack([zero, fyz, -fyz * y * inv_z], dim=-1),
        ], dim=-2)                                          # [N, 2, 3]
        px, py, pz = pc[:, 0], pc[:, 1], pc[:, 2]
        zeros = torch.zeros_like(px)
        skew = torch.stack([
            torch.stack([zeros, -pz, py], dim=-1),
            torch.stack([pz, zeros, -px], dim=-1),
            torch.stack([-py, px, zeros], dim=-1),
        ], dim=-2)                                          # [N, 3, 3]
        Jxi = torch.cat([eye3.expand(skew.shape), -skew], dim=-1)  # [N,3,6]
        J2d = torch.einsum("nij,njk->nik", Jp, Jxi)         # [N, 2, 6]
        Jz = w_d[:, None] * Jxi[:, 2, :]                    # [N, 6]
        J = torch.cat([J2d, Jz[:, None, :]], dim=1)         # [N, 3, 6]

        w = weights[:, None, None]
        Hm = torch.einsum("nik,nil->kl", J * w, J) + 1e-6 * eye6
        g = torch.einsum("nik,ni->k", J * w, r)
        # solve_ex: no host sync and no raise on a singular system, like
        # jnp.linalg.solve
        xi = torch.linalg.solve_ex(Hm, g)[0]
        tcw = pose_compose(se3_exp(xi), tcw)
    return pose_inverse(tcw)


def ransac_pnp(cam: Camera, pts_world: Tensor, uv: Tensor, pts_cam: Tensor,
               valid: Tensor, initial: Pose, sampler: Sampler,
               cfg: PnpConfig) -> PnpResult:
    """pts_world [N, 3] matched landmarks, uv [N, 2] observed pixels,
    pts_cam [N, 3] depth-backprojected observations, valid [N] usable
    matches, initial the warm-start pose."""
    thresh2 = cfg.inlier_threshold_px ** 2
    nvalid = torch.sum(valid.to(torch.int32), dtype=torch.int32)

    # --- hypothesis generation -------------------------------------------
    idx = sampler(valid, cfg.n_hypotheses).long()             # [H, 3]
    hyp = _align3(pts_cam[idx], pts_world[idx])
    hyp = Pose(q=torch.cat([initial.q[None], hyp.q]),
               t=torch.cat([initial.t[None], hyp.t]))

    z_meas = pts_cam[:, 2]
    inl_all = _inlier_mask(cam, hyp, pts_world, uv, z_meas, valid, thresh2,
                           cfg.depth_inlier_m)                # [H+1, N]
    counts = torch.sum(inl_all.to(torch.int32), dim=-1, dtype=torch.int32)
    best = torch.argmax(counts)
    best_pose = Pose(q=hyp.q[best], t=hyp.t[best])

    # --- polish on inliers ------------------------------------------------
    inl = _inlier_mask(cam, best_pose, pts_world, uv, z_meas, valid, thresh2,
                       cfg.depth_inlier_m)
    refined = _gauss_newton_polish(cam, best_pose, pts_world, uv, z_meas,
                                   inl.to(torch.float32), cfg.refine_iters,
                                   cfg.depth_weight)

    # final inlier classification at the refined pose; keep the unrefined
    # hypothesis if refinement lost inliers (degenerate GN on few points)
    inliers = _inlier_mask(cam, refined, pts_world, uv, z_meas, valid,
                           thresh2, cfg.depth_inlier_m)
    n_inl = torch.sum(inliers.to(torch.int32), dtype=torch.int32)
    keep_refined = n_inl >= counts[best]
    final_q = torch.where(keep_refined, refined.q, best_pose.q)
    final_t = torch.where(keep_refined, refined.t, best_pose.t)
    final_inl = torch.where(keep_refined, inliers, inl)
    final_n = torch.sum(final_inl.to(torch.int32), dtype=torch.int32)

    ok = (final_n >= cfg.min_points) & (nvalid >= cfg.min_points)
    return PnpResult(pose=Pose(q=quat_normalize(final_q), t=final_t),
                     inliers=final_inl, n_inliers=final_n, ok=ok)
