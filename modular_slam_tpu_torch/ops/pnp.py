"""Batched RANSAC pose estimation + Gauss-Newton polish (counterpart of
modular_slam_tpu/ops/pnp.py).

A fixed batch of minimal hypotheses — 3-point rigid alignments of the
depth-backprojected observations onto their landmarks — is scored in
parallel by reprojection + depth-agreement inlier counts; hypothesis 0 is
the warm-start pose.  The best one is polished by damped Gauss-Newton on
the hybrid residual (2D reprojection rows + a disparity-scaled depth row).

The minimal samples are JAX's: `jax.random.choice(key, N, (n_hyp, 3),
p=probs)` with probs = (valid + 1e-9) / sum, reproduced bit for bit by
`utils/prng.choice_rows`, so that a key gives the triplets the JAX
package draws from it on the CPU.  Two stand-ins may take the key's
place: `prng.Uniforms`, the key's uniforms already on the device (a
chunk's draws go up in one upload), and a `Sampler`, any callable
`(valid, n_hyp) -> [n_hyp, 3]`, which draws the rows itself and replaces
JAX's stream (the replay tools and tests; `MultinomialSampler` is one).
`prng.split` of a sampler gives the sampler back, so it passes through
every split of the engine.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from modular_slam_tpu_torch.config import PnpConfig
from modular_slam_tpu_torch.geometry.camera import Camera, project
from modular_slam_tpu_torch.geometry.se3 import (Pose, _cross,
                                                 matrix_to_quat,
                                                 pose_compose, pose_inverse,
                                                 quat_conjugate,
                                                 quat_normalize, quat_rotate,
                                                 quat_to_matrix, se3_exp)
from modular_slam_tpu_torch.utils.prng import choice_rows

Tensor = torch.Tensor
Sampler = Callable[[Tensor, int], Tensor]


class PnpResult(NamedTuple):
    pose: Pose          # camera-to-world
    inliers: Tensor     # [N] bool
    n_inliers: Tensor   # int32
    ok: Tensor          # bool — found a pose with >= min_points inliers


class MultinomialSampler:
    """A RANSAC sampler of its own stream, for a caller to pass in place
    of a key: 3·n_hyp draws with replacement, uniform over the valid rows
    (uniform over all rows when none is valid).  The uniforms come from an
    explicit CPU generator and are mapped to rows on the rows' device by
    an exact integer inverse CDF (`uniform_rows`), so a seed gives the
    same triplets for a CPU and a CUDA run of the same frames, and nothing
    is read back from the card."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(seed)

    def uniforms(self, n_hyp: int) -> Tensor:
        """The next draw's uniforms, [n_hyp, 3] float64 on the host."""
        return torch.rand((n_hyp, 3), generator=self.generator,
                          dtype=torch.float64)

    def __call__(self, valid: Tensor, n_hyp: int) -> Tensor:
        u = self.uniforms(n_hyp)
        if valid.device.type == "cuda":
            u = u.pin_memory().to(valid.device, non_blocking=True)
        return uniform_rows(u, valid)


def uniform_rows(u: Tensor, valid: Tensor) -> Tensor:
    """Uniforms u [..., H, 3] in [0, 1) -> row indices [..., H, 3] over
    valid [..., N]: the j-th valid row for j = floor(u * n_valid) (the
    j-th row when none is valid)."""
    N = valid.shape[-1]
    cdf = torch.cumsum(valid.to(torch.int64), -1)
    n = cdf[..., -1:]
    none = n == 0
    cdf = torch.where(none, torch.arange(1, N + 1, device=cdf.device), cdf)
    j = torch.floor(u * torch.where(none, N, n)[..., None]).to(torch.int64)
    rows = torch.searchsorted(cdf, j.reshape(*j.shape[:-2], -1), right=True)
    return rows.reshape(j.shape).clamp(max=N - 1)


def draw_rows(key, valid: Tensor, n_hyp: int) -> Tensor:
    """The minimal samples [..., n_hyp, 3] (int64) for masks valid
    [..., N]: JAX's draws for keys [..., 2] or their `prng.Uniforms`; a
    `Sampler` in the key's place draws them itself, one mask at a time."""
    if callable(key):
        return key(valid, n_hyp).long()
    return choice_rows(key, valid, n_hyp)


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
               valid: Tensor, initial: Pose, key, cfg: PnpConfig, *,
               sampler: Optional[Sampler] = None) -> PnpResult:
    """pts_world [N, 3] matched landmarks, uv [N, 2] observed pixels,
    pts_cam [N, 3] depth-backprojected observations, valid [N] usable
    matches, initial the warm-start pose, key the PRNG key [2] (or a
    stand-in, see the module's docstring).  `sampler`, when given, draws
    the triplets in place of the key's stream."""
    n = cfg.n_hypotheses
    idx = (draw_rows(key, valid, n) if sampler is None
           else sampler(valid, n).long())                     # [H, 3]
    return _ransac_from_rows(cam, pts_world, uv, pts_cam, valid, initial,
                             idx, cfg)


def _ransac_from_rows(cam: Camera, pts_world: Tensor, uv: Tensor,
                      pts_cam: Tensor, valid: Tensor, initial: Pose,
                      idx: Tensor, cfg: PnpConfig) -> PnpResult:
    """`ransac_pnp` on minimal samples already drawn, idx [H, 3]."""
    thresh2 = cfg.inlier_threshold_px ** 2
    nvalid = torch.sum(valid.to(torch.int32), dtype=torch.int32)

    # --- hypothesis generation -------------------------------------------
    hyp = _align3(pts_cam[idx], pts_world[idx])
    hyp = Pose(q=torch.cat([initial.q[None], hyp.q]),
               t=torch.cat([initial.t[None], hyp.t]))

    z_meas = pts_cam[:, 2]
    inl_all = _inlier_mask(cam, hyp, pts_world, uv, z_meas, valid, thresh2,
                           cfg.depth_inlier_m)                # [H+1, N]
    counts = torch.sum(inl_all.to(torch.int32), dim=-1, dtype=torch.int32)
    # gathers with a 1-d index: a 0-d tensor index reads it back to the host
    best = torch.argmax(counts).reshape(1)
    best_pose = Pose(q=hyp.q.index_select(0, best)[0],
                     t=hyp.t.index_select(0, best)[0])

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
    keep_refined = n_inl >= counts.index_select(0, best)[0]
    final_q = torch.where(keep_refined, refined.q, best_pose.q)
    final_t = torch.where(keep_refined, refined.t, best_pose.t)
    final_inl = torch.where(keep_refined, inliers, inl)
    final_n = torch.sum(final_inl.to(torch.int32), dtype=torch.int32)

    ok = (final_n >= cfg.min_points) & (nvalid >= cfg.min_points)
    return PnpResult(pose=Pose(q=quat_normalize(final_q), t=final_t),
                     inliers=final_inl, n_inliers=final_n, ok=ok)
