"""Levenberg-Marquardt bundle adjustment with Schur-complement landmark
elimination (counterpart of modular_slam_tpu/backend/ba.py).

Landmarks are eliminated analytically (block-diagonal 3x3 V).  Two cores
solve the reduced camera system S = U - W V^-1 W^T:

- `ba_core_dense` (local BA): observations laid out once on a dense
  [L, K] grid, S materialized as a [6K, 6K] matrix and solved directly;
- `ba_core` (global BA): matrix-free block-Jacobi PCG, each S·x two
  segment sums over the observation list, with an `allreduce` hook on
  every reduction so that the same code runs with observations sharded.

Departures from a literal translation, all for the card:

- The JAX LM loops exit early on the device (`lax.while_loop`).  Here the
  loop is a Python loop that reads its stop flag back once per iteration:
  one host sync, in exchange for not dispatching the iterations left after
  convergence (the host, not the device, is the busy side).
- `.at[...].set(mode="drop")` writes into buffers with one spare row or
  column that is then cut off, and the arena is updated in place through
  `_set_slots` and `_clear_pairs`, which do the same; no index is clamped
  onto a real row, and no host sync is needed.
- Segment sums are `index_add_`: on CUDA its float atomics add in a
  different order from run to run, so `ba_core` there is reproducible
  only to float32 rounding; on the CPU it is deterministic.
- Dense solves use `torch.linalg.solve_ex` / `inv_ex`, which skip the
  host-side error check of `solve` / `inv`.

Like the rest of the port, the functions that take an arena update its
tensors in place and return it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from modular_slam_tpu_torch.backend.cg import pcg
from modular_slam_tpu_torch.backend.residuals import (
    ObsData,
    gather_obs,
    huber_weights,
    point2point_residuals,
    point2point_residuals_grid,
    reprojection_residuals,
    reprojection_residuals_grid,
    rgbd_residuals,
    rgbd_residuals_grid,
)
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.engine import _resolve_device
from modular_slam_tpu_torch.frontend.tracker import TrackState
from modular_slam_tpu_torch.geometry.camera import (Camera, backproject,
                                                    camera_from_config)
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_compose,
                                                 pose_inverse, quat_normalize,
                                                 quat_to_matrix, se3_exp)
from modular_slam_tpu_torch.map.arena import (MapArena, khop_keyframes,
                                              visible_landmarks)
from modular_slam_tpu_torch.utils.indices import masked_indices

Tensor = torch.Tensor
F32 = torch.float32


class BAStats(NamedTuple):
    initial_cost: Tensor
    final_cost: Tensor
    n_active_obs: Tensor
    n_outliers: Tensor
    cg_residual: Tensor
    n_iterations: int    # LM iterations run (not in the JAX BAStats)


def _stall_update(stall: Tensor, accept: Tensor, improved: Tensor) -> Tensor:
    """Early-stop stall counter of the LM loop.

    A stall is an ACCEPTED step whose cost improvement fell below rtol —
    true convergence.  Rejected steps adapt lambda and leave the counter
    alone; an improving step resets it (`improved` implies `accept`)."""
    return torch.where(improved, torch.zeros_like(stall),
                       torch.where(accept, stall + 1, stall))


def _huber_cost(r: Tensor, delta: float, w: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(r, dim=-1)
    rho = torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta))
    return torch.sum(rho * w)


def _inv3x3(M: Tensor) -> Tensor:
    """Batched 3x3 inverse via the adjugate; |det| <= 1e-12 divides by
    1e-12 instead (part of the result, as in JAX)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det,
                                torch.full_like(det, 1e-12))
    adj = torch.stack([A, B, C, D, E, F, G, H, I], dim=-1)
    return adj.reshape(*M.shape[:-2], 3, 3) * inv_det[..., None, None]


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=F32, device=like.device)


def _damp(M: Tensor, lam: Tensor, eye: Tensor) -> Tensor:
    """Marquardt damping of the diagonal blocks."""
    return M + lam * M * eye + 1e-8 * eye


def _lm_update(cfg, accept: Tensor, lam: Tensor, new, old):
    """Keep the tentative (q, t, lm, cost) where accepted; lambda down on
    accept, up on reject, clipped to [1e-9, 1e6]."""
    kept = tuple(torch.where(accept, n, o) for n, o in zip(new, old))
    lam = torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up)
    return kept + (torch.clamp(lam, 1e-9, 1e6),)


def _free_poses(pose_free: Tensor, q_cw: Tensor, t_cw: Tensor,
                q_wc0: Tensor, t_wc0: Tensor) -> Tuple[Tensor, Tensor]:
    """Optimized camera-from-world poses back to camera-to-world.  Fixed
    poses (the gauge) come back bit-identical as they went in; the JAX
    cores return them through an inverse round trip, within 1e-7."""
    wc = pose_inverse(Pose(q=quat_normalize(q_cw), t=t_cw))
    free = pose_free[:, None]
    return (torch.where(free, wc.q, q_wc0), torch.where(free, wc.t, t_wc0))


def _segment_sum(x: Tensor, idx: Tensor, n: int) -> Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx, x)


def ba_core(
    cam: Camera,
    kf_q_wc: Tensor, kf_t_wc: Tensor,   # [K,4],[K,3] camera-to-world
    lm_pos: Tensor,                     # [L,3]
    obs: ObsData,                       # weights already encode activity
    pose_free: Tensor,                  # [K] bool
    lm_free: Tensor,                    # [L] bool
    cfg,                                # BackendConfig
    residual_type: str = "p2p",
    allreduce: Callable[[Tensor], Tensor] = lambda x: x,
    early_stop_rtol: Optional[float] = None,
) -> Tuple[Tensor, Tensor, Tensor, BAStats]:
    """Matrix-free LM; returns (kf_q_wc, kf_t_wc, lm_pos, stats).

    `allreduce` is applied to every observation reduction (the segment
    sums and the costs): the identity on one device, a sum across devices
    when the observations are sharded.

    `early_stop_rtol`: when set, the loop stops once TWO accepted steps
    improved the cost by less than rtol (relative) with no better step
    between them, or at `cfg.max_iterations`; unset, it runs
    `cfg.max_iterations` steps."""
    K = kf_q_wc.shape[0]
    L = lm_pos.shape[0]
    tcw0 = pose_inverse(Pose(q=kf_q_wc, t=kf_t_wc))
    # huber deltas live in residual units: meters (p2p) vs pixels
    delta = cfg.huber_delta if residual_type == "p2p" else cfg.huber_delta_px

    def residuals(q_cw, t_cw, lm):
        R = quat_to_matrix(q_cw)
        if residual_type == "p2p":
            return point2point_residuals(R, t_cw, lm, obs)
        if residual_type == "rgbd":
            return rgbd_residuals(cam, R, t_cw, lm, obs,
                                  depth_weight=cfg.depth_weight)
        return reprojection_residuals(cam, R, t_cw, lm, obs)

    pf_obs = pose_free[obs.kf].to(F32)[:, None, None]
    lf_obs = lm_free[obs.lm].to(F32)[:, None, None]
    eyeK, eyeL = _eye(6, lm_pos), _eye(3, lm_pos)

    def seg_kf(x):
        return allreduce(_segment_sum(x, obs.kf, K))

    def seg_lm(x):
        return allreduce(_segment_sum(x, obs.lm, L))

    def cost_of(q_cw, t_cw, lm):
        r, _, _ = residuals(q_cw, t_cw, lm)
        return allreduce(_huber_cost(r, delta, obs.w))

    def lm_step(q_cw, t_cw, lm, lam, cost):
        r, Jp, Jl = residuals(q_cw, t_cw, lm)
        w = huber_weights(r, delta, obs.w)[:, None, None]
        # fixed parameters: zero Jacobians (their residuals still
        # constrain the free ones)
        Jp = Jp * pf_obs
        Jl = Jl * lf_obs
        wJp, wJl = Jp * w, Jl * w

        U = seg_kf(torch.einsum("oki,okj->oij", wJp, Jp))       # [K,6,6]
        V = seg_lm(torch.einsum("oki,okj->oij", wJl, Jl))       # [L,3,3]
        b_p = -seg_kf(torch.einsum("oki,ok->oi", wJp, r))       # [K,6]
        b_l = -seg_lm(torch.einsum("oki,ok->oi", wJl, r))       # [L,3]
        Ud = _damp(U, lam, eyeK)
        Vinv = _inv3x3(_damp(V, lam, eyeL))

        def matvec(x_flat):
            x = x_flat.reshape(K, 6)
            ux = torch.einsum("kij,kj->ki", Ud, x)
            a = torch.einsum("oki,oi->ok", Jp, x[obs.kf])
            zb = seg_lm(torch.einsum("oki,ok->oi", wJl, a))
            y = torch.einsum("lij,lj->li", Vinv, zb)
            c = torch.einsum("oki,oi->ok", Jl, y[obs.lm])
            wx = seg_kf(torch.einsum("oki,ok->oi", wJp, c))
            return (ux - wx).reshape(-1)

        # rhs = b_p - W Vinv b_l
        y0 = torch.einsum("lij,lj->li", Vinv, b_l)
        c0 = torch.einsum("oki,oi->ok", Jl, y0[obs.lm])
        rhs = b_p - seg_kf(torch.einsum("oki,ok->oi", wJp, c0))
        Uinv = torch.linalg.inv_ex(Ud + 1e-6 * eyeK)[0]

        def precond(x_flat):
            return torch.einsum("kij,kj->ki", Uinv,
                                x_flat.reshape(K, 6)).reshape(-1)

        dp_flat, cg_res = pcg(matvec, rhs.reshape(-1), precond, cfg.cg_iters)
        dp = dp_flat.reshape(K, 6) * pose_free[:, None].to(F32)

        # back-substitute landmarks
        a2 = torch.einsum("oki,oi->ok", Jp, dp[obs.kf])
        z2 = seg_lm(torch.einsum("oki,ok->oi", wJl, a2))
        dl = (torch.einsum("lij,lj->li", Vinv, b_l - z2)
              * lm_free[:, None].to(F32))

        tcw_new = pose_compose(se3_exp(dp), Pose(q=q_cw, t=t_cw))
        lm_new = lm + dl
        new_cost = cost_of(tcw_new.q, tcw_new.t, lm_new)
        accept = new_cost < cost
        out = _lm_update(cfg, accept, lam,
                         (tcw_new.q, tcw_new.t, lm_new, new_cost),
                         (q_cw, t_cw, lm, cost))
        q_o, t_o, lm_o, cost_o, lam_o = out
        return (q_o, t_o, lm_o, lam_o, cost_o), cg_res, accept

    cost0 = cost_of(tcw0.q, tcw0.t, lm_pos)
    state = (tcw0.q, tcw0.t, lm_pos,
             torch.full((), cfg.init_lambda, dtype=F32, device=lm_pos.device),
             cost0)
    cg_last = torch.zeros((), dtype=F32, device=lm_pos.device)
    n_it = 0
    if early_stop_rtol is None:
        for n_it in range(1, cfg.max_iterations + 1):
            state, cg_last, _ = lm_step(*state)
    else:
        rtol = torch.full((), early_stop_rtol, dtype=F32,
                          device=lm_pos.device)
        stall = torch.zeros((), dtype=torch.int32, device=lm_pos.device)
        while n_it < cfg.max_iterations:
            prev_cost = state[4]
            state, cg_last, accept = lm_step(*state)
            improved = state[4] < prev_cost * (1.0 - rtol)
            stall = _stall_update(stall, accept, improved)
            n_it += 1
            if int(stall) >= 2:       # the loop's one host sync
                break
    q_cw, t_cw, lm_out, _, cost_end = state
    q_wc, t_wc = _free_poses(pose_free, q_cw, t_cw, kf_q_wc, kf_t_wc)
    stats = BAStats(
        initial_cost=cost0, final_cost=cost_end,
        n_active_obs=allreduce(torch.sum((obs.w > 0).to(torch.int32))),
        n_outliers=torch.zeros((), dtype=torch.int32, device=lm_pos.device),
        cg_residual=cg_last, n_iterations=n_it)
    return q_wc, t_wc, lm_out, stats


# ---------------------------------------------------------------------------
# writes that drop out-of-range slots
# ---------------------------------------------------------------------------


def _set_slots(dst: Tensor, idx: Tensor, src: Tensor) -> None:
    """dst[idx[i]] = src[i] in place, dropping rows whose idx is
    len(dst).  The kept slots are distinct, so the result does not depend
    on the order of the writes."""
    pad = torch.cat([dst, dst.new_zeros((1, *dst.shape[1:]))])
    pad[idx] = src.to(dst.dtype)
    dst.copy_(pad[:-1])


def _clear_rows(flags: Tensor, rows: Tensor) -> None:
    """flags[rows] = False in place; rows == len(flags) are dropped.
    (`index_fill_` takes the value as a kernel argument; `clr[rows] = True`
    would copy it to the card and wait for the copy.)"""
    clr = torch.zeros(flags.shape[0] + 1, dtype=torch.bool,
                      device=flags.device)
    clr.index_fill_(0, rows, True)
    flags &= ~clr[:-1]


def _clear_pairs(inc: Tensor, bad: Tensor, kf: Tensor, lm: Tensor) -> None:
    """inc[kf[i], lm[i]] = False in place where bad[i]."""
    K, L = inc.shape
    clr = torch.zeros((K + 1, L + 1), dtype=torch.bool, device=inc.device)
    flat = (torch.where(bad, kf.long(), K) * (L + 1)
            + torch.where(bad, lm.long(), L))
    clr.view(-1).index_fill_(0, flat, True)
    inc &= ~clr[:K, :L]


def _inverse_map(idx: Tensor, n: int) -> Tensor:
    """[n] local position of each global slot in idx (len(idx) if absent);
    idx entries equal to n are dropped."""
    c = idx.shape[0]
    inv = torch.full((n + 1,), c, dtype=torch.int64, device=idx.device)
    inv[idx] = torch.arange(c, device=idx.device)
    return inv[:n]


def _outliers(prob_obs: ObsData, q_n: Tensor, t_n: Tensor, lm_n: Tensor,
              threshold_m: float) -> Tensor:
    """Outlier classification at the optimized state: squared
    point-to-point residual > threshold^2, active observations only."""
    tcw = pose_inverse(Pose(q=q_n, t=t_n))
    r, _, _ = point2point_residuals(quat_to_matrix(tcw.q), tcw.t, lm_n,
                                    prob_obs)
    return (prob_obs.w > 0) & (torch.sum(r * r, dim=-1) > threshold_m ** 2)


def ba_solve(
    cam: Camera,
    arena: MapArena,
    pose_free: Tensor,
    lm_free: Tensor,
    obs_active: Tensor,
    cfg,                       # BackendConfig
    residual_type: str = "p2p",
) -> Tuple[MapArena, BAStats]:
    """Bundle-adjust the arena in place."""
    obs = gather_obs(cam, arena, obs_active)
    kf_q, kf_t, lm_pos, stats = ba_core(
        cam, arena.kf_q, arena.kf_t, arena.lm_pos, obs,
        pose_free & arena.kf_valid, lm_free & arena.lm_valid,
        cfg, residual_type)
    bad = _outliers(obs, kf_q, kf_t, lm_pos, cfg.outlier_threshold_m)
    arena.obs_valid.logical_and_(~bad)
    _clear_pairs(arena.inc, bad, arena.obs_kf, arena.obs_lm)
    arena.kf_q.copy_(kf_q)
    arena.kf_t.copy_(kf_t)
    arena.lm_pos.copy_(lm_pos)
    return arena, stats._replace(n_outliers=torch.sum(bad.to(torch.int32)))


def ba_core_dense(
    cam: Camera,
    kf_q_wc: Tensor, kf_t_wc: Tensor,   # [K,4],[K,3] camera-to-world
    lm_pos: Tensor,                     # [L,3]
    obs: ObsData,
    pose_free: Tensor,                  # [K] bool
    lm_free: Tensor,                    # [L] bool
    cfg,                                # BackendConfig
    residual_type: str = "p2p",
) -> Tuple[Tensor, Tensor, Tensor, BAStats]:
    """LM with a dense materialized Schur complement, for compacted local
    windows (K small).  The observations are laid out once on a dense
    [L, K] grid (absent pairs weight 0); every iteration is then
    elementwise residuals over the grid, einsum contractions over l, and
    one [6K, 6K] solve.  Stops after an accepted step that improves the
    cost by at most 1e-5 (relative), or at `cfg.max_iterations`."""
    K = kf_q_wc.shape[0]
    L = lm_pos.shape[0]
    dev = lm_pos.device
    tcw0 = pose_inverse(Pose(q=kf_q_wc, t=kf_t_wc))
    delta = cfg.huber_delta if residual_type == "p2p" else cfg.huber_delta_px

    # one (kf, lm) pair holds at most one observation (add_observations
    # records a landmark once per keyframe); inactive rows go to the spare
    # row L / column K, which is cut off
    active = obs.w > 0
    l_sc = torch.where(active, obs.lm, L)
    k_sc = torch.where(active, obs.kf, K)

    def grid(values: Tensor) -> Tensor:
        g = torch.zeros((L + 1, K + 1, *values.shape[1:]), dtype=F32,
                        device=dev)
        g[l_sc, k_sc] = values
        return g[:L, :K]

    w_g, p_g, uv_g = grid(obs.w), grid(obs.p_obs), grid(obs.uv)

    def residuals(q_cw, t_cw, lm):
        R = quat_to_matrix(q_cw)
        if residual_type == "p2p":
            return point2point_residuals_grid(R, t_cw, lm, p_g)
        if residual_type == "rgbd":
            return rgbd_residuals_grid(cam, R, t_cw, lm, p_g, uv_g,
                                       depth_weight=cfg.depth_weight)
        return reprojection_residuals_grid(cam, R, t_cw, lm, p_g, uv_g)

    pf_g = pose_free.to(F32)[None, :, None, None]           # [1,K,1,1]
    lf_g = lm_free.to(F32)[:, None, None, None]             # [L,1,1,1]
    eyeK, eyeL = _eye(6, lm_pos), _eye(3, lm_pos)
    free6 = pose_free[:, None].expand(K, 6).reshape(-1)
    fixed_diag = torch.diag((~free6).to(F32))

    def cost_of(q_cw, t_cw, lm):
        r, _, _ = residuals(q_cw, t_cw, lm)
        return _huber_cost(r, delta, w_g)

    def lm_step(q_cw, t_cw, lm, lam, cost):
        rw, Jp, Jl = residuals(q_cw, t_cw, lm)             # [L,K,d,...]
        w = huber_weights(rw, delta, w_g)[:, :, None, None]
        Jpr, Jlr = Jp * pf_g, Jl * lf_g
        Jpw, Jlw = Jpr * w, Jlr * w                        # weighted

        U = torch.einsum("lkdi,lkdj->kij", Jpw, Jpr)       # [K,6,6]
        V = torch.einsum("lkdi,lkdj->lij", Jlw, Jlr)       # [L,3,3]
        W = torch.einsum("lkdi,lkdj->klij", Jpw, Jlr)      # [K,L,6,3]
        b_p = -torch.einsum("lkdi,lkd->ki", Jpw, rw)       # [K,6]
        b_l = -torch.einsum("lkdi,lkd->li", Jlw, rw)       # [L,3]
        Ud = _damp(U, lam, eyeK)
        Vinv = _inv3x3(_damp(V, lam, eyeL))

        WVi = torch.einsum("klim,lmn->klin", W, Vinv)      # [K,L,6,3]
        S = -torch.einsum("alin,bljn->aibj", WVi, W)       # [K,6,K,6]
        # the diagonal blocks S[k, :, k, :] are distinct elements, so an
        # add through the diagonal view is exact
        S.diagonal(dim1=0, dim2=2).add_(Ud.permute(1, 2, 0))
        S = S.reshape(K * 6, K * 6)
        rhs = (b_p - torch.einsum("klin,ln->ki", WVi, b_l)).reshape(-1)

        # fixed poses: identity rows/cols force dx = 0
        S = torch.where(free6[:, None] & free6[None, :], S,
                        torch.zeros_like(S)) + fixed_diag
        rhs = torch.where(free6, rhs, torch.zeros_like(rhs))
        dp = torch.linalg.solve_ex(S, rhs)[0].reshape(K, 6)
        dp = dp * pose_free[:, None].to(F32)

        # back-substitute landmarks (dense grid: no segment ops)
        a2 = torch.einsum("lkdi,ki->lkd", Jpr, dp)
        z2 = torch.einsum("lkdi,lkd->li", Jlw, a2)
        dl = (torch.einsum("lij,lj->li", Vinv, b_l - z2)
              * lm_free[:, None].to(F32))

        tcw_new = pose_compose(se3_exp(dp), Pose(q=q_cw, t=t_cw))
        lm_new = lm + dl
        new_cost = cost_of(tcw_new.q, tcw_new.t, lm_new)
        accept = new_cost < cost
        q_o, t_o, lm_o, cost_o, lam_o = _lm_update(
            cfg, accept, lam, (tcw_new.q, tcw_new.t, lm_new, new_cost),
            (q_cw, t_cw, lm, cost))
        # converged: an ACCEPTED step improved the cost by <= 1e-5
        done = accept & (cost - new_cost <= 1e-5 * cost)
        return (q_o, t_o, lm_o, lam_o, cost_o), done

    cost0 = cost_of(tcw0.q, tcw0.t, lm_pos)
    state = (tcw0.q, tcw0.t, lm_pos,
             torch.full((), cfg.init_lambda, dtype=F32, device=dev), cost0)
    n_it = 0
    while n_it < cfg.max_iterations:
        state, done = lm_step(*state)
        n_it += 1
        if bool(done):                 # the loop's one host sync
            break
    q_cw, t_cw, lm_out, _, cost_end = state
    q_wc, t_wc = _free_poses(pose_free, q_cw, t_cw, kf_q_wc, kf_t_wc)
    zero = torch.zeros((), device=dev)
    stats = BAStats(
        initial_cost=cost0, final_cost=cost_end,
        n_active_obs=torch.sum(active.to(torch.int32)),
        n_outliers=zero.to(torch.int32), cg_residual=zero, n_iterations=n_it)
    return q_wc, t_wc, lm_out, stats


# ---------------------------------------------------------------------------
# windowed local BA: extract -> solve -> merge
#
# Three pure stages, so that the solve can run on another device than
# tracking (backend/executor.py offloads it to the CPU and merges it at the
# next keyframe).  `make_local_ba` chains all three.
# ---------------------------------------------------------------------------


class WindowProblem(NamedTuple):
    """A compacted local-BA window and the index maps that merge its
    solution back into the (possibly meanwhile advanced) arena.  Slots are
    append-only, so the merge stays exact after new keyframes and
    landmarks were appended while the solve was in flight."""

    kf_q: Tensor       # [Kc, 4] window keyframe poses (camera-to-world)
    kf_t: Tensor       # [Kc, 3]
    lm_pos: Tensor     # [Lc, 3]
    obs: ObsData       # [Oc] compacted observations (local indices)
    pose_free: Tensor  # [Kc] bool (slot 0 = gauge, held fixed)
    kf_ok: Tensor      # [Kc] bool — which window slots are real
    lm_ok: Tensor      # [Lc] bool
    kf_idx: Tensor     # [Kc] global keyframe slots (K = invalid)
    lm_idx: Tensor     # [Lc] global landmark slots (L = invalid)
    obs_idx: Tensor    # [Oc] global observation rows (O = invalid)
    obs_kf_g: Tensor   # [Oc] global kf slot per obs (for incidence clear)
    obs_lm_g: Tensor   # [Oc] global lm slot per obs


class WindowSolution(NamedTuple):
    kf_q: Tensor       # [Kc, 4] optimized window poses
    kf_t: Tensor       # [Kc, 3]
    lm_pos: Tensor     # [Lc, 3]
    bad: Tensor        # [Oc] bool — outlier observations to invalidate
    stats: BAStats     # of the solve (not in the JAX WindowSolution)


def _compact_obs(cam: Camera, arena: MapArena, obs_idx: Tensor,
                 inv_kf: Tensor, inv_lm: Tensor, Kc: int, Lc: int):
    """Observation rows obs_idx in window-local indices; rows that are
    padding or whose keyframe/landmark is outside the window get weight 0.
    Returns (obs, global kf slot per row, global lm slot per row)."""
    O = arena.max_observations
    obs_g = torch.clamp(obs_idx, 0, O - 1)
    obs_kf_g = arena.obs_kf[obs_g].long()
    obs_lm_g = arena.obs_lm[obs_g].long()
    o_kf = inv_kf[obs_kf_g]
    o_lm = inv_lm[obs_lm_g]
    ok = (obs_idx < O) & (o_kf < Kc) & (o_lm < Lc)
    uv = arena.obs_uv[obs_g]
    obs = ObsData(
        kf=torch.where(ok, o_kf, 0), lm=torch.where(ok, o_lm, 0),
        p_obs=backproject(cam, uv, arena.obs_depth[obs_g]), uv=uv,
        w=ok.to(F32))
    return obs, obs_kf_g, obs_lm_g


def extract_window(cam: Camera, arena: MapArena, kf_slot, bcfg
                   ) -> WindowProblem:
    """Compact the new keyframe's covisibility window into small static
    buffers (local_*_cap), so BA cost scales with the window, not the
    arena capacity.  Only observations *from window keyframes* enter the
    problem."""
    K, L, O = (arena.max_keyframes, arena.max_landmarks,
               arena.max_observations)
    Kc = min(bcfg.local_kf_cap, K)
    Lc = min(bcfg.local_lm_cap, L)
    Oc = min(bcfg.local_obs_cap, O)
    dev = arena.kf_q.device

    window = khop_keyframes(arena, kf_slot, bcfg.local_window_depth)
    window = window & arena.kf_valid
    lm_active = visible_landmarks(arena, window)
    obs_active = (arena.obs_valid & window[arena.obs_kf.long()]
                  & lm_active[arena.obs_lm.long()])

    # slot order == recency (append-only).  When the window exceeds Kc,
    # keep the Kc NEWEST slots, ascending, so local slot 0 is the oldest
    # selected keyframe (the gauge).  The start is a device value: gather
    # at start + arange(Kc) (start + Kc <= K) instead of reading it back.
    idx_all = masked_indices(window, K)
    n_w = torch.sum(window.to(torch.int64))
    start = torch.clamp(n_w - Kc, min=0)
    kf_idx = idx_all[start + torch.arange(Kc, device=dev)]
    lm_idx = masked_indices(lm_active, Lc)
    obs_idx = masked_indices(obs_active, Oc)
    kf_ok = kf_idx < K
    lm_ok = lm_idx < L

    obs, obs_kf_g, obs_lm_g = _compact_obs(
        cam, arena, obs_idx, _inverse_map(kf_idx, K),
        _inverse_map(lm_idx, L), Kc, Lc)
    kf_g = torch.clamp(kf_idx, 0, K - 1)
    return WindowProblem(
        kf_q=arena.kf_q[kf_g], kf_t=arena.kf_t[kf_g],
        lm_pos=arena.lm_pos[torch.clamp(lm_idx, 0, L - 1)], obs=obs,
        # gauge: local slot 0 = oldest SELECTED window keyframe
        pose_free=kf_ok & (torch.arange(Kc, device=dev) != 0),
        kf_ok=kf_ok, lm_ok=lm_ok, kf_idx=kf_idx, lm_idx=lm_idx,
        obs_idx=obs_idx, obs_kf_g=obs_kf_g, obs_lm_g=obs_lm_g)


def solve_window(cam: Camera, prob: WindowProblem, bcfg) -> WindowSolution:
    """Dense-Schur LM on the compacted window, then outlier classification.
    A pure function of the problem: it runs on the device its inputs (and
    `cam`) live on."""
    q_n, t_n, lm_n, stats = ba_core_dense(
        cam, prob.kf_q, prob.kf_t, prob.lm_pos, prob.obs,
        prob.pose_free, prob.lm_ok, bcfg, residual_type=bcfg.local_residual)
    bad = _outliers(prob.obs, q_n, t_n, lm_n, bcfg.outlier_threshold_m)
    return WindowSolution(kf_q=q_n, kf_t=t_n, lm_pos=lm_n, bad=bad,
                          stats=stats)


def merge_window(arena: MapArena, state: TrackState, prob: WindowProblem,
                 sol: WindowSolution) -> Tuple[MapArena, TrackState]:
    """Write an optimized window back into the arena (in place).

    The current sensor pose receives the world-side correction of the
    window's newest keyframe, D = P_new ∘ P_old⁻¹: right after the solve
    that is "pose = optimized keyframe pose"; after frames tracked during
    an async solve it carries the correction forward through the odometry
    accumulated since."""
    Kc = prob.kf_idx.shape[0]
    O = arena.max_observations
    _clear_rows(arena.obs_valid, torch.where(sol.bad, prob.obs_idx, O))
    _clear_pairs(arena.inc, sol.bad, prob.obs_kf_g, prob.obs_lm_g)

    n_valid = torch.sum(prob.kf_ok.to(torch.int64))
    # a [1] index: indexing with a 0-d tensor would read it back to the host
    newest = torch.clamp(n_valid - 1, 0, Kc - 1).reshape(1)
    old = Pose(q=prob.kf_q[newest][0], t=prob.kf_t[newest][0])
    new = Pose(q=sol.kf_q[newest][0], t=sol.kf_t[newest][0])
    corrected = pose_compose(pose_compose(new, pose_inverse(old)), state.pose)
    has_kf = n_valid > 0
    state = state._replace(pose=Pose(
        q=torch.where(has_kf, corrected.q, state.pose.q),
        t=torch.where(has_kf, corrected.t, state.pose.t)))

    _set_slots(arena.kf_q, prob.kf_idx, sol.kf_q)
    _set_slots(arena.kf_t, prob.kf_idx, sol.kf_t)
    _set_slots(arena.lm_pos, prob.lm_idx, sol.lm_pos)
    return arena, state


def local_ba_config(cfg: SlamConfig):
    """The BackendConfig of local BA: `local_max_iterations` LM steps."""
    return dataclasses.replace(
        cfg.backend, max_iterations=cfg.backend.local_max_iterations)


def make_local_ba(cfg: SlamConfig, device="cuda") -> Callable:
    """Synchronous local BA over the new keyframe's 1-hop covisibility
    window: extract + solve + merge.  Returns fn(arena, state, kf_slot) ->
    (arena, state), updating the arena in place.  Gauge: the oldest
    keyframe in the window is held fixed."""
    cam = camera_from_config(cfg.camera, _resolve_device(device))
    bcfg = local_ba_config(cfg)

    def local_ba(arena: MapArena, state: TrackState, kf_slot):
        prob = extract_window(cam, arena, kf_slot, bcfg)
        sol = solve_window(cam, prob, bcfg)
        return merge_window(arena, state, prob, sol)

    return local_ba


def make_global_ba(cfg: SlamConfig, device="cuda") -> Callable:
    """Global BA over every valid keyframe at the arena's full capacity.
    Returns fn(arena) -> (arena, stats), updating the arena in place.
    `make_global_ba_compact` scales with the live map instead."""
    cam = camera_from_config(cfg.camera, _resolve_device(device))
    bcfg = cfg.backend

    def global_ba(arena: MapArena):
        slot0 = torch.arange(arena.max_keyframes,
                             device=arena.kf_q.device) == 0
        return ba_solve(cam, arena, arena.kf_valid & ~slot0, arena.lm_valid,
                        arena.obs_valid, bcfg,
                        residual_type=bcfg.global_residual)

    return global_ba


def global_ba_tier(arena: MapArena) -> Tuple[int, int, int]:
    """Smallest power-of-two (Kt, Lt, Ot) caps covering the LIVE map (one
    host read of the three counters)."""
    return global_ba_tier_counts(arena)[0]


def tier_from_counts(counts: Tuple[int, int, int],
                     caps: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Host-pure tier from already-fetched counters."""
    def up(n, lo, hi):
        t = lo
        while t < min(n, hi):
            t *= 2
        return min(t, hi)

    return (up(counts[0], 16, caps[0]),
            up(counts[1], 1024, caps[1]),
            up(counts[2], 4096, caps[2]))


def standard_tier_ladder(caps: Tuple[int, int, int]
                         ) -> List[Tuple[int, int, int]]:
    """The diagonal global-BA tier ladder a growing map walks:
    (16, 1024, 4096) doubling every axis until all caps saturate."""
    K, L, O = caps
    ladder = []
    t = (min(16, K), min(1024, L), min(4096, O))
    while True:
        ladder.append(t)
        if t == (K, L, O):
            break
        t = (min(2 * t[0], K), min(2 * t[1], L), min(2 * t[2], O))
    return ladder


def global_ba_tier_counts(arena: MapArena
                          ) -> Tuple[Tuple[int, int, int],
                                     Tuple[int, int, int]]:
    """-> (tier, (n_kf, n_lm, n_obs)), the three counters read back in one
    copy."""
    n_kf, n_lm, n_obs = (int(x) for x in torch.stack(
        [arena.n_kf, arena.n_lm, arena.n_obs]).cpu())
    caps = (arena.max_keyframes, arena.max_landmarks,
            arena.max_observations)
    return tier_from_counts((n_kf, n_lm, n_obs), caps), (n_kf, n_lm, n_obs)


def make_global_ba_compact(cfg: SlamConfig, tier: Tuple[int, int, int],
                           device="cuda") -> Callable:
    """Global BA with the problem compacted to static (Kt, Lt, Ot) caps,
    so its cost scales with the live map, not the arena capacity; the
    caller picks `tier` with `global_ba_tier`.  A polish budget
    (`gba_max_iterations`, `gba_cg_iters`) with the early stop at
    `gba_early_stop_rtol`.

    Returns fn(arena) -> (arena, BAStats), updating the arena in place."""
    cam = camera_from_config(cfg.camera, _resolve_device(device))
    bcfg = dataclasses.replace(cfg.backend,
                               max_iterations=cfg.backend.gba_max_iterations,
                               cg_iters=cfg.backend.gba_cg_iters)
    Kt, Lt, Ot = tier

    def global_ba(arena: MapArena):
        K, L, O = (arena.max_keyframes, arena.max_landmarks,
                   arena.max_observations)
        kf_act, lm_act = arena.kf_valid, arena.lm_valid
        obs_act = (arena.obs_valid & kf_act[arena.obs_kf.long()]
                   & lm_act[arena.obs_lm.long()])

        # compact to the tier caps (ascending keeps slot 0 = gauge)
        kf_idx = masked_indices(kf_act, Kt)
        lm_idx = masked_indices(lm_act, Lt)
        obs_idx = masked_indices(obs_act, Ot)
        kf_ok, lm_ok = kf_idx < K, lm_idx < L
        obs, obs_kf_g, obs_lm_g = _compact_obs(
            cam, arena, obs_idx, _inverse_map(kf_idx, K),
            _inverse_map(lm_idx, L), Kt, Lt)
        kf_g = torch.clamp(kf_idx, 0, K - 1)
        pose_free = kf_ok & (torch.arange(Kt, device=kf_ok.device) != 0)
        q_n, t_n, lm_n, stats = ba_core(
            cam, arena.kf_q[kf_g], arena.kf_t[kf_g],
            arena.lm_pos[torch.clamp(lm_idx, 0, L - 1)], obs, pose_free,
            lm_ok, bcfg, residual_type=bcfg.global_residual,
            early_stop_rtol=bcfg.gba_early_stop_rtol)

        bad = _outliers(obs, q_n, t_n, lm_n, bcfg.outlier_threshold_m)
        _clear_rows(arena.obs_valid, torch.where(bad, obs_idx, O))
        _clear_pairs(arena.inc, bad, obs_kf_g, obs_lm_g)
        _set_slots(arena.kf_q, kf_idx, q_n)
        _set_slots(arena.kf_t, kf_idx, t_n)
        _set_slots(arena.lm_pos, lm_idx, lm_n)
        return arena, stats._replace(
            n_outliers=torch.sum(bad.to(torch.int32)))

    return global_ba
