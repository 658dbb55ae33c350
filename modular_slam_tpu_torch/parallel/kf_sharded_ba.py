"""Keyframe-block sharded global bundle adjustment over a 2-D grid of
ranks, BASELINE config 4 (counterpart of
modular_slam_tpu/parallel/kf_sharded_ba.py).

`parallel/sharded_ba.py` shards only the observation list; keyframe and
landmark state stays replicated.  This module partitions the reduced
camera system itself: keyframe state, landmark state and their U/V
Hessian blocks are split over the grid's "kf" axis (each rank holds K/nk
keyframes and L/nk landmark blocks during the solve), while observations
are split over both axes (O/(nk*no) rows per rank).

The JAX collectives and theirs here, on the grid's process groups:
  all_gather over kf          -> all_gather_into_tensor on the kf group
  psum over obs, psum_scatter over kf
                              -> all_reduce on the obs group, then
                                 reduce_scatter_tensor on the kf group
  psum over both axes         -> all_reduce on each group in turn
  CG inner products           -> `pcg`'s `dot`, all-reduced over kf

The LM loop is the JAX `lax.scan`, its accept a `torch.where`, with the
JAX arithmetic: the gauge at global slot 0, the 1e-8 / 1e-6 diagonal
loads, every row returned through `pose_inverse`.  Numerics match the
single-device matrix-free core up to reduction order.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist

from modular_slam_tpu_torch.backend.ba import (BAStats, _damp, _eye,
                                               _huber_cost, _inv3x3,
                                               _lm_update, _segment_sum,
                                               residual_model)
from modular_slam_tpu_torch.backend.cg import pcg
from modular_slam_tpu_torch.backend.residuals import ObsData, huber_weights
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import (backproject,
                                                    camera_from_config)
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_compose,
                                                 pose_inverse, quat_normalize,
                                                 se3_exp)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.parallel.mesh import Mesh, Spec, local_rows

Tensor = torch.Tensor


def all_gather(x: Tensor, group, n: int) -> Tensor:
    """Blocks of the ranks of `group`, stacked in rank order."""
    x = x.contiguous()
    wire = x.view(torch.uint8) if x.dtype == torch.bool else x
    out = wire.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.view(torch.bool) if x.dtype == torch.bool else out


def all_reduce(x: Tensor, group) -> Tensor:
    dist.all_reduce(x, group=group)
    return x


def make_kf_sharded_global_ba(cfg: SlamConfig, mesh: Mesh,
                              kf_axis: str = "kf",
                              obs_axis: str = "obs") -> Callable:
    """Global BA with keyframe/landmark state split over `kf_axis` and
    observations over (`kf_axis`, `obs_axis`).

    Returns fn(arena) -> (arena, BAStats, blocks): the arena gathered on
    every rank (updated in place), and `blocks`, the shapes of the
    keyframe and landmark blocks this rank held, {"kf_q": (K/nk, 4),
    "kf_t": (K/nk, 3), "lm_pos": (L/nk, 3)} (what the JAX tests read from
    `addressable_shards`).  K and L must divide by the kf-axis size and O
    by the rank count.  Follows the arena's float dtype."""
    cam = camera_from_config(cfg.camera, mesh.device)
    bcfg = cfg.backend
    nk, no = mesh.shape[kf_axis], mesh.shape[obs_axis]
    g_kf, g_obs = mesh.group(kf_axis), mesh.group(obs_axis)
    kf_i = mesh.coords[kf_axis]
    kf_sh, obs_sh = Spec((kf_axis,)), Spec((kf_axis, obs_axis))
    residuals, delta = residual_model(cam, bcfg, bcfg.global_residual)

    def ag(x):
        """kf block -> full array."""
        return all_gather(x, g_kf, nk)

    def rs(x):
        """full per-rank partial sums -> reduced kf block: summed over
        the obs axis, then summed and scattered over kf."""
        x = all_reduce(x.contiguous(), g_obs)
        out = x.new_empty((x.shape[0] // nk, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=g_kf)
        return out

    def psum_all(x):
        return all_reduce(all_reduce(x, g_obs), g_kf)

    def dot_kf(a, b):
        """inner product of kf-block vectors (replicated over obs)."""
        return all_reduce(torch.dot(a, b), g_kf)

    def global_ba(arena: MapArena) -> Tuple[MapArena, BAStats, Dict]:
        K, L, O = (arena.max_keyframes, arena.max_landmarks,
                   arena.max_observations)
        if K % nk or L % nk or O % (nk * no):
            raise ValueError(f"caps {(K, L, O)} do not split over the "
                             f"{nk}x{no} grid")
        Kb, Lb = K // nk, L // nk
        kf_q_b, kf_t_b, kf_valid_b = (local_rows(mesh, x, kf_sh) for x in
                                      (arena.kf_q, arena.kf_t,
                                       arena.kf_valid))
        lm_pos_b, lm_valid_b = (local_rows(mesh, x, kf_sh) for x in
                                (arena.lm_pos, arena.lm_valid))
        dt, dev = lm_pos_b.dtype, lm_pos_b.device

        def rows(x):
            return local_rows(mesh, x, obs_sh)

        uv = rows(arena.obs_uv)
        obs = ObsData(kf=rows(arena.obs_kf).long(),
                      lm=rows(arena.obs_lm).long(),
                      p_obs=backproject(cam, uv, rows(arena.obs_depth)),
                      uv=uv, w=rows(arena.obs_valid).to(torch.float32))

        lm_valid = ag(lm_valid_b)
        # gauge: global slot 0 fixed (ceres_backend.cpp:155-159)
        pose_free_b = kf_valid_b & (
            torch.arange(Kb, device=dev) + kf_i * Kb != 0)
        pose_free = ag(pose_free_b)
        pf_obs = pose_free[obs.kf].to(dt)[:, None, None]
        lf_obs = lm_valid[obs.lm].to(dt)[:, None, None]
        eyeK, eyeL = _eye(6, lm_pos_b), _eye(3, lm_pos_b)

        def seg_kf(x):
            return rs(_segment_sum(x, obs.kf, K))

        def seg_lm(x):
            return rs(_segment_sum(x, obs.lm, L))

        tcw0_b = pose_inverse(Pose(q=kf_q_b, t=kf_t_b))    # rowwise

        def cost_of(q_full, t_full, lm_full):
            r, _, _ = residuals(q_full, t_full, lm_full, obs)
            return psum_all(_huber_cost(r, delta, obs.w))

        def lm_step(q_b, t_b, lm_b, lam, cost):
            r, Jp, Jl = residuals(ag(q_b), ag(t_b), ag(lm_b), obs)
            w = huber_weights(r, delta, obs.w)[:, None, None]
            Jp = Jp * pf_obs
            Jl = Jl * lf_obs
            wJp, wJl = Jp * w, Jl * w

            # block-sharded normal equations
            U_b = seg_kf(torch.einsum("oki,okj->oij", wJp, Jp))   # [Kb,6,6]
            V_b = seg_lm(torch.einsum("oki,okj->oij", wJl, Jl))   # [Lb,3,3]
            b_p_b = -seg_kf(torch.einsum("oki,ok->oi", wJp, r))   # [Kb,6]
            b_l_b = -seg_lm(torch.einsum("oki,ok->oi", wJl, r))   # [Lb,3]
            Ud_b = _damp(U_b, lam, eyeK)
            Vinv_b = _inv3x3(_damp(V_b, lam, eyeL))

            def matvec(x_flat):
                x_b = x_flat.reshape(Kb, 6)
                ux = torch.einsum("kij,kj->ki", Ud_b, x_b)
                a = torch.einsum("oki,oi->ok", Jp, ag(x_b)[obs.kf])
                zb_b = seg_lm(torch.einsum("oki,ok->oi", wJl, a))
                y_b = torch.einsum("lij,lj->li", Vinv_b, zb_b)
                c = torch.einsum("oki,oi->ok", Jl, ag(y_b)[obs.lm])
                wx = seg_kf(torch.einsum("oki,ok->oi", wJp, c))
                return (ux - wx).reshape(-1)

            y0_b = torch.einsum("lij,lj->li", Vinv_b, b_l_b)
            c0 = torch.einsum("oki,oi->ok", Jl, ag(y0_b)[obs.lm])
            rhs_b = b_p_b - seg_kf(torch.einsum("oki,ok->oi", wJp, c0))
            Uinv_b = torch.linalg.inv_ex(Ud_b + 1e-6 * eyeK)[0]

            def precond(x_flat):
                return torch.einsum("kij,kj->ki", Uinv_b,
                                    x_flat.reshape(Kb, 6)).reshape(-1)

            dp_flat, cg_res = pcg(matvec, rhs_b.reshape(-1), precond,
                                  bcfg.cg_iters, dot=dot_kf)
            dp_b = dp_flat.reshape(Kb, 6) * pose_free_b[:, None].to(dt)

            # back-substitute landmark blocks
            a2 = torch.einsum("oki,oi->ok", Jp, ag(dp_b)[obs.kf])
            z2_b = seg_lm(torch.einsum("oki,ok->oi", wJl, a2))
            dl_b = (torch.einsum("lij,lj->li", Vinv_b, b_l_b - z2_b)
                    * lm_valid_b[:, None].to(dt))

            tcw_new = pose_compose(se3_exp(dp_b), Pose(q=q_b, t=t_b))
            lm_new = lm_b + dl_b
            new_cost = cost_of(ag(tcw_new.q), ag(tcw_new.t), ag(lm_new))
            out = _lm_update(bcfg, new_cost < cost, lam,
                             (tcw_new.q, tcw_new.t, lm_new, new_cost),
                             (q_b, t_b, lm_b, cost))
            q_o, t_o, lm_o, cost_o, lam_o = out
            return (q_o, t_o, lm_o, lam_o, cost_o), cg_res

        cost0 = cost_of(ag(tcw0_b.q), ag(tcw0_b.t), ag(lm_pos_b))
        state = (tcw0_b.q, tcw0_b.t, lm_pos_b,
                 torch.full((), bcfg.init_lambda, dtype=dt, device=dev),
                 cost0)
        cg_last = torch.zeros((), dtype=dt, device=dev)
        for _ in range(bcfg.max_iterations):
            state, cg_last = lm_step(*state)
        q_b, t_b, lm_b, _, cost_end = state

        wc = pose_inverse(Pose(q=quat_normalize(q_b), t=t_b))
        stats = BAStats(
            initial_cost=cost0, final_cost=cost_end,
            n_active_obs=psum_all(torch.sum((obs.w > 0).to(torch.int32))),
            n_outliers=torch.zeros((), dtype=torch.int32, device=dev),
            cg_residual=cg_last, n_iterations=bcfg.max_iterations)
        blocks = {"kf_q": tuple(wc.q.shape), "kf_t": tuple(wc.t.shape),
                  "lm_pos": tuple(lm_b.shape)}
        arena.kf_q.copy_(ag(wc.q))
        arena.kf_t.copy_(ag(wc.t))
        arena.lm_pos.copy_(ag(lm_b))
        return arena, stats, blocks

    return global_ba
