"""Halo-exchange keyframe/landmark-block sharded global BA — the
communication-scaling upgrade of `parallel/kf_sharded_ba.py`
(counterpart of modular_slam_tpu/parallel/halo_ba.py).

The kf-sharded design gathers the full x [K,6] and y [L,3] on every
rank for each CG matvec, because a rank's observations reference
arbitrary keyframe and landmark slots.  This module uses the arena's
temporal layout instead:

- keyframe slots are recency-ordered (the compaction invariant,
  map/lifecycle.py), so block b of keyframe slots is a contiguous time
  range;
- landmarks are created in keyframe order, so landmark-slot block b
  covers the same time range;
- an observation therefore references a landmark in a block NEAR its
  keyframe's block — except re-observations across loop closures.

Sharding: rank b (on the "kf" axis) owns keyframe block b [Kb=K/nk] and
landmark block b [Lb=L/nk]; observations are BUCKETED BY KEYFRAME BLOCK
(rank b holds only observations whose keyframe lives in block b), so the
keyframe side of the solve — U blocks, b_p, the CG vector x, the Schur
matvec's Jp products — is rank-local with no communication.

The landmark side communicates through two channels:
- **halo window**: observations whose landmark block is within `halo`
  of their keyframe block accumulate into a (2*halo+1)-slab window;
  slabs go to the neighbouring ranks by point-to-point sends on the kf
  group (`batch_isend_irecv`; the JAX `lax.ppermute` ring shifts), so a
  rank's bytes are ~ halo * L/nk and shrink with the rank count;
- **far set**: the few observations violating locality (loop-closure
  re-observations) route through a compacted global set of at most
  `far_cap` landmark slots, reduced with a small all-reduce.

`halo_comms_table` gives the analytic bytes per CG matvec (the JAX
package's MULTICHIP record).  Numerics: exact against the single-device
core up to float reduction order — locality only decides WHICH channel
carries a contribution, never whether it is counted.  Two static
capacities bound the compaction: `obs_cap` rows per keyframe-block
bucket and `far_cap` far landmarks; overflow drops observations and is
REPORTED in the returned diagnostics (never silent).

The buckets, the far set and `far_pos` are computed identically on every
rank from the replicated arena; `utils/indices.masked_indices` is the
JAX one's, and the `mode="drop"` scatters write into buffers with a
spare row that is cut off, as in the arena.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from modular_slam_tpu_torch.backend.ba import (BAStats, _damp, _eye,
                                               _huber_cost, _inv3x3,
                                               _lm_update, _segment_sum,
                                               _set_slots, residual_model)
from modular_slam_tpu_torch.backend.cg import pcg
from modular_slam_tpu_torch.backend.residuals import ObsData, huber_weights
from modular_slam_tpu_torch.config import SlamConfig
from modular_slam_tpu_torch.geometry.camera import (backproject,
                                                    camera_from_config)
from modular_slam_tpu_torch.geometry.se3 import (Pose, pose_compose,
                                                 pose_inverse, quat_normalize,
                                                 se3_exp)
from modular_slam_tpu_torch.map.arena import MapArena
from modular_slam_tpu_torch.parallel.kf_sharded_ba import (all_gather,
                                                           all_reduce)
from modular_slam_tpu_torch.parallel.mesh import Mesh, Spec, local_rows
from modular_slam_tpu_torch.utils.indices import masked_indices

Tensor = torch.Tensor


def halo_comms_table(K: int, L: int, O: int, halo: int = 1,
                     far_cap: int = 1024, device_counts=(1, 2, 4, 8)):
    """Analytic per-device bytes for one CG matvec (the MULTICHIP
    scaling record).  kf-side: zero.  lm-side: one window allreduce of
    [*, 3] (reduce 2*halo slabs + broadcast 2*halo slabs of Lb rows)
    plus two far-set psums."""
    out = {}
    for nk in device_counts:
        Lb = L // nk
        win_mb = 4 * halo * min(Lb, L) * 3 * 4 / 1e6 if nk > 1 else 0.0
        far_mb = 2 * far_cap * 3 * 4 * (nk - 1) / max(nk, 1) / 1e6
        out[nk] = {
            "state_blocks_MB_per_dev": round(
                (K // nk * (6 * 6 + 6) + Lb * (3 * 3 + 3)) * 4 / 1e6, 3),
            "obs_rows_per_dev": O // nk,
            "lm_window_MB_per_cg_matvec": round(win_mb, 4),
            "far_psum_MB_per_cg_matvec": round(far_mb, 4),
            "total_MB_per_cg_matvec": round(win_mb + far_mb, 4),
        }
    return out


def _buckets(arena: MapArena, nk: int, H: int, Ob: int, far_cap: int):
    """Observations bucketed by keyframe block, the far set and its
    positions, as every rank computes them -> (bucket arrays [nk, Ob],
    far_idx [far_cap], far_ok [far_cap], diag)."""
    K, L, O = (arena.max_keyframes, arena.max_landmarks,
               arena.max_observations)
    Kb, Lb = K // nk, L // nk
    dev = arena.obs_kf.device
    obs_kf, obs_lm = arena.obs_kf.long(), arena.obs_lm.long()
    obs_act = (arena.obs_valid & arena.kf_valid[obs_kf]
               & arena.lm_valid[obs_lm])
    blk = torch.clamp(obs_kf, 0, K - 1) // Kb                    # [O]

    # bucket observations by keyframe block (fixed Ob rows each)
    idx = torch.stack([masked_indices(obs_act & (blk == b), Ob)
                       for b in range(nk)])                      # [nk, Ob]
    ok = idx < O
    g = torch.clamp(idx, 0, O - 1)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    b_kf = torch.where(ok, obs_kf[g], zero)
    b_lm = torch.where(ok, obs_lm[g], zero)
    b_uv = arena.obs_uv[g]
    b_depth = torch.where(ok, arena.obs_depth[g],
                          torch.ones((), dtype=arena.obs_depth.dtype,
                                     device=dev))

    # far classification: landmark block outside the halo window
    lm_blk = b_lm // Lb
    kf_blk = torch.arange(nk, device=dev)[:, None]
    is_far = ok & (torch.abs(lm_blk - kf_blk) > H)

    # global far landmark set (replicated), capped at far_cap; slot L is
    # dropped
    far_mask = torch.zeros(L, dtype=torch.bool, device=dev)
    _set_slots(far_mask, torch.where(is_far, b_lm, L).reshape(-1),
               torch.ones_like(is_far).reshape(-1))
    far_idx = masked_indices(far_mask, far_cap)                  # [far_cap]
    far_okv = far_idx < L
    far_pos = torch.full((L,), far_cap, dtype=torch.int64, device=dev)
    _set_slots(far_pos, torch.where(far_okv, far_idx, L),
               torch.arange(far_cap, device=dev))
    fs = far_pos[b_lm]                                           # [nk, Ob]
    far_overflow = is_far & (fs >= far_cap)

    keep = ok & ~far_overflow
    far = is_far & keep
    n_total = torch.sum(obs_act.to(torch.int32))
    n_kept = torch.sum(keep.to(torch.int32))
    diag = {"n_dropped_obs": n_total - n_kept,
            "n_far_obs": torch.sum(far.to(torch.int32)),
            "n_far_landmarks": torch.sum(far_okv.to(torch.int32))}
    buckets = (b_kf, b_lm, b_uv, b_depth, keep, far,
               torch.where(far, fs, zero))
    return buckets, far_idx, far_okv, diag


def make_halo_sharded_global_ba(
    cfg: SlamConfig, mesh: Mesh, kf_axis: str = "kf",
    halo: int = 1, far_cap: int = 1024, obs_cap: Optional[int] = None,
) -> Callable:
    """Returns fn(arena) -> (arena, BAStats, diag, blocks) with keyframe
    AND landmark state split over `kf_axis` and halo-exchange landmark
    communication: the arena gathered on every rank (updated in place),
    `diag` the JAX diagnostics (`n_dropped_obs` reports capacity
    overflow, 0 in budget; `n_far_obs`, `n_far_landmarks`), and
    `blocks` the shapes of the keyframe and landmark blocks this rank
    held.  K and L must divide by the kf-axis size.  Ranks along other
    axes repeat the solve.  Follows the arena's float dtype."""
    cam = camera_from_config(cfg.camera, mesh.device)
    bcfg = cfg.backend
    nk = mesh.shape[kf_axis]
    H = halo
    g_kf = mesh.group(kf_axis)
    kf_i = mesh.coords[kf_axis]
    kf_ranks = mesh.axis_ranks(kf_axis)
    kf_sh = Spec((kf_axis,))
    residuals, delta = residual_model(cam, bcfg, bcfg.global_residual)

    def psum_kf(x):
        return all_reduce(x, g_kf)

    def dot_kf(a, b):
        return all_reduce(torch.dot(a, b), g_kf)

    def _shift(x: Tensor, s: int) -> Tensor:
        """Send this rank's x to kf index i+s and receive that of i-s;
        a rank with no sender keeps zeros."""
        out = torch.zeros_like(x)
        ops = []
        if 0 <= kf_i + s < nk:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  kf_ranks[kf_i + s], group=g_kf))
        if 0 <= kf_i - s < nk:
            ops.append(dist.P2POp(dist.irecv, out, kf_ranks[kf_i - s],
                                  group=g_kf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def global_ba(arena: MapArena):
        K, L, O = (arena.max_keyframes, arena.max_landmarks,
                   arena.max_observations)
        if K % nk or L % nk:
            raise ValueError(f"caps {(K, L)} do not split over kf={nk}")
        Kb, Lb = K // nk, L // nk
        Ob = obs_cap if obs_cap is not None else min(
            O, max(256, 2 * O // nk))
        W = (2 * H + 1) * Lb            # window rows
        M = W + far_cap                 # local landmark-view rows
        buckets, far_idx, far_ok, diag = _buckets(arena, nk, H, Ob,
                                                  far_cap)
        o_kf, o_lm, o_uv, o_depth, o_w, o_far, o_fs = (b[kf_i]
                                                       for b in buckets)
        kf_q_b, kf_t_b, kf_valid_b, lm_pos_b, lm_valid_b = (
            local_rows(mesh, x, kf_sh) for x in
            (arena.kf_q, arena.kf_t, arena.kf_valid, arena.lm_pos,
             arena.lm_valid))
        dt, dev = lm_pos_b.dtype, lm_pos_b.device

        def _reduce_to_owner(win):
            """[W, ...] window partial sums -> [Lb, ...] own-block totals
            of all ranks' window contributions."""
            out = win[H * Lb:(H + 1) * Lb]
            for s in range(2 * H + 1):
                d = s - H
                if d == 0:
                    continue
                out = out + _shift(win[s * Lb:(s + 1) * Lb], d)
            return out

        def _broadcast_window(own):
            """[Lb, ...] own-block totals -> [W, ...] this rank's window
            view (slab s holds block kf_i - H + s)."""
            return torch.cat([own if s == H else _shift(own, H - s)
                              for s in range(2 * H + 1)])

        # own-block rows of the far set (replicated far_idx)
        far_mine = far_ok & (far_idx // Lb == kf_i)
        far_local_row = torch.where(far_mine, far_idx - kf_i * Lb, Lb)

        def _mine(x):
            return far_mine.reshape((-1,) + (1,) * (x.ndim - 1))

        def _merge_far_into_own(own, far_tot):
            """Add the all-reduced far-channel totals into the owner's
            rows (row Lb, not this rank's, is dropped)."""
            contrib = torch.where(_mine(far_tot), far_tot,
                                  torch.zeros_like(far_tot))
            return own + _segment_sum(contrib, far_local_row, Lb + 1)[:Lb]

        def _far_view_from_own(own):
            """Replicated [far_cap, ...] view of the merged owner rows."""
            rows = own[torch.clamp(far_local_row, 0, Lb - 1)]
            rows = torch.where(_mine(rows), rows, torch.zeros_like(rows))
            return psum_kf(rows)

        def lmspace_allreduce(x_m):
            """[M, ...] per-rank partial sums -> [M, ...] consistent
            totals (window slabs halo-exchanged, far rows all-reduced,
            owner rows merged so window and far views agree)."""
            own = _reduce_to_owner(x_m[:W])
            far_tot = psum_kf(x_m[W:].contiguous())
            own = _merge_far_into_own(own, far_tot)
            return torch.cat([_broadcast_window(own),
                              _far_view_from_own(own)])

        def lmspace_from_own(own):
            """[Lb, ...] owner state -> consistent [M, ...] view."""
            return torch.cat([_broadcast_window(own),
                              _far_view_from_own(own)])

        # local observation view: kf indices local to the block, lm
        # indices into the M-space (window position or W + far slot)
        kf_loc = torch.clamp(o_kf - kf_i * Kb, 0, Kb - 1)
        win_pos = torch.clamp(o_lm - (kf_i - H) * Lb, 0, W - 1)
        lm_loc = torch.where(o_far, W + torch.clamp(o_fs, 0, far_cap - 1),
                             win_pos)
        obs = ObsData(kf=kf_loc, lm=lm_loc,
                      p_obs=backproject(cam, o_uv, o_depth), uv=o_uv,
                      w=o_w.to(torch.float32))

        # validity / gauge in the M-space
        lm_valid_m = lmspace_from_own(lm_valid_b.to(torch.float32)) > 0.5
        pose_free_b = kf_valid_b & (
            torch.arange(Kb, device=dev) + kf_i * Kb != 0)
        pf_obs = pose_free_b[obs.kf].to(dt)[:, None, None]
        lf_obs = lm_valid_m[obs.lm].to(dt)[:, None, None]
        eyeK, eyeL = _eye(6, lm_pos_b), _eye(3, lm_pos_b)

        def seg_kf(x):                     # block-local: no communication
            return _segment_sum(x, obs.kf, Kb)

        def seg_lm(x):
            return lmspace_allreduce(_segment_sum(x, obs.lm, M))

        tcw0_b = pose_inverse(Pose(q=kf_q_b, t=kf_t_b))
        lm_m0 = lmspace_from_own(lm_pos_b)

        def cost_of(q_b, t_b, lm_m):
            r, _, _ = residuals(q_b, t_b, lm_m, obs)
            return psum_kf(_huber_cost(r, delta, obs.w))

        def lm_step(q_b, t_b, lm_m, lam, cost):
            r, Jp, Jl = residuals(q_b, t_b, lm_m, obs)
            w = huber_weights(r, delta, obs.w)[:, None, None]
            Jp = Jp * pf_obs
            Jl = Jl * lf_obs
            wJp, wJl = Jp * w, Jl * w

            U_b = seg_kf(torch.einsum("oki,okj->oij", wJp, Jp))   # [Kb,6,6]
            b_p_b = -seg_kf(torch.einsum("oki,ok->oi", wJp, r))   # [Kb,6]
            # landmark side: window + far channels, allreduced
            V_m = seg_lm(torch.einsum("oki,okj->oij", wJl, Jl))   # [M,3,3]
            b_l_m = seg_lm(torch.einsum("oki,ok->oi", wJl, r)) * -1.0
            Ud_b = _damp(U_b, lam, eyeK)
            Vinv_m = _inv3x3(_damp(V_m, lam, eyeL))

            def matvec(x_flat):
                x_b = x_flat.reshape(Kb, 6)
                ux = torch.einsum("kij,kj->ki", Ud_b, x_b)
                a = torch.einsum("oki,oi->ok", Jp, x_b[obs.kf])
                zb = seg_lm(torch.einsum("oki,ok->oi", wJl, a))   # [M,3]
                y = torch.einsum("lij,lj->li", Vinv_m, zb)
                c = torch.einsum("oki,oi->ok", Jl, y[obs.lm])
                wx = seg_kf(torch.einsum("oki,ok->oi", wJp, c))  # local!
                return (ux - wx).reshape(-1)

            y0 = torch.einsum("lij,lj->li", Vinv_m, b_l_m)
            c0 = torch.einsum("oki,oi->ok", Jl, y0[obs.lm])
            rhs_b = b_p_b - seg_kf(torch.einsum("oki,ok->oi", wJp, c0))
            Uinv_b = torch.linalg.inv_ex(Ud_b + 1e-6 * eyeK)[0]

            def precond(x_flat):
                return torch.einsum("kij,kj->ki", Uinv_b,
                                    x_flat.reshape(Kb, 6)).reshape(-1)

            dp_flat, cg_res = pcg(matvec, rhs_b.reshape(-1), precond,
                                  bcfg.cg_iters, dot=dot_kf)
            dp_b = dp_flat.reshape(Kb, 6) * pose_free_b[:, None].to(dt)

            # landmark back-substitution (consistent inputs -> every rank
            # computes identical updates for its view rows)
            a2 = torch.einsum("oki,oi->ok", Jp, dp_b[obs.kf])
            z2 = seg_lm(torch.einsum("oki,ok->oi", wJl, a2))
            dl_m = (torch.einsum("lij,lj->li", Vinv_m, b_l_m - z2)
                    * lm_valid_m[:, None].to(dt))

            tcw_new = pose_compose(se3_exp(dp_b), Pose(q=q_b, t=t_b))
            lm_new = lm_m + dl_m
            new_cost = cost_of(tcw_new.q, tcw_new.t, lm_new)
            out = _lm_update(bcfg, new_cost < cost, lam,
                             (tcw_new.q, tcw_new.t, lm_new, new_cost),
                             (q_b, t_b, lm_m, cost))
            q_o, t_o, lm_o, cost_o, lam_o = out
            return (q_o, t_o, lm_o, lam_o, cost_o), cg_res

        cost0 = cost_of(tcw0_b.q, tcw0_b.t, lm_m0)
        state = (tcw0_b.q, tcw0_b.t, lm_m0,
                 torch.full((), bcfg.init_lambda, dtype=dt, device=dev),
                 cost0)
        cg_last = torch.zeros((), dtype=dt, device=dev)
        for _ in range(bcfg.max_iterations):
            state, cg_last = lm_step(*state)
        q_b, t_b, lm_m, _, cost_end = state

        wc = pose_inverse(Pose(q=quat_normalize(q_b), t=t_b))
        lm_out_b = lm_m[H * Lb:(H + 1) * Lb]    # own block (center slab)
        stats = BAStats(
            initial_cost=cost0, final_cost=cost_end,
            n_active_obs=psum_kf(torch.sum((obs.w > 0).to(torch.int32))),
            n_outliers=torch.zeros((), dtype=torch.int32, device=dev),
            cg_residual=cg_last, n_iterations=bcfg.max_iterations)
        blocks = {"kf_q": tuple(wc.q.shape), "kf_t": tuple(wc.t.shape),
                  "lm_pos": tuple(lm_out_b.shape)}
        arena.kf_q.copy_(all_gather(wc.q, g_kf, nk))
        arena.kf_t.copy_(all_gather(wc.t, g_kf, nk))
        arena.lm_pos.copy_(all_gather(lm_out_b, g_kf, nk))
        return arena, stats, diag, blocks

    return global_ba
