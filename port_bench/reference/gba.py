"""Global bundle adjustment in plain PyTorch: the yardstick for the
port's `make_global_ba_compact`.

The problem is the configuration's: keyframe poses and landmarks, one
residual per observation with the pixel error in u and v and the depth
error scaled by 0.25 fx / z (clamped at 0.1 m) as a third row, Huber on
the residual's norm at 2 px, keyframe 0 held fixed.  This solver runs
Levenberg-Marquardt to convergence with the exact Schur complement: the
3x3 landmark blocks are eliminated and the reduced camera system is
factored by Cholesky, so its optimum does not depend on an iteration
budget.  Outliers are the observations whose point-to-point residual at
a solution exceeds 0.15 m, as the configuration classifies them.

`dtype` is the precision of the arithmetic: float64 for the reference,
bfloat16 for the control (its Cholesky in float32, which PyTorch's
factorisations need).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class GbaSettings(NamedTuple):
    huber_px: float = 2.0
    depth_weight: float = 0.25
    outlier_m: float = 0.15
    max_iters: int = 60
    rtol: float = 1e-10


class Problem(NamedTuple):
    """Observations and the starting state, camera-to-world poses."""
    R_wc: Tensor      # [K, 3, 3]
    t_wc: Tensor      # [K, 3]
    lm: Tensor        # [L, 3]
    obs_kf: Tensor    # [O] int64
    obs_lm: Tensor    # [O] int64
    uv: Tensor        # [O, 2]
    depth: Tensor     # [O]
    cam: tuple        # (fx, fy, cx, cy)


def _skew(p: Tensor) -> Tensor:
    z = torch.zeros_like(p[..., 0])
    return torch.stack([z, -p[..., 2], p[..., 1], p[..., 2], z, -p[..., 0],
                        -p[..., 1], p[..., 0], z], -1).reshape(*p.shape[:-1], 3, 3)


def _exp_so3(w: Tensor) -> Tensor:
    th = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    k = w / torch.clamp(th, min=1e-30)
    K = _skew(k)
    s = torch.sin(th)[..., None]
    c = torch.cos(th)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s * K + (1 - c) * (K @ K)


def residuals(p: Problem, R_cw: Tensor, t_cw: Tensor, lm: Tensor,
              s: GbaSettings):
    """(r [O, 3], camera-frame points [O, 3]) at camera-from-world poses."""
    fx, fy, cx, cy = p.cam
    pc = torch.einsum("oij,oj->oi", R_cw[p.obs_kf], lm[p.obs_lm]) + t_cw[p.obs_kf]
    inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    w_d = s.depth_weight * fx / torch.clamp(p.depth, min=0.1)
    r = torch.stack([pc[:, 0] * inv_z * fx + cx - p.uv[:, 0],
                     pc[:, 1] * inv_z * fy + cy - p.uv[:, 1],
                     w_d * (pc[:, 2] - p.depth)], -1)
    return r, pc


def huber_cost(r: Tensor, delta: float) -> Tensor:
    n = torch.linalg.vector_norm(r, dim=-1)
    return torch.sum(torch.where(n <= delta, 0.5 * n * n, delta * (n - 0.5 * delta)))


def cost_of(p: Problem, R_wc: Tensor, t_wc: Tensor, lm: Tensor,
            s: GbaSettings = GbaSettings()) -> float:
    """The robust cost of a camera-to-world state, in float64."""
    d = torch.float64
    R_cw = R_wc.to(d).transpose(-1, -2)
    t_cw = -torch.einsum("kij,kj->ki", R_cw, t_wc.to(d))
    q = Problem(*[x.to(d) if torch.is_tensor(x) and x.is_floating_point() else x
                  for x in p])
    r, _ = residuals(q, R_cw, t_cw, lm.to(d), s)
    return float(huber_cost(r, s.huber_px))


def outliers(p: Problem, R_wc: Tensor, t_wc: Tensor, lm: Tensor,
             s: GbaSettings = GbaSettings(),
             dtype: torch.dtype = torch.float64) -> Tensor:
    """[O] bool: point-to-point residual above `outlier_m`, computed in
    `dtype`."""
    d = dtype
    fx, fy, cx, cy = p.cam
    R_cw = R_wc.to(d).transpose(-1, -2)
    t_cw = -torch.einsum("kij,kj->ki", R_cw, t_wc.to(d))
    pc = (torch.einsum("oij,oj->oi", R_cw[p.obs_kf], lm.to(d)[p.obs_lm])
          + t_cw[p.obs_kf])
    z = p.depth.to(d)
    p_obs = torch.stack([(p.uv[:, 0].to(d) - cx) * z / fx,
                         (p.uv[:, 1].to(d) - cy) * z / fy, z], -1)
    return torch.sum((pc - p_obs) ** 2, -1) > s.outlier_m ** 2


def _pairs(obs_lm: Tensor):
    """All ordered pairs (a, b) of observations of one landmark."""
    order = torch.argsort(obs_lm, stable=True)
    lm_sorted = obs_lm[order]
    counts = torch.bincount(lm_sorted)
    starts = torch.cumsum(counts, 0) - counts
    n = counts[lm_sorted]
    first = starts[lm_sorted]
    rep = torch.repeat_interleave(torch.arange(order.shape[0], device=order.device), n)
    k = torch.arange(rep.shape[0], device=order.device)
    off = k - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    return order[rep], order[first[rep] + off]


def solve(p: Problem, s: GbaSettings = GbaSettings(),
          dtype: torch.dtype = torch.float64):
    """(R_wc, t_wc, lm, final cost) of LM run to convergence."""
    d = dtype
    dev = p.lm.device
    K, L = p.R_wc.shape[0], p.lm.shape[0]
    fx, fy, cx, cy = p.cam
    q = Problem(*[x.to(d) if torch.is_tensor(x) and x.is_floating_point() else x
                  for x in p])
    R_cw = q.R_wc.transpose(-1, -2).contiguous()
    t_cw = -torch.einsum("kij,kj->ki", R_cw, q.t_wc)
    lm = q.lm.clone()
    pa, pb = _pairs(p.obs_lm)
    pair_blk = p.obs_kf[pa] * K + p.obs_kf[pb]
    eye3 = torch.eye(3, dtype=d, device=dev)

    def cost(R, t, l):
        r, _ = residuals(q, R, t, l, s)
        return huber_cost(r, s.huber_px)

    cur = cost(R_cw, t_cw, lm)
    lam = 1e-4
    stalls = 0
    for _ in range(s.max_iters):
        r, pc = residuals(q, R_cw, t_cw, lm, s)
        nrm = torch.linalg.vector_norm(r, dim=-1)
        w = torch.where(nrm <= s.huber_px, torch.ones_like(nrm),
                        s.huber_px / torch.clamp(nrm, min=1e-12))
        inv_z = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
        w_d = s.depth_weight * fx / torch.clamp(q.depth, min=0.1)
        zero = torch.zeros_like(inv_z)
        Jproj = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * pc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * pc[:, 1] * inv_z * inv_z], -1),
            torch.stack([zero, zero, w_d], -1)], -2)                 # [O, 3, 3]
        Jp = Jproj @ torch.cat([eye3.expand(pc.shape[0], 3, 3), -_skew(pc)], -1)
        Jl = Jproj @ R_cw[p.obs_kf]
        Jp = torch.where((p.obs_kf == 0)[:, None, None], torch.zeros_like(Jp), Jp)
        wr = w[:, None]
        U = torch.zeros(K, 6, 6, dtype=d, device=dev).index_add_(
            0, p.obs_kf, Jp.transpose(1, 2) @ (Jp * wr[..., None]))
        V = torch.zeros(L, 3, 3, dtype=d, device=dev).index_add_(
            0, p.obs_lm, Jl.transpose(1, 2) @ (Jl * wr[..., None]))
        W = Jp.transpose(1, 2) @ (Jl * wr[..., None])                # [O, 6, 3]
        bp = -torch.zeros(K, 6, dtype=d, device=dev).index_add_(
            0, p.obs_kf, torch.einsum("oki,ok->oi", Jp, r * wr))
        bl = -torch.zeros(L, 3, dtype=d, device=dev).index_add_(
            0, p.obs_lm, torch.einsum("oki,ok->oi", Jl, r * wr))
        while True:
            Vd = V + lam * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2)) \
                + 1e-9 * eye3
            Vinv = torch.linalg.inv(Vd.float() if d == torch.bfloat16 else Vd).to(d)
            Ud = U + lam * torch.diag_embed(torch.diagonal(U, dim1=1, dim2=2))
            A = W @ Vinv[p.obs_lm]                                   # [O, 6, 3]
            S = torch.zeros(K * K, 6, 6, dtype=d, device=dev).index_add_(
                0, pair_blk, -(A[pa] @ W[pb].transpose(1, 2)))
            S = S.reshape(K, K, 6, 6)
            S[torch.arange(K), torch.arange(K)] += Ud
            S = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
            rhs = bp - torch.zeros(K, 6, dtype=d, device=dev).index_add_(
                0, p.obs_kf, torch.einsum("oij,oj->oi", A, bl[p.obs_lm]))
            Sf = S[6:, 6:].to(torch.float64 if d == torch.float64 else torch.float32)
            Sf = Sf + 1e-12 * torch.eye(Sf.shape[0], dtype=Sf.dtype, device=dev)
            ch, info = torch.linalg.cholesky_ex(Sf)
            if int(info) != 0:
                lam *= 10.0
                if lam > 1e8:
                    break
                continue
            dp = torch.zeros(K, 6, dtype=d, device=dev)
            dp[1:] = torch.cholesky_solve(rhs[1:].reshape(-1, 1).to(Sf.dtype),
                                          ch).reshape(K - 1, 6).to(d)
            dl = torch.einsum("lij,lj->li", Vinv, bl - torch.zeros(
                L, 3, dtype=d, device=dev).index_add_(
                    0, p.obs_lm, torch.einsum("oji,oj->oi", W, dp[p.obs_kf])))
            dR = _exp_so3(dp[:, 3:])
            R_new = dR @ R_cw
            t_new = torch.einsum("kij,kj->ki", dR, t_cw) + dp[:, :3]
            l_new = lm + dl
            new = cost(R_new, t_new, l_new)
            if bool(new < cur):
                rel = float((cur - new) / cur)
                R_cw, t_cw, lm, cur = R_new, t_new, l_new, new
                lam = max(lam * 0.1, 1e-12)
                stalls = stalls + 1 if rel < s.rtol else 0
                break
            lam *= 10.0
            if lam > 1e8:
                break
        if stalls >= 2 or lam > 1e8:
            break
    R_wc = R_cw.transpose(-1, -2)
    t_wc = -torch.einsum("kij,kj->ki", R_wc, t_cw)
    return R_wc, t_wc, lm, float(cur)
