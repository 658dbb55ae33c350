"""Bundle-adjustment residuals and analytic Jacobians (counterpart of
modular_slam_tpu/backend/residuals.py).

Three residual types:

- **3D point-to-point**: r = T_cw * l_world - backproject(uv, depth) in the
  camera frame (the local-BA default);
- **2D reprojection**: r = uv - project(T_cw * l);
- **hybrid RGB-D** (`rgbd_residuals`, the global-BA default): the pixel
  reprojection error plus the depth measurement as a third row, scaled to
  pixel-comparable units.

Pose parametrization: left-multiplicative se(3) delta on the
camera-from-world transform T_cw (exp(xi) * T_cw), so
d(T_cw * l)/dxi = [I | -[p_c]x] and d(T_cw * l)/dl = R_cw.

Each function has an observation-list form ([O] rows, gathers by slot)
and a `_grid` form over a dense [L, K] layout (backend/ba.py
`ba_core_dense`), where the slot lookups are broadcasts.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from modular_slam_tpu_torch.geometry.camera import Camera, backproject

Tensor = torch.Tensor


class ObsData(NamedTuple):
    """Gathered per-observation data, ready for residual evaluation."""

    kf: Tensor       # [O] int64 keyframe slot
    lm: Tensor       # [O] int64 landmark slot
    p_obs: Tensor    # [O, 3] backprojected observed point (camera frame)
    uv: Tensor       # [O, 2]
    w: Tensor        # [O] base weight (0 = inactive)


def _skew(v: Tensor) -> Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def _eye3(r: Tensor, batch) -> Tensor:
    return torch.eye(3, dtype=r.dtype, device=r.device).expand(*batch, 3, 3)


def _pose_jacobian(p_c: Tensor, batch) -> Tensor:
    """d(T_cw * l)/dxi = [I | -[p_c]x], [..., 3, 6]."""
    return torch.cat([_eye3(p_c, batch), -_skew(p_c)], dim=-1)


def _pixel_jacobian(cam: Camera, p_c: Tensor, inv_z: Tensor) -> Tensor:
    """d(uv)/d(p_c), [..., 2, 3]."""
    x, y = p_c[..., 0], p_c[..., 1]
    fxz, fyz = cam.fx * inv_z, cam.fy * inv_z
    zero = torch.zeros_like(fxz)
    return torch.stack([torch.stack([fxz, zero, -fxz * x * inv_z], dim=-1),
                        torch.stack([zero, fyz, -fyz * y * inv_z], dim=-1)],
                       dim=-2)


def _inv_depth(p_c: Tensor) -> Tensor:
    z = p_c[..., 2]
    return 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))


def _pixels(cam: Camera, p_c: Tensor, inv_z: Tensor) -> Tensor:
    return torch.stack([p_c[..., 0] * inv_z * cam.fx + cam.cx,
                        p_c[..., 1] * inv_z * cam.fy + cam.cy], dim=-1)


def _depth_row(cam: Camera, p_c: Tensor, z_meas: Tensor,
               depth_weight: float) -> Tuple[Tensor, Tensor]:
    """Row 2 of the RGB-D residual, w_d * (z_pred - z_meas), and w_d =
    depth_weight * fx / z_meas (constant in the parameters)."""
    w_d = depth_weight * cam.fx / torch.clamp(z_meas, min=0.1)
    return w_d * (p_c[..., 2] - z_meas), w_d


def point2point_residuals(
    R_cw: Tensor,     # [K, 3, 3] camera-from-world rotations
    t_cw: Tensor,     # [K, 3]
    lm_pos: Tensor,   # [L, 3]
    obs: ObsData,
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [O, 3], Jp [O, 3, 6], Jl [O, 3, 3])."""
    Rk = R_cw[obs.kf]
    p_c = torch.einsum("oij,oj->oi", Rk, lm_pos[obs.lm]) + t_cw[obs.kf]
    r = p_c - obs.p_obs
    return r, _pose_jacobian(p_c, r.shape[:1]), Rk


def reprojection_residuals(
    cam: Camera, R_cw: Tensor, t_cw: Tensor, lm_pos: Tensor, obs: ObsData,
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [O, 2], Jp [O, 2, 6], Jl [O, 2, 3])."""
    Rk = R_cw[obs.kf]
    p_c = torch.einsum("oij,oj->oi", Rk, lm_pos[obs.lm]) + t_cw[obs.kf]
    inv_z = _inv_depth(p_c)
    r = _pixels(cam, p_c, inv_z) - obs.uv
    Jproj = _pixel_jacobian(cam, p_c, inv_z)                 # [O, 2, 3]
    Jp = torch.einsum("oij,ojk->oik", Jproj,
                      _pose_jacobian(p_c, r.shape[:1]))
    Jl = torch.einsum("oij,ojk->oik", Jproj, Rk)
    return r, Jp, Jl


def rgbd_residuals(
    cam: Camera, R_cw: Tensor, t_cw: Tensor, lm_pos: Tensor, obs: ObsData,
    depth_weight: float = 0.25,
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [O, 3], Jp [O, 3, 6], Jl [O, 3, 3]).

    Rows 0-1: pixel reprojection error.  Row 2: w_d * (z_pred - z_meas)
    with w_d = depth_weight * fx / z_meas, so a depth error counts in the
    units of the pixel shift it would cause on nearby geometry."""
    Rk = R_cw[obs.kf]
    p_c = torch.einsum("oij,oj->oi", Rk, lm_pos[obs.lm]) + t_cw[obs.kf]
    inv_z = _inv_depth(p_c)
    r_d, w_d = _depth_row(cam, p_c, obs.p_obs[:, 2], depth_weight)
    r = torch.cat([_pixels(cam, p_c, inv_z) - obs.uv, r_d[:, None]], dim=-1)
    zero = torch.zeros_like(w_d)
    Jproj = torch.cat([_pixel_jacobian(cam, p_c, inv_z),
                       torch.stack([zero, zero, w_d], dim=-1)[:, None]],
                      dim=-2)                                # [O, 3, 3]
    Jp = torch.einsum("oij,ojk->oik", Jproj,
                      _pose_jacobian(p_c, r.shape[:1]))
    Jl = torch.einsum("oij,ojk->oik", Jproj, Rk)
    return r, Jp, Jl


def point2point_residuals_grid(
    R_cw: Tensor,     # [K, 3, 3]
    t_cw: Tensor,     # [K, 3]
    lm_pos: Tensor,   # [L, 3]
    p_obs: Tensor,    # [L, K, 3] observed points (camera frame)
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [L,K,3], Jp [L,K,3,6], Jl [L,K,3,3])."""
    L, K = p_obs.shape[:2]
    p_c = torch.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    r = p_c - p_obs
    return r, _pose_jacobian(p_c, (L, K)), R_cw[None].expand(L, K, 3, 3)


def reprojection_residuals_grid(
    cam: Camera, R_cw: Tensor, t_cw: Tensor, lm_pos: Tensor,
    p_obs: Tensor,    # [L, K, 3] (unused beyond shape; kept for parity)
    uv: Tensor,       # [L, K, 2]
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [L,K,2], Jp [L,K,2,6], Jl [L,K,2,3])."""
    L, K = uv.shape[:2]
    p_c = torch.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    inv_z = _inv_depth(p_c)
    r = _pixels(cam, p_c, inv_z) - uv
    Jproj = _pixel_jacobian(cam, p_c, inv_z)                 # [L,K,2,3]
    Jp = torch.einsum("lkij,lkjm->lkim", Jproj, _pose_jacobian(p_c, (L, K)))
    Jl = torch.einsum("lkij,kjm->lkim", Jproj, R_cw)
    return r, Jp, Jl


def rgbd_residuals_grid(
    cam: Camera, R_cw: Tensor, t_cw: Tensor, lm_pos: Tensor,
    p_obs: Tensor,    # [L, K, 3]
    uv: Tensor,       # [L, K, 2]
    depth_weight: float = 0.25,
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> (r [L,K,3], Jp [L,K,3,6], Jl [L,K,3,3])."""
    L, K = uv.shape[:2]
    p_c = torch.einsum("kij,lj->lki", R_cw, lm_pos) + t_cw[None]
    inv_z = _inv_depth(p_c)
    r_d, w_d = _depth_row(cam, p_c, p_obs[..., 2], depth_weight)
    r = torch.cat([_pixels(cam, p_c, inv_z) - uv, r_d[..., None]], dim=-1)
    zero = torch.zeros_like(w_d)
    Jproj = torch.cat([_pixel_jacobian(cam, p_c, inv_z),
                       torch.stack([zero, zero, w_d], dim=-1)[..., None, :]],
                      dim=-2)                                # [L,K,3,3]
    Jp = torch.einsum("lkij,lkjm->lkim", Jproj, _pose_jacobian(p_c, (L, K)))
    Jl = torch.einsum("lkij,kjm->lkim", Jproj, R_cw)
    return r, Jp, Jl


def huber_weights(r: Tensor, delta: float, base_w: Tensor) -> Tensor:
    """IRLS weights for the Huber loss on the residual norm."""
    nrm = torch.linalg.vector_norm(r, dim=-1)
    w = torch.where(nrm <= delta, torch.ones_like(nrm),
                    delta / torch.clamp(nrm, min=1e-12))
    return w * base_w


def gather_obs(cam: Camera, arena, active: Tensor) -> ObsData:
    """Build ObsData from arena observation rows; `active` [O] bool."""
    return ObsData(
        kf=arena.obs_kf.long(),
        lm=arena.obs_lm.long(),
        p_obs=backproject(cam, arena.obs_uv, arena.obs_depth),
        uv=arena.obs_uv,
        w=active.to(torch.float32),
    )
