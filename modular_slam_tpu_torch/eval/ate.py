"""Absolute trajectory error (ATE), numpy-only (counterpart of
modular_slam_tpu/eval/ate.py): timestamp association, Umeyama alignment,
APE-translation statistics."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from modular_slam_tpu_torch.io.associate import associate


def align_umeyama(src: np.ndarray, dst: np.ndarray,
                  with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray,
                                                     float]:
    """Least-squares similarity transform: dst ~= s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, max_difference: float = 0.02,
             with_scale: bool = False) -> Dict[str, float]:
    """ATE statistics between TUM-format trajectories [N, 8]
    (t x y z qx qy qz qw)."""
    pairs = associate(est[:, 0], gt[:, 0], max_difference=max_difference)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated poses")
    ei = np.array([p[0] for p in pairs])
    gi = np.array([p[1] for p in pairs])
    p_est = est[ei, 1:4]
    p_gt = gt[gi, 1:4]

    R, t, s = align_umeyama(p_est, p_gt, with_scale=with_scale)
    p_al = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_al - p_gt, axis=1)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n_pairs": float(len(pairs)),
    }
