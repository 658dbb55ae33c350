"""Trajectory evaluation reports: plots + CSV (counterpart of
modular_slam_tpu/eval/report.py).

Reference parity: utils/tools/py/evaluate.py — evo APE stats (:99-122),
xyz/rpy/3D trajectory plots (:38-92), pandas CSV export (:110-122).
Reimplemented on numpy/matplotlib (no evo/pandas dependency); the ATE
math lives in eval/ate.py.  matplotlib and cv2 are imported inside the
functions that use them: neither is needed elsewhere.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np

from modular_slam_tpu_torch.eval.ate import align_umeyama
from modular_slam_tpu_torch.io.associate import associate


def write_ate_csv(path: str, results: Dict[str, Dict[str, float]]) -> None:
    """results: {sequence_name: ate stats dict} -> one CSV row each."""
    fields = ["sequence", "rmse", "mean", "median", "std", "min", "max",
              "n_pairs"]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=fields)
        wr.writeheader()
        for name, stats in results.items():
            wr.writerow({"sequence": name, **{k: stats[k] for k in fields[1:]}})


def plot_trajectories(
    est: np.ndarray, gt: Optional[np.ndarray], out_dir: str,
    name: str = "trajectory", max_difference: float = 0.02,
) -> Dict[str, str]:
    """Write xyz-over-time and top-down (x-z) plots as PNG.

    est/gt: TUM arrays [N, 8].  gt may be None.  Returns paths written.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    paths = {}

    aligned = est[:, 1:4]
    gt_assoc = None
    if gt is not None and len(gt):
        pairs = associate(est[:, 0], gt[:, 0], max_difference=max_difference)
        if len(pairs) >= 2:
            ei = np.array([p[0] for p in pairs])
            gi = np.array([p[1] for p in pairs])
            R, t, s = align_umeyama(est[ei, 1:4], gt[gi, 1:4])
            aligned = (R @ est[:, 1:4].T).T + t
            gt_assoc = gt

    # xyz over time
    fig, axes = plt.subplots(3, 1, figsize=(8, 6), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[i].plot(est[:, 0], aligned[:, i], label="estimate")
        if gt_assoc is not None:
            axes[i].plot(gt_assoc[:, 0], gt_assoc[:, 1 + i], "--",
                         label="groundtruth")
        axes[i].set_ylabel(lbl + " [m]")
    axes[0].legend()
    axes[-1].set_xlabel("t [s]")
    p = os.path.join(out_dir, f"{name}_xyz.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    paths["xyz"] = p

    # top-down
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(aligned[:, 0], aligned[:, 2], label="estimate")
    if gt_assoc is not None:
        ax.plot(gt_assoc[:, 1], gt_assoc[:, 3], "--", label="groundtruth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    p = os.path.join(out_dir, f"{name}_topdown.png")
    fig.savefig(p, dpi=100, bbox_inches="tight")
    plt.close(fig)
    paths["topdown"] = p
    return paths


def render_observation_overlay(
    rgb: np.ndarray,
    kp_uv: np.ndarray,
    lm_uv: Optional[np.ndarray] = None,
    path: Optional[str] = None,
) -> np.ndarray:
    """Draw the reference viewer's observation overlay
    (image_viewer.cpp:27-58): red keypoint dot, blue projected-landmark
    dot, green line between them.  Returns the annotated image."""
    import cv2

    img = np.ascontiguousarray(rgb[..., ::-1])  # BGR for cv2
    for i, (u, v) in enumerate(kp_uv):
        p1 = (int(round(u)), int(round(v)))
        cv2.circle(img, p1, 2, (0, 0, 255), -1)
        if lm_uv is not None:
            p2 = (int(round(lm_uv[i, 0])), int(round(lm_uv[i, 1])))
            cv2.circle(img, p2, 2, (255, 0, 0), -1)
            cv2.line(img, p1, p2, (0, 255, 0), 1)
    out = img[..., ::-1]
    if path:
        cv2.imwrite(path, img)
    return out


def render_depth_colormap(depth: np.ndarray, d_min: float = 0.0,
                          d_max: float = 5.0,
                          path: Optional[str] = None) -> np.ndarray:
    """HOT-colormapped depth (depth_image_viewer.cpp:9-44 parity)."""
    import cv2

    scaled = np.clip((depth - d_min) / max(d_max - d_min, 1e-6), 0, 1)
    u8 = (scaled * 255).astype(np.uint8)
    colored = cv2.applyColorMap(u8, cv2.COLORMAP_HOT)
    if path:
        cv2.imwrite(path, colored)
    return colored[..., ::-1]
