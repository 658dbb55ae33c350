"""PLY export of the map (counterpart of modular_slam_tpu/eval/ply.py):
the landmark cloud and the keyframe frusta as ASCII PLY, for any external
point-cloud viewer."""

from __future__ import annotations

import numpy as np

from modular_slam_tpu_torch.geometry.se3 import quat_to_matrix


def export_map_ply(path: str, arena, frustum_scale: float = 0.1) -> int:
    """Write the valid landmarks (grey), each valid keyframe's camera
    center (green) and four frustum corners (red).  Returns the number of
    points written."""
    lm_valid = arena.lm_valid.cpu().numpy()
    lms = arena.lm_pos.cpu().numpy()[lm_valid]
    kf_valid = arena.kf_valid.cpu()
    kf_R = quat_to_matrix(arena.kf_q.cpu()[kf_valid]).numpy()
    kf_t = arena.kf_t.cpu().numpy()[kf_valid.numpy()]

    pts = [(p, (200, 200, 200)) for p in lms]
    s = frustum_scale
    corners = np.array([          # camera frame: center, then 4 corners
        [0, 0, 0], [-s, -s, 2 * s], [s, -s, 2 * s], [s, s, 2 * s],
        [-s, s, 2 * s]])
    for R, t in zip(kf_R, kf_t):
        world = corners @ R.T + t
        pts.append((world[0], (0, 255, 0)))
        for c in world[1:]:
            pts.append((c, (255, 0, 0)))

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, (r, g, b) in pts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
    return len(pts)
