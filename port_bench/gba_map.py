"""A long run's map at highwater, made from a seed: the input of the
global-BA cells.

Keyframes lie along a closed loop around a rectangular room, each looking
out at the walls with a slow wobble in yaw, pitch and roll; landmarks lie
on the room's walls, floor and ceiling where a keyframe's view ray meets
them; each landmark is observed by a contiguous run of the keyframes that
see it, as a tracker keeps a point across a stretch of frames, and runs
wrap around the loop, so the loop's end re-observes its start as after a
closure.  Observations carry pixel noise and the Kinect's axial depth
noise, quantised to 1/5000 m, and a share of them are wrong associations
(another surface point's pixel and depth).  The keyframe poses the BA
starts from carry a random-walk drift along the loop (keyframe 0, the
gauge, is exact), and each landmark starts where its first observer's
drifted pose puts its noisy observation, as a tracker creates it.

Everything is drawn from `numpy.random.default_rng(seed)`; the counts are
exact: `n_kf` keyframes, `n_lm` landmarks, `n_obs` observations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from port_bench.scene import axis_angle_matrix


class MapData(NamedTuple):
    R_gt: np.ndarray       # [K, 3, 3] camera-to-world, exact
    t_gt: np.ndarray       # [K, 3]
    R0: np.ndarray         # [K, 3, 3] the drifted start
    t0: np.ndarray         # [K, 3]
    lm_gt: np.ndarray      # [L, 3]
    lm0: np.ndarray        # [L, 3] the start
    obs_kf: np.ndarray     # [O] int64
    obs_lm: np.ndarray     # [O] int64
    uv: np.ndarray         # [O, 2] float32
    depth: np.ndarray      # [O] float32
    wrong: np.ndarray      # [O] bool, the planted wrong associations


def _ray_room(o: np.ndarray, d: np.ndarray, half: np.ndarray,
              floor_y: float, ceil_y: float) -> np.ndarray:
    """Nearest hit [N] of rays o + s d [N, 3] with the room's inside
    faces: x = +-half[0], z = +-half[1], y = floor_y / ceil_y."""
    s = np.full(d.shape[0], np.inf)
    for axis, planes in ((0, (-half[0], half[0])), (2, (-half[1], half[1])),
                         (1, (ceil_y, floor_y))):
        for c in planes:
            with np.errstate(divide="ignore", invalid="ignore"):
                si = (c - o[axis]) / d[:, axis]
            s = np.where((si > 1e-6) & (si < s), si, s)
    return s


def make_map(seed: int, cam, n_kf: int, n_lm: int, n_obs: int, room: dict,
             noise: dict) -> MapData:
    """cam = (fx, fy, cx, cy, width, height); `room` gives the loop and
    the room's size, `noise` the pixel and drift noise and the share of
    wrong associations."""
    rng = np.random.default_rng(seed)
    fx, fy, cx, cy, W, H = cam
    half = np.array([room["half_x_m"], room["half_z_m"]])
    a, b = room["loop_semi_axes_m"]
    floor_y, ceil_y = room["floor_y_m"], room["ceiling_y_m"]

    # keyframes: an ellipse around the room, facing outwards, wobbling
    ang = 2 * math.pi * (np.arange(n_kf) + rng.uniform(-0.2, 0.2, n_kf)) / n_kf
    pos = np.stack([a * np.cos(ang), np.zeros(n_kf), b * np.sin(ang)], -1)
    yaw_out = np.arctan2(np.cos(ang) / a, np.sin(ang) / b)
    wob = room["wobble_rad"]
    ph = rng.uniform(0, 2 * math.pi, 3)
    k = np.arange(n_kf)
    yaw = yaw_out + wob * np.sin(2 * math.pi * 7 * k / n_kf + ph[0])
    pitch = 0.5 * wob * np.sin(2 * math.pi * 5 * k / n_kf + ph[1])
    roll = 0.2 * wob * np.sin(2 * math.pi * 3 * k / n_kf + ph[2])
    R_gt = (axis_angle_matrix(np.stack([np.zeros(n_kf), yaw, np.zeros(n_kf)], -1))
            @ axis_angle_matrix(np.stack([pitch, np.zeros(n_kf), np.zeros(n_kf)], -1))
            @ axis_angle_matrix(np.stack([np.zeros(n_kf), np.zeros(n_kf), roll], -1)))
    t_gt = pos + rng.normal(0, 0.01, (n_kf, 3))

    # landmarks: a home keyframe's view ray through a random pixel
    home = rng.integers(0, n_kf, n_lm)
    px = np.stack([rng.uniform(0.1 * W, 0.9 * W, n_lm),
                   rng.uniform(0.1 * H, 0.9 * H, n_lm)], -1)
    rays_c = np.stack([(px[:, 0] - cx) / fx, (px[:, 1] - cy) / fy,
                       np.ones(n_lm)], -1)
    rays_w = np.einsum("nij,nj->ni", R_gt[home], rays_c)
    s = _ray_room(t_gt[home].T, rays_w, half, floor_y, ceil_y)
    lm_gt = t_gt[home] + s[:, None] * rays_w

    def project(kf, p):
        pc = np.einsum("nji,nj->ni", R_gt[kf], p - t_gt[kf])
        return pc, np.stack([pc[:, 0] / pc[:, 2] * fx + cx,
                             pc[:, 1] / pc[:, 2] * fy + cy], -1)

    def seen(kf, p):
        pc, uv = project(kf, p)
        return ((pc[:, 2] > 0.3) & (pc[:, 2] < 5.0) & (uv[:, 0] > 8)
                & (uv[:, 0] < W - 8) & (uv[:, 1] > 8) & (uv[:, 1] < H - 8))

    # each landmark's run of observers: grow from home while it stays seen
    want = np.clip(rng.poisson(noise["obs_per_lm_mean"] - 2, n_lm) + 2, 2, 40)
    lo = home.copy()
    hi = home.copy()
    for step in range(1, 40):
        grow = (hi - lo + 1) < want
        if not grow.any():
            break
        fwd = grow & seen((hi + 1) % n_kf, lm_gt)
        hi = np.where(fwd, hi + 1, hi)
        grow = (hi - lo + 1) < want
        back = grow & seen((lo - 1) % n_kf, lm_gt)
        lo = np.where(back, lo - 1, lo)
    count = hi - lo + 1
    # exact total: trim the longest runs or drop runs' ends at random
    excess = int(count.sum()) - n_obs
    while excess > 0:
        i = rng.choice(np.flatnonzero(count > 2), size=min(excess, int(
            (count > 2).sum())), replace=False)
        hi[i] -= 1
        count = hi - lo + 1
        excess = int(count.sum()) - n_obs
    if excess < 0:
        raise ValueError(f"the room gives {int(count.sum())} observations; "
                         f"{n_obs} asked: widen the loop or the runs")
    obs_lm = np.repeat(np.arange(n_lm), count)
    first = np.repeat(np.cumsum(count) - count, count)
    obs_kf = (np.repeat(lo, count) + np.arange(obs_lm.shape[0]) - first) % n_kf

    pc, uv = project(obs_kf, lm_gt[obs_lm])
    uv = uv + rng.normal(0, noise["pixel_sigma_px"], uv.shape)
    z = pc[:, 2]
    depth = z + (0.0012 + 0.0019 * (z - 0.4) ** 2) * rng.standard_normal(z.shape)
    wrong = rng.random(obs_lm.shape[0]) < noise["wrong_share"]
    n_w = int(wrong.sum())
    uv[wrong] = np.stack([rng.uniform(8, W - 8, n_w), rng.uniform(8, H - 8, n_w)], -1)
    depth[wrong] = rng.uniform(0.5, 4.5, n_w)
    depth = np.round(depth * 5000.0) / 5000.0

    # the drifted start: a random walk along the loop, keyframe 0 exact
    dt = rng.normal(0, noise["drift_m_per_kf"], (n_kf, 3))
    dw = rng.normal(0, noise["drift_rad_per_kf"], (n_kf, 3))
    dt[0], dw[0] = 0.0, 0.0
    R0, t0 = np.empty_like(R_gt), np.empty_like(t_gt)
    Rd, td = np.eye(3), np.zeros(3)
    for i in range(n_kf):
        Rd = axis_angle_matrix(dw[i]) @ Rd
        td = td + dt[i]
        R0[i] = Rd @ R_gt[i]
        t0[i] = Rd @ t_gt[i] + td
    # a landmark starts at its first observer's view of it
    f = np.cumsum(count) - count
    fk = obs_kf[f]
    zc = depth[f]
    pcf = np.stack([(uv[f, 0] - cx) / fx * zc, (uv[f, 1] - cy) / fy * zc, zc], -1)
    lm0 = np.einsum("nij,nj->ni", R0[fk], pcf) + t0[fk]
    return MapData(R_gt=R_gt, t_gt=t_gt, R0=R0, t0=t0, lm_gt=lm_gt, lm0=lm0,
                   obs_kf=obs_kf.astype(np.int64), obs_lm=obs_lm.astype(np.int64),
                   uv=uv.astype(np.float32), depth=depth.astype(np.float32),
                   wrong=wrong)
