"""The plain references at tiny sizes: held to the port's plain CPU path
where the arithmetic is the same (the detector), to an independent
solver where it is not (PnP refit, global BA), and to brute force (the
matcher)."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.optimize import least_squares

from port_bench import scene
from port_bench.gba_map import make_map
from port_bench.reference import detector as ref_det
from port_bench.reference import gba as ref_gba
from port_bench.reference import track as ref_track


def _frame(seed, w=320, h=240, f=262.5):
    cam = scene.Camera(f, f, w / 2 - 0.5, h / 2 - 0.5, w, h)
    gen = torch.Generator().manual_seed(seed)
    tex = scene.make_texture(gen, 1024, "cpu")
    rects = scene.room_rects(np.random.default_rng(seed), 6, 1024)
    R, t = scene.sweep_path(np.random.default_rng(seed + 1), 4, 0.413, 23.3, 30.0)
    g, d = scene.render(cam, rects, tex, torch.as_tensor(R), torch.as_tensor(t))
    return cam, g, scene.kinect_depth(d, gen)


def test_brief_pattern_is_the_ports():
    from modular_slam_tpu_torch.ops.brief_pattern import PATTERN

    np.testing.assert_array_equal(ref_det.brief_pattern(), PATTERN)


@pytest.mark.parametrize("seed", [3, 11])
def test_detector_equals_the_ports_plain_path(seed):
    from modular_slam_tpu_torch.config import DetectorConfig
    from modular_slam_tpu_torch.ops.detector import detect

    _, g, d = _frame(seed)
    s = ref_det.DetectorSettings(n_levels=4, max_keypoints=256)
    ref = ref_det.detect(g[0], d[0], s)
    port = detect(g[0], d[0], DetectorConfig(n_levels=4, max_keypoints=256))
    kp = port.keypoints
    assert torch.equal(ref.valid, kp.valid)
    v = ref.valid
    assert torch.equal(ref.uv[v], kp.uv[v])
    assert torch.equal(ref.depth[v], kp.depth[v])
    assert torch.equal((ref.bits[v].to(torch.int8) * 2 - 1),
                       port.descriptors.unpacked[v])


def test_detector_in_bfloat16_moves_keypoints():
    _, g, d = _frame(5)
    s = ref_det.DetectorSettings(n_levels=4, max_keypoints=256)
    a = ref_det.detect(g[0], d[0], s)
    b = ref_det.detect(g[0], d[0], s, dtype=torch.bfloat16)
    same = (a.uv == b.uv).all(-1) & (a.bits == b.bits).all(-1)
    assert same.float().mean() < 0.9


def _pnp_problem(seed, n=120):
    rng = np.random.default_rng(seed)
    R = scene.axis_angle_matrix(rng.normal(0, 0.2, 3))
    t = rng.normal(0, 0.3, 3)
    pc = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                   rng.uniform(1.0, 3.5, n)], -1)
    pw = pc @ R.T + t
    cam = (525.0, 525.0, 319.5, 239.5)
    uv = np.stack([pc[:, 0] / pc[:, 2] * cam[0] + cam[2],
                   pc[:, 1] / pc[:, 2] * cam[1] + cam[3]], -1)
    uv += rng.normal(0, 0.7, uv.shape)
    z = pc[:, 2] + rng.normal(0, 0.01, n)
    return R, t, pw, uv, z, cam


def test_refit_is_the_least_squares_optimum():
    R, t, pw, uv, z, cam = _pnp_problem(4)
    R0 = scene.axis_angle_matrix(np.array([0.01, -0.02, 0.015])) @ R
    T = torch.as_tensor
    Rr, tr = ref_track.refit_poses(T(pw)[None], T(uv)[None], T(z)[None],
                                   torch.ones(1, len(z), dtype=torch.float64),
                                   T(R0)[None], T(t + 0.02)[None], cam)

    def resid(x):
        Rx = scene.axis_angle_matrix(x[:3]) @ R
        pc = (pw - (t + x[3:])) @ Rx
        w_d = 0.25 * cam[0] / np.maximum(z, 0.1)
        return np.concatenate([uv[:, 0] - (pc[:, 0] / pc[:, 2] * cam[0] + cam[2]),
                               uv[:, 1] - (pc[:, 1] / pc[:, 2] * cam[1] + cam[3]),
                               w_d * (z - pc[:, 2])])

    sol = least_squares(resid, np.zeros(6), xtol=1e-14, ftol=1e-14, gtol=1e-14)
    Rs, ts = scene.axis_angle_matrix(sol.x[:3]) @ R, t + sol.x[3:]
    pts = ref_track.view_points(cam + (640, 480))
    assert ref_track.pose_gap_m(Rr[0].numpy(), tr[0].numpy(), Rs, ts, pts) < 1e-7


def test_refit_in_bfloat16_is_off_by_millimetres():
    R, t, pw, uv, z, cam = _pnp_problem(6, n=300)
    T = torch.as_tensor
    args = (T(pw)[None], T(uv)[None], T(z)[None],
            torch.ones(1, len(z), dtype=torch.float64), T(R)[None], T(t)[None], cam)
    a = ref_track.refit_poses(*args)
    b = ref_track.refit_poses(*args, dtype=torch.bfloat16)
    pts = ref_track.view_points(cam + (640, 480))
    assert ref_track.pose_gap_m(a[0][0].numpy(), a[1][0].numpy(),
                                b[0][0].numpy(), b[1][0].numpy(), pts) > 1e-3


def _small_map(seed=5):
    room = dict(half_x_m=4.5, half_z_m=3.5, loop_semi_axes_m=[3.0, 2.0],
                floor_y_m=1.2, ceiling_y_m=-1.4, wobble_rad=0.15)
    noise = dict(pixel_sigma_px=0.7, obs_per_lm_mean=9, wrong_share=0.0,
                 drift_m_per_kf=0.005, drift_rad_per_kf=0.0025)
    return make_map(seed, (525.0, 525.0, 319.5, 239.5, 640, 480), 80, 150,
                    800, room, noise)


def test_make_map_counts_and_gauge():
    m = _small_map()
    assert m.obs_kf.shape == (800,) and m.lm0.shape == (150, 3)
    assert np.bincount(m.obs_lm, minlength=150).min() >= 1
    np.testing.assert_allclose(m.t0[0], m.t_gt[0])
    np.testing.assert_allclose(m.R0[0], m.R_gt[0])


def test_global_ba_optimum_is_stationary():
    """At the reference's optimum no small step of any one keyframe or
    landmark lowers the cost (finite differences, float64)."""
    m = _small_map()
    T = torch.as_tensor
    p = ref_gba.Problem(T(m.R0), T(m.t0), T(m.lm0), T(m.obs_kf), T(m.obs_lm),
                        T(m.uv).double(), T(m.depth).double(),
                        (525.0, 525.0, 319.5, 239.5))
    R, t, lm, c = ref_gba.solve(p)
    assert c < ref_gba.cost_of(p, p.R_wc, p.t_wc, p.lm)
    assert abs(ref_gba.cost_of(p, R, t, lm) - c) < 1e-9 * c
    rng = np.random.default_rng(0)
    for _ in range(20):
        k = int(rng.integers(1, 80))
        dt = torch.zeros_like(t)
        dt[k] = torch.as_tensor(rng.normal(0, 1e-4, 3))
        assert ref_gba.cost_of(p, R, t + dt, lm) >= c * (1 - 1e-12)
        j = int(rng.integers(0, 150))
        dl = torch.zeros_like(lm)
        dl[j] = torch.as_tensor(rng.normal(0, 1e-4, 3))
        assert ref_gba.cost_of(p, R, t, lm + dl) >= c * (1 - 1e-12)


def test_global_ba_in_bfloat16_stops_short():
    m = _small_map()
    T = torch.as_tensor
    p = ref_gba.Problem(T(m.R0), T(m.t0), T(m.lm0), T(m.obs_kf), T(m.obs_lm),
                        T(m.uv).double(), T(m.depth).double(),
                        (525.0, 525.0, 319.5, 239.5))
    c0 = ref_gba.cost_of(p, p.R_wc, p.t_wc, p.lm)
    _, _, _, c = ref_gba.solve(p)
    R, t, lm, _ = ref_gba.solve(p, dtype=torch.bfloat16)
    assert (ref_gba.cost_of(p, R, t, lm) - c) / (c0 - c) > 0.03


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_matcher_equals_the_ports_plain_path(seed):
    """2-NN, ratio test and duplicate removal against the port's plain
    matcher, on descriptors with near and tied neighbours."""
    from modular_slam_tpu_torch.config import MatcherConfig
    from modular_slam_tpu_torch.ops.match import (dedupe_matches,
                                                  match_descriptors_plain)
    from port_bench.reference import match as ref_match

    g = torch.Generator().manual_seed(seed)
    train = torch.randint(0, 2, (300, 256), generator=g).to(torch.int8) * 2 - 1
    flip = torch.rand((200, 256), generator=g) < 0.08
    query = train[torch.randint(0, 300, (200,), generator=g)]
    query = torch.where(flip, -query, query)
    query[150:] = query[:50]                 # duplicates compete for a landmark
    train[299] = train[298]                  # a tie for nearest
    tv = torch.rand(300, generator=g) < 0.9
    qv = torch.rand(200, generator=g) < 0.95
    cfg = MatcherConfig()
    port = dedupe_matches(match_descriptors_plain(query, qv, train, tv, cfg), 300)
    lm, dist, ok = ref_match.match_2nn(query, qv, train, tv, cfg.lowe_ratio,
                                       cfg.max_hamming)
    ok = ref_match.dedupe(lm, dist, ok)
    assert torch.equal(ok, port.valid) and ok.sum() > 50
    assert torch.equal(lm[ok], port.lm_slot[ok].long())


def test_covisibility_masks_equal_the_ports_queries():
    from modular_slam_tpu_torch.config import MapConfig
    from modular_slam_tpu_torch.map.arena import (empty_arena, khop_keyframes,
                                                  visible_landmarks)
    from port_bench.reference import match as ref_match

    g = torch.Generator().manual_seed(4)
    a = empty_arena(MapConfig(max_keyframes=16, max_landmarks=256,
                              max_observations=64))
    # a chain of keyframes, each seeing a band of landmarks
    inc = torch.zeros(16, 256, dtype=torch.bool)
    for k in range(12):
        inc[k, 20 * k:20 * k + 24] = True
    inc[3] |= torch.rand(256, generator=g) < 0.02
    a = a._replace(inc=inc, kf_valid=torch.arange(16) < 12,
                   lm_valid=torch.rand(256, generator=g) < 0.95)
    masks = ref_match.covis_masks(a.inc, a.kf_valid, a.lm_valid, 2)
    for k in range(16):
        port = visible_landmarks(a, khop_keyframes(a, torch.tensor(k), 2))
        assert torch.equal(masks[k], port), k
    assert not torch.equal(masks[0], masks[11])
