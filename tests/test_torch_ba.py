"""The port's bundle-adjustment backend (modular_slam_tpu_torch/backend/)
against the JAX package on the CPU, on a seeded multi-view scene, and the
JAX suite's behavioural cases (tests/test_backend_ba.py) on the port.

Tolerances: index bookkeeping, gathers, merges and the tier functions are
exact; residuals, Jacobians, Huber weights and the 3x3 inverse within
1e-5 on unit-scale inputs; PCG within 1e-4 relative; the solvers within
1e-4 on poses, 1e-3 m on landmarks and 1e-3 relative on the final cost,
with equal outlier masks and equal LM iteration counts.
"""

import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.backend import ba as jba
from modular_slam_tpu.backend import cg as jcg
from modular_slam_tpu.backend import residuals as jres
from modular_slam_tpu.config import (BackendConfig, CameraConfig, MapConfig,
                                     SlamConfig)
from modular_slam_tpu.frontend.tracker import initial_state as j_initial_state
from modular_slam_tpu.geometry import (camera_from_config, project,
                                       quat_from_axis_angle,
                                       pose_apply_inverse)
from modular_slam_tpu.geometry.se3 import Pose as JPose
from modular_slam_tpu.geometry.se3 import quat_multiply, quat_normalize
from modular_slam_tpu.map import (add_keyframe, add_landmarks,
                                  add_observations, empty_arena)
from modular_slam_tpu.utils.indices import masked_indices as j_masked
from modular_slam_tpu_torch.backend import ba as tba
from modular_slam_tpu_torch.backend import cg as tcg
from modular_slam_tpu_torch.backend import residuals as tres
from modular_slam_tpu_torch.config import SlamConfig as TSlamConfig
from modular_slam_tpu_torch.geometry.camera import \
    camera_from_config as t_camera_from_config
from modular_slam_tpu_torch.geometry.se3 import Pose as TPose
from modular_slam_tpu_torch.utils.indices import masked_indices as t_masked
from modular_slam_tpu_torch.utils.state import (arena_from_numpy,
                                                track_state_from_numpy)

CAM_CFG = CameraConfig(fx=300.0, fy=300.0, cx=159.5, cy=119.5,
                       width=320, height=240)
POSE_TOL = 1e-4
LM_TOL = 1e-3
COST_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file.  The suite runs in
    several worker processes that share the cores, and each process's
    default of one thread per core oversubscribes them: under five busy
    cores this file took 326 s with the default and 93 s with one thread.
    The count is restored for the files that run after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the scene: tests/test_backend_ba.py `_build_problem`, rebuilt here
# ---------------------------------------------------------------------------


def _build_problem(n_kf=5, n_lm=120, pose_noise=0.02, lm_noise=0.02,
                   px_noise=0.0, depth_noise=0.0, seed=0):
    """A JAX arena (16/256/2048 caps) of n_kf noisy keyframes along x and
    n_lm noisy landmarks, observed from the ground truth; keyframe 0 sits
    at its ground truth.  -> (jax arena, gt poses, gt landmarks)."""
    arena, gt_poses, lm_gt = _scene(n_kf, n_lm, pose_noise, lm_noise,
                                    px_noise, depth_noise, seed)
    return jax.tree.map(jnp.asarray, arena), gt_poses, lm_gt


@functools.lru_cache(maxsize=None)
def _scene(n_kf, n_lm, pose_noise, lm_noise, px_noise, depth_noise, seed):
    """`_build_problem` with numpy leaves, built once per argument set
    (the eager JAX ops that build it dominate the file's time)."""
    rng = np.random.default_rng(seed)
    cam = camera_from_config(CAM_CFG)
    mcfg = MapConfig(max_keyframes=16, max_landmarks=256,
                     max_observations=2048, descriptor_bits=16)
    gt_poses = []
    for k in range(n_kf):
        q = quat_from_axis_angle(jnp.asarray(
            rng.normal(size=3).astype(np.float32) * 0.01))
        t = jnp.asarray(np.array([0.05 * k, 0, 0], np.float32)
                        + rng.normal(size=3).astype(np.float32) * 0.01)
        gt_poses.append(JPose(q=q, t=t))
    lm_gt = np.stack([
        rng.uniform(-0.8, 0.8 + 0.05 * n_kf, n_lm),
        rng.uniform(-0.6, 0.6, n_lm),
        rng.uniform(1.5, 3.0, n_lm),
    ], axis=1).astype(np.float32)

    arena = empty_arena(mcfg)
    for k, p in enumerate(gt_poses):
        if k:
            dq = quat_from_axis_angle(jnp.asarray(
                rng.normal(size=3).astype(np.float32) * pose_noise))
            p = JPose(q=quat_normalize(quat_multiply(p.q, dq)),
                      t=p.t + jnp.asarray(rng.normal(size=3).astype(
                          np.float32) * pose_noise))
        arena, _ = add_keyframe(arena, p, jnp.float32(k))
    lm_init = lm_gt + rng.normal(size=lm_gt.shape).astype(np.float32) \
        * lm_noise
    desc = jnp.asarray(rng.choice([-1, 1], size=(n_lm, 16)).astype(np.int8))
    arena, lm_slots = add_landmarks(arena, jnp.asarray(lm_init), desc,
                                    jnp.ones(n_lm, bool))
    for k, p in enumerate(gt_poses):
        pc = np.asarray(pose_apply_inverse(p, jnp.asarray(lm_gt)))
        uv = np.asarray(project(cam, jnp.asarray(pc)))
        vis = ((uv[:, 0] >= 5) & (uv[:, 0] < 315) & (uv[:, 1] >= 5)
               & (uv[:, 1] < 235) & (pc[:, 2] > 0.1))
        uv_obs = uv + rng.normal(size=uv.shape).astype(np.float32) * px_noise
        d_obs = pc[:, 2] * (1 + rng.normal(size=n_lm).astype(np.float32)
                            * depth_noise)
        arena = add_observations(arena, jnp.int32(k), lm_slots,
                                 jnp.asarray(uv_obs), jnp.asarray(d_obs),
                                 desc, jnp.asarray(vis))
    return jax.tree.map(np.asarray, (arena, gt_poses)) + (lm_gt,)


def _noisy(seed=9, n_kf=6, **kw):
    """Pixel and depth noise keep the optimum's cost far above float32
    rounding, so the final costs compare relatively.

    At the optimum the last LM step changes the cost by a few float32
    ulps, so whether it is accepted (and when the loop stops) depends on
    the order of the cost sum: over seeds 2-11 (6 keyframes) the counts of
    JAX and the port agree on all three dense cores and the early-stopped
    matrix-free core only for seed 9, where the latter runs to its
    budget; `test_solvers_agree_where_the_stop_is_a_float_tie` holds the
    solutions on seeds where the counts differ."""
    return _build_problem(n_kf=n_kf, px_noise=0.3, depth_noise=0.002,
                          seed=seed, **kw)


def _corrupt(jarena, every=17):
    """Scale the depth of every `every`-th observation by 1.5 (bad
    matches); -> (arena, corrupted rows)."""
    rows = np.arange(0, int(jarena.n_obs), every)
    depth = np.array(jarena.obs_depth)
    depth[rows] *= 1.5
    return jarena._replace(obs_depth=jnp.asarray(depth)), rows


def _port_arena(jarena):
    return arena_from_numpy(jax.tree.map(np.asarray, jarena))


def _cams():
    return camera_from_config(CAM_CFG), t_camera_from_config(CAM_CFG)


def _cfgs(**backend):
    bcfg = BackendConfig(**backend)
    jcfg = SlamConfig(camera=CAM_CFG, backend=bcfg)
    tcfg = TSlamConfig(**{f.name: getattr(jcfg, f.name) for f in
                          dataclasses.fields(jcfg)})
    return jcfg, tcfg


def _t(x, long=False):
    t = torch.from_numpy(np.array(x))
    return t.long() if long else t


def _obs_to_port(obs):
    return tres.ObsData(kf=_t(obs.kf, True), lm=_t(obs.lm, True),
                        p_obs=_t(obs.p_obs), uv=_t(obs.uv), w=_t(obs.w))


def _close(t, j, atol, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol,
                               err_msg=what)


def _same_solution(tq, tt, tl, jq, jt, jl, what):
    _close(tq, jq, POSE_TOL, f"{what}: q")
    _close(tt, jt, POSE_TOL, f"{what}: t")
    _close(tl, jl, LM_TOL, f"{what}: landmarks")


def _same_cost(t_stats, j_stats, what):
    for f in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(getattr(t_stats, f)),
                                   float(getattr(j_stats, f)),
                                   rtol=COST_RTOL, err_msg=f"{what}: {f}")


def _same_iterations(t_it, j_it, costs_after):
    """Equal LM iteration counts; on failure, report the cost after each
    iteration on both sides (a repeated cost is a rejected step).
    costs_after(n) -> (JAX cost, port cost) after at most n iterations."""
    if t_it != j_it:
        trace = [costs_after(n) for n in range(1, max(t_it, j_it) + 1)]
        pytest.fail(f"LM iterations: port {t_it}, JAX {j_it}; cost after "
                    f"each iteration (JAX, port): {trace}")


@pytest.fixture
def jax_iterations(monkeypatch):
    """Record the LM iteration count of every JAX `lax.while_loop` in
    backend/ba.py: both loops carry it as their first element."""
    seen = []
    real = jax.lax

    def while_loop(cond, body, init):
        out = real.while_loop(cond, body, init)
        jax.debug.callback(lambda n: seen.append(int(n)), out[0])
        return out

    monkeypatch.setattr(jba, "lax", types.SimpleNamespace(
        while_loop=while_loop, scan=real.scan,
        dynamic_slice=real.dynamic_slice))

    def last():
        jax.effects_barrier()
        return seen[-1]

    return last


# ---------------------------------------------------------------------------
# exact: indices, stall counter, tiers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,p,cap", [(100, 0.3, 16), (100, 0.3, 100),
                                     (50, 0.5, 80), (64, 0.0, 8),
                                     (64, 1.0, 64), (1, 1.0, 4)])
def test_masked_indices_exact(n, p, cap):
    mask = np.random.default_rng(n + cap).random(n) < p
    want = np.asarray(j_masked(jnp.asarray(mask), cap))
    got = t_masked(torch.from_numpy(mask), cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (cap,)


def test_ba_records_take_jax_style_construction():
    """`BAStats` and `WindowSolution` built from JAX's fields alone, as
    JAX's sharded BA builds its stats: the port's extra trailing fields
    take their defaults (0 iterations, no stats)."""
    rep = torch.zeros(())
    stats = tba.BAStats(rep, rep, rep, rep, rep)
    assert stats.n_iterations == 0
    assert stats[:5] == tuple(jba.BAStats(*[rep] * 5))
    sol = tba.WindowSolution(rep, rep, rep, rep)
    assert sol.stats is None
    assert tba.WindowSolution._fields[:4] == jba.WindowSolution._fields


def test_stall_update_exact_and_ignores_rejected_steps():
    for stall in (0, 1, 2):
        for accept in (False, True):
            for improved in ((False, True) if accept else (False,)):
                j = jba._stall_update(jnp.int32(stall), jnp.bool_(accept),
                                      jnp.bool_(improved))
                t = tba._stall_update(torch.tensor(stall, dtype=torch.int32),
                                      torch.tensor(accept),
                                      torch.tensor(improved))
                assert int(t) == int(j), (stall, accept, improved)
    # rejected: untouched; accepted sub-rtol: +1; improving: reset
    s = torch.tensor(1, dtype=torch.int32)
    f, t = torch.tensor(False), torch.tensor(True)
    assert int(tba._stall_update(s, f, f)) == 1
    assert int(tba._stall_update(s, t, f)) == 2
    assert int(tba._stall_update(s, t, t)) == 0


def test_tier_functions_exact():
    caps = [(256, 16384, 131072), (16, 256, 2048), (48, 3000, 5000)]
    for c in caps:
        assert tba.standard_tier_ladder(c) == jba.standard_tier_ladder(c)
        for counts in [(0, 0, 0), (5, 120, 400), (17, 1025, 4097),
                       (256, 16384, 131072), (300, 20000, 200000)]:
            assert tba.tier_from_counts(counts, c) \
                == jba.tier_from_counts(counts, c)
    jarena, _, _ = _build_problem()
    assert tba.global_ba_tier_counts(_port_arena(jarena)) \
        == jba.global_ba_tier_counts(jarena)
    assert tba.global_ba_tier(_port_arena(jarena)) \
        == jba.global_ba_tier(jarena)


# ---------------------------------------------------------------------------
# residuals, Jacobians, weights, 3x3 inverse, gather: 1e-5
# ---------------------------------------------------------------------------


def _residual_inputs(rng, K=4, L=6, O=20):
    q = rng.normal(size=(K, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(K, 3)).astype(np.float32) * 0.3
    lm = (rng.normal(size=(L, 3)) * 0.5 + [0, 0, 2.0]).astype(np.float32)
    kf = rng.integers(0, K, O).astype(np.int32)
    li = rng.integers(0, L, O).astype(np.int32)
    p_obs = (rng.normal(size=(O, 3)) * 0.5 + [0, 0, 2.0]).astype(np.float32)
    uv = rng.uniform(0, 300, (O, 2)).astype(np.float32)
    w = (rng.random(O) > 0.2).astype(np.float32)
    return q, t, lm, kf, li, p_obs, uv, w


def test_residuals_and_jacobians_close():
    from modular_slam_tpu.geometry.se3 import quat_to_matrix as jq2m
    from modular_slam_tpu_torch.geometry.se3 import quat_to_matrix as tq2m

    rng = np.random.default_rng(0)
    q, t, lm, kf, li, p_obs, uv, w = _residual_inputs(rng)
    jcam, tcam = _cams()
    jR, tR = jq2m(jnp.asarray(q)), tq2m(torch.from_numpy(q))
    jobs = jres.ObsData(kf=jnp.asarray(kf), lm=jnp.asarray(li),
                        p_obs=jnp.asarray(p_obs), uv=jnp.asarray(uv),
                        w=jnp.asarray(w))
    tobs = _obs_to_port(jobs)
    jt, jl = jnp.asarray(t), jnp.asarray(lm)
    tt, tl = torch.from_numpy(t), torch.from_numpy(lm)
    # observations on the [L, K] grid
    K, L = q.shape[0], lm.shape[0]
    p_g = rng.normal(size=(L, K, 3)).astype(np.float32) * 0.5 + [0, 0, 2.0]
    p_g = p_g.astype(np.float32)
    uv_g = rng.uniform(0, 300, (L, K, 2)).astype(np.float32)
    pairs = [
        ("p2p", jres.point2point_residuals(jR, jt, jl, jobs),
         tres.point2point_residuals(tR, tt, tl, tobs)),
        ("reproj", jres.reprojection_residuals(jcam, jR, jt, jl, jobs),
         tres.reprojection_residuals(tcam, tR, tt, tl, tobs)),
        ("rgbd", jres.rgbd_residuals(jcam, jR, jt, jl, jobs, 0.25),
         tres.rgbd_residuals(tcam, tR, tt, tl, tobs, 0.25)),
        ("p2p_grid", jres.point2point_residuals_grid(
            jR, jt, jl, jnp.asarray(p_g)),
         tres.point2point_residuals_grid(tR, tt, tl, torch.from_numpy(p_g))),
        ("reproj_grid", jres.reprojection_residuals_grid(
            jcam, jR, jt, jl, jnp.asarray(p_g), jnp.asarray(uv_g)),
         tres.reprojection_residuals_grid(
             tcam, tR, tt, tl, torch.from_numpy(p_g),
             torch.from_numpy(uv_g))),
        ("rgbd_grid", jres.rgbd_residuals_grid(
            jcam, jR, jt, jl, jnp.asarray(p_g), jnp.asarray(uv_g), 0.25),
         tres.rgbd_residuals_grid(
             tcam, tR, tt, tl, torch.from_numpy(p_g),
             torch.from_numpy(uv_g), 0.25)),
    ]
    for name, jout, tout in pairs:
        for part, j, tv in zip(("r", "Jp", "Jl"), jout, tout):
            assert tuple(tv.shape) == tuple(j.shape), (name, part)
            # pixel-unit rows scale with fx / z: compare relative to it
            scale = max(1.0, float(np.abs(np.asarray(j)).max()))
            _close(tv / scale, np.asarray(j) / scale, 1e-5, f"{name} {part}")

    r = rng.normal(size=(50, 3)).astype(np.float32) * 0.2
    bw = (rng.random(50) > 0.3).astype(np.float32)
    for delta in (0.1, 2.0):
        _close(tres.huber_weights(torch.from_numpy(r), delta,
                                  torch.from_numpy(bw)),
               jres.huber_weights(jnp.asarray(r), delta, jnp.asarray(bw)),
               1e-5, f"huber {delta}")

    M = rng.normal(size=(40, 3, 3)).astype(np.float32)
    M = M @ M.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    M[0] = 0.0                             # |det| under the 1e-12 guard
    _close(tba._inv3x3(torch.from_numpy(M)), jba._inv3x3(jnp.asarray(M)),
           1e-5 * max(1.0, float(np.abs(np.asarray(
               jba._inv3x3(jnp.asarray(M[1:])))).max())), "_inv3x3")


def test_gather_obs_close():
    jarena, _, _ = _build_problem()
    jcam, tcam = _cams()
    active = np.asarray(jarena.obs_valid).copy()
    active[::3] = False
    j = jres.gather_obs(jcam, jarena, jnp.asarray(active))
    t = tres.gather_obs(tcam, _port_arena(jarena), torch.from_numpy(active))
    for f in ("kf", "lm", "uv", "w"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    _close(t.p_obs, j.p_obs, 1e-5, "p_obs")


def test_pcg_close_on_spd_system():
    rng = np.random.default_rng(3)
    n = 24
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=n).astype(np.float32)
    dinv = (1.0 / np.diag(A)).astype(np.float32)
    jx, jr = jcg.pcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                     lambda r: jnp.asarray(dinv) * r, 12)
    tA, tdinv = torch.from_numpy(A), torch.from_numpy(dinv)
    tx, tr = tcg.pcg(lambda x: tA @ x, torch.from_numpy(b),
                     lambda r: tdinv * r, 12)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jx).max()))
    np.testing.assert_allclose(float(tr), float(jr), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(A @ tx.numpy(), b, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# local BA: extract, solve, merge
# ---------------------------------------------------------------------------


def _both_windows(jarena, slot, bcfg):
    jcam, tcam = _cams()
    jprob = jba.extract_window(jcam, jarena, jnp.int32(slot), bcfg)
    tprob = tba.extract_window(tcam, _port_arena(jarena), slot, bcfg)
    return jprob, tprob


@pytest.mark.parametrize("kf_cap,slot", [(16, 4), (4, 7), (3, 2)])
def test_extract_window_exact(kf_cap, slot):
    jarena, _, _ = _build_problem(n_kf=8, seed=4)
    bcfg = BackendConfig(local_kf_cap=kf_cap, local_lm_cap=100,
                         local_obs_cap=300)
    jprob, tprob = _both_windows(jarena, slot, bcfg)
    for f in tba.WindowProblem._fields:
        if f == "obs":
            continue
        np.testing.assert_array_equal(getattr(tprob, f).numpy(),
                                      np.asarray(getattr(jprob, f)),
                                      err_msg=f)
    for f in ("kf", "lm", "uv", "w"):
        np.testing.assert_array_equal(getattr(tprob.obs, f).numpy(),
                                      np.asarray(getattr(jprob.obs, f)),
                                      err_msg=f"obs.{f}")
    _close(tprob.obs.p_obs, jprob.obs.p_obs, 1e-5, "obs.p_obs")


def _problem_to_port(jprob):
    fields = {f: _t(getattr(jprob, f),
                    long=f in ("kf_idx", "lm_idx", "obs_idx", "obs_kf_g",
                               "obs_lm_g"))
              for f in tba.WindowProblem._fields if f != "obs"}
    return tba.WindowProblem(obs=_obs_to_port(jprob.obs), **fields)


def test_merge_window_exact_on_the_same_solution():
    jarena, _ = _corrupt(_noisy()[0])
    jcam, _ = _cams()
    bcfg = BackendConfig(max_iterations=4)
    jprob = jba.extract_window(jcam, jarena, jnp.int32(4), bcfg)
    jsol = jba.solve_window(jcam, jprob, bcfg)
    assert int(jnp.sum(jsol.bad)) > 0          # the outlier path runs
    q = np.array([0.9, 0.1, -0.2, 0.3], np.float32)
    q /= np.linalg.norm(q)
    jstate = j_initial_state()._replace(
        pose=JPose(q=jnp.asarray(q), t=jnp.asarray([0.1, 0.2, 0.3],
                                                    jnp.float32)))
    tarena = _port_arena(jarena)
    tstate = track_state_from_numpy(jax.tree.map(np.asarray, jstate))
    tsol = tba.WindowSolution(kf_q=_t(jsol.kf_q), kf_t=_t(jsol.kf_t),
                              lm_pos=_t(jsol.lm_pos), bad=_t(jsol.bad),
                              stats=None)
    ja2, js2 = jba.merge_window(jarena, jstate, jprob, jsol)
    ta2, ts2 = tba.merge_window(tarena, tstate, _problem_to_port(jprob),
                                tsol)
    for f in tba.MapArena._fields:
        np.testing.assert_array_equal(getattr(ta2, f).numpy(),
                                      np.asarray(getattr(ja2, f)),
                                      err_msg=f)
    _close(ts2.pose.q, js2.pose.q, 1e-6, "state q")
    _close(ts2.pose.t, js2.pose.t, 1e-6, "state t")


def _dense_cores(jarena, residual, max_iterations=8):
    """-> run(n): both dense cores on the newest keyframe's window with
    at most n LM iterations, -> (JAX result, port result)."""
    jcam, tcam = _cams()
    args = ("kf_q", "kf_t", "lm_pos", "obs", "pose_free", "lm_ok")
    bcfg = BackendConfig(local_residual=residual)
    jprob, tprob = _both_windows(jarena, int(jarena.n_kf) - 1, bcfg)

    def run(n=max_iterations):
        b = dataclasses.replace(bcfg, max_iterations=n)
        return (jba.ba_core_dense(jcam, *(getattr(jprob, a) for a in args),
                                  b, residual),
                tba.ba_core_dense(tcam, *(getattr(tprob, a) for a in args),
                                  b, residual))
    return run


def _final_costs(run):
    def costs_after(n):
        j, t = run(n)
        return float(j[3].final_cost), float(t[3].final_cost)
    return costs_after


@pytest.mark.parametrize("residual", ["p2p", "rgbd", "reproj"])
def test_ba_core_dense_and_solve_window_close(residual, jax_iterations):
    jarena, _ = _corrupt(_noisy()[0])
    run = _dense_cores(jarena, residual)
    (jq, jt, jl, js), (tq, tt, tl, ts) = run()
    j_it = jax_iterations()
    _same_solution(tq, tt, tl, jq, jt, jl, f"ba_core_dense {residual}")
    _same_cost(ts, js, f"ba_core_dense {residual}")
    _same_iterations(ts.n_iterations, j_it, _final_costs(run))
    assert int(ts.n_active_obs) == int(js.n_active_obs)

    bcfg = BackendConfig(max_iterations=8, local_residual=residual)
    jprob, tprob = _both_windows(jarena, 5, bcfg)
    jcam, tcam = _cams()

    jsol = jba.solve_window(jcam, jprob, bcfg)
    tsol = tba.solve_window(tcam, tprob, bcfg)
    _same_solution(tsol.kf_q, tsol.kf_t, tsol.lm_pos, jsol.kf_q, jsol.kf_t,
                   jsol.lm_pos, f"solve_window {residual}")
    np.testing.assert_array_equal(tsol.bad.numpy(), np.asarray(jsol.bad))
    _same_iterations(tsol.stats.n_iterations, jax_iterations(),
                     _final_costs(run))
    if residual == "p2p":
        assert int(tsol.bad.sum()) > 0


@pytest.mark.parametrize("kf_cap", [16, 4])
def test_make_local_ba_close(kf_cap):
    jarena, _ = _corrupt(_noisy(n_kf=8, seed=4)[0])
    jcfg, tcfg = _cfgs(local_max_iterations=8, local_kf_cap=kf_cap)
    newest = 7
    jstate = j_initial_state()._replace(
        pose=JPose(q=jarena.kf_q[newest], t=jarena.kf_t[newest]))
    tarena = _port_arena(jarena)
    tstate = track_state_from_numpy(jax.tree.map(np.asarray, jstate))
    ta, ts = tba.make_local_ba(tcfg, device="cpu")(tarena, tstate, newest)
    ja, js = jba.make_local_ba(jcfg)(jarena, jstate, jnp.int32(newest))
    _same_solution(ta.kf_q, ta.kf_t, ta.lm_pos, ja.kf_q, ja.kf_t, ja.lm_pos,
                   "make_local_ba")
    for f in ("obs_valid", "inc", "kf_valid", "lm_valid", "n_obs"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    _close(ts.pose.q, js.pose.q, POSE_TOL, "state q")
    _close(ts.pose.t, js.pose.t, POSE_TOL, "state t")


# ---------------------------------------------------------------------------
# global BA: matrix-free core, full and compact
# ---------------------------------------------------------------------------


def _core_args(cam, arena, module):
    lib = jnp if module is jres else torch
    obs = module.gather_obs(cam, arena, arena.obs_valid)
    K = arena.kf_q.shape[0]
    pose_free = arena.kf_valid & (lib.arange(K) != 0)
    return (cam, arena.kf_q, arena.kf_t, arena.lm_pos, obs, pose_free,
            arena.lm_valid)


def _matrix_free_cores(jarena, residual, rtol, max_iterations=10):
    """-> run(n): both matrix-free cores over the whole arena with at
    most n LM iterations, -> (JAX result, port result)."""
    jcam, tcam = _cams()
    jargs = _core_args(jcam, jarena, jres)
    targs = _core_args(tcam, _port_arena(jarena), tres)

    def run(n=max_iterations):
        b = BackendConfig(max_iterations=n, cg_iters=24)
        return (jba.ba_core(*jargs, b, residual, early_stop_rtol=rtol),
                tba.ba_core(*targs, b, residual, early_stop_rtol=rtol))
    return run


@pytest.mark.parametrize("residual,rtol", [("p2p", None), ("rgbd", None),
                                           ("rgbd", 1e-3)])
def test_ba_core_close(residual, rtol, jax_iterations):
    # seed 6: the early stop fires at iteration 4 in both engines
    jarena, _ = _corrupt(_noisy(seed=6)[0])
    run = _matrix_free_cores(jarena, residual, rtol)
    (jq, jt, jl, js), (tq, tt, tl, ts) = run()
    _same_solution(tq, tt, tl, jq, jt, jl, f"ba_core {residual} {rtol}")
    _same_cost(ts, js, f"ba_core {residual} {rtol}")
    j_it = 10 if rtol is None else jax_iterations()
    _same_iterations(ts.n_iterations, j_it, _final_costs(run))


@pytest.mark.parametrize("core,residual,seed", [
    ("dense", "p2p", 4), ("dense", "rgbd", 2), ("dense", "reproj", 2),
    ("matrix_free", "rgbd", 7)])
def test_solvers_agree_where_the_stop_is_a_float_tie(core, residual, seed):
    """Scenes whose last LM step changes the cost by a few float32 ulps,
    where the two engines stopped at different iterations on the CPU
    (dense p2p seed 4: JAX 3, port 5; dense rgbd seed 2: 8 and 4; dense
    reproj seed 2: 4 and 5; matrix-free rgbd seed 7: 4 and 10): they
    still agree on the solution."""
    jarena, _ = _corrupt(_noisy(seed=seed)[0])
    run = (_dense_cores(jarena, residual) if core == "dense"
           else _matrix_free_cores(jarena, residual, 1e-3))
    (jq, jt, jl, js), (tq, tt, tl, ts) = run()
    _same_solution(tq, tt, tl, jq, jt, jl, f"{core} {residual} {seed}")
    _same_cost(ts, js, f"{core} {residual} {seed}")


def test_make_global_ba_close():
    jarena, _ = _corrupt(_noisy()[0])
    jcfg, tcfg = _cfgs(max_iterations=10)
    ta, ts = tba.make_global_ba(tcfg, device="cpu")(_port_arena(jarena))
    ja, js = jba.make_global_ba(jcfg)(jarena)
    _same_solution(ta.kf_q, ta.kf_t, ta.lm_pos, ja.kf_q, ja.kf_t, ja.lm_pos,
                   "make_global_ba")
    _same_cost(ts, js, "make_global_ba")
    assert ts.n_iterations == jcfg.backend.max_iterations
    assert int(ts.n_outliers) == int(js.n_outliers) > 0
    for f in ("obs_valid", "inc"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)


def test_make_global_ba_compact_close(jax_iterations):
    jarena, _ = _corrupt(_noisy()[0])
    jcfg, tcfg = _cfgs(gba_max_iterations=10)
    tier = jba.global_ba_tier(jarena)
    ta, ts = tba.make_global_ba_compact(tcfg, tier, device="cpu")(
        _port_arena(jarena))
    ja, js = jba.make_global_ba_compact(jcfg, tier)(jarena)
    _same_solution(ta.kf_q, ta.kf_t, ta.lm_pos, ja.kf_q, ja.kf_t, ja.lm_pos,
                   "make_global_ba_compact")
    _same_cost(ts, js, "make_global_ba_compact")
    assert ts.n_iterations == jax_iterations()
    assert int(ts.n_outliers) == int(js.n_outliers) > 0
    for f in ("obs_valid", "inc"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)


# ---------------------------------------------------------------------------
# the JAX suite's behavioural cases, on the port
# ---------------------------------------------------------------------------


def _pose_errors(arena, gt_poses):
    dts, drs = [], []
    for k, p in enumerate(gt_poses):
        dts.append(float(np.linalg.norm(arena.kf_t[k].numpy()
                                        - np.asarray(p.t))))
        dq = abs(float(np.sum(arena.kf_q[k].numpy() * np.asarray(p.q))))
        drs.append(np.degrees(2 * np.arccos(min(dq, 1.0))))
    return np.array(dts), np.array(drs)


def test_port_global_ba_recovers_ground_truth_and_keeps_the_gauge():
    jarena, gt, lm_gt = _build_problem(seed=1)
    _, tcfg = _cfgs(max_iterations=15)
    arena = _port_arena(jarena)
    q0, t0 = arena.kf_q[0].clone(), arena.kf_t[0].clone()
    arena, stats = tba.make_global_ba(tcfg, device="cpu")(arena)
    assert torch.equal(arena.kf_q[0], q0) and torch.equal(arena.kf_t[0], t0)
    assert float(stats.final_cost) < float(stats.initial_cost) * 0.01
    dt, dr = _pose_errors(arena, gt)
    assert dt.max() < 2e-3 and dr.max() < 0.2, (dt, dr)
    lm_err = np.linalg.norm(arena.lm_pos[:120].numpy() - lm_gt, axis=1)
    assert np.median(lm_err) < 2e-3


def test_port_ba_flags_outliers_and_second_pass_tightens():
    jarena, rows = _corrupt(_noisy()[0])
    _, tcfg = _cfgs(max_iterations=15)
    gba = tba.make_global_ba(tcfg, device="cpu")
    arena, stats = gba(_port_arena(jarena))
    assert int(stats.n_outliers) >= len(rows) * 0.7
    assert not arena.obs_valid[torch.from_numpy(rows)].all()
    arena, _ = gba(arena)
    gt = _noisy()[1]
    dt, _ = _pose_errors(arena, gt)
    assert dt.max() < 8e-3, dt


def test_port_local_ba_overfull_window_keeps_newest_keyframe():
    n_kf, newest, gauge = 8, 7, 4
    jarena, gt, _ = _build_problem(n_kf=n_kf, pose_noise=0.05, seed=4)
    _, tcfg = _cfgs(max_iterations=8, local_max_iterations=8,
                    local_kf_cap=4)
    arena = _port_arena(jarena)
    t_before = arena.kf_t.clone()
    gt_rel = np.asarray(gt[newest].t) - np.asarray(gt[gauge].t)
    err_before = float(np.linalg.norm(
        (t_before[newest] - t_before[gauge]).numpy() - gt_rel))
    state = track_state_from_numpy(jax.tree.map(
        np.asarray, j_initial_state()))._replace(
            pose=TPose(q=arena.kf_q[newest].clone(),
                       t=arena.kf_t[newest].clone()))
    arena, state = tba.make_local_ba(tcfg, device="cpu")(arena, state,
                                                         newest)
    # window = 8 > cap 4: slots 4..7 solved, 0..3 untouched, 4 the gauge
    assert torch.equal(arena.kf_t[:gauge + 1], t_before[:gauge + 1])
    err_after = float(np.linalg.norm(
        (arena.kf_t[newest] - arena.kf_t[gauge]).numpy() - gt_rel))
    assert err_after < err_before * 0.5, (err_before, err_after)
    _close(state.pose.t, arena.kf_t[newest].numpy(), 1e-5, "state rides kf")


def test_port_compact_global_ba_matches_full():
    jarena, gt, _ = _build_problem(seed=5)
    _, tcfg = _cfgs(max_iterations=12)
    arena = _port_arena(jarena)
    tier = tba.global_ba_tier(arena)
    n_kf, n_lm, n_obs = (int(x) for x in (arena.n_kf, arena.n_lm,
                                          arena.n_obs))
    assert tier[0] >= n_kf and tier[1] >= n_lm and tier[2] >= n_obs
    full, _ = tba.make_global_ba(tcfg, device="cpu")(_port_arena(jarena))
    comp, _ = tba.make_global_ba_compact(tcfg, tier, device="cpu")(arena)
    _close(comp.kf_t[:n_kf], full.kf_t[:n_kf].numpy(), 1e-4, "t")
    _close(comp.kf_q[:n_kf], full.kf_q[:n_kf].numpy(), 1e-4, "q")
    _close(comp.lm_pos[:n_lm], full.lm_pos[:n_lm].numpy(), 1e-3, "lm")
    assert torch.equal(comp.obs_valid, full.obs_valid)
    dt, _ = _pose_errors(comp, gt)
    assert dt.max() < 2e-3, dt


def _float64(arena):
    return type(arena)(*(x.double() if x.is_floating_point() else x.clone()
                         for x in arena))


def test_port_compact_global_ba_follows_float64_inputs():
    """A float64 arena gives a float64 solve (what the card-against-CPU
    check of a converged global BA compares): close to the float32 solve,
    and moved by less than 1e-9 when the landmarks move by 1e-7
    relative."""
    jarena, _ = _corrupt(_noisy()[0])
    _, tcfg = _cfgs(gba_max_iterations=10, gba_cg_iters=200,
                    gba_early_stop_rtol=None)
    arena = _port_arena(jarena)
    tier = tba.global_ba_tier(arena)
    gba = tba.make_global_ba_compact(tcfg, tier, device="cpu")
    f32, s32 = gba(_port_arena(jarena))
    f64, s64 = gba(_float64(arena))
    assert f64.kf_t.dtype == f64.lm_pos.dtype == torch.float64
    assert s64.final_cost.dtype == torch.float64
    assert f32.kf_t.dtype == s32.final_cost.dtype == torch.float32
    _same_solution(f64.kf_q.float(), f64.kf_t.float(), f64.lm_pos.float(),
                   f32.kf_q, f32.kf_t, f32.lm_pos, "float64 vs float32")
    assert torch.equal(f64.obs_valid, f32.obs_valid)
    g = torch.Generator().manual_seed(0)
    moved = _float64(arena)
    moved = moved._replace(lm_pos=moved.lm_pos * (1 + 1e-7 * torch.randn(
        moved.lm_pos.shape, generator=g, dtype=torch.float64)))
    again, _ = gba(moved)
    n = int(arena.n_kf)
    assert float((again.kf_t[:n] - f64.kf_t[:n]).abs().max()) < 1e-9
    assert float((again.kf_q[:n] - f64.kf_q[:n]).abs().max()) < 1e-9


def test_port_early_stop_reaches_the_full_run_from_hard_init():
    jarena, _, _ = _build_problem(pose_noise=1.2, lm_noise=1.0, seed=5)
    bcfg = BackendConfig(max_iterations=25, init_lambda=1e-9,
                         lambda_up=10.0)
    _, tcam = _cams()
    arena = _port_arena(jarena)
    args = _core_args(tcam, arena, tres)
    _, _, _, s_full = tba.ba_core(*args, bcfg)
    _, _, _, s_es = tba.ba_core(*args, bcfg, early_stop_rtol=1e-3)
    assert float(s_es.final_cost) <= max(10.0 * float(s_full.final_cost),
                                         1e-8)
