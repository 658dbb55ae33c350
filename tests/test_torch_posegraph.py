"""The port's pose-graph optimization (modular_slam_tpu_torch/backend/
posegraph.py) and the SE(3) functions it rests on, against the JAX package
on the CPU.

Tolerances: edge bookkeeping exact; so3/se3 logs, retractions and matrices
within 1e-6; edge residuals and their Jacobians (forward-mode in both)
within 1e-5, also at residuals that are exactly zero; PGO poses within
1e-4 and its cost within 1e-4 relative, on the drifted chain of
tests/test_loop.py:74 and on a rotated variant; the landmark correction
within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.backend import posegraph as jpg
from modular_slam_tpu.config import LoopConfig
from modular_slam_tpu.geometry import se3 as jse3
from modular_slam_tpu.loop.detector import relative_pose as j_relative
from modular_slam_tpu_torch.backend import posegraph as tpg
from modular_slam_tpu_torch.geometry import se3 as tse3
from modular_slam_tpu_torch.loop.detector import relative_pose
from modular_slam_tpu_torch.utils import state as port_state

POSE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread for this file (the suite's workers
    share the cores; see tests/test_torch_engine.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_poses(n, seed, rot=0.8, trans=1.0, identity_rows=()):
    """n float32 poses (q wxyz, t); rows in identity_rows are exact
    identities."""
    rng = np.random.default_rng(seed)
    aa = (rng.normal(size=(n, 3)) * rot).astype(np.float32)
    aa[list(identity_rows)] = 0.0
    q = np.array(jse3.quat_from_axis_angle(jnp.asarray(aa)))
    t = (rng.normal(size=(n, 3)) * trans).astype(np.float32)
    t[list(identity_rows)] = 0.0
    return q, t


def test_so3_se3_log_retract_and_matrix_match_jax():
    q, t = _random_poses(64, 0, identity_rows=(0, 1))
    q[2] = np.asarray(jse3.quat_from_axis_angle(
        jnp.asarray([1e-4, 0.0, 0.0], jnp.float32)))     # small branch
    xi = np.random.default_rng(1).normal(size=(64, 6)).astype(np.float32)
    xi[:2] = 0.0
    xi[3, 3:] = 1e-6                                      # small rotation
    jp, tp = jse3.Pose(q=jnp.asarray(q), t=jnp.asarray(t)), \
        tse3.Pose(q=_t(q), t=_t(t))
    pairs = [
        (tse3.so3_log(_t(q)), jse3.so3_log(jnp.asarray(q))),
        (tse3.se3_log(tp), jse3.se3_log(jp)),
        (tse3.pose_to_matrix(tp), jse3.pose_to_matrix(jp)),
    ]
    tr, jr = tse3.pose_retract(tp, _t(xi)), jse3.pose_retract(
        jp, jnp.asarray(xi))
    pairs += [(tr.q, jr.q), (tr.t, jr.t)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert tse3.se3_log(tp)[0].abs().max() == 0.0        # identity -> 0


def test_log_is_differentiable_at_the_identity():
    """The double-where: d log(exp(xi)) / d xi at xi = 0 is the identity,
    with no NaN."""
    def f(xi):
        return tse3.se3_log(tse3.se3_exp(xi))

    J = torch.func.jacfwd(f)(torch.zeros(6))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), np.eye(6), rtol=0, atol=1e-6)


def _edges_pair(E=12, K=10, seed=2, zero_rows=(0, 1)):
    """The same random edges on random nodes in both packages; edges in
    zero_rows join two exact identity nodes with an identity measurement
    (residual exactly 0)."""
    rng = np.random.default_rng(seed)
    q, t = _random_poses(K, seed, rot=0.3, identity_rows=(0, 1))
    i = rng.integers(0, K, E).astype(np.int32)
    j = (i + 1 + rng.integers(0, K - 1, E)).astype(np.int32) % K
    i[list(zero_rows)], j[list(zero_rows)] = 0, 1
    rq, rt = _random_poses(E, seed + 1, rot=0.3, identity_rows=zero_rows)
    w = rng.uniform(0.5, 2.0, E).astype(np.float32)
    loop = rng.random(E) > 0.6
    jed = jpg.empty_edges(E + 4)
    ted = tpg.empty_edges(E + 4)
    for e in range(E):
        jed = jpg.add_edge(jed, jnp.int32(e), jnp.int32(i[e]),
                           jnp.int32(j[e]),
                           jse3.Pose(q=jnp.asarray(rq[e]),
                                     t=jnp.asarray(rt[e])),
                           float(w[e]), bool(loop[e]))
        tpg.add_edge(ted, e, int(i[e]), int(j[e]),
                     tse3.Pose(q=_t(rq[e]), t=_t(rt[e])), float(w[e]),
                     bool(loop[e]))
    tpg.add_edge(ted, E + 4, 0, 1, tse3.Pose(q=_t(rq[0]), t=_t(rt[0])))
    return q, t, jed, ted


def test_edges_bookkeeping_exact():
    q, t, jed, ted = _edges_pair()
    got = port_state.pose_graph_edges_to_numpy(ted)
    for f in tpg.PoseGraphEdges._fields:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(jed, f)),
                                      err_msg=f)
    jr = jpg.refresh_odometry_edges(jed, jnp.asarray(q), jnp.asarray(t))
    tr = tpg.refresh_odometry_edges(ted, _t(q), _t(t))
    for f in ("rel_q", "rel_t"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), rtol=0,
                                   atol=1e-6)
    assert torch.equal(tr.i, ted.i) and torch.equal(ted.rel_q, _t(
        np.asarray(jed.rel_q)))                    # the input is unchanged


def test_edge_residuals_and_jacobians_match_jax():
    q, t, jed, ted = _edges_pair()
    i, j = np.asarray(jed.i), np.asarray(jed.j)
    args = (q[i], t[i], q[j], t[j], np.asarray(jed.rel_q),
            np.asarray(jed.rel_t))
    z6 = np.zeros(6, np.float32)
    ax = (0, 0, 0, 0, 0, 0, None, None)
    jargs = tuple(jnp.asarray(a) for a in args) + (jnp.asarray(z6),) * 2
    r, Ji, Jj = jax.jit(lambda *a: (
        jax.vmap(jpg._edge_residual, in_axes=ax)(*a),
        jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=6), in_axes=ax)(*a),
        jax.vmap(jax.jacfwd(jpg._edge_residual, argnums=7), in_axes=ax)(*a)
    ))(*jargs)
    (tJi, tJj), tr = tpg._r_and_jacobians(*(_t(a) for a in args),
                                          _t(z6), _t(z6))
    for got, want in ((tr, r), (tJi, Ji), (tJj, Jj)):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert tr[:2].abs().max() == 0.0                   # exactly zero rows
    np.testing.assert_allclose(
        tpg._residuals(*(_t(a) for a in args), _t(z6), _t(z6)).numpy(),
        np.asarray(r), rtol=0, atol=1e-6)


def _square_chain(rotate: bool):
    """tests/test_loop.py:74: 12 nodes around a square with biased
    odometry and one exact loop edge, in a 16-slot graph; `rotate` turns
    each step by a few degrees as well."""
    n, K = 12, 16
    dirs = [(0.5, 0, 0), (0, 0.5, 0), (-0.5, 0, 0), (0, -0.5, 0)]
    turn = jse3.quat_from_axis_angle(jnp.asarray(
        [0.01, 0.03, 0.05] if rotate else [0.0, 0.0, 0.0], jnp.float32))
    gt = [jse3.identity_pose()]
    steps = [jse3.Pose(q=turn, t=jnp.asarray(dirs[(k // 3) % 4],
                                            jnp.float32))
             for k in range(n - 1)]
    for s in steps:
        gt.append(jse3.pose_compose(gt[-1], s))
    drift = jse3.Pose(q=jse3.quat_from_axis_angle(jnp.asarray(
        [0.0, 0.0, 0.01] if rotate else [0.0, 0.0, 0.0], jnp.float32)),
        t=jnp.asarray([0.01, 0.004, -0.003], jnp.float32))
    est = [jse3.identity_pose()]
    for s in steps:
        est.append(jse3.pose_compose(est[-1], jse3.pose_compose(s, drift)))
    kf_q = np.stack([np.asarray(p.q) for p in est] + [[1, 0, 0, 0]] * (K - n)
                    ).astype(np.float32)
    kf_t = np.stack([np.asarray(p.t) for p in est] + [[0, 0, 0]] * (K - n)
                    ).astype(np.float32)
    valid = np.arange(K) < n
    jed, ted = jpg.empty_edges(32), tpg.empty_edges(32)
    meas = [(k, k + 1, j_relative(est[k], est[k + 1]), 1.0)
            for k in range(n - 1)]
    meas.append((n - 1, 0, j_relative(gt[n - 1], gt[0]), 2.0))
    for e, (a, b, rel, w) in enumerate(meas):
        jed = jpg.add_edge(jed, jnp.int32(e), jnp.int32(a), jnp.int32(b),
                           rel, w, is_loop=w > 1)
        tpg.add_edge(ted, e, a, b, tse3.Pose(q=_t(rel.q), t=_t(rel.t)), w,
                     is_loop=w > 1)
    return kf_q, kf_t, valid, jed, ted, gt


@pytest.mark.parametrize("rotate", [False, True])
def test_optimize_pose_graph_matches_jax_on_drifted_chain(rotate):
    kf_q, kf_t, valid, jed, ted, gt = _square_chain(rotate)
    lcfg = LoopConfig()
    jq, jt, jc = jax.jit(lambda *a: jpg.optimize_pose_graph(
        *a, iters=lcfg.pgo_iterations, cg_iters=lcfg.pgo_cg_iters))(
        jnp.asarray(kf_q), jnp.asarray(kf_t), jnp.asarray(valid), jed)
    tq, tt, tc = tpg.optimize_pose_graph(
        _t(kf_q), _t(kf_t), _t(valid), ted, iters=lcfg.pgo_iterations,
        cg_iters=lcfg.pgo_cg_iters)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4, atol=1e-9)
    # the loop correction pulled the end back; the gauge stayed put
    end_before = np.linalg.norm(kf_t[11] - np.asarray(gt[11].t))
    end_after = np.linalg.norm(tt[11].numpy() - np.asarray(gt[11].t))
    assert end_after < 0.5 * end_before
    assert torch.equal(tt[0], _t(kf_t[0])) and torch.equal(tq[0],
                                                           _t(kf_q[0]))


def test_pgo_converges_near_capacity():
    """tests/test_loop.py:213 on the port: the default budget (20 GN x 32
    CG) distributes a loop correction along a 250-node drifted chain."""
    lcfg = LoopConfig()
    n, K = 250, 256
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt_t = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang), np.zeros(n)],
                    axis=1).astype(np.float32)
    drift = np.array([0.0015, -0.001, 0.0008], np.float32)
    est_t = np.concatenate([gt_t[:1], gt_t[0] + np.cumsum(
        np.diff(gt_t, axis=0) + drift, axis=0)]).astype(np.float32)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    kf_q = ident.repeat(K, 1)
    kf_t = torch.cat([_t(est_t), torch.zeros(K - n, 3)])
    edges = tpg.empty_edges(512)
    for k in range(n - 1):
        rel = relative_pose(tse3.Pose(q=ident, t=_t(est_t[k])),
                            tse3.Pose(q=ident, t=_t(est_t[k + 1])))
        tpg.add_edge(edges, k, k, k + 1, rel)
    tpg.add_edge(edges, n - 1, n - 1, 0,
                 relative_pose(tse3.Pose(q=ident, t=_t(gt_t[n - 1])),
                               tse3.Pose(q=ident, t=_t(gt_t[0]))), 2.0)
    before = float(np.linalg.norm(est_t[n - 1] - gt_t[n - 1]))
    _, t, _ = tpg.optimize_pose_graph(kf_q, kf_t, torch.arange(K) < n,
                                      edges, iters=lcfg.pgo_iterations,
                                      cg_iters=lcfg.pgo_cg_iters)
    err = np.linalg.norm(t[:n].numpy() - gt_t, axis=1)
    assert before > 0.3
    assert err[n - 1] < 0.2 * before and err.max() < 0.5 * before


def test_correct_landmarks_matches_jax():
    rng = np.random.default_rng(5)
    K, L = 8, 200
    oq, ot = _random_poses(K, 6, rot=0.2)
    nq, nt = _random_poses(K, 7, rot=0.2)
    lm = rng.normal(size=(L, 3)).astype(np.float32) * 3
    valid = rng.random(L) > 0.2
    anchor = rng.integers(0, K, L).astype(np.int32)
    want = jpg.correct_landmarks(*(jnp.asarray(x) for x in (
        lm, valid, anchor, oq, ot, nq, nt)))
    got = tpg.correct_landmarks(*(_t(x) for x in (lm, valid, anchor, oq,
                                                  ot, nq, nt)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(got[~_t(valid)], _t(lm)[~_t(valid)])


@pytest.mark.parametrize("rotate", [False, True])
def test_loop_pgo_in_float64_matches_jax(rotate):
    """The loop pipeline's PGO (`solve_pose_graph`: odometry edges
    re-measured, then solved in float64) against the JAX pipeline's
    (`_pgo_impl`, float32): poses within 1e-4, returned in float32."""
    from modular_slam_tpu_torch.loop.pipeline import solve_pose_graph

    kf_q, kf_t, valid, jed, ted, _ = _square_chain(rotate)
    lcfg = LoopConfig()

    def jax_pgo(q, t, v, e):
        e = jpg.refresh_odometry_edges(e, q, t)
        return jpg.optimize_pose_graph(q, t, v, e, iters=lcfg.pgo_iterations,
                                       cg_iters=lcfg.pgo_cg_iters)

    jq, jt, jc = jax.jit(jax_pgo)(jnp.asarray(kf_q), jnp.asarray(kf_t),
                                  jnp.asarray(valid), jed)
    tq, tt, tc = solve_pose_graph(_t(kf_q), _t(kf_t), _t(valid), ted, lcfg)
    assert tq.dtype == tt.dtype == tc.dtype == torch.float32
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0,
                               atol=POSE_TOL)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4, atol=1e-9)
