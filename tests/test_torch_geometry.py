"""The port's SE(3) and camera math against the JAX package, within 1e-6
(float32 rounding of the same formulas)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from modular_slam_tpu.config import CameraConfig
from modular_slam_tpu.geometry import camera as jcam
from modular_slam_tpu.geometry import se3 as jse3
from modular_slam_tpu_torch.geometry import camera as tcam
from modular_slam_tpu_torch.geometry import se3 as tse3

TOL = 1e-6


def _rng_quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def test_quaternion_primitives():
    a, b = _rng_quats(16, 0), _rng_quats(16, 1)
    v = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    ta, tb, tv = (torch.from_numpy(x) for x in (a, b, v))
    ja, jb, jv = (jnp.asarray(x) for x in (a, b, v))
    _close(tse3.quat_normalize(ta * 3), jse3.quat_normalize(ja * 3))
    _close(tse3.quat_multiply(ta, tb), jse3.quat_multiply(ja, jb))
    _close(tse3.quat_conjugate(ta), jse3.quat_conjugate(ja))
    _close(tse3.quat_rotate(ta, tv), jse3.quat_rotate(ja, jv))
    _close(tse3.quat_to_matrix(ta), jse3.quat_to_matrix(ja))
    aa = v * 0.3
    _close(tse3.quat_from_axis_angle(torch.from_numpy(aa)),
           jse3.quat_from_axis_angle(jnp.asarray(aa)))


def test_matrix_to_quat_all_shepperd_branches():
    """Rotations by pi-ish angles about x, y, z select candidates 1-3; a
    small rotation selects the trace branch 0."""
    aas = np.array([[0.1, 0.2, -0.1],       # trace > 0
                    [3.0, 0.1, 0.0],        # m00 dominant
                    [0.1, 3.0, 0.0],        # m11 dominant
                    [0.0, 0.1, 3.0]], np.float32)
    R = np.array(jse3.quat_to_matrix(jse3.quat_from_axis_angle(
        jnp.asarray(aas))))
    m00, m11, m22 = R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    assert tr[0] > 0 and (tr[1:] <= 0).all()
    assert m00[1] >= max(m11[1], m22[1])
    assert m11[2] >= m22[2] and m11[2] > m00[2]
    assert m22[3] > max(m00[3], m11[3])
    _close(tse3.matrix_to_quat(torch.from_numpy(R)),
           jse3.matrix_to_quat(jnp.asarray(R)))


def test_so3_exp_matches_jax():
    """`so3_exp` is the axis-angle map, in both packages, exact at 0."""
    assert tse3.so3_exp is tse3.quat_from_axis_angle
    aa = np.random.default_rng(4).normal(size=(16, 3)).astype(np.float32)
    aa[0] = 0.0
    got = tse3.so3_exp(torch.from_numpy(aa))
    _close(got, jse3.so3_exp(jnp.asarray(aa)))
    np.testing.assert_array_equal(got[0].numpy(), [1.0, 0.0, 0.0, 0.0])


def test_se3_exp_exact_at_zero_and_close_elsewhere():
    p = tse3.se3_exp(torch.zeros(6))
    assert torch.equal(p.q, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert torch.equal(p.t, torch.zeros(3))
    xi = np.random.default_rng(3).normal(size=(8, 6)).astype(np.float32)
    xi[0, 3:] = 1e-7  # small-angle branch
    tp = tse3.se3_exp(torch.from_numpy(xi))
    jp = jse3.se3_exp(jnp.asarray(xi))
    _close(tp.q, jp.q)
    _close(tp.t, jp.t)


def test_pose_compose_inverse_apply():
    qa, qb = _rng_quats(4, 4), _rng_quats(4, 5)
    ta, tb = (np.random.default_rng(s).normal(size=(4, 3)).astype(
        np.float32) for s in (6, 7))
    pts = np.random.default_rng(8).normal(size=(4, 3)).astype(np.float32)
    tA = tse3.Pose(torch.from_numpy(qa), torch.from_numpy(ta))
    tB = tse3.Pose(torch.from_numpy(qb), torch.from_numpy(tb))
    jA = jse3.Pose(jnp.asarray(qa), jnp.asarray(ta))
    jB = jse3.Pose(jnp.asarray(qb), jnp.asarray(tb))
    for got, ref in ((tse3.pose_compose(tA, tB), jse3.pose_compose(jA, jB)),
                     (tse3.pose_inverse(tA), jse3.pose_inverse(jA))):
        _close(got.q, ref.q)
        _close(got.t, ref.t)
    _close(tse3.pose_apply(tA, torch.from_numpy(pts)),
           jse3.pose_apply(jA, jnp.asarray(pts)))
    _close(tse3.pose_apply_inverse(tA, torch.from_numpy(pts)),
           jse3.pose_apply_inverse(jA, jnp.asarray(pts)))


@pytest.mark.parametrize("cfg", [CameraConfig(),
                                 CameraConfig(fx=100.0, fy=90.0, cx=79.5,
                                              cy=59.5, width=160, height=120)])
def test_camera_project_backproject(cfg):
    rng = np.random.default_rng(9)
    pts = np.concatenate([rng.normal(size=(32, 2)),
                          rng.uniform(-1, 4, (32, 1))], -1).astype(np.float32)
    uv = rng.uniform(0, 160, (32, 2)).astype(np.float32)
    depth = rng.uniform(0, 3, 32).astype(np.float32)
    tc, jc = tcam.camera_from_config(cfg), jcam.camera_from_config(cfg)
    proj_t = tcam.project(tc, torch.from_numpy(pts)).numpy()
    proj_j = np.asarray(jcam.project(jc, jnp.asarray(pts)))
    np.testing.assert_allclose(proj_t, proj_j, rtol=TOL)
    _close(tcam.backproject(tc, torch.from_numpy(uv), torch.from_numpy(depth)),
           jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(depth)))
    np.testing.assert_array_equal(
        tcam.is_visible(tc, torch.from_numpy(pts)).numpy(),
        np.asarray(jcam.is_visible(jc, jnp.asarray(pts))))
    q = _rng_quats(1, 10)[0]
    t = np.array([0.1, -0.2, -2.0], np.float32)
    np.testing.assert_allclose(
        tcam.project_world(tc, tse3.Pose(torch.from_numpy(q),
                                         torch.from_numpy(t)),
                           torch.from_numpy(pts)).numpy(),
        np.asarray(jcam.project_world(jc, jse3.Pose(jnp.asarray(q),
                                                    jnp.asarray(t)),
                                      jnp.asarray(pts))), rtol=TOL)
