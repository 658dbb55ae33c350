"""SE(3) / quaternion math on tensors.

Counterpart of modular_slam_tpu/geometry/se3.py, with the same
conventions:

- A sensor/keyframe pose is **camera-to-world**: ``p_world = q * p_cam + t``.
- Quaternions are ``[w, x, y, z]`` float tensors, kept normalized; all ops
  broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_EPS = 1e-8


class Pose(NamedTuple):
    """Camera-to-world rigid transform. q: [..., 4] wxyz, t: [..., 3]."""

    q: Tensor
    t: Tensor


def identity_pose(batch_shape=(), dtype=torch.float32,
                  device="cpu") -> Pose:
    q = torch.zeros((*batch_shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return Pose(q=q, t=t)


# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------


def quat_normalize(q: Tensor) -> Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=_EPS)
    # canonicalize sign (w >= 0) so log/compare are stable
    return torch.where(q[..., :1] < 0, -q, q)


def quat_multiply(a: Tensor, b: Tensor) -> Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: Tensor) -> Tensor:
    # a negation, not a product with a [1, -1, -1, -1] constant: building
    # that on the card copies it from the host and waits for the copy
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qw = q[..., :1]
    qv = q[..., 1:]
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: Tensor) -> Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def matrix_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (wxyz).

    Branch-free Shepperd-style construction: all four candidates are
    computed and the numerically best one is selected by the largest
    diagonal term."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack(
        [0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0],
        dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack(
        [(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1],
        dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack(
        [(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2],
        dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack(
        [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3],
        dim=-1)

    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return quat_normalize(q)


def quat_from_axis_angle(axis_angle: Tensor) -> Tensor:
    """so(3) vector [..., 3] -> quaternion (double-where: exact at 0)."""
    theta2 = torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, k * axis_angle], dim=-1))


so3_exp = quat_from_axis_angle


def so3_log(q: Tensor) -> Tensor:
    """Quaternion -> so(3) vector (axis * angle).  The double-where keeps
    the value and its forward-mode derivative finite at the identity,
    where the pose-graph optimizer linearizes."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-12
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(vn, w)
    # small: theta / vn -> 2 / w
    k = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return k * v


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def _skew(v: Tensor) -> Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(*v.shape[:-1], 3, 3)


def se3_exp(xi: Tensor) -> Pose:
    """se(3) vector [..., 6] (rho, phi) -> Pose, V-matrix translation.

    The double-where keeps every norm-dependent term finite, and the
    result exact, at xi = 0."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = th2 < 1e-10
    one = torch.ones_like(th2)
    th2_safe = torch.where(small, one, th2)
    theta = torch.sqrt(th2_safe)
    q = quat_from_axis_angle(phi)

    a = torch.where(small, 0.5 - th2 / 24.0,
                    (1.0 - torch.cos(theta)) / th2_safe)
    b = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, one, th2 * theta))
    K = _skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    V = eye + a[..., None] * K + b[..., None] * (K @ K)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return Pose(q=q, t=t)


def se3_log(pose: Pose) -> Tensor:
    """Pose -> se(3) vector [..., 6] (rho, phi); the double-where keeps it
    differentiable at the identity."""
    phi = so3_log(pose.q)
    th2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = th2 < 1e-10
    one = torch.ones_like(th2)
    theta = torch.sqrt(torch.where(small, one, th2))
    K = _skew(phi)
    # V^-1 = I - K/2 + c K^2
    half = theta / 2.0
    cot_term = torch.where(
        small, 1.0 / 12.0 + th2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.where(small, one, torch.sin(half)))
        / torch.where(small, one, th2))
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    Vinv = eye - 0.5 * K + cot_term[..., None] * (K @ K)
    rho = torch.einsum("...ij,...j->...i", Vinv, pose.t)
    return torch.cat([rho, phi], dim=-1)


def pose_compose(a: Pose, b: Pose) -> Pose:
    """a then b applied to camera points: result maps p -> a(b(p))."""
    return Pose(
        q=quat_normalize(quat_multiply(a.q, b.q)),
        t=quat_rotate(a.q, b.t) + a.t,
    )


def pose_inverse(p: Pose) -> Pose:
    qi = quat_conjugate(p.q)
    return Pose(q=qi, t=-quat_rotate(qi, p.t))


def pose_apply(p: Pose, pts: Tensor) -> Tensor:
    """camera -> world; a single pose broadcasts over pts [N, 3]."""
    return quat_rotate(p.q, pts) + p.t


def pose_apply_inverse(p: Pose, pts: Tensor) -> Tensor:
    """world -> camera."""
    return quat_rotate(quat_conjugate(p.q), pts - p.t)


def pose_retract(p: Pose, xi: Tensor) -> Pose:
    """Right-multiplicative retraction used by optimizers: p * exp(xi)."""
    return pose_compose(p, se3_exp(xi))


def pose_to_matrix(p: Pose) -> Tensor:
    """Pose -> homogeneous [..., 4, 4] camera-to-world matrix."""
    R = quat_to_matrix(p.q)
    top = torch.cat([R, p.t[..., :, None]], dim=-1)
    bottom = torch.zeros((*top.shape[:-2], 1, 4), dtype=p.t.dtype,
                         device=p.t.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
