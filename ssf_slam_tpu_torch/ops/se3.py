"""SE(3) / quaternion utilities (ssf_slam_tpu/ops/se3.py).

Quaternions are ``[x, y, z, w]``; a pose is a ``(q, t)`` tuple with
``pose_apply((q, t), p) = R(q) p + t``. Shape-polymorphic over leading
batch dims.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def quat_identity(device=None) -> Tensor:
    # filled on the device: a tensor built from a host list, or a Python
    # number assigned by index, is a host-to-device copy the host waits for
    q = torch.zeros(4, device=device)
    q[3:].fill_(1.0)
    return q


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=eps)
    # canonicalize sign (w >= 0) so compositions stay numerically stable
    w = q[..., 3:4]
    return q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))


def quat_multiply(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product; R(q1 * q2) = R(q1) R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q: Tensor) -> Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def cross3(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the last axis (broadcasting), written out as
    ``jnp.cross`` computes it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vectors v [..., 3] by quaternion q [..., 4] (broadcasting)."""
    qv, qw = q[..., :3], q[..., 3:4]
    t = 2.0 * cross3(qv, v)
    return v + qw * t + cross3(qv, t)


def quat_to_matrix(q: Tensor) -> Tensor:
    """[..., 4] -> [..., 3, 3] rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: Tensor) -> Tensor:
    """[..., 3, 3] -> [..., 4] (x, y, z, w). Branch-free Shepperd's method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) / 2

    qw_w = root(1.0 + tr)
    q_w = torch.stack([(m21 - m12) / (4 * qw_w), (m02 - m20) / (4 * qw_w),
                       (m10 - m01) / (4 * qw_w), qw_w], dim=-1)
    qx_x = root(1.0 + m00 - m11 - m22)
    q_x = torch.stack([qx_x, (m01 + m10) / (4 * qx_x),
                       (m02 + m20) / (4 * qx_x), (m21 - m12) / (4 * qx_x)],
                      dim=-1)
    qy_y = root(1.0 - m00 + m11 - m22)
    q_y = torch.stack([(m01 + m10) / (4 * qy_y), qy_y,
                       (m12 + m21) / (4 * qy_y), (m02 - m20) / (4 * qy_y)],
                      dim=-1)
    qz_z = root(1.0 - m00 - m11 + m22)
    q_z = torch.stack([(m02 + m20) / (4 * qz_z), (m12 + m21) / (4 * qz_z),
                       qz_z, (m10 - m01) / (4 * qz_z)], dim=-1)

    # pick the branch with the largest pivot
    cond_w = (tr > 0)[..., None]
    cond_x = ((m00 > m11) & (m00 > m22))[..., None]
    cond_y = (m11 > m22)[..., None]
    q = torch.where(cond_w, q_w,
                    torch.where(cond_x, q_x, torch.where(cond_y, q_y, q_z)))
    return quat_normalize(q)


def quat_to_rpy(q: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Quaternion -> (roll, pitch, yaw), ZYX convention."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def so3_exp_quat(w: Tensor) -> Tensor:
    """so(3) vector [..., 3] -> unit quaternion (exponential map), with
    the small-angle series below theta^2 = 1e-12."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    small = theta2 > 1e-12
    k = torch.where(small, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    qw = torch.where(small[..., 0], torch.cos(half[..., 0]),
                     1.0 - theta2[..., 0] / 8.0)
    return torch.cat([w * k, qw[..., None]], dim=-1)


def so3_log_quat(q: Tensor) -> Tensor:
    """Unit quaternion -> so(3) vector (inverse of so3_exp_quat), sign-
    canonicalised so the geodesic is the short way."""
    w0 = q[..., 3:4]
    q = q * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))
    xyz = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    s = torch.linalg.norm(xyz, dim=-1)
    half = torch.atan2(s, w)
    k = torch.where(s > 1e-8, 2.0 * half / torch.clamp(s, min=1e-24),
                    2.0 / torch.clamp(w, min=1e-8))
    return xyz * k[..., None]


def pose_compose(pose_ab, pose_bc):
    """T_ac = T_ab * T_bc (q_0_curr = q_0_last * q_last_curr;
    t_0_curr = t_0_last + q_0_last * t_last_curr)."""
    q_ab, t_ab = pose_ab
    q_bc, t_bc = pose_bc
    return quat_multiply(q_ab, q_bc), t_ab + quat_rotate(q_ab, t_bc)


def pose_inverse(pose):
    q, t = pose
    qi = quat_conjugate(q)
    return qi, -quat_rotate(qi, t)


def pose_apply(pose, p: Tensor) -> Tensor:
    q, t = pose
    return quat_rotate(q, p) + t


def pose_between(pose_a, pose_b):
    """T_a^-1 * T_b, the relative pose (gtsam Pose3::between)."""
    return pose_compose(pose_inverse(pose_a), pose_b)


def quat_from_rpy(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    """ZYX Euler angles (tf::createQuaternionFromRPY) -> [..., 4] xyzw."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy,
                        cr * cp * sy - sr * sp * cy,
                        cr * cp * cy + sr * sp * sy], dim=-1)


def pose_identity(device: str | torch.device = "cuda"):
    """The identity pose (q [4], t [3]), float32, on ``device`` (the card
    unless the caller asks for the CPU)."""
    from ssf_slam_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return quat_identity(dev), torch.zeros(3, device=dev)


def pose_from_rt(r_mat: Tensor, t: Tensor):
    """(rotation matrix [..., 3, 3], t [..., 3]) -> pose (q, t)."""
    return matrix_to_quat(r_mat), t


def pose_to_mat4(pose) -> Tensor:
    """Pose (q [..., 4], t [..., 3]) -> homogeneous [..., 4, 4]."""
    q, t = pose
    m = torch.zeros(q.shape[:-1] + (4, 4), dtype=q.dtype, device=q.device)
    m[..., :3, :3] = quat_to_matrix(q)
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m
