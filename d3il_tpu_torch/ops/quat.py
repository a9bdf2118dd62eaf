"""Batched quaternion / rotation ops (wxyz convention) on torch tensors.

Counterpart of ``d3il_tpu/ops/quat.py``: every function broadcasts over
leading batch dimensions, with the quaternion or vector on the last axis.
Euler conventions follow the reference's extrinsic-XYZ functions so that
observation yaw encodings (tan(yaw)) agree with the JAX package.
"""
from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize quaternion(s) along the last axis."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def mul(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Hamilton product q0 * q1 (wxyz)."""
    w0, x0, y0, z0 = q0.unbind(-1)
    w1, x1, y1, z1 = q1.unbind(-1)
    return torch.stack([
        w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1,
        w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
        w0 * y1 - x0 * z1 + y0 * w1 + z0 * x1,
        w0 * z1 + x0 * y1 - y0 * x1 + z0 * w1,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting leading dims."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q: R(q) @ v."""
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + qw * t + cross(qv, t)


def rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q: R(q)^T @ v."""
    return rotate(conj(q), v)


def to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix (normalizing first)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def from_mat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> quaternion (wxyz, w >= 0), branch-free
    Shepperd: of the four candidate quaternions, the one of the largest of
    (trace, m00, m11, m22)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
                    dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
                    dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
                    dim=-1)], dim=-2)                    # [..., 4, 4]
    idx = torch.stack([tr, m00, m11, m22], dim=-1).argmax(dim=-1)
    q = normalize(torch.take_along_dim(cands, idx[..., None, None],
                                       dim=-2)[..., 0, :])
    return torch.where(q[..., :1] < 0, -q, q)


def quat_error(curr: torch.Tensor, des: torch.Tensor) -> torch.Tensor:
    """Orientation error e = w_c v_d - w_d v_c - v_d x v_c, shape [..., 3]."""
    wc, vc = curr[..., :1], curr[..., 1:]
    wd, vd = des[..., :1], des[..., 1:]
    return wc * vd - wd * vc - cross(vd, vc)


def from_euler(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles -> quaternion (reference ``euler2quat`` convention)."""
    ai, aj, ak = euler[..., 2] / 2, -euler[..., 1] / 2, euler[..., 0] / 2
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack([cj * cc + sj * ss, cj * cs - sj * sc,
                        -(cj * ss + sj * cc), cj * sc - sj * cs], dim=-1)


def to_euler(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> Euler angles (reference ``quat2euler``); [..., 2] is yaw."""
    m = to_mat(q)
    eps4 = 4.0 * torch.finfo(m.dtype).eps
    cy = torch.sqrt(m[..., 2, 2] ** 2 + m[..., 1, 2] ** 2)
    cond = cy > eps4
    e2 = torch.where(cond, -torch.atan2(m[..., 0, 1], m[..., 0, 0]),
                     -torch.atan2(-m[..., 1, 0], m[..., 1, 1]))
    e1 = -torch.atan2(-m[..., 0, 2], cy)
    e0 = torch.where(cond, -torch.atan2(m[..., 1, 2], m[..., 2, 2]),
                     torch.zeros_like(cy))
    return torch.stack([e0, e1, e2], dim=-1)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis [..., 3] + angle [...] -> quaternion [..., 4]."""
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], dim=-1)


def integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q * exp(0.5 omega dt) for a body-local angular velocity (MuJoCo
    mju_quatIntegrate semantics)."""
    angle = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
    half = 0.5 * dt * angle
    k = torch.where(angle > 1e-9, torch.sin(half) / angle.clamp_min(1e-9),
                    torch.full_like(angle, 0.5 * dt))
    dq = torch.cat([torch.cos(half), omega * k], dim=-1)
    return normalize(mul(q, dq))
