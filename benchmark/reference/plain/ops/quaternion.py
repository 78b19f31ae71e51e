"""Quaternion and 3D rotation ops (MuJoCo conventions: wxyz, Hamilton product).

Port of track_mjx_tpu/ops/quaternion.py. Every function broadcasts over
leading dimensions: quaternions are [..., 4], vectors [..., 3], matrices
[..., 3, 3]. Formulas are term-for-term those of the JAX module so that the
two agree to f32 roundoff.
"""

from __future__ import annotations

import math

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last dimension (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last dimension (broadcasting)."""
    return (a * b).sum(-1)


def mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v of wxyz quaternions (mju_mulQuat)."""
    u0, u1, u2, u3 = u.unbind(-1)
    v0, v1, v2, v3 = v.unbind(-1)
    return torch.stack(
        [
            u0 * v0 - u1 * v1 - u2 * v2 - u3 * v3,
            u0 * v1 + u1 * v0 + u2 * v3 - u3 * v2,
            u0 * v2 - u1 * v3 + u2 * v0 + u3 * v1,
            u0 * v3 + u1 * v2 - u2 * v1 + u3 * v0,
        ],
        dim=-1,
    )


def inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (mju_negQuat)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def rotate(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotates vec by quat: r = 2 (u.v) u + (s^2 - u.u) v + 2 s (u x v)."""
    s, u = quat[..., :1], quat[..., 1:]
    r = 2.0 * (dot(u, vec)[..., None] * u) + (s * s - dot(u, u)[..., None]) * vec
    return r + 2.0 * s * cross(u, vec)


def rotate_inv(vec: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Rotates vec by the inverse of quat."""
    return rotate(vec, inv(quat))


def relative_quat(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Relative quaternion from q1 to q2 (brax.math.relative_quat parity)."""
    return mul(q2, inv(q1))


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalizes to a unit quaternion."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (mju_quat2Mat, row-major)."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [
            1.0 - 2.0 * (y * y + z * z),
            2.0 * (x * y - w * z),
            2.0 * (x * z + w * y),
        ],
        [
            2.0 * (x * y + w * z),
            1.0 - 2.0 * (x * x + z * z),
            2.0 * (y * z - w * x),
        ],
        [
            2.0 * (x * z - w * y),
            2.0 * (y * z + w * x),
            1.0 - 2.0 * (x * x + y * y),
        ],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion (mju_axisAngle2Quat); axis must be unit."""
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], -1)


def integrate(q: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
    """Integrates a quaternion by angular velocity over dt (mju_quatIntegrate);
    the result is normalized."""
    norm = torch.linalg.vector_norm(vel, dim=-1)
    angle = norm * dt
    axis = vel / torch.clamp(norm, min=1e-12)[..., None]
    return normalize(mul(q, from_axis_angle(axis, angle)))


def subtract(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """3D velocity that rotates qb into qa over unit time (mju_subQuat)."""
    qdif = mul(inv(qb), qa)
    sin_a_2 = torch.linalg.vector_norm(qdif[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(sin_a_2, qdif[..., 0])
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    axis = qdif[..., 1:] / torch.clamp(sin_a_2, min=1e-12)[..., None]
    return axis * angle[..., None]
