"""6D spatial-vector algebra in MuJoCo layout: [angular(3); linear(3)].

Port of track_mjx_tpu/ops/spatial.py. Every function broadcasts over leading
dimensions: motion/force vectors are [..., 6], compact inertias [..., 10]
laid out as MuJoCo's cinert = [Ixx Iyy Izz Ixy Ixz Iyz, m*com (3), m].
"""

from __future__ import annotations

import torch

from track_mjx_tpu_torch.ops.quaternion import cross


def motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cross product of motion vectors v x u (mju_crossMotion)."""
    w_v, l_v = v[..., :3], v[..., 3:]
    w_u, l_u = u[..., :3], u[..., 3:]
    return torch.cat([cross(w_v, w_u), cross(w_v, l_u) + cross(l_v, w_u)], -1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Cross product of a motion vector with a force vector (mju_crossForce)."""
    w_v, l_v = v[..., :3], v[..., 3:]
    t_f, f_f = f[..., :3], f[..., 3:]
    return torch.cat([cross(w_v, t_f) + cross(l_v, f_f), cross(w_v, f_f)], -1)


def inert_mul(i: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """f = I * v for the compact 10-parameter inertia (mju_mulInertVec)."""
    w, l = v[..., :3], v[..., 3:]
    ixx, iyy, izz, ixy, ixz, iyz = i[..., 0], i[..., 1], i[..., 2], i[..., 3], i[..., 4], i[..., 5]
    h = i[..., 6:9]
    m = i[..., 9:10]
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    torque = torch.stack(
        [
            ixx * w0 + ixy * w1 + ixz * w2,
            ixy * w0 + iyy * w1 + iyz * w2,
            ixz * w0 + iyz * w1 + izz * w2,
        ],
        -1,
    ) + cross(h, l)
    force = m * l - cross(h, w)
    return torch.cat([torque, force], -1)


def transform_motion(
    vec: torch.Tensor, offset: torch.Tensor, rotnew2old: torch.Tensor
) -> torch.Tensor:
    """Transforms a motion vector between frames (mju_transformSpatial,
    force=0). offset = new_origin - old_origin in old coordinates; rotnew2old
    maps new-frame coordinates to old-frame coordinates."""
    w, l = vec[..., :3], vec[..., 3:]
    new_l = l - cross(offset, w)
    new_w = (rotnew2old * w[..., :, None]).sum(-2)
    new_l = (rotnew2old * new_l[..., :, None]).sum(-2)
    return torch.cat([new_w, new_l], -1)


def transform_force(vec: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Translates a force vector to a new application point (torque picks up
    -offset x f)."""
    t, f = vec[..., :3], vec[..., 3:]
    return torch.cat([t - cross(offset, f), f], -1)


def inertia_in_com_frame(
    body_mass: torch.Tensor,
    body_inertia: torch.Tensor,
    ximat: torch.Tensor,
    xipos: torch.Tensor,
    com: torch.Tensor,
) -> torch.Tensor:
    """Body inertia about `com` in world axes, compact layout (mj_comPos's
    cinert): I_world = R diag(I) R^T shifted by d = xipos - com with the
    parallel axis theorem. body_mass [...], body_inertia [..., 3],
    ximat [..., 3, 3], xipos/com [..., 3] -> [..., 10]."""
    r = ximat
    ri = r * body_inertia[..., None, :]
    r0, r1, r2 = r[..., 0, :], r[..., 1, :], r[..., 2, :]
    i00 = (ri[..., 0, :] * r0).sum(-1)
    i11 = (ri[..., 1, :] * r1).sum(-1)
    i22 = (ri[..., 2, :] * r2).sum(-1)
    i01 = (ri[..., 0, :] * r1).sum(-1)
    i02 = (ri[..., 0, :] * r2).sum(-1)
    i12 = (ri[..., 1, :] * r2).sum(-1)
    d = xipos - com
    dd = (d * d).sum(-1)
    m = torch.broadcast_to(body_mass, dd.shape)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    h = m[..., None] * d
    return torch.cat(
        [
            torch.stack(
                [
                    i00 + m * (dd - d0 * d0),
                    i11 + m * (dd - d1 * d1),
                    i22 + m * (dd - d2 * d2),
                    i01 - m * d0 * d1,
                    i02 - m * d0 * d2,
                    i12 - m * d1 * d2,
                ],
                -1,
            ),
            h,
            m[..., None],
        ],
        -1,
    )
