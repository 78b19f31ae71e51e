"""Com-based quantities: subtree_com, cinert, cdof (mj_comPos) and
cvel/cdof_dot (mj_comVel).

Port of track_mjx_tpu/physics/com.py: subtree aggregation is one static-mask
matmul, the dof axes are built per joint type and restored to dof order by
one gather, and com_vel walks the kinematics schedule level by level.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import spatial
from track_mjx_tpu_torch.ops.quaternion import cross
from track_mjx_tpu_torch.physics.kinematics import kin_schedule
from track_mjx_tpu_torch.physics.model import (
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    Data,
    Model,
    PhysicsPlan,
    static_tensor,
)


def subtree_mask(plan: PhysicsPlan) -> np.ndarray:
    """mask[b, i] = 1 if body i is in the subtree rooted at b (incl. b)."""
    mask = np.eye(plan.nbody, dtype=bool)
    for i in range(plan.nbody - 1, 0, -1):
        mask[int(plan.body_parentid[i])] |= mask[i]
    return mask.astype(np.float64)


def com_pos(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes subtree_com, cinert, cdof."""
    like = data.qpos
    bsz = like.shape[0]

    def idx(key, build):
        return static_tensor(plan, ("com",) + key, like, build)

    mask = idx(("subtree_mask",), lambda: subtree_mask(plan))
    mass = model.body_mass  # [nbody], or [B, nbody] per env
    weighted = mass[..., None] * data.xipos
    subtree_mass = torch.clamp(mass @ mask.T if mass.dim() > 1 else mask @ mass, min=1e-12)
    subtree_com = (mask @ weighted) / subtree_mass[..., None]

    root_com = subtree_com[:, idx(("rootid",), lambda: plan.body_rootid)]
    cinert = spatial.inertia_in_com_frame(
        mass, model.body_inertia, data.ximat, data.xipos, root_com
    )

    blocks = []  # (dof indices np(k,), rows [B, k, 6])
    for jt in (JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE):
        jids = np.nonzero(plan.jnt_type == jt)[0]
        if len(jids) == 0:
            continue
        jids_t = idx(("jids", jt), lambda: jids)
        bodyid = idx(("bodyid", jt), lambda: plan.jnt_bodyid[jids])
        com = subtree_com[:, idx(("root", jt), lambda: plan.body_rootid[plan.jnt_bodyid[jids]])]
        dadr = plan.jnt_dofadr[jids]
        zero3 = like.new_zeros((bsz, len(jids), 3))
        if jt in (JNT_FREE, JNT_BALL):
            axes = data.xmat[:, bodyid]  # column i = axis i in world
            offset = com - data.xanchor[:, jids_t]
            if jt == JNT_FREE:
                eye = torch.eye(3, dtype=like.dtype, device=like.device)
                for i in range(3):
                    blocks.append((dadr + i, torch.cat([zero3, eye[i].expand_as(zero3)], -1)))
            first = 3 if jt == JNT_FREE else 0
            for i in range(3):
                a = axes[..., :, i]
                blocks.append((dadr + first + i, torch.cat([a, cross(a, offset)], -1)))
        elif jt == JNT_SLIDE:
            blocks.append((dadr, torch.cat([zero3, data.xaxis[:, jids_t]], -1)))
        else:  # hinge
            a = data.xaxis[:, jids_t]
            offset = com - data.xanchor[:, jids_t]
            blocks.append((dadr, torch.cat([a, cross(a, offset)], -1)))

    if blocks:
        order = idx(
            ("cdof_order",),
            lambda: np.argsort(np.concatenate([np.asarray(b[0]) for b in blocks])),
        )
        cdof = torch.cat([b[1] for b in blocks], dim=1)[:, order]
    else:
        cdof = like.new_zeros((bsz, plan.nv, 6))

    return data.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes cvel (body spatial velocities) and cdof_dot (mj_comVel)."""
    like = data.qpos
    bsz = like.shape[0]
    qvel, cdof = data.qvel, data.cdof
    levels, pos_in_acc, body_inv, _ = kin_schedule(plan)

    def idx(key, build):
        return static_tensor(plan, ("comvel",) + key, like, build)

    cat_vel = like.new_zeros((bsz, 1, 6))
    dot_blocks = []  # (dof indices np(k,), rows [B, k, 6])

    for li, groups in enumerate(levels):
        level_vels = []
        for gi, (ids, sig) in enumerate(groups):
            v = cat_vel[:, idx((li, gi, "par"), lambda: pos_in_acc[plan.body_parentid[ids]])]
            for k, jt in enumerate(sig):
                dadr_np = plan.jnt_dofadr[plan.body_jntadr[ids] + k]

                def dof(i, dadr_np=dadr_np, k=k):
                    return idx((li, gi, k, i), lambda: dadr_np + i)

                if jt == JNT_FREE:
                    dv = torch.zeros_like(v)
                    for i in range(3):
                        d = dof(i)
                        dv = dv + cdof[:, d] * qvel[:, d, None]
                    v = v + dv
                    for i in range(3):
                        dot_blocks.append((dadr_np + i, torch.zeros_like(v)))
                    for i in range(3):
                        d = dof(3 + i)
                        dot_blocks.append((dadr_np + 3 + i, spatial.motion_cross(v, cdof[:, d])))
                    for i in range(3):
                        d = dof(3 + i)
                        v = v + cdof[:, d] * qvel[:, d, None]
                elif jt == JNT_BALL:
                    for i in range(3):
                        d = dof(i)
                        dot_blocks.append((dadr_np + i, spatial.motion_cross(v, cdof[:, d])))
                    for i in range(3):
                        d = dof(i)
                        v = v + cdof[:, d] * qvel[:, d, None]
                else:  # slide / hinge: one dof
                    d = dof(0)
                    cd = cdof[:, d]
                    dot_blocks.append((dadr_np, spatial.motion_cross(v, cd)))
                    v = v + cd * qvel[:, d, None]
            level_vels.append(v)
        cat_vel = torch.cat([cat_vel] + level_vels, dim=1)

    cvel = cat_vel[:, idx(("body_inv",), lambda: body_inv)]
    if dot_blocks:
        order = idx(
            ("dot_order",),
            lambda: np.argsort(np.concatenate([np.asarray(b[0]) for b in dot_blocks])),
        )
        cdof_dot = torch.cat([b[1] for b in dot_blocks], dim=1)[:, order]
    else:
        cdof_dot = like.new_zeros((bsz, plan.nv, 6))
    return data.replace(cvel=cvel, cdof_dot=cdof_dot)
