"""Forward kinematics: qpos -> body/geom/site frames (mj_kinematics parity).

Port of track_mjx_tpu/physics/kinematics.py. The tree is processed level by
level; within a level, bodies sharing a joint-type signature update as one
batched op over [B, k, ...]. Levels are appended by concatenation and body
and joint order is restored by one gather at the end, as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import quaternion as quat
from track_mjx_tpu_torch.physics.model import (
    JNT_BALL,
    JNT_FREE,
    JNT_SLIDE,
    Data,
    Model,
    PhysicsPlan,
    plan_cache,
    static_tensor,
    take,
)


def kin_schedule(plan: PhysicsPlan):
    """Host schedule: per tree level, groups (body_ids, joint-type signature),
    plus the permutations mapping level order back to body/joint order."""
    return plan_cache(plan, "kin_schedule", lambda: _kin_schedule(plan))


def _kin_schedule(plan: PhysicsPlan):
    levels = []
    body_order = [0]
    jnt_order = []
    for ids in plan.body_levels:
        sigs: dict = {}
        for b in ids:
            jn = int(plan.body_jntnum[b])
            adr = int(plan.body_jntadr[b])
            sig = tuple(int(plan.jnt_type[adr + k]) for k in range(jn))
            sigs.setdefault(sig, []).append(int(b))
        groups = []
        for sig, bodies in sigs.items():
            arr = np.asarray(bodies)
            groups.append((arr, sig))
            body_order.extend(bodies)
            for k in range(len(sig)):
                jnt_order.extend(plan.body_jntadr[arr] + k)
        levels.append(groups)
    body_inv = np.argsort(np.asarray(body_order))
    jnt_inv = np.argsort(np.asarray(jnt_order)) if jnt_order else np.zeros(0, int)
    pos_in_acc = np.zeros(plan.nbody, dtype=int)
    pos_in_acc[np.asarray(body_order)] = np.arange(len(body_order))
    return levels, pos_in_acc, body_inv, jnt_inv


def kinematics(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes xpos/xquat/xmat, xanchor/xaxis, geom/site frames from qpos."""
    qpos = data.qpos
    bsz = qpos.shape[0]
    levels, pos_in_acc, body_inv, jnt_inv = kin_schedule(plan)

    def idx(key, build):
        return static_tensor(plan, ("kin",) + key, qpos, build)

    cat_pos = qpos.new_zeros((bsz, 1, 3))
    cat_quat = qpos.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(bsz, 1, 4)
    anchor_parts, axis_parts = [], []

    for li, groups in enumerate(levels):
        level_pos, level_quat = [], []
        for gi, (ids, sig) in enumerate(groups):
            parents = idx((li, gi, "par"), lambda: pos_in_acc[plan.body_parentid[ids]])
            ids_t = idx((li, gi, "ids"), lambda: ids)
            p_pos = cat_pos[:, parents]
            p_quat = cat_quat[:, parents]
            b_pos = p_pos + quat.rotate(take(model, "body_pos", ids_t), p_quat)
            b_quat = quat.mul(p_quat, take(model, "body_quat", ids_t))

            for k, jt in enumerate(sig):
                j_np = plan.body_jntadr[ids] + k
                qadr_np = plan.jnt_qposadr[j_np]
                j_sel = idx((li, gi, k, "j"), lambda: j_np)
                if jt == JNT_FREE:
                    q3 = idx((li, gi, k, "q3"), lambda: qadr_np[:, None] + np.arange(3))
                    q4 = idx((li, gi, k, "q4"), lambda: qadr_np[:, None] + 3 + np.arange(4))
                    new_pos = qpos[:, q3]
                    new_quat = quat.normalize(qpos[:, q4])
                    anchor = new_pos
                    axis = take(model, "jnt_axis", j_sel).expand(bsz, -1, 3)
                else:
                    qadr = idx((li, gi, k, "q"), lambda: qadr_np)
                    anchor = b_pos + quat.rotate(take(model, "jnt_pos", j_sel), b_quat)
                    axis = quat.rotate(take(model, "jnt_axis", j_sel), b_quat)
                    if jt == JNT_SLIDE:
                        disp = (qpos[:, qadr] - take(model, "qpos0", qadr))[..., None]
                        new_pos = b_pos + axis * disp
                        new_quat = b_quat
                    elif jt == JNT_BALL:
                        q4 = idx((li, gi, k, "q4"), lambda: qadr_np[:, None] + np.arange(4))
                        qloc = quat.normalize(qpos[:, q4])
                        new_quat = quat.mul(b_quat, qloc)
                        new_pos = anchor - quat.rotate(take(model, "jnt_pos", j_sel), new_quat)
                    else:  # hinge
                        angle = qpos[:, qadr] - take(model, "qpos0", qadr)
                        qloc = quat.from_axis_angle(take(model, "jnt_axis", j_sel), angle)
                        new_quat = quat.mul(b_quat, qloc)
                        new_pos = anchor - quat.rotate(take(model, "jnt_pos", j_sel), new_quat)
                b_pos, b_quat = new_pos, new_quat
                anchor_parts.append(anchor)
                axis_parts.append(axis)

            level_pos.append(b_pos)
            level_quat.append(quat.normalize(b_quat))
        cat_pos = torch.cat([cat_pos] + level_pos, dim=1)
        cat_quat = torch.cat([cat_quat] + level_quat, dim=1)

    body_inv_t = idx(("body_inv",), lambda: body_inv)
    xpos = cat_pos[:, body_inv_t]
    xquat = cat_quat[:, body_inv_t]
    if anchor_parts:
        jnt_inv_t = idx(("jnt_inv",), lambda: jnt_inv)
        xanchor = torch.cat(anchor_parts, dim=1)[:, jnt_inv_t]
        xaxis = torch.cat(axis_parts, dim=1)[:, jnt_inv_t]
    else:
        xanchor = qpos.new_zeros((bsz, plan.njnt, 3))
        xaxis = qpos.new_zeros((bsz, plan.njnt, 3))

    xmat = quat.to_mat(xquat)
    xipos = xpos + quat.rotate(model.body_ipos, xquat)
    ximat = quat.to_mat(quat.mul(xquat, model.body_iquat))

    g_body = idx(("geom_body",), lambda: plan.geom_bodyid)
    geom_xpos = xpos[:, g_body] + quat.rotate(model.geom_pos, xquat[:, g_body])
    geom_xmat = quat.to_mat(quat.mul(xquat[:, g_body], model.geom_quat))
    if plan.nsite:
        s_body = idx(("site_body",), lambda: plan.site_bodyid)
        site_xpos = xpos[:, s_body] + quat.rotate(model.site_pos, xquat[:, s_body])
        site_xmat = quat.to_mat(quat.mul(xquat[:, s_body], model.site_quat))
    else:
        site_xpos, site_xmat = data.site_xpos, data.site_xmat

    return data.replace(
        xpos=xpos,
        xquat=xquat,
        xmat=xmat,
        xipos=xipos,
        ximat=ximat,
        xanchor=xanchor,
        xaxis=xaxis,
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        site_xmat=site_xmat,
    )
