"""Passive forces: joint springs, dof dampers and fluid drag (mj_passive).

Port of track_mjx_tpu/physics/passive.py. Fluid forces use MuJoCo's
inertia-box model (mj_inertiaBoxFluidModel): each body with mass is its
equivalent-inertia box; viscous and quadratic (density) drag wrenches are
computed in the body inertia frame and mapped to qfrc through the com-frame
dof axes. The fly depends on it (fruitfly_force_fast.xml sets density
0.00128 and viscosity 0.000185, cgs); the per-geom ellipsoid model is
rejected by put_model.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from track_mjx_tpu_torch.ops import quaternion as quat
from track_mjx_tpu_torch.physics.constraint import dof_body_mask
from track_mjx_tpu_torch.physics.model import (
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    Data,
    Model,
    PhysicsPlan,
    env_lined,
    env_view,
    is_per_env,
    mat_vec,
    static_tensor,
    take,
    vec_mat,
)


_MINVAL = 1e-15


def fluid(plan: PhysicsPlan, model: Model, data: Data) -> torch.Tensor:
    """Inertia-box fluid forces -> qfrc contribution [B, nv]."""
    mass = model.body_mass
    inert = model.body_inertia  # (nbody, 3) principal moments, or [B, nbody, 3] per env

    # equivalent inertia box: full side lengths, (nbody, 3) (or [B, nbody, 3])
    safe_mass = torch.clamp(mass, min=_MINVAL)
    box = torch.stack(
        [
            torch.sqrt(
                torch.clamp(inert[..., (i + 1) % 3] + inert[..., (i + 2) % 3] - inert[..., i], min=_MINVAL)
                / safe_mass
                * 6.0
            )
            for i in range(3)
        ],
        dim=-1,
    )

    # body 6D velocity at xipos, in the inertia (ximat) frame
    rootid = static_tensor(plan, ("passive", "rootid"), data.qpos, lambda: plan.body_rootid)
    arm = data.xipos - data.subtree_com[:, rootid]  # [B, nbody, 3]
    w_world = data.cvel[..., :3]
    v_world = data.cvel[..., 3:] + quat.cross(w_world, arm)
    # local = R^T world (ximat columns are the local axes in world coordinates)
    lw = (data.ximat * w_world[..., :, None]).sum(-2)
    lv = (data.ximat * v_world[..., :, None]).sum(-2)
    wind = env_view(model, "opt_wind", 3)[..., None]  # a linear velocity field
    lv = lv - (data.ximat * wind).sum(-2)

    # viscous drag (sphere of equivalent mean diameter)
    diam = box.mean(dim=-1, keepdim=True)
    visc = env_view(model, "opt_viscosity", 3)
    lfrc_ang = -math.pi * diam**3 * visc * lw
    lfrc_lin = -3.0 * math.pi * diam * visc * lv

    # quadratic (density) drag against the box faces
    dens = env_view(model, "opt_density", 3)
    b0, b1, b2 = box[..., 0:1], box[..., 1:2], box[..., 2:3]
    face = torch.cat([b1 * b2, b0 * b2, b0 * b1], dim=-1)
    lfrc_lin = lfrc_lin - 0.5 * dens * face * torch.abs(lv) * lv
    ang_coef = (
        torch.cat([b0 * (b1**4 + b2**4), b1 * (b0**4 + b2**4), b2 * (b0**4 + b1**4)], dim=-1)
        / 64.0
    )
    lfrc_ang = lfrc_ang - dens * ang_coef * torch.abs(lw) * lw

    # wrench to world, moved to the com reference point
    torque_w = (data.ximat * lfrc_ang[..., None, :]).sum(-1)
    force_w = (data.ximat * lfrc_lin[..., None, :]).sum(-1)
    torque_com = torque_w + quat.cross(arm, force_w)
    wrench = torch.cat([torque_com, force_w], dim=-1)  # [B, nbody, 6]
    # massless bodies contribute nothing (MuJoCo skips them)
    wrench = torch.where(mass[..., None] > _MINVAL, wrench, 0.0)

    # qfrc[i] = sum_b mask[b, i] cdof[i] . wrench[b]
    mask = static_tensor(plan, ("passive", "body_dof_mask"), data.qpos, lambda: dof_body_mask(plan))
    dots = (data.cdof[:, :, None, :] * wrench[:, None, :, :]).sum(-1)  # [B, nv, nbody]
    return (dots * mask.T).sum(-1)


def passive(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes qfrc_spring, qfrc_damper, qfrc_passive (with fluid drag)."""
    like = data.qpos
    qfrc_spring = like.new_zeros((like.shape[0], plan.nv))

    scalar = np.nonzero((plan.jnt_type == JNT_HINGE) | (plan.jnt_type == JNT_SLIDE))[0]
    if len(scalar):
        jids = static_tensor(plan, ("passive", "jids"), like, lambda: scalar)
        qadr = static_tensor(plan, ("passive", "qadr"), like, lambda: plan.jnt_qposadr[scalar])
        dadr = static_tensor(plan, ("passive", "dadr"), like, lambda: plan.jnt_dofadr[scalar])
        frc = -take(model, "jnt_stiffness", jids) * (data.qpos[:, qadr] - take(model, "qpos_spring", qadr))
        qfrc_spring[:, dadr] = frc  # in place on the fresh zeros above

    # a free or ball joint's stiffness, [B, 1] per env against [B, 3]
    stiff_per_env = is_per_env(model, "jnt_stiffness")
    spring = model.qpos_spring
    for j in np.nonzero(plan.jnt_type == JNT_FREE)[0]:
        stiff = env_lined(take(model, "jnt_stiffness", j), stiff_per_env, 2)
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        dif = data.qpos[:, qadr : qadr + 3] - spring[..., qadr : qadr + 3]
        qfrc_spring[:, dadr : dadr + 3] = -stiff * dif
        rot = quat.subtract(
            data.qpos[:, qadr + 3 : qadr + 7], spring[..., qadr + 3 : qadr + 7]
        )
        qfrc_spring[:, dadr + 3 : dadr + 6] = -stiff * rot

    for j in np.nonzero(plan.jnt_type == JNT_BALL)[0]:
        stiff = env_lined(take(model, "jnt_stiffness", j), stiff_per_env, 2)
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        rot = quat.subtract(data.qpos[:, qadr : qadr + 4], spring[..., qadr : qadr + 4])
        qfrc_spring[:, dadr : dadr + 3] = -stiff * rot

    qfrc_damper = -model.dof_damping * data.qvel

    if plan.tendon_passive_active:
        length = mat_vec(model, "tendon_length_mat", data.qpos) + model.tendon_length0_const
        lo = model.tendon_lengthspring[..., 0]
        hi = model.tendon_lengthspring[..., 1]
        zero = torch.zeros_like(length)
        disp = torch.where(length > hi, hi - length, torch.where(length < lo, lo - length, zero))
        qfrc_spring = qfrc_spring + vec_mat(model.tendon_stiffness * disp, model, "tendon_moment")
        ten_vel = mat_vec(model, "tendon_moment", data.qvel)
        qfrc_damper = qfrc_damper - vec_mat(model.tendon_damping * ten_vel, model, "tendon_moment")

    qfrc_passive = qfrc_spring + qfrc_damper
    if plan.fluid_active:
        qfrc_passive = qfrc_passive + fluid(plan, model, data)
    return data.replace(
        qfrc_spring=qfrc_spring,
        qfrc_damper=qfrc_damper,
        qfrc_passive=qfrc_passive,
    )

