"""Passive forces: joint springs and dof dampers (mj_passive).

Port of track_mjx_tpu/physics/passive.py without the fluid model: the rodent
sets no density, viscosity or wind, and a plan with fluid forces raises
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import quaternion as quat
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


def passive(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes qfrc_spring, qfrc_damper, qfrc_passive."""
    if plan.fluid_active:
        raise NotImplementedError("inertia-box fluid forces are not ported")
    like = data.qpos
    qfrc_spring = like.new_zeros((like.shape[0], plan.nv))

    scalar = np.nonzero((plan.jnt_type == JNT_HINGE) | (plan.jnt_type == JNT_SLIDE))[0]
    if len(scalar):
        jids = static_tensor(plan, ("passive", "jids"), like, lambda: scalar)
        qadr = static_tensor(plan, ("passive", "qadr"), like, lambda: plan.jnt_qposadr[scalar])
        dadr = static_tensor(plan, ("passive", "dadr"), like, lambda: plan.jnt_dofadr[scalar])
        frc = -model.jnt_stiffness[jids] * (data.qpos[:, qadr] - model.qpos_spring[qadr])
        qfrc_spring[:, dadr] = frc  # in place on the fresh zeros above

    for j in np.nonzero(plan.jnt_type == JNT_FREE)[0]:
        stiff = model.jnt_stiffness[j]
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        dif = data.qpos[:, qadr : qadr + 3] - model.qpos_spring[qadr : qadr + 3]
        qfrc_spring[:, dadr : dadr + 3] = -stiff * dif
        rot = quat.subtract(
            data.qpos[:, qadr + 3 : qadr + 7], model.qpos_spring[qadr + 3 : qadr + 7]
        )
        qfrc_spring[:, dadr + 3 : dadr + 6] = -stiff * rot

    for j in np.nonzero(plan.jnt_type == JNT_BALL)[0]:
        stiff = model.jnt_stiffness[j]
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        rot = quat.subtract(data.qpos[:, qadr : qadr + 4], model.qpos_spring[qadr : qadr + 4])
        qfrc_spring[:, dadr : dadr + 3] = -stiff * rot

    qfrc_damper = -model.dof_damping * data.qvel

    if plan.tendon_passive_active:
        length = data.qpos @ model.tendon_length_mat.T + model.tendon_length0_const
        lo = model.tendon_lengthspring[:, 0]
        hi = model.tendon_lengthspring[:, 1]
        zero = torch.zeros_like(length)
        disp = torch.where(length > hi, hi - length, torch.where(length < lo, lo - length, zero))
        qfrc_spring = qfrc_spring + (model.tendon_stiffness * disp) @ model.tendon_moment
        ten_vel = data.qvel @ model.tendon_moment.T
        qfrc_damper = qfrc_damper - (model.tendon_damping * ten_vel) @ model.tendon_moment

    return data.replace(
        qfrc_spring=qfrc_spring,
        qfrc_damper=qfrc_damper,
        qfrc_passive=qfrc_spring + qfrc_damper,
    )

