"""Tendon lengths and actuation (mj_tendon + mj_fwdActuation parity).

Port of track_mjx_tpu/physics/actuation.py. Transmissions are scalar joints
and fixed tendons, so actuator length, velocity and torque are constant
matrices applied to the batch (each env's own where they are per env).
"""

from __future__ import annotations

import torch

from track_mjx_tpu_torch.physics.model import (
    BIAS_AFFINE,
    DYN_FILTER,
    DYN_FILTEREXACT,
    DYN_INTEGRATOR,
    DYN_NONE,
    GAIN_AFFINE,
    Data,
    Model,
    PhysicsPlan,
    mat_vec,
    static_tensor,
    vec_mat,
)


def tendon(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Fixed-tendon lengths and velocities (constant jacobian)."""
    if plan.ntendon == 0:
        return data
    ten_length = mat_vec(model, "tendon_length_mat", data.qpos) + model.tendon_length0_const
    ten_velocity = mat_vec(model, "tendon_moment", data.qvel)
    return data.replace(ten_length=ten_length, ten_velocity=ten_velocity)


def _flag(plan, name, like, values):
    return static_tensor(plan, ("act", name), like, lambda: values).bool()


def _act_dot(plan: PhysicsPlan, model: Model, ctrl: torch.Tensor, act: torch.Tensor):
    """Activation dynamics act_dot per actuator (na == nu layouts only)."""
    if plan.na == 0:
        return ctrl.new_zeros((ctrl.shape[0], 0))
    dyntype = plan.actuator_dyntype
    tau = torch.clamp(model.actuator_dynprm[..., 0], min=1e-10)
    filt = (ctrl - act) / tau
    out = torch.zeros_like(act)
    is_filter = _flag(plan, "filter", act, (dyntype == DYN_FILTER) | (dyntype == DYN_FILTEREXACT))
    out = torch.where(is_filter, filt, out)
    out = torch.where(_flag(plan, "integrator", act, dyntype == DYN_INTEGRATOR), ctrl, out)
    return out


def _clip_where(x, limited, lo, hi):
    return torch.where(limited, torch.minimum(torch.maximum(x, lo), hi), x)


def actuation(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes actuator force and qfrc_actuator from ctrl/act."""
    if plan.nu == 0:
        return data
    ctrl = _clip_where(
        data.ctrl,
        model.actuator_ctrllimited > 0,
        model.actuator_ctrlrange[..., 0],
        model.actuator_ctrlrange[..., 1],
    )
    length = mat_vec(model, "actuator_len_mat", data.qpos) + model.actuator_len_const
    velocity = mat_vec(model, "actuator_moment", data.qvel)
    act_dot = _act_dot(plan, model, ctrl, data.act)

    if plan.na:
        stateful = _flag(plan, "stateful", ctrl, plan.actuator_dyntype != DYN_NONE)
        inp = torch.where(stateful, data.act, ctrl)
    else:
        inp = ctrl

    gp = model.actuator_gainprm
    gain_affine = gp[..., 0] + gp[..., 1] * length + gp[..., 2] * velocity
    is_affine = _flag(plan, "gain_affine", ctrl, plan.actuator_gaintype == GAIN_AFFINE)
    gain = torch.where(is_affine, gain_affine, gp[..., 0])

    bp = model.actuator_biasprm
    bias_affine = bp[..., 0] + bp[..., 1] * length + bp[..., 2] * velocity
    is_bias = _flag(plan, "bias_affine", ctrl, plan.actuator_biastype == BIAS_AFFINE)
    bias = torch.where(is_bias, bias_affine, torch.zeros_like(bias_affine))

    force = _clip_where(
        gain * inp + bias,
        model.actuator_forcelimited > 0,
        model.actuator_forcerange[..., 0],
        model.actuator_forcerange[..., 1],
    )
    qfrc_actuator = vec_mat(force, model, "actuator_moment")
    return data.replace(
        actuator_length=length,
        actuator_velocity=velocity,
        actuator_force=force,
        act_dot=act_dot if plan.na else data.act_dot,
        qfrc_actuator=qfrc_actuator,
    )
