"""Forward dynamics pipeline and Euler step (mj_forward / mj_step parity).

Port of track_mjx_tpu/physics/forward.py. Every function takes a batch of
envs, [B, ...]; `n_step` is a Python loop over substeps that carries only
the dynamic state (`_CARRY_FIELDS`) from one substep to the next, as the JAX
scan does.

Physics runs in full f32. cond(M) is about 6e5 for the rodent, so TF32
matmuls (about 1e-3 relative error) would corrupt the mass-matrix and
constraint solves: `set_full_f32()` turns TF32 off and `forward` raises if it
is on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from track_mjx_tpu_torch.ops import batched_linalg
from track_mjx_tpu_torch.ops import quaternion as quat
from track_mjx_tpu_torch.physics import actuation as _actuation
from track_mjx_tpu_torch.physics import collision as _collision
from track_mjx_tpu_torch.physics import com as _com
from track_mjx_tpu_torch.physics import constraint as _constraint
from track_mjx_tpu_torch.physics import inertia as _inertia
from track_mjx_tpu_torch.physics import kinematics as _kinematics
from track_mjx_tpu_torch.physics import passive as _passive
from track_mjx_tpu_torch.physics import rne as _rne
from track_mjx_tpu_torch.physics import sensors as _sensors
from track_mjx_tpu_torch.physics import solver as _solver
from track_mjx_tpu_torch.physics.model import (
    DYN_FILTEREXACT,
    INT_EULER,
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    Data,
    Model,
    PhysicsPlan,
    make_data,
    static_tensor,
)


def set_full_f32() -> None:
    """Turns TF32 off for matmuls and cuDNN and sets float32 matmul precision
    to "highest" (process-wide torch settings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_full_f32() -> None:
    """Raises unless the physics runs in full f32 (see `set_full_f32`)."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "physics needs full f32: call track_mjx_tpu_torch.physics.forward."
            "set_full_f32() (TF32 off, matmul precision 'highest')"
        )


def fwd_position(plan: PhysicsPlan, model: Model, data: Data):
    data = _kinematics.kinematics(plan, model, data)
    data = _com.com_pos(plan, model, data)
    data = _actuation.tendon(plan, model, data)
    data = _inertia.crb(plan, model, data)
    if not _solver.fused_cg(plan):
        # fused CG plans never materialize qLD: their solve factors qM itself
        data = _inertia.factor_m(plan, model, data)
    data, contact = _collision.collide(plan, model, data)
    efc = _constraint.make_constraint(plan, model, data, contact)
    return data, efc


def fwd_velocity(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    data = _com.com_vel(plan, model, data)
    data = _passive.passive(plan, model, data)
    return _rne.rne(plan, model, data)


def fwd_actuation(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    return _actuation.actuation(plan, model, data)


def fwd_acceleration(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    qfrc_smooth = data.qfrc_passive - data.qfrc_bias + data.qfrc_actuator
    if _solver.fused_cg(plan):
        # qacc_smooth comes from the fused solve in solve()
        return data.replace(qfrc_smooth=qfrc_smooth)
    return data.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=_inertia.solve_m(data, qfrc_smooth))


def forward(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Full forward dynamics: qpos/qvel/ctrl/act -> qacc and all stages."""
    check_full_f32()
    data, efc = fwd_position(plan, model, data)
    data = fwd_velocity(plan, model, data)
    data = fwd_actuation(plan, model, data)
    data = fwd_acceleration(plan, model, data)
    data = _solver.solve(plan, model, data, efc)
    return _sensors.sensor(plan, model, data)


def _integrate_pos(plan: PhysicsPlan, qpos: torch.Tensor, qvel: torch.Tensor, dt):
    """mj_integratePos: joint-type-aware position integration, [B, nq]."""
    out = qpos.clone()
    scalar = np.nonzero((plan.jnt_type == JNT_HINGE) | (plan.jnt_type == JNT_SLIDE))[0]
    if len(scalar):
        qadr = static_tensor(plan, ("int", "qadr"), qpos, lambda: plan.jnt_qposadr[scalar])
        dadr = static_tensor(plan, ("int", "dadr"), qpos, lambda: plan.jnt_dofadr[scalar])
        out[:, qadr] = qpos[:, qadr] + dt * qvel[:, dadr]  # in place on the clone
    for j in np.nonzero(plan.jnt_type == JNT_FREE)[0]:
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        out[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt * qvel[:, dadr : dadr + 3]
        out[:, qadr + 3 : qadr + 7] = quat.integrate(
            qpos[:, qadr + 3 : qadr + 7], qvel[:, dadr + 3 : dadr + 6], dt
        )
    for j in np.nonzero(plan.jnt_type == JNT_BALL)[0]:
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        out[:, qadr : qadr + 4] = quat.integrate(
            qpos[:, qadr : qadr + 4], qvel[:, dadr : dadr + 3], dt
        )
    return out


def _advance_act(plan: PhysicsPlan, model: Model, data: Data, dt) -> torch.Tensor:
    if plan.na == 0:
        return data.act
    act = data.act + dt * data.act_dot
    exact = static_tensor(
        plan, ("int", "exact"), data.act, lambda: plan.actuator_dyntype == DYN_FILTEREXACT
    ).bool()
    tau = torch.clamp(model.actuator_dynprm[:, 0], min=1e-10)
    ctrl = data.ctrl
    act_exact = ctrl + (data.act - ctrl) * torch.exp(-dt / tau)
    act = torch.where(exact, act_exact, act)
    lo, hi = model.actuator_actrange[:, 0], model.actuator_actrange[:, 1]
    return torch.where(
        model.actuator_actlimited > 0, torch.minimum(torch.maximum(act, lo), hi), act
    )


def euler(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Semi-implicit Euler with implicit joint damping (mj_Euler parity):
    qvel += h (M + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint), the
    raw force as MuJoCo C takes it. Fused CG plans solved it inside their
    solve (data.qacc_eff); the others solve it here with the solve_spd
    kernel, which data does not keep, as in the reference."""
    if plan.integrator != INT_EULER:
        raise NotImplementedError(f"integrator {plan.integrator}: only Euler is ported")
    dt = model.opt_timestep
    if _solver.fused_euler(plan):
        qacc_eff = data.qacc_eff
    else:
        mh = data.qM + torch.diag_embed((dt * model.dof_damping).expand_as(data.qvel))
        qacc_eff = batched_linalg.solve_spd(mh, data.qfrc_smooth + data.qfrc_constraint)
    act = _advance_act(plan, model, data, dt)
    qvel = data.qvel + dt * qacc_eff
    qpos = _integrate_pos(plan, data.qpos, qvel, dt)
    return data.replace(
        qpos=qpos, qvel=qvel, act=act, time=data.time + dt, qacc_warmstart=data.qacc
    )


def step(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """One physics step: forward dynamics + Euler integration."""
    return euler(plan, model, forward(plan, model, data))


# the dynamic state that survives between physics substeps; everything else
# in Data is recomputed by forward()
_CARRY_FIELDS = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart")


@dataclasses.dataclass(frozen=True)
class SlimData:
    """The minimal dynamic state between control steps, [B, ...]."""

    time: torch.Tensor
    qpos: torch.Tensor
    qvel: torch.Tensor
    act: torch.Tensor
    ctrl: torch.Tensor
    qacc_warmstart: torch.Tensor


def slim_data(data) -> SlimData:
    """Full Data (or SlimData) -> SlimData."""
    return SlimData(**{f: getattr(data, f) for f in _CARRY_FIELDS})


def expand_slim(plan: PhysicsPlan, model: Model, slim: SlimData) -> Data:
    """SlimData -> full Data (derived fields zeroed; forward() repopulates
    them)."""
    base = make_data(plan, model, slim.qpos.shape[0])
    return base.replace(**{f: getattr(slim, f) for f in _CARRY_FIELDS})


def n_step(plan: PhysicsPlan, model: Model, data: Data, n: int) -> Data:
    """n physics substeps (pipeline_step's inner loop). Each substep starts
    from a zeroed template carrying only `_CARRY_FIELDS`, as the JAX scan
    does; the returned Data has every derived stage of the last forward()
    populated."""
    if n <= 1:
        return step(plan, model, data)
    template = make_data(plan, model, data.qpos.shape[0])
    for _ in range(n):
        data = step(plan, model, template.replace(**{f: getattr(data, f) for f in _CARRY_FIELDS}))
    return data
