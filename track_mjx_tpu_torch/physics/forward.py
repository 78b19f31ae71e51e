"""Forward dynamics pipeline and the integrators (mj_forward / mj_step
parity): semi-implicit Euler, RK4, implicit and implicitfast.

Port of track_mjx_tpu/physics/forward.py. Every function takes a batch of
envs, [B, ...]; `step` dispatches on the plan's integrator, and `n_step` is
a Python loop of `step` over substeps that carries only the dynamic state
(`_CARRY_FIELDS`) from one substep to the next, as the JAX scan does.

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
    INT_IMPLICIT,
    INT_IMPLICITFAST,
    INT_RK4,
    JNT_BALL,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    Data,
    Model,
    PhysicsPlan,
    env_lined,
    env_view,
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
    """mj_integratePos: joint-type-aware position integration, [B, nq];
    dt is the model's timestep, 0-d, or [B] per env."""
    out = qpos.clone()
    dt_col = env_lined(dt, dt.dim() > 0, 2)  # against [B, k]
    scalar = np.nonzero((plan.jnt_type == JNT_HINGE) | (plan.jnt_type == JNT_SLIDE))[0]
    if len(scalar):
        qadr = static_tensor(plan, ("int", "qadr"), qpos, lambda: plan.jnt_qposadr[scalar])
        dadr = static_tensor(plan, ("int", "dadr"), qpos, lambda: plan.jnt_dofadr[scalar])
        out[:, qadr] = qpos[:, qadr] + dt_col * qvel[:, dadr]  # in place on the clone
    for j in np.nonzero(plan.jnt_type == JNT_FREE)[0]:
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        out[:, qadr : qadr + 3] = qpos[:, qadr : qadr + 3] + dt_col * qvel[:, dadr : dadr + 3]
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
    """act after a step of dt ([B, 1] where the timestep is per env)."""
    if plan.na == 0:
        return data.act
    act = data.act + dt * data.act_dot
    exact = static_tensor(
        plan, ("int", "exact"), data.act, lambda: plan.actuator_dyntype == DYN_FILTEREXACT
    ).bool()
    tau = torch.clamp(model.actuator_dynprm[..., 0], min=1e-10)
    ctrl = data.ctrl
    act_exact = ctrl + (data.act - ctrl) * torch.exp(-dt / tau)
    return _clip_act(model, torch.where(exact, act_exact, act))


def _clip_act(model: Model, act: torch.Tensor) -> torch.Tensor:
    lo, hi = model.actuator_actrange[..., 0], model.actuator_actrange[..., 1]
    return torch.where(model.actuator_actlimited > 0, torch.minimum(torch.maximum(act, lo), hi), act)


def euler(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Semi-implicit Euler with implicit joint damping (mj_Euler parity):
    qvel += h (M + h diag(damping))^-1 (qfrc_smooth + qfrc_constraint), the
    raw force as MuJoCo C takes it. Fused CG plans solved it inside their
    solve (data.qacc_eff); the others solve it here with the solve_spd
    kernel, which data does not keep, as in the reference."""
    if plan.integrator != INT_EULER:
        raise NotImplementedError(
            f"integrator {plan.integrator} not supported by euler(): use "
            "step(), which dispatches Euler/RK4/implicit/implicitfast"
        )
    dt = model.opt_timestep  # 0-d, or [B] per env
    dt_col = env_view(model, "opt_timestep", 2)  # against [B, nv]
    if _solver.fused_euler(plan):
        qacc_eff = data.qacc_eff
    else:
        mh = data.qM + torch.diag_embed((dt_col * model.dof_damping).expand_as(data.qvel))
        qacc_eff = batched_linalg.solve_spd(mh, data.qfrc_smooth + data.qfrc_constraint)
    act = _advance_act(plan, model, data, dt_col)
    qvel = data.qvel + dt_col * qacc_eff
    qpos = _integrate_pos(plan, data.qpos, qvel, dt)
    return data.replace(
        qpos=qpos, qvel=qvel, act=act, time=data.time + dt, qacc_warmstart=data.qacc
    )


# classic RK4 Butcher tableau (mj_RungeKutta with N = 4)
_RK4_A = ((0.5, 0.0, 0.0), (0.0, 0.5, 0.0), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)
_RK4_C = (0.5, 0.5, 1.0)


def rk4(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """4th-order Runge-Kutta (mj_RungeKutta(m, d, 4) parity) from a
    post-`forward` `data`, whose derivatives are stage 0's; three more
    forwards give the others. Positions integrate on the quaternion manifold
    (`_integrate_pos`). The stage solves warm-start from the step-initial
    qacc, as mj_step copies it to qacc_warmstart before them; the returned
    data keeps the first forward's derived stages."""
    dt = model.opt_timestep  # 0-d, or [B] per env
    dt_col = env_view(model, "opt_timestep", 2)  # against [B, n]
    time0, qpos0, qvel0, act0 = data.time, data.qpos, data.qvel, data.act
    has_act = plan.na > 0
    d = data.replace(qacc_warmstart=data.qacc)
    derivs = [(d.qvel, d.qacc, d.act_dot)]
    for i in range(1, 4):
        a = _RK4_A[i - 1]
        dqvel = sum(a[j] * derivs[j][0] for j in range(i) if a[j])
        dqacc = sum(a[j] * derivs[j][1] for j in range(i) if a[j])
        d = d.replace(
            time=time0 + _RK4_C[i - 1] * dt,
            qpos=_integrate_pos(plan, qpos0, dqvel, dt),
            qvel=qvel0 + dt_col * dqacc,
        )
        if has_act:
            dact = sum(a[j] * derivs[j][2] for j in range(i) if a[j])
            d = d.replace(act=act0 + dt_col * dact)
        d = forward(plan, model, d)
        derivs.append((d.qvel, d.qacc, d.act_dot))
    dqvel = sum(b * f[0] for b, f in zip(_RK4_B, derivs))
    dqacc = sum(b * f[1] for b, f in zip(_RK4_B, derivs))
    act = act0
    if has_act:
        act = _clip_act(model, act0 + dt_col * sum(b * f[2] for b, f in zip(_RK4_B, derivs)))
    return data.replace(
        time=time0 + dt,
        qpos=_integrate_pos(plan, qpos0, dqvel, dt),
        qvel=qvel0 + dt_col * dqacc,
        act=act,
        qacc_warmstart=data.qacc,
    )


def ancestor_pair_mask(plan: PhysicsPlan) -> np.ndarray:
    """(nv, nv) 0/1 mask of dof pairs on one kinematic chain: the mass
    matrix's sparsity pattern."""
    mask = np.eye(plan.nv)
    for j in range(plan.nv):
        i = int(plan.dof_parentid[j])
        while i >= 0:
            mask[i, j] = mask[j, i] = 1.0
            i = int(plan.dof_parentid[i])
    return mask


def qderiv(plan: PhysicsPlan, model: Model, data: Data, include_rne: bool) -> torch.Tensor:
    """d(qfrc_passive + qfrc_actuator [- qfrc_bias]) / d qvel [B, nv, nv] at
    fixed pose: C's mjd_smooth_vel, here exact forward-mode derivatives
    (torch.func.jvp) through the velocity stages the forward pass runs
    (com_vel, passive with fluid drag, actuation, rne), one column per basis
    tangent, all nv columns at once under torch.func.vmap. Envs are
    independent, so a tangent e_k given to every env yields every env's
    column k. C keeps qDeriv in the mass matrix's ancestor-pair sparsity and
    so drops entries that couple dofs on different branches (possible only
    through tendon damping or multi-joint transmissions); the result is
    masked to the same pattern (`ancestor_pair_mask`)."""

    def smooth_force(qvel):
        d = data.replace(qvel=qvel)
        d = _com.com_vel(plan, model, d)
        d = _passive.passive(plan, model, d)
        d = _actuation.actuation(plan, model, d)
        out = d.qfrc_passive + d.qfrc_actuator
        if include_rne:
            out = out - _rne.rne(plan, model, d).qfrc_bias
        return out

    def column(tangent):
        return torch.func.jvp(smooth_force, (data.qvel,), (tangent,))[1]

    qvel = data.qvel
    basis = torch.eye(plan.nv, dtype=qvel.dtype, device=qvel.device)[:, None, :].expand(-1, qvel.shape[0], -1)
    cols = torch.func.vmap(column)(basis)  # [nv (column k), B, nv (row i)]
    mask = static_tensor(plan, ("int", "anc_pairs"), qvel, lambda: ancestor_pair_mask(plan))
    return cols.permute(1, 2, 0) * mask


def implicit(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Implicit-in-velocity integration (mj_implicit parity) from a
    post-`forward` `data`. implicitfast: qDeriv without the RNE term,
    symmetrized, and M - h qDeriv solved by the solve_spd kernel;
    implicit: the full qDeriv and torch.linalg.solve, as the reference
    leaves that general solve to its library. Both then advance as Euler
    does (act, qvel from the raw qfrc_smooth + qfrc_constraint, manifold
    positions); joint damping enters through qDeriv."""
    dt = model.opt_timestep  # 0-d, or [B] per env
    dt_col, dt_mat = env_view(model, "opt_timestep", 2), env_view(model, "opt_timestep", 3)
    fast = plan.integrator == INT_IMPLICITFAST
    qd = qderiv(plan, model, data, include_rne=not fast)
    rhs = data.qfrc_smooth + data.qfrc_constraint
    if fast:
        qd = 0.5 * (qd + qd.transpose(-1, -2))
        qacc_eff = batched_linalg.solve_spd((data.qM - dt_mat * qd).contiguous(), rhs.contiguous())
    else:
        qacc_eff = torch.linalg.solve(data.qM - dt_mat * qd, rhs)
    act = _advance_act(plan, model, data, dt_col)
    qvel = data.qvel + dt_col * qacc_eff
    qpos = _integrate_pos(plan, data.qpos, qvel, dt)
    return data.replace(
        qpos=qpos, qvel=qvel, act=act, time=data.time + dt, qacc_warmstart=data.qacc
    )


def step(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """One physics step: forward dynamics and the plan's integrator (Euler,
    RK4, implicit or implicitfast)."""
    data = forward(plan, model, data)
    if plan.integrator == INT_RK4:
        return rk4(plan, model, data)
    if plan.integrator in (INT_IMPLICIT, INT_IMPLICITFAST):
        return implicit(plan, model, data)
    return euler(plan, model, data)


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
