"""Constraint solve: the fused CG solves, the bounded CG and Newton.

Port of track_mjx_tpu/physics/solver.py:

- Fused CG plans (CG solver, unilateral rows only: limits and pyramidal
  contacts, or limits and elliptic cone blocks) solve through one call of a
  fused smooth + CG op, which factors qM, solves qacc_smooth and, on Euler
  plans (`fused_euler`), the integrator's implicit-damping solve too:
  ops/cg_solver_kernel.cg_solve on the compact pyramidal layout (the
  rodent), cg_solve_dense on a dense J (condim-1, -4 or -6 contacts),
  ell_cg_solve on the elliptic layout (the fly) and ell_cg_solve_dense on a
  dense elliptic J (condim-1 contacts beside the cone blocks).
  `fused_scalar_cg`, `fused_elliptic_cg`, `fused_cg`, `fused_euler`,
  `_jb_static`.
- CG plans with equality or frictionloss rows run in plain torch over the
  dense J, every (L L^T)^-1 apply the cho_solve kernel on forward's factor
  of qM (data.qLD): the bounded scalar CG (`cg_solver_kernel.scalar_cg`
  with the rows' force bounds), or, beside elliptic cone blocks, the general
  elliptic CG (`cg_solver_kernel.elliptic_cg`).
- Newton plans run `_newton`, batch-first: forward has factored qM and
  solved qacc_smooth (inertia.factor_m/solve_m), each iteration's Hessian
  solve is the solve_spd kernel, and the linesearch is the plain Newton
  search of the scalar rows (`_linesearch`), bounded where the plan has
  equality or frictionloss rows.

`solve` dispatches as the reference does: PGS and Newton with elliptic
cones raise NotImplementedError with the reference's messages, and a plan
with no constraint rows takes qacc = qacc_smooth.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.plain.ops import batched_linalg, cg_solver_kernel
from benchmark.reference.plain.physics import inertia
from benchmark.reference.plain.physics.constraint import EfcData, contact_diff_mask
from benchmark.reference.plain.physics.model import (
    INT_EULER,
    SOLVER_CG,
    SOLVER_NEWTON,
    Data,
    Model,
    PhysicsPlan,
    env_view,
    plan_cache,
    static_tensor,
)

_EPS = 1e-12


def fused_scalar_cg(plan: PhysicsPlan) -> bool:
    """True when the model solves through the fused smooth + CG op: CG
    solver, unilateral scalar rows only (limits, pyramidal contacts of any
    condim; cg_solve on the compact layout, cg_solve_dense off it)."""
    return bool(
        plan.nefc > 0
        and plan.solver == SOLVER_CG
        and plan.ncon_ell == 0
        and not (plan.ne or plan.nf)
    )


def fused_elliptic_cg(plan: PhysicsPlan) -> bool:
    """True when the model solves through the fused elliptic smooth + CG op:
    CG solver, unilateral scalar rows plus elliptic cone blocks, no equality
    or frictionloss rows."""
    return bool(
        plan.nefc > 0
        and plan.solver == SOLVER_CG
        and plan.ncon_ell > 0
        and not (plan.ne or plan.nf)
    )


def fused_cg(plan: PhysicsPlan) -> bool:
    """Any fused CG plan, scalar or elliptic: the op factors qM and solves
    qacc_smooth itself."""
    return fused_scalar_cg(plan) or fused_elliptic_cg(plan)


def fused_euler(plan: PhysicsPlan) -> bool:
    """True when the fused op also performs the Euler integrator's
    implicit-damping solve, exported as data.qacc_eff (both variants)."""
    return fused_cg(plan) and plan.integrator == INT_EULER


def _jb_static(plan: PhysicsPlan):
    """Host tables for the J build: dm (ncon, nv), the per-contact dof
    difference mask body2 - body1; lim1h (nlimit, nv), one-hot limit rows at
    each limited joint's dof."""
    def build():
        jids = plan.limited_jnt_ids
        lim1h = np.zeros((plan.nlimit, plan.nv))
        if len(jids):
            lim1h[np.arange(len(jids)), plan.jnt_dofadr[jids]] = 1.0
        return contact_diff_mask(plan), lim1h

    return plan_cache(plan, "jb_static", build)


def _common_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData, compact: bool = True) -> dict:
    """The operands every fused solve takes, and the compact layout's J
    operands except the friction `mu` where `compact`. The armature is (nv,)
    or, per env, [B, nv]; hd and tolscale are per env either way."""
    like = data.qpos
    bsz, nv = like.shape[0], plan.nv
    arm = model.dof_armature.contiguous()
    # convergence threshold tol * trace(M), trace from the CRB factors
    scale = torch.clamp((data.crb_buf * data.cdof).sum((-2, -1)) + arm.sum(-1), min=_EPS)
    out = dict(
        buf=data.crb_buf.contiguous(),
        cdof=data.cdof.contiguous(),
        aref=efc.aref.contiguous(),
        D=efc.D.contiguous(),
        qfrc_smooth=data.qfrc_smooth.contiguous(),
        warm=data.qacc_warmstart.contiguous(),
        hd=(env_view(model, "opt_timestep", 2) * model.dof_damping).expand(bsz, nv).contiguous(),
        tolscale=(model.opt_tolerance * scale).contiguous(),
        anc=static_tensor(plan, ("solver", "anc"), like, lambda: plan.ancestry_mask),
        arm=arm,
    )
    if compact:
        out.update(
            fq=efc.jb_fq.contiguous(),
            sw=efc.jb_sw.contiguous(),
            ll=efc.jb_ll.contiguous(),
            dm=static_tensor(plan, ("solver", "dm"), like, lambda: _jb_static(plan)[0]),
            lim1h=static_tensor(plan, ("solver", "lim1h"), like, lambda: _jb_static(plan)[1]),
        )
    return out


def solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.cg_solve for this batch."""
    if not fused_scalar_cg(plan) or efc.jb_fq is None:
        raise NotImplementedError(
            "the fused scalar-CG solve takes CG plans with limit and condim-3 "
            "pyramidal contact rows only"
        )
    bsz = data.qpos.shape[0]
    return dict(_common_inputs(plan, model, data, efc), mu=efc.jb_mu.expand(bsz, -1, -1).contiguous())


def _mu_t(model: Model, efc: EfcData) -> torch.Tensor:
    """Each cone block's effective friction mu_1 / sqrt(impratio) [nc] (or
    [B, nc])."""
    return efc.ell_mu * torch.rsqrt(torch.clamp(env_view(model, "opt_impratio", 2), min=_EPS))


def ell_solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.ell_cg_solve for this batch:
    as `solve_inputs`, with each cone block's effective friction
    mu_t = mu_1 / sqrt(impratio) as `mu`."""
    if not fused_elliptic_cg(plan) or efc.jb_fq is None:
        raise NotImplementedError(
            "the fused elliptic-CG solve takes CG plans with limit rows and "
            "elliptic cone blocks only"
        )
    bsz = data.qpos.shape[0]
    return dict(_common_inputs(plan, model, data, efc), mu=_mu_t(model, efc).expand(bsz, -1).contiguous())


def ell_dense_solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.ell_cg_solve_dense for this
    batch (elliptic plans with condim-1 contacts, no equality or frictionloss
    rows): the dense J, mu as in `ell_solve_inputs` and the scalar row count
    ns = nefc - 3 ncon_ell."""
    if not fused_elliptic_cg(plan) or efc.J is None:
        raise NotImplementedError(
            "the fused dense-J elliptic-CG solve takes CG plans with unilateral scalar rows and "
            "elliptic cone blocks off the compact layout"
        )
    bsz = data.qpos.shape[0]
    return dict(_common_inputs(plan, model, data, efc, compact=False), J=efc.J.contiguous(),
                mu=_mu_t(model, efc).expand(bsz, -1).contiguous(), ns=plan.nefc - 3 * plan.ncon_ell)


def dense_j(plan: PhysicsPlan, data: Data, efc: EfcData) -> torch.Tensor:
    """Dense J [B, nefc, nv] of pyramidal plans in efc row order, built from
    the compact operands as the fused kernel builds it."""
    like = data.qpos
    dm = static_tensor(plan, ("solver", "dm"), like, lambda: _jb_static(plan)[0])
    lim1h = static_tensor(plan, ("solver", "lim1h"), like, lambda: _jb_static(plan)[1])
    return cg_solver_kernel.build_j(efc.jb_fq, efc.jb_sw, efc.jb_ll, efc.jb_mu, dm, lim1h)


def _matv(j: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (j @ x[..., None])[..., 0]


def _force(efc: EfcData, jar: torch.Tensor) -> torch.Tensor:
    """Constraint force -ds/djar [B, nefc] of the scalar rows."""
    return cg_solver_kernel.scalar_zone(jar, efc.D, efc.fmin, efc.fmax)[0]


def _cost_rows(efc: EfcData, jar: torch.Tensor) -> torch.Tensor:
    """Summed cost s(jar) of the scalar rows [B]."""
    return cg_solver_kernel.scalar_cost(jar, efc.D, efc.fmin, efc.fmax).sum(-1)


def _cost_grad(data: Data, efc: EfcData, j: torch.Tensor, x: torch.Tensor):
    """jar = J x - aref, mdx = M (x - qacc_smooth) and the objective's
    gradient mdx - J^T force at x."""
    jar = _matv(j, x) - efc.aref
    mdx = inertia.mul_m(data, x - data.qacc_smooth)
    grad = mdx - _matv(j.transpose(-1, -2), _force(efc, jar))
    return jar, mdx, grad


def _linesearch(data: Data, efc: EfcData, j: torch.Tensor, jar0, mdx, p, ls_iterations: int):
    """cg_solver_kernel.scalar_linesearch along p from `_cost_grad`'s jar0
    and mdx. Returns alpha [B]."""
    pmp = (p * inertia.mul_m(data, p)).sum(-1)
    return cg_solver_kernel.scalar_linesearch(jar0, _matv(j, p), pmp, (p * mdx).sum(-1), efc.D, efc.fmin,
                                              efc.fmax, ls_iterations)


def newton_hessian(qm: torch.Tensor, j: torch.Tensor, d: torch.Tensor, jar: torch.Tensor,
                   fmin=None, fmax=None) -> torch.Tensor:
    """H = qM + J^T diag(D active) J [B, nv, nv], active the rows'
    quadratic zone (`scalar_zone`: jar < 0 for unilateral rows, always for
    equality rows, unclamped frictionloss rows), symmetrized as (H + H^T) /
    2: the matrix that the reference's `jnp.linalg.cholesky` factors (it
    symmetrizes its input), since the product is not exactly symmetric in
    f32 and `solve_spd` reads only the lower triangle."""
    active = cg_solver_kernel.scalar_zone(jar, d, fmin, fmax)[1]
    dj = j * (d * active.to(d.dtype))[..., None]
    h = qm + j.transpose(-1, -2) @ dj
    return (h + h.transpose(-1, -2)) / 2


def newton_start(data: Data, efc: EfcData, j: torch.Tensor) -> torch.Tensor:
    """The cheaper of the warmstart and qacc_smooth by cost, per env."""
    smooth, warm = data.qacc_smooth, data.qacc_warmstart

    def cost(x):
        dx = x - smooth
        return 0.5 * (dx * inertia.mul_m(data, dx)).sum(-1) + _cost_rows(efc, _matv(j, x) - efc.aref)

    return torch.where((cost(warm) < cost(smooth))[:, None], warm, smooth)


def _newton(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """mjSOL_NEWTON over scalar rows (limits, pyramidal contacts, equality
    and frictionloss rows).

    Exact-Hessian Newton on the soft-constraint objective: each iteration
    rebuilds the active set, assembles H = M + J^T diag(D active) J, solves
    p = -H^-1 grad with the solve_spd kernel and runs the linesearch. Like
    the reference's fori_loop it runs all `iterations` for every env: an env
    whose gradient (at the start of an iteration) fell under the tolerance
    freezes from the next iteration on, by masking, not by leaving the
    loop."""
    j = dense_j(plan, data, efc) if efc.J is None else efc.J
    x = newton_start(data, efc, j)
    meaninertia = torch.diagonal(data.qM, dim1=-2, dim2=-1).mean(-1)
    scale = torch.clamp(meaninertia * plan.nv, min=_EPS)
    improved = torch.ones_like(scale, dtype=torch.bool)
    for _ in range(plan.iterations):
        jar, mdx, grad = _cost_grad(data, efc, j, x)
        h = newton_hessian(data.qM, j, efc.D, jar, efc.fmin, efc.fmax)
        p = -batched_linalg.solve_spd(h, grad)
        alpha = _linesearch(data, efc, j, jar, mdx, p, plan.ls_iterations)
        # the update and the new flag are kept only where the env was still
        # improving when the iteration began
        x = torch.where(improved[:, None], x + alpha[:, None] * p, x)
        improved = improved & (torch.sqrt((grad * grad).sum(-1)) / scale > model.opt_tolerance)
    force = _force(efc, _matv(j, x) - efc.aref)
    return data.replace(
        qacc=x,
        qfrc_constraint=_matv(j.transpose(-1, -2), force),
        efc_force=force,
    )


def _bounded_cg(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """CG over box-clamped scalar rows (equality, frictionloss beside limits
    and contacts): the reference's plain `_scalar_cg_single` with bounds,
    over forward's qM and its factor qLD (each apply a cho_solve launch)."""
    meaninertia = torch.diagonal(data.qM, dim1=-2, dim2=-1).mean(-1)
    tolscale = model.opt_tolerance * torch.clamp(meaninertia * plan.nv, min=_EPS)
    x, force, qfrc = cg_solver_kernel.scalar_cg(
        data.qM, lambda b: inertia.solve_m(data, b), efc.J, efc.aref, efc.D, data.qacc_smooth,
        data.qacc_warmstart, tolscale, iterations=plan.iterations, ls_iterations=plan.ls_iterations,
        fmin=efc.fmin, fmax=efc.fmax,
    )
    return data.replace(qacc=x, qfrc_constraint=qfrc, efc_force=force)


def _elliptic_cg(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """The general elliptic CG (elliptic plans with equality or frictionloss
    rows beside the cone blocks): the reference's plain path, over forward's
    qM and its factor qLD (each apply a cho_solve launch)."""
    meaninertia = torch.diagonal(data.qM, dim1=-2, dim2=-1).mean(-1)
    tolscale = model.opt_tolerance * torch.clamp(meaninertia * plan.nv, min=_EPS)
    x, force, qfrc = cg_solver_kernel.elliptic_cg(
        data.qM, lambda b: inertia.solve_m(data, b), efc.J, efc.aref, efc.D, efc.fmin, efc.fmax,
        _mu_t(model, efc), data.qacc_smooth, data.qacc_warmstart, tolscale, ns=plan.nefc - 3 * plan.ncon_ell,
        iterations=plan.iterations, ls_iterations=plan.ls_iterations,
    )
    return data.replace(qacc=x, qfrc_constraint=qfrc, efc_force=force)


def dense_solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.cg_solve_dense for this
    batch (pyramidal plans with a dense J and unilateral rows only)."""
    if not fused_scalar_cg(plan) or efc.J is None:
        raise NotImplementedError(
            "the fused dense-J CG solve takes CG plans with unilateral rows off the compact layout"
        )
    a = _common_inputs(plan, model, data, efc, compact=False)
    return dict(a, J=efc.J.contiguous())


def solve(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """Runs the configured solver and writes qacc, qfrc_constraint and
    efc_force (fused CG plans also qacc_smooth, and qacc_eff on Euler
    plans).

    CG (mjSOL_CG) runs the fused solves, or, where the plan has equality or
    frictionloss rows, the bounded CG (scalar rows only) or the general
    elliptic CG; Newton (mjSOL_NEWTON) is ported for scalar-row models. PGS
    and Newton with an elliptic cone raise. A plan with no constraint rows
    takes qacc = qacc_smooth."""
    if plan.nefc and plan.solver not in (SOLVER_CG, SOLVER_NEWTON):
        raise NotImplementedError(
            f"solver {plan.solver} not supported: CG (mjSOL_CG=1) and "
            "Newton (mjSOL_NEWTON=2) are implemented (the reference "
            "workloads all configure cg: track_mjx/config/*.yaml)"
        )
    if plan.nefc and plan.solver == SOLVER_NEWTON and plan.ncon_ell:
        raise NotImplementedError(
            "newton + elliptic cone not supported: use solver=cg for "
            "elliptic-cone models (the shipped elliptic workload, fly, "
            "configures cg: track_mjx/config/fly-mc-intention.yaml)"
        )
    if plan.nefc == 0:
        return data.replace(qacc=data.qacc_smooth, qfrc_constraint=torch.zeros_like(data.qacc_smooth))
    if plan.solver == SOLVER_NEWTON:
        return _newton(plan, model, data, efc)
    if plan.ne or plan.nf:
        return (_elliptic_cg if plan.ncon_ell else _bounded_cg)(plan, model, data, efc)
    with_euler = fused_euler(plan)
    steps = dict(with_euler=with_euler, iterations=plan.iterations, ls_iterations=plan.ls_iterations)
    if fused_elliptic_cg(plan) and efc.J is None:
        out = cg_solver_kernel.ell_cg_solve(**ell_solve_inputs(plan, model, data, efc), **steps)
    elif fused_elliptic_cg(plan):
        out = cg_solver_kernel.ell_cg_solve_dense(**ell_dense_solve_inputs(plan, model, data, efc), **steps)
    elif efc.J is None:
        out = cg_solver_kernel.cg_solve(**solve_inputs(plan, model, data, efc), **steps)
    else:
        out = cg_solver_kernel.cg_solve_dense(**dense_solve_inputs(plan, model, data, efc), **steps)
    data = data.replace(
        qacc_smooth=out.qacc_smooth,
        qacc=out.qacc,
        qfrc_constraint=out.qfrc_constraint,
        efc_force=out.efc_force,
    )
    if with_euler:
        data = data.replace(qacc_eff=out.qacc_eff)
    return data
