"""Constraint solve: the fused CG branches and the Newton solver.

Port of track_mjx_tpu/physics/solver.py for unilateral limit rows plus
condim-3 contacts (no equality or frictionloss rows):

- CG plans solve through a fused smooth + CG op: `fused_scalar_cg`
  (pyramidal contacts, the rodent), `fused_elliptic_cg` (elliptic cone
  blocks, the fly), `fused_cg`, `fused_euler`, `_jb_static`. The whole
  solve, including the qM factorization, the qacc_smooth solve and the Euler
  implicit-damping solve, is one call of ops/cg_solver_kernel.cg_solve or
  ell_cg_solve.
- Newton plans with pyramidal contacts run `_newton`, batch-first: forward
  has factored qM and solved qacc_smooth (inertia.factor_m/solve_m), each
  iteration's Hessian solve is the solve_spd kernel, and the linesearch is
  the plain Newton search of the scalar rows (`_linesearch`).

`solve` dispatches as the reference does: PGS and Newton with elliptic
cones raise NotImplementedError with the reference's messages, a plan with
no constraint rows takes qacc = qacc_smooth, and plans with equality or
frictionloss rows (the reference's bounded scalar CG) raise too.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import batched_linalg, cg_solver_kernel
from track_mjx_tpu_torch.physics import inertia
from track_mjx_tpu_torch.physics.constraint import EfcData, contact_diff_mask
from track_mjx_tpu_torch.physics.model import (
    INT_EULER,
    SOLVER_CG,
    SOLVER_NEWTON,
    Data,
    Model,
    PhysicsPlan,
    plan_cache,
    static_tensor,
)

_EPS = 1e-12


def fused_scalar_cg(plan: PhysicsPlan) -> bool:
    """True when the model solves through the fused smooth + CG op: CG
    solver, unilateral scalar rows only (limits / pyramidal contacts)."""
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


def _common_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """The operands both fused solves take, except the friction `mu`."""
    like = data.qpos
    bsz, nv = like.shape[0], plan.nv
    arm = model.dof_armature.contiguous()
    # convergence threshold tol * trace(M), trace from the CRB factors
    scale = torch.clamp((data.crb_buf * data.cdof).sum((-2, -1)) + arm.sum(), min=_EPS)
    return dict(
        buf=data.crb_buf.contiguous(),
        cdof=data.cdof.contiguous(),
        fq=efc.jb_fq.contiguous(),
        sw=efc.jb_sw.contiguous(),
        ll=efc.jb_ll.contiguous(),
        aref=efc.aref.contiguous(),
        D=efc.D.contiguous(),
        qfrc_smooth=data.qfrc_smooth.contiguous(),
        warm=data.qacc_warmstart.contiguous(),
        hd=(model.opt_timestep * model.dof_damping).expand(bsz, nv).contiguous(),
        tolscale=(model.opt_tolerance * scale).contiguous(),
        anc=static_tensor(plan, ("solver", "anc"), like, lambda: plan.ancestry_mask),
        arm=arm,
        dm=static_tensor(plan, ("solver", "dm"), like, lambda: _jb_static(plan)[0]),
        lim1h=static_tensor(plan, ("solver", "lim1h"), like, lambda: _jb_static(plan)[1]),
    )


def solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.cg_solve for this batch."""
    if not fused_scalar_cg(plan):
        raise NotImplementedError(
            "the fused scalar-CG solve takes CG plans with limit and pyramidal "
            "contact rows only"
        )
    bsz = data.qpos.shape[0]
    return dict(_common_inputs(plan, model, data, efc), mu=efc.jb_mu.expand(bsz, -1, -1).contiguous())


def ell_solve_inputs(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> dict:
    """Keyword arguments of ops/cg_solver_kernel.ell_cg_solve for this batch:
    as `solve_inputs`, with each cone block's effective friction
    mu_t = mu_1 / sqrt(impratio) as `mu`."""
    if not fused_elliptic_cg(plan):
        raise NotImplementedError(
            "the fused elliptic-CG solve takes CG plans with limit rows and "
            "elliptic cone blocks only"
        )
    bsz = data.qpos.shape[0]
    mu_t = efc.ell_mu * torch.rsqrt(torch.clamp(model.opt_impratio, min=_EPS))
    return dict(_common_inputs(plan, model, data, efc), mu=mu_t.expand(bsz, -1).contiguous())


def dense_j(plan: PhysicsPlan, data: Data, efc: EfcData) -> torch.Tensor:
    """Dense J [B, nefc, nv] of pyramidal plans in efc row order, built from
    the compact operands as the fused kernel builds it."""
    like = data.qpos
    dm = static_tensor(plan, ("solver", "dm"), like, lambda: _jb_static(plan)[0])
    lim1h = static_tensor(plan, ("solver", "lim1h"), like, lambda: _jb_static(plan)[1])
    return cg_solver_kernel.build_j(efc.jb_fq, efc.jb_sw, efc.jb_ll, efc.jb_mu, dm, lim1h)


def _matv(j: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (j @ x[..., None])[..., 0]


def _force(d: torch.Tensor, jar: torch.Tensor) -> torch.Tensor:
    """Constraint force of unilateral scalar rows, -ds/djar [B, nefc]."""
    return torch.where(jar < 0, -d * jar, torch.zeros_like(jar))


def _cost_rows(d: torch.Tensor, jar: torch.Tensor) -> torch.Tensor:
    """Summed cost s(jar) of unilateral scalar rows [B]."""
    return 0.5 * torch.where(jar < 0, d * jar * jar, torch.zeros_like(jar)).sum(-1)


def _cost_grad(data: Data, efc: EfcData, j: torch.Tensor, x: torch.Tensor):
    """jar = J x - aref, mdx = M (x - qacc_smooth) and the objective's
    gradient mdx - J^T force at x."""
    jar = _matv(j, x) - efc.aref
    mdx = inertia.mul_m(data, x - data.qacc_smooth)
    grad = mdx - _matv(j.transpose(-1, -2), _force(efc.D, jar))
    return jar, mdx, grad


def _linesearch(data: Data, efc: EfcData, j: torch.Tensor, jar0, mdx, p, ls_iterations: int):
    """Newton linesearch on phi(alpha) with exact derivatives, scalar rows
    only: phi' is piecewise linear in alpha and plain Newton (no bracket)
    is the reference's scalar-row search. jar0 and mdx are `_cost_grad`'s
    at the search's start. Returns alpha [B]."""
    mp = inertia.mul_m(data, p)
    pmp = (p * mp).sum(-1)
    dmx = (p * mdx).sum(-1)
    jp = _matv(j, p)
    d = efc.D

    def phi_derivs(alpha):
        jar = jar0 + alpha[:, None] * jp
        active = jar < 0
        zero = torch.zeros_like(jar)
        d1 = alpha * pmp + dmx + torch.where(active, d * jar * jp, zero).sum(-1)
        d2 = pmp + torch.where(active, d * jp * jp, zero).sum(-1)
        return d1, torch.clamp(d2, min=_EPS)

    d1, d2 = phi_derivs(torch.zeros_like(pmp))
    alpha = -d1 / d2
    for _ in range(ls_iterations):
        d1, d2 = phi_derivs(alpha)
        alpha = alpha - d1 / d2
    return alpha


def newton_hessian(qm: torch.Tensor, j: torch.Tensor, d: torch.Tensor, jar: torch.Tensor) -> torch.Tensor:
    """H = qM + J^T diag(D active) J with active = jar < 0 [B, nv, nv],
    symmetrized as (H + H^T) / 2: the matrix that the reference's
    `jnp.linalg.cholesky` factors (it symmetrizes its input), since the
    product is not exactly symmetric in f32 and `solve_spd` reads only the
    lower triangle."""
    dj = j * (d * (jar < 0).to(d.dtype))[..., None]
    h = qm + j.transpose(-1, -2) @ dj
    return (h + h.transpose(-1, -2)) / 2


def newton_start(data: Data, efc: EfcData, j: torch.Tensor) -> torch.Tensor:
    """The cheaper of the warmstart and qacc_smooth by cost, per env."""
    smooth, warm = data.qacc_smooth, data.qacc_warmstart

    def cost(x):
        dx = x - smooth
        return 0.5 * (dx * inertia.mul_m(data, dx)).sum(-1) + _cost_rows(efc.D, _matv(j, x) - efc.aref)

    return torch.where((cost(warm) < cost(smooth))[:, None], warm, smooth)


def _newton(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """mjSOL_NEWTON over unilateral scalar rows (limits, pyramidal contacts).

    Exact-Hessian Newton on the soft-constraint objective: each iteration
    rebuilds the active set, assembles H = M + J^T diag(D active) J, solves
    p = -H^-1 grad with the solve_spd kernel and runs the linesearch. Like
    the reference's fori_loop it runs all `iterations` for every env: an env
    whose gradient (at the start of an iteration) fell under the tolerance
    freezes from the next iteration on, by masking, not by leaving the
    loop."""
    j = dense_j(plan, data, efc)
    x = newton_start(data, efc, j)
    meaninertia = torch.diagonal(data.qM, dim1=-2, dim2=-1).mean(-1)
    scale = torch.clamp(meaninertia * plan.nv, min=_EPS)
    improved = torch.ones_like(scale, dtype=torch.bool)
    for _ in range(plan.iterations):
        jar, mdx, grad = _cost_grad(data, efc, j, x)
        p = -batched_linalg.solve_spd(newton_hessian(data.qM, j, efc.D, jar), grad)
        alpha = _linesearch(data, efc, j, jar, mdx, p, plan.ls_iterations)
        # the update and the new flag are kept only where the env was still
        # improving when the iteration began
        x = torch.where(improved[:, None], x + alpha[:, None] * p, x)
        improved = improved & (torch.sqrt((grad * grad).sum(-1)) / scale > model.opt_tolerance)
    force = _force(efc.D, _matv(j, x) - efc.aref)
    return data.replace(
        qacc=x,
        qfrc_constraint=_matv(j.transpose(-1, -2), force),
        efc_force=force,
    )


def solve(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """Runs the configured solver and writes qacc, qfrc_constraint and
    efc_force (CG plans also qacc_smooth, and qacc_eff on Euler plans).

    CG (mjSOL_CG) runs the fused solves; Newton (mjSOL_NEWTON) is ported for
    scalar-row models (limits, pyramidal contacts). PGS, Newton with an
    elliptic cone, and equality or frictionloss rows raise. A plan with no
    constraint rows takes qacc = qacc_smooth."""
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
    if plan.ne or plan.nf:
        raise NotImplementedError(
            "equality and frictionloss rows (the bounded scalar CG) are not ported"
        )
    if plan.solver == SOLVER_NEWTON:
        return _newton(plan, model, data, efc)
    if fused_elliptic_cg(plan):
        op, inputs = cg_solver_kernel.ell_cg_solve, ell_solve_inputs(plan, model, data, efc)
    else:
        op, inputs = cg_solver_kernel.cg_solve, solve_inputs(plan, model, data, efc)
    out = op(**inputs, iterations=plan.iterations, ls_iterations=plan.ls_iterations)
    data = data.replace(
        qacc_smooth=out.qacc_smooth,
        qacc=out.qacc,
        qfrc_constraint=out.qfrc_constraint,
        efc_force=out.efc_force,
    )
    if fused_euler(plan):
        data = data.replace(qacc_eff=out.qacc_eff)
    return data
