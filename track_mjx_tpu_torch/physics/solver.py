"""Constraint solve: the fused CG branches of the JAX solver.

Port of track_mjx_tpu/physics/solver.py for plans that solve through a fused
smooth + CG op (CG solver, unilateral limit rows plus condim-3 contacts, no
equality or frictionloss rows): `fused_scalar_cg` (pyramidal contacts, the
rodent), `fused_elliptic_cg` (elliptic cone blocks, the fly), `fused_cg`,
`fused_euler`, `_jb_static` and those branches of `solve`. The whole solve,
including the qM factorization, the qacc_smooth solve and the Euler
implicit-damping solve, is one call of ops/cg_solver_kernel.cg_solve or
ell_cg_solve. Newton and plans with equality or frictionloss rows raise
NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import cg_solver_kernel
from track_mjx_tpu_torch.physics.constraint import EfcData, contact_diff_mask
from track_mjx_tpu_torch.physics.model import (
    INT_EULER,
    SOLVER_CG,
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


def solve(plan: PhysicsPlan, model: Model, data: Data, efc: EfcData) -> Data:
    """Runs the fused smooth + CG (+ Euler) solve and writes qacc_smooth,
    qacc, qfrc_constraint, efc_force (and qacc_eff on Euler plans)."""
    if fused_elliptic_cg(plan):
        op, inputs = cg_solver_kernel.ell_cg_solve, ell_solve_inputs(plan, model, data, efc)
    elif fused_scalar_cg(plan):
        op, inputs = cg_solver_kernel.cg_solve, solve_inputs(plan, model, data, efc)
    else:
        raise NotImplementedError(
            "only the fused CG solves are ported (CG solver, limit rows and "
            "condim-3 pyramidal or elliptic contacts); Newton and equality or "
            "frictionloss rows are not"
        )
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
