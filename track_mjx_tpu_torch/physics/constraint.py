"""Constraint rows: joint limits and condim-3 contacts, pyramidal or elliptic.

Port of track_mjx_tpu/physics/constraint.py for the two row structures the
fused CG solves take: [joint-limit rows | contact-major pyramid rows (+t1,
-t1, +t2, -t2)] (opt.cone pyramidal, the rodent) and [joint-limit rows |
per-contact (normal, t1, t2) cone blocks] (opt.cone elliptic, the fly). Rows
are emitted as the compact J operands `jb_*` plus per-row aref, D, pos and
activity; the dense J is never built on the step path, because the solve
assembles it itself (ops/cg_solver_kernel.build_j and build_j_ell rebuild it
from the same operands). Impedance/reference math follows MuJoCo's
soft-constraint model (mj_makeImpedance / mj_referenceConstraint); elliptic
friction rows reuse the normal row's impedance, aref_fric = -b jv, and
D_fric_i = D_normal impratio (mu_i / mu_1)^2 (mj_instantiateContact).

A model without contacts takes the first layout with no contact rows: its
limit rows alone, or no rows at all (nefc 0), as the reference solves them.
Equality, frictionloss and condim-1/4/6 rows raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from track_mjx_tpu_torch.ops.quaternion import cross
from track_mjx_tpu_torch.physics.collision import Contact, contact_bodies
from track_mjx_tpu_torch.physics.model import Data, Model, PhysicsPlan, static_tensor


@dataclasses.dataclass(frozen=True)
class EfcData:
    """Constraint rows, batch-first. nefc = nlimit + 4 * ncon (pyramidal) or
    nlimit + 3 * ncon (elliptic).

    J[limit l] = jb_ll[l] * onehot(dofadr_l); the frame-projected contact row
    jfr[c, k, d] = (frame[c,k] . s[d] + (pos x frame)[c,k] . w[d]) *
    diff_mask[c, d] with jb_sw = [s | w], s = cdof_lin - cdof_ang x root_com,
    w = cdof_ang, and jb_fq = [frame | pos x frame] zeroed for inactive
    contacts. Pyramid rows are jfr0 +/- mu_i jfr_{i+1}; an elliptic cone
    block's rows are jfr0, jfr1, jfr2 themselves."""

    aref: torch.Tensor  # [B, nefc]
    D: torch.Tensor  # [B, nefc]
    pos: torch.Tensor  # [B, nefc] constraint violation
    active_row: torch.Tensor  # [B, nefc] bool
    jb_sw: torch.Tensor  # [B, nv, 6]
    jb_fq: torch.Tensor  # [B, ncon, 3, 6] (ncon may be 0)
    jb_ll: torch.Tensor  # [B, nlimit] side * active
    jb_mu: torch.Tensor | None  # [ncon, 2] tangential friction (pyramidal, and models without contacts)
    ell_mu: torch.Tensor | None = None  # [ncon] mu_1 of each cone block (elliptic)


def _jb_supported(plan: PhysicsPlan) -> bool:
    """True when the plan's rows are exactly [joint limits | contact-major
    condim-3 pyramid rows], the layout the fused solve builds J for. A plan
    with no contacts (limit rows only, or no rows at all) is one, as in the
    reference, which solves such rows as scalar rows."""
    return bool(
        plan.ne == 0
        and plan.nf == 0
        and plan.ncon_ell == 0
        and np.all(plan.contact_condim == 3)
    )


def _jb_supported_ell(plan: PhysicsPlan) -> bool:
    """True when the plan's rows are exactly [joint limits | per-contact
    (normal, t1, t2) elliptic cone blocks], every contact condim 3, and
    there is at least one contact."""
    return bool(
        plan.ncon > 0
        and plan.ne == 0
        and plan.nf == 0
        and plan.ncon_ell == plan.ncon
        and np.all(plan.contact_condim == 3)
    )


def _kbi(model: Model, solref, solimp, pos):
    """Stiffness/damping/impedance from solver parameters (mj_makeImpedance)."""
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    dmin = torch.clamp(solimp[..., 0], 0.0001, 0.9999)
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    width = torch.clamp(solimp[..., 2], min=1e-10)
    mid = torch.clamp(solimp[..., 3], 0.0001, 0.9999)
    power = torch.clamp(solimp[..., 4], min=1.0)

    # C floors the time constant at 2*timestep (mj_assignRef)
    tc_eff = torch.maximum(timeconst, 2.0 * model.opt_timestep)
    k_std = 1.0 / torch.clamp(
        dmax * dmax * tc_eff * tc_eff * dampratio * dampratio, min=1e-12
    )
    b_std = 2.0 / torch.clamp(dmax * tc_eff, min=1e-12)
    k = torch.where(timeconst > 0, k_std, -solref[..., 0])
    b = torch.where(dampratio > 0, b_std, -solref[..., 1])

    x = torch.abs(pos) / width
    y_low = (x**power) * (mid ** (1.0 - power))
    y_high = 1.0 - ((1.0 - x) ** power) * ((1.0 - mid) ** (1.0 - power))
    y = torch.where(x < mid, y_low, y_high)
    imp = dmin + y * (dmax - dmin)
    imp = torch.minimum(torch.maximum(imp, dmin), dmax)
    imp = torch.where(x > 1.0, dmax, imp)
    return k, b, imp


def dof_body_mask(plan: PhysicsPlan) -> np.ndarray:
    """mask[b, i] = 1 if dof i is an ancestor dof of body b."""
    mask = np.zeros((plan.nbody, plan.nv), dtype=np.float64)
    for b in range(1, plan.nbody):
        body = b
        while body > 0 and plan.body_dofnum[body] == 0:
            body = int(plan.body_parentid[body])
        if body == 0:
            continue
        i = int(plan.body_dofadr[body]) + int(plan.body_dofnum[body]) - 1
        while i >= 0:
            mask[b, i] = 1.0
            i = int(plan.dof_parentid[i])
    return mask


def contact_diff_mask(plan: PhysicsPlan) -> np.ndarray:
    """(ncon, nv) dof mask of body2 minus that of body1 per contact slot."""
    _, _, body1, body2 = contact_bodies(plan)
    bm = dof_body_mask(plan)
    return bm[body2] - bm[body1]


def make_constraint(
    plan: PhysicsPlan, model: Model, data: Data, contact: Contact
) -> EfcData:
    """Assembles the limit and contact rows (C row order: limits, contacts)."""
    elliptic = _jb_supported_ell(plan)
    if not (elliptic or _jb_supported(plan)):
        raise NotImplementedError(
            "only [joint limits | condim-3 contacts] rows are ported, pyramidal "
            "or elliptic; equality, frictionloss and condim 1/4/6 rows are not"
        )
    like = data.qpos
    bsz = like.shape[0]

    def st(key, build):
        return static_tensor(plan, ("con", key), like, build)

    arefs, ds, poss, acts = [], [], [], []

    jids = plan.limited_jnt_ids
    if len(jids):
        jids_t = st("jids", lambda: jids)
        qadr = st("qadr", lambda: plan.jnt_qposadr[jids])
        dadr = st("dadr", lambda: plan.jnt_dofadr[jids])
        qpos = data.qpos[:, qadr]
        r0, r1 = model.jnt_range[jids_t, 0], model.jnt_range[jids_t, 1]
        dist_min = qpos - r0
        dist_max = r1 - qpos
        dist = torch.minimum(dist_min, dist_max)
        side = torch.where(dist_min < dist_max, 1.0, -1.0).to(like.dtype)
        margin = model.jnt_margin[jids_t]
        active = dist < margin
        pos = dist - margin
        k, b, imp = _kbi(model, model.jnt_solref[jids_t], model.jnt_solimp[jids_t], pos)
        jv = side * data.qvel[:, dadr]
        aref = -b * jv - k * imp * pos
        jb_ll = torch.where(active, side, 0.0)
        invweight = model.dof_invweight0[dadr]
        D = imp / torch.clamp((1.0 - imp) * invweight, min=1e-12)
        arefs.append(torch.where(active, aref, 0.0))
        ds.append(D)
        poss.append(pos)
        acts.append(active)
    else:
        jb_ll = like.new_zeros((bsz, 0))

    diff_mask = st("diff_mask", lambda: contact_diff_mask(plan))  # (ncon, nv)
    _, _, body1_np, body2_np = contact_bodies(plan)
    body1 = st("body1", lambda: body1_np)
    body2 = st("body2", lambda: body2_np)
    rootcom = st("rootcom", lambda: plan.body_rootid[plan.dof_bodyid])

    com = data.subtree_com[:, rootcom]  # [B, nv, 3]
    w, v = data.cdof[..., :3], data.cdof[..., 3:]
    s = v - cross(w, com)
    q = cross(contact.pos[:, :, None, :], contact.frame)  # [B, ncon, 3, 3]

    # jv of the frame rows from per-contact 3-vectors (no dense J):
    # jv[c,k] = frame[c,k] . (dm[c] (s*qvel)) + (p x frame)[c,k] . (dm[c] (w*qvel))
    sqv = s * data.qvel[..., None]
    wqv = w * data.qvel[..., None]
    sv = (diff_mask[None, :, :, None] * sqv[:, None, :, :]).sum(2)  # [B, ncon, 3]
    wv = (diff_mask[None, :, :, None] * wqv[:, None, :, :]).sum(2)
    jv3 = (contact.frame * sv[:, :, None, :]).sum(-1) + (q * wv[:, :, None, :]).sum(-1)

    pos = contact.dist - contact.includemargin
    active = contact.dist < contact.includemargin
    jb_sw = torch.cat([s, w], dim=-1)
    jb_fq = torch.cat([contact.frame, q], dim=-1) * active[..., None, None].to(like.dtype)
    mu = contact.friction[:, :2]

    k, b, imp = _kbi(model, contact.solref, contact.solimp, pos)
    invweight_n = model.body_invweight0[body1, 0] + model.body_invweight0[body2, 0]

    if elliptic:
        # one (normal, t1, t2) block per contact; friction rows have no
        # position term and reuse the normal row's impedance
        jv = torch.where(active[..., None], jv3, 0.0)
        aref = -b[..., None] * jv
        aref = torch.cat([aref[..., :1] - (k * imp * pos)[..., None], aref[..., 1:]], dim=-1)
        aref = torch.where(active[..., None], aref, 0.0)
        d_n = imp / torch.clamp((1.0 - imp) * invweight_n, min=1e-12)
        mu1 = torch.clamp(mu[:, 0], min=1e-12)
        d_f = d_n[..., None] * model.opt_impratio * (mu / mu1[:, None]) ** 2
        D = torch.cat([d_n[..., None], d_f], dim=-1)
        zero = torch.zeros_like(pos)
        rows_pos = torch.stack([pos, zero, zero], dim=-1).reshape(bsz, -1)
        per = 3
    else:
        jvn = jv3[..., 0]
        jv = torch.stack(
            [
                jvn + mu[:, 0] * jv3[..., 1],
                jvn - mu[:, 0] * jv3[..., 1],
                jvn + mu[:, 1] * jv3[..., 2],
                jvn - mu[:, 1] * jv3[..., 2],
            ],
            dim=-1,
        )  # [B, ncon, 4]
        jv = torch.where(active[..., None], jv, 0.0)
        aref = -b[..., None] * jv - (k * imp * pos)[..., None]
        aref = torch.where(active[..., None], aref, 0.0)
        # C regularizes every pyramid row with the first friction coefficient
        mu0 = mu[:, 0:1]
        invweight_pyr = invweight_n[:, None] * (1.0 + mu0**2) * 2.0 * mu0**2 / model.opt_impratio
        impg = imp[..., None]
        D = (impg / torch.clamp((1.0 - impg) * invweight_pyr, min=1e-12)).expand(-1, -1, 4)
        rows_pos = pos.repeat_interleave(4, dim=1)
        per = 4

    arefs.append(aref.reshape(bsz, -1))
    ds.append(D.reshape(bsz, -1))
    poss.append(rows_pos)
    acts.append(active.repeat_interleave(per, dim=1))

    return EfcData(
        aref=torch.cat(arefs, dim=1),
        D=torch.cat(ds, dim=1),
        pos=torch.cat(poss, dim=1),
        active_row=torch.cat(acts, dim=1),
        jb_sw=jb_sw,
        jb_fq=jb_fq,
        jb_ll=jb_ll,
        jb_mu=None if elliptic else mu,
        ell_mu=mu1 if elliptic else None,
    )
