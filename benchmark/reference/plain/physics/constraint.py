"""Constraint rows: equality, frictionloss, joint limits and contacts.

Port of track_mjx_tpu/physics/constraint.py, rows in C's order (equality,
frictionloss, limits, contacts). Two row structures have a compact layout,
which the fused CG solves build J from themselves: [joint-limit rows |
contact-major condim-3 pyramid rows (+t1, -t1, +t2, -t2)] (opt.cone
pyramidal, the rodent) and [joint-limit rows | per-contact (normal, t1, t2)
cone blocks] (opt.cone elliptic, the fly). Their rows are emitted as the
compact J operands `jb_*` plus per-row aref, D, pos and activity, and no
dense J (ops/cg_solver_kernel.build_j and build_j_ell rebuild it from the
same operands). A model without contacts takes the first layout with no
contact rows: its limit rows alone, or no rows at all (nefc 0).

Every other plan carries a dense J [B, nefc, nv] and per-row force bounds
fmin/fmax: equality rows (connect, weld, joint, tendon; bilateral,
-BIG_FORCE to BIG_FORCE), dof and tendon frictionloss rows (+-frictionloss),
limits, then contacts: the condim-1 rows first, then, pyramidal, the
pyramid groups by ascending condim, 2 (condim - 1) rows per contact, the
rotational (torsional, rolling) directions of condim 4 and 6 included, or,
elliptic, one (normal, t1, t2) cone block per condim-3 contact.

Any Model leaf may be per env (physics/model.py): the rows' terms then
carry the env axis first ([B, r] where [r] would be shared), and so may
the force bounds fmin/fmax. The rows themselves are fixed by the plan: a
frictionloss row exists for each dof and tendon whose frictionloss is
positive in the model the plan was built from, so a per-env
dof_frictionloss acts on those dofs only (the JAX package's rows are fixed
alike).

Impedance/reference math follows MuJoCo's soft-constraint model
(mj_makeImpedance / mj_referenceConstraint); elliptic friction rows reuse
the normal row's impedance, aref_fric = -b jv, and D_fric_i = D_normal
impratio (mu_i / mu_1)^2 (mj_instantiateContact). Connect and weld rows
carry C's second-order -Jdot qvel term in aref, a forward-mode derivative
(torch.func.jvp) through kinematics and com_pos.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.plain.ops import quaternion as quat
from benchmark.reference.plain.ops.cg_solver_kernel import BIG_FORCE
from benchmark.reference.plain.ops.quaternion import cross
from benchmark.reference.plain.physics.collision import Contact, contact_bodies
from benchmark.reference.plain.physics.model import (
    CONE_ELLIPTIC,
    JNT_BALL,
    JNT_FREE,
    Data,
    Model,
    PhysicsPlan,
    env_lined,
    env_view,
    is_per_env,
    static_tensor,
    take,
)

@dataclasses.dataclass(frozen=True)
class EfcData:
    """Constraint rows, batch-first, in efc order.

    On the compact layouts (nefc = nlimit + 4 ncon pyramidal, nlimit + 3
    ncon elliptic; `J` None): J[limit l] = jb_ll[l] * onehot(dofadr_l); the
    frame-projected contact row jfr[c, k, d] = (frame[c,k] . s[d] + (pos x
    frame)[c,k] . w[d]) * diff_mask[c, d] with jb_sw = [s | w], s = cdof_lin
    - cdof_ang x root_com, w = cdof_ang, and jb_fq = [frame | pos x frame]
    zeroed for inactive contacts. Pyramid rows are jfr0 +/- mu_i jfr_{i+1};
    an elliptic cone block's rows are jfr0, jfr1, jfr2 themselves.

    Off them (plans with equality, frictionloss or condim-1/4/6 rows): the
    dense `J` and the per-row force bounds, force = clip(-D jar, fmin, fmax)
    on the scalar rows; the `jb_*` operands are None, and `ell_mu` is set
    where the plan has cone blocks (its last 3 ncon_ell rows)."""

    aref: torch.Tensor  # [B, nefc]
    D: torch.Tensor  # [B, nefc]
    pos: torch.Tensor  # [B, nefc] constraint violation
    active_row: torch.Tensor  # [B, nefc] bool
    jb_sw: torch.Tensor | None = None  # [B, nv, 6]
    jb_fq: torch.Tensor | None = None  # [B, ncon, 3, 6] (ncon may be 0)
    jb_ll: torch.Tensor | None = None  # [B, nlimit] side * active
    jb_mu: torch.Tensor | None = None  # [ncon, 2] (or [B, ncon, 2]) tangential friction (pyramidal, and models without contacts)
    ell_mu: torch.Tensor | None = None  # [ncon] (or [B, ncon]) mu_1 of each cone block (elliptic)
    J: torch.Tensor | None = None  # [B, nefc, nv] off the compact layouts
    fmin: torch.Tensor | None = None  # [nefc] (or [B, nefc]) off the compact layouts
    fmax: torch.Tensor | None = None  # [nefc] (or [B, nefc])


def _jb_supported(plan: PhysicsPlan) -> bool:
    """True when the plan's rows are exactly [joint limits | contact-major
    condim-3 pyramid rows], the layout the fused solve builds J for. A plan
    with no contacts (limit rows only, or no rows at all) is one here, where
    the reference sends limit rows alone through its dense J: the outputs
    agree."""
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


def _kbi(model: Model, solref, solimp, pos, ndim: int | None = None):
    """Stiffness/damping/impedance from solver parameters (mj_makeImpedance).
    A per-env timestep is lined up against batch-first rows of `ndim` dims
    (default: pos's)."""
    timeconst, dampratio = solref[..., 0], solref[..., 1]
    dmin = torch.clamp(solimp[..., 0], 0.0001, 0.9999)
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    width = torch.clamp(solimp[..., 2], min=1e-10)
    mid = torch.clamp(solimp[..., 3], 0.0001, 0.9999)
    power = torch.clamp(solimp[..., 4], min=1.0)

    # C floors the time constant at 2*timestep (mj_assignRef)
    tc_eff = torch.maximum(timeconst, 2.0 * env_view(model, "opt_timestep", pos.dim() if ndim is None else ndim))
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


# ---------------------------------------------------------------------------
# equality and frictionloss rows
# ---------------------------------------------------------------------------


def _body_point_jac(plan: PhysicsPlan, data: Data, body: int, point: torch.Tensor):
    """World point jacobian (jacp, jacr) [B, nv, 3] of `body` at `point`
    [B, 3]: cdof_v + cdof_w x (point - root com), masked to the body's
    ancestor dofs (mj_jac)."""
    like = data.qpos
    mask = static_tensor(plan, ("con", "body_mask", body), like, lambda: dof_body_mask(plan)[body])
    rootcom = static_tensor(plan, ("con", "rootcom"), like, lambda: plan.body_rootid[plan.dof_bodyid])
    com = data.subtree_com[:, rootcom]  # [B, nv, 3]
    w, v = data.cdof[..., :3], data.cdof[..., 3:]
    jacp = (v + cross(w, point[:, None, :] - com)) * mask[:, None]
    return jacp, w * mask[:, None]


def _poly(coef: torch.Tensor, x: torch.Tensor):
    """MuJoCo's quartic coupling polynomial and its derivative."""
    c = [coef[..., i] for i in range(5)]
    val = c[0] + x * (c[1] + x * (c[2] + x * (c[3] + x * c[4])))
    deriv = c[1] + x * (2 * c[2] + x * (3 * c[3] + x * 4 * c[4]))
    return val, deriv


def _qpos_tangent(plan: PhysicsPlan, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """d(qpos)/dt induced by qvel [B, nq]: identity on scalar joints, the
    quaternion derivative 0.5 q (0, w_local) on ball and free rotations."""
    out = torch.zeros_like(qpos)
    scalar = np.nonzero((plan.jnt_type != JNT_BALL) & (plan.jnt_type != JNT_FREE))[0]
    if len(scalar):
        out[:, plan.jnt_qposadr[scalar]] = qvel[:, plan.jnt_dofadr[scalar]]
    zero = qpos.new_zeros((qpos.shape[0], 1))
    for j in np.nonzero(plan.jnt_type == JNT_FREE)[0]:
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        out[:, qadr : qadr + 3] = qvel[:, dadr : dadr + 3]
        w = torch.cat([zero, qvel[:, dadr + 3 : dadr + 6]], dim=1)
        out[:, qadr + 3 : qadr + 7] = 0.5 * quat.mul(qpos[:, qadr + 3 : qadr + 7], w)
    for j in np.nonzero(plan.jnt_type == JNT_BALL)[0]:
        qadr, dadr = int(plan.jnt_qposadr[j]), int(plan.jnt_dofadr[j])
        w = torch.cat([zero, qvel[:, dadr : dadr + 3]], dim=1)
        out[:, qadr : qadr + 4] = 0.5 * quat.mul(qpos[:, qadr : qadr + 4], w)
    return out


def _connect_weld_blocks(plan: PhysicsPlan, model: Model, data: Data):
    """(eq_id, J [B, r, nv], pos [B, r], invweight [r] or [B, r]) of each
    connect (3 rows) and weld (6 rows) constraint, from kinematics-complete
    `data`."""
    blocks = []

    def anchor(o, is_site, eq_anchor):
        """(body, world point [B, 3]) of one end: in body mode eq_data's
        anchor in the body frame, in site mode the site's world position
        (eq_data ignored, as C does)."""
        if is_site:
            return int(plan.site_bodyid[o]), data.site_xpos[:, o]
        if eq_anchor.dim() > 1:  # per env, [B, 3]
            return o, data.xpos[:, o] + (data.xmat[:, o] @ eq_anchor[..., None])[..., 0]
        return o, data.xpos[:, o] + data.xmat[:, o] @ eq_anchor

    def invweight(b, k):
        return take(model, "body_invweight0", b)[..., k]

    for e, o1, o2, is_site in plan.eq_connect:
        eq_data = take(model, "eq_data", e)
        b1, p1 = anchor(o1, is_site, eq_data[..., 0:3])
        b2, p2 = anchor(o2, is_site, eq_data[..., 3:6])
        jacp1, _ = _body_point_jac(plan, data, b1, p1)
        jacp2, _ = _body_point_jac(plan, data, b2, p2)
        iw_t = invweight(b1, 0) + invweight(b2, 0)
        blocks.append((e, (jacp1 - jacp2).transpose(-1, -2), p1 - p2, torch.stack([iw_t] * 3, dim=-1)))

    for e, o1, o2, is_site in plan.eq_weld:
        eq_data = take(model, "eq_data", e)
        ts = eq_data[..., 10]
        b1, p1 = anchor(o1, is_site, eq_data[..., 3:6])
        b2, p2 = anchor(o2, is_site, eq_data[..., 0:3])
        jacp1, jacr1 = _body_point_jac(plan, data, b1, p1)
        jacp2, jacr2 = _body_point_jac(plan, data, b2, p2)
        # rotation residual ts vec(conj(q2) q1 relq); its jacobian 0.5 ts A
        # (jacr1 - jacr2) with A e_i = vec(conj(q2) e_i q1r). Site mode: the
        # site frames, relpose identity (C derives the rest pose from them).
        if is_site:
            q1 = quat.mul(data.xquat[:, b1], take(model, "site_quat", o1))
            q2 = quat.mul(data.xquat[:, b2], take(model, "site_quat", o2))
            q1r = q1
        else:
            q1r = quat.mul(data.xquat[:, o1], eq_data[..., 6:10])
            q2 = data.xquat[:, o2]
        q2inv = quat.inv(q2)
        eq_per_env = is_per_env(model, "eq_data")
        pos_r = env_lined(ts, eq_per_env, 2) * quat.mul(q2inv, q1r)[..., 1:]
        basis = torch.eye(4, dtype=q2.dtype, device=q2.device)[1:]
        a = torch.stack([quat.mul(q2inv, quat.mul(bq, q1r))[..., 1:] for bq in basis], dim=-1)
        jr = 0.5 * env_lined(ts, eq_per_env, 3) * (a @ (jacr1 - jacr2).transpose(-1, -2))
        iw_t = invweight(b1, 0) + invweight(b2, 0)
        iw_r = invweight(b1, 1) + invweight(b2, 1)
        blocks.append((
            e,
            torch.cat([(jacp1 - jacp2).transpose(-1, -2), jr], dim=1),
            torch.cat([p1 - p2, pos_r], dim=1),
            torch.stack([iw_t] * 3 + [iw_r] * 3, dim=-1),
        ))
    return blocks


def _connect_weld_jdot_qvel(plan: PhysicsPlan, model: Model, data: Data) -> torch.Tensor:
    """Jdot qvel [B, rows] of the stacked connect/weld rows, d/dt [J(qpos(t))
    qvel] at fixed qvel, by forward-mode differentiation (torch.func.jvp)
    through kinematics and com_pos along qpos's tangent. C adds it to the
    connect/weld aref (mj_referenceConstraint's efc_vel for these rows)."""
    from benchmark.reference.plain.physics import com as _com
    from benchmark.reference.plain.physics import kinematics as _kinematics

    qvel = data.qvel

    def vel_rows(qpos):
        d = _kinematics.kinematics(plan, model, data.replace(qpos=qpos))
        d = _com.com_pos(plan, model, d)
        blocks = _connect_weld_blocks(plan, model, d)
        return torch.cat([(j @ qvel[:, :, None])[..., 0] for _, j, _, _ in blocks], dim=1)

    tangent = _qpos_tangent(plan, data.qpos, qvel)
    return torch.func.jvp(vel_rows, (data.qpos,), (tangent,))[1]


def _equality_rows(plan: PhysicsPlan, model: Model, data: Data):
    """Equality constraint rows (mj_instantiateEquality) in eq-id order:
    [(J [B, r, nv], aref, D, pos [B, r]), ...].

    Impedance is evaluated on the norm of the constraint's residual (all its
    rows), as C does. Weld rotation rows carry torquescale in J and pos.
    Connect/weld aref carries -Jdot qvel; joint and tendon rows do not, as
    in C."""
    like = data.qpos
    bsz, nv = like.shape[0], plan.nv
    out = []

    def kbi_norm(e, res):
        norm = torch.sqrt(torch.clamp((res * res).sum(-1), min=1e-30))
        return _kbi(model, take(model, "eq_solref", e), take(model, "eq_solimp", e), norm)

    cw_blocks = _connect_weld_blocks(plan, model, data)
    if cw_blocks:
        jdot_qvel = _connect_weld_jdot_qvel(plan, model, data)
        row0 = 0
        for e, j, pos, iw in cw_blocks:
            nrow = j.shape[1]
            k, b, imp = kbi_norm(e, pos)
            vel = (j * data.qvel[:, None, :]).sum(-1)
            jdot = jdot_qvel[:, row0 : row0 + nrow]
            row0 += nrow
            aref = -env_lined(b, b.dim() > 0, 2) * vel - (k * imp)[:, None] * pos - jdot
            imp = imp[:, None]
            out.append((e, j, aref, imp / torch.clamp((1.0 - imp) * iw, min=1e-12), pos))

    for e, j1, j2 in plan.eq_joint:
        d1, q1adr = int(plan.jnt_dofadr[j1]), int(plan.jnt_qposadr[j1])
        pos1 = data.qpos[:, q1adr] - take(model, "qpos0", q1adr)
        j = like.new_zeros((bsz, nv))
        j[:, d1] = 1.0
        eq_data = take(model, "eq_data", e)
        if j2 >= 0:
            d2, q2adr = int(plan.jnt_dofadr[j2]), int(plan.jnt_qposadr[j2])
            val, deriv = _poly(eq_data, data.qpos[:, q2adr] - take(model, "qpos0", q2adr))
            pos = pos1 - val
            j[:, d2] = -deriv
            invweight = take(model, "dof_invweight0", d1) + take(model, "dof_invweight0", d2)
        else:
            pos = pos1 - eq_data[..., 0]
            invweight = take(model, "dof_invweight0", d1)
        k, b, imp = kbi_norm(e, pos[:, None])
        aref = -b * (j * data.qvel).sum(-1) - k * imp * pos
        d = imp / torch.clamp((1.0 - imp) * invweight, min=1e-12)
        out.append((e, j[:, None], aref[:, None], d[:, None], pos[:, None]))

    if plan.eq_tendon:
        lengths = (model.tendon_length_mat * data.qpos[:, None, :]).sum(-1) + model.tendon_length0_const
        for e, t1, t2 in plan.eq_tendon:
            pos1 = lengths[:, t1] - take(model, "tendon_length0", t1)
            j = take(model, "tendon_moment", t1).expand(bsz, nv)
            eq_data = take(model, "eq_data", e)
            if t2 >= 0:
                val, deriv = _poly(eq_data, lengths[:, t2] - take(model, "tendon_length0", t2))
                pos = pos1 - val
                j = j - deriv[:, None] * take(model, "tendon_moment", t2)
                invweight = take(model, "tendon_invweight0", t1) + take(model, "tendon_invweight0", t2)
            else:
                pos = pos1 - eq_data[..., 0]
                invweight = take(model, "tendon_invweight0", t1)
            k, b, imp = kbi_norm(e, pos[:, None])
            aref = -b * (j * data.qvel).sum(-1) - k * imp * pos
            d = imp / torch.clamp((1.0 - imp) * invweight, min=1e-12)
            out.append((e, j[:, None], aref[:, None], d[:, None], pos[:, None]))

    out.sort(key=lambda block: block[0])
    return [block[1:] for block in out]


def _friction_rows(plan: PhysicsPlan, model: Model, data: Data):
    """Dof, then tendon frictionloss rows: [(J [r, nv], aref [B, r], D [r],
    frictionloss [r]), ...] (J, D and frictionloss [B, ...] where the leaves
    they come from are per env). pos is 0 and K is 0 (aref = -B vel); the
    solver clamps their force to +-frictionloss. The rows are the plan's
    (module docstring)."""
    like = data.qpos
    out = []
    ids = plan.friction_dof_ids
    if len(ids):
        ids_t = static_tensor(plan, ("con", "fri_dof"), like, lambda: ids)
        j = static_tensor(plan, ("con", "fri_dof_J"), like, lambda: np.eye(plan.nv)[ids])
        _, b, imp = _kbi(model, take(model, "dof_solref_fri", ids_t), take(model, "dof_solimp_fri", ids_t),
                         like.new_zeros(len(ids)), ndim=2)
        d = imp / torch.clamp((1.0 - imp) * take(model, "dof_invweight0", ids_t), min=1e-12)
        out.append((j, -b * data.qvel[:, ids_t], d, take(model, "dof_frictionloss", ids_t)))
    tids = plan.friction_tendon_ids
    if len(tids):
        tids_t = static_tensor(plan, ("con", "fri_ten"), like, lambda: tids)
        j = take(model, "tendon_moment", tids_t)
        _, b, imp = _kbi(model, take(model, "tendon_solref_fri", tids_t), take(model, "tendon_solimp_fri", tids_t),
                         like.new_zeros(len(tids)), ndim=2)
        d = imp / torch.clamp((1.0 - imp) * take(model, "tendon_invweight0", tids_t), min=1e-12)
        out.append((j, -b * (j * data.qvel[:, None, :]).sum(-1), d, take(model, "tendon_frictionloss", tids_t)))
    return out


# ---------------------------------------------------------------------------
# limits and contacts
# ---------------------------------------------------------------------------


def _limit_rows(plan: PhysicsPlan, model: Model, data: Data):
    """Joint-limit rows [B, nlimit]: (aref, D, pos, active, side * active)."""
    like = data.qpos

    def st(key, build):
        return static_tensor(plan, ("con", key), like, build)

    jids = plan.limited_jnt_ids
    jids_t = st("jids", lambda: jids)
    qadr = st("qadr", lambda: plan.jnt_qposadr[jids])
    dadr = st("dadr", lambda: plan.jnt_dofadr[jids])
    qpos = data.qpos[:, qadr]
    if is_per_env(model, "jnt_range"):
        r0, r1 = model.jnt_range[:, jids_t, 0], model.jnt_range[:, jids_t, 1]
    else:
        r0, r1 = model.jnt_range[jids_t, 0], model.jnt_range[jids_t, 1]
    dist_min = qpos - r0
    dist_max = r1 - qpos
    dist = torch.minimum(dist_min, dist_max)
    side = torch.where(dist_min < dist_max, 1.0, -1.0).to(like.dtype)
    margin = take(model, "jnt_margin", jids_t)
    active = dist < margin
    pos = dist - margin
    k, b, imp = _kbi(model, take(model, "jnt_solref", jids_t), take(model, "jnt_solimp", jids_t), pos)
    jv = side * data.qvel[:, dadr]
    aref = -b * jv - k * imp * pos
    invweight = take(model, "dof_invweight0", dadr)
    D = imp / torch.clamp((1.0 - imp) * invweight, min=1e-12)
    return torch.where(active, aref, 0.0), D, pos, active, torch.where(active, side, 0.0)


class _ContactTerms(NamedTuple):
    """Per-contact quantities both row layouts build from."""

    s: torch.Tensor  # [B, nv, 3] cdof_lin - cdof_ang x root com
    w: torch.Tensor  # [B, nv, 3] cdof_ang
    q: torch.Tensor  # [B, ncon, 3, 3] pos x frame
    jv3: torch.Tensor  # [B, ncon, 3] jv of the frame rows
    wv: torch.Tensor  # [B, ncon, 3] diff-masked w qvel
    pos: torch.Tensor  # [B, ncon]
    active: torch.Tensor  # [B, ncon]
    k: torch.Tensor  # [ncon] (or [B, ncon] from per-env leaves, as b and invweight_n)
    b: torch.Tensor  # [ncon]
    imp: torch.Tensor  # [B, ncon]
    invweight_n: torch.Tensor  # [ncon]
    diff_mask: torch.Tensor  # [ncon, nv]


def _contact_terms(plan: PhysicsPlan, model: Model, data: Data, contact: Contact) -> _ContactTerms:
    like = data.qpos

    def st(key, build):
        return static_tensor(plan, ("con", key), like, build)

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
    k, b, imp = _kbi(model, contact.solref, contact.solimp, pos)
    invweight_n = take(model, "body_invweight0", body1)[..., 0] + take(model, "body_invweight0", body2)[..., 0]
    return _ContactTerms(s, w, q, jv3, wv, pos, contact.dist < contact.includemargin, k, b, imp,
                         invweight_n, diff_mask)


def _cone_blocks(model: Model, active, jv3, pos, k, b, imp, invweight_n, mu):
    """aref and D [B, n3, 3] of elliptic cone blocks (normal, t1, t2) and
    each block's mu_1 [n3] (mj_instantiateContact): the friction rows have
    no position term and reuse the normal row's impedance, D_f = D_n
    impratio (mu_i / mu_1)^2. The contacts' per-contact terms come in
    indexed alike: active, pos, imp [B, n3], jv3 [B, n3, 3], k, b,
    invweight_n [n3] (or [B, n3]), tangential friction mu [n3, 2] (or [B, n3,
    2])."""
    jv = torch.where(active[..., None], jv3, 0.0)
    aref = -b[..., None] * jv
    aref = torch.cat([aref[..., :1] - (k * imp * pos)[..., None], aref[..., 1:]], dim=-1)
    aref = torch.where(active[..., None], aref, 0.0)
    d_n = imp / torch.clamp((1.0 - imp) * invweight_n, min=1e-12)
    mu1 = torch.clamp(mu[..., 0], min=1e-12)
    d_f = d_n[..., None] * env_view(model, "opt_impratio", 3) * (mu / mu1[..., None]) ** 2
    return aref, torch.cat([d_n[..., None], d_f], dim=-1), mu1


def make_constraint(
    plan: PhysicsPlan, model: Model, data: Data, contact: Contact
) -> EfcData:
    """Assembles the constraint rows in C's order (equality, frictionloss,
    limits, contacts): on a compact layout as its operands, else with a
    dense J and force bounds."""
    elliptic = _jb_supported_ell(plan)
    if elliptic or _jb_supported(plan):
        return _compact_rows(plan, model, data, contact, elliptic)
    return _dense_rows(plan, model, data, contact)


def _compact_rows(plan, model, data, contact, elliptic: bool) -> EfcData:
    like = data.qpos
    bsz = like.shape[0]
    arefs, ds, poss, acts = [], [], [], []

    if len(plan.limited_jnt_ids):
        aref, D, pos, active, jb_ll = _limit_rows(plan, model, data)
        arefs.append(aref)
        ds.append(D)
        poss.append(pos)
        acts.append(active)
    else:
        jb_ll = like.new_zeros((bsz, 0))

    t = _contact_terms(plan, model, data, contact)
    pos, active, k, b, imp, jv3 = t.pos, t.active, t.k, t.b, t.imp, t.jv3
    jb_sw = torch.cat([t.s, t.w], dim=-1)
    jb_fq = torch.cat([contact.frame, t.q], dim=-1) * active[..., None, None].to(like.dtype)
    mu = contact.friction[..., :2]  # [ncon, 2], or [B, ncon, 2] randomized per env
    invweight_n = t.invweight_n

    if elliptic:
        aref, D, mu1 = _cone_blocks(model, active, jv3, pos, k, b, imp, invweight_n, mu)
        zero = torch.zeros_like(pos)
        rows_pos = torch.stack([pos, zero, zero], dim=-1).reshape(bsz, -1)
        per = 3
    else:
        jvn = jv3[..., 0]
        jv = torch.stack(
            [
                jvn + mu[..., 0] * jv3[..., 1],
                jvn - mu[..., 0] * jv3[..., 1],
                jvn + mu[..., 1] * jv3[..., 2],
                jvn - mu[..., 1] * jv3[..., 2],
            ],
            dim=-1,
        )  # [B, ncon, 4]
        jv = torch.where(active[..., None], jv, 0.0)
        aref = -b[..., None] * jv - (k * imp * pos)[..., None]
        aref = torch.where(active[..., None], aref, 0.0)
        # C regularizes every pyramid row with the first friction coefficient
        mu0 = mu[..., 0:1]
        invweight_pyr = invweight_n[..., None] * (1.0 + mu0**2) * 2.0 * mu0**2 / env_view(model, "opt_impratio", 3)
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


def _dense_rows(plan, model, data, contact) -> EfcData:
    """Rows off the compact layouts, with a dense J and force bounds:
    equality, frictionloss, limits, condim-1 contacts, then the pyramid
    groups by ascending condim (pyramidal) or one (normal, t1, t2) cone
    block per condim-3 contact (elliptic, `ell_mu` set)."""
    like = data.qpos
    bsz, nv = like.shape[0], plan.nv
    rows = []  # (J [B, r, nv], aref, D, pos [B, r], active [B, r], fmin, fmax [r] or [B, r])

    def push(j, aref, D, pos, active, fmin, fmax):
        rows.append((j, aref, D, pos, active, fmin, fmax))

    big = like.new_tensor(BIG_FORCE)
    zero = like.new_tensor(0.0)
    ell_mu = None
    for j, aref, D, pos in _equality_rows(plan, model, data):
        push(j, aref, D, pos, torch.ones_like(aref, dtype=torch.bool), -big, big)
    for j, aref, D, floss in _friction_rows(plan, model, data):
        push(j.expand(bsz, -1, -1), aref, D.expand(bsz, -1), torch.zeros_like(aref),
             torch.ones_like(aref, dtype=torch.bool), -floss, floss)

    if len(plan.limited_jnt_ids):
        aref, D, pos, active, side = _limit_rows(plan, model, data)
        jids = plan.limited_jnt_ids
        lim1h = static_tensor(plan, ("con", "lim1h"), like,
                              lambda: np.eye(plan.nv)[plan.jnt_dofadr[jids]])
        push(side[..., None] * lim1h, aref, D, pos, active, zero, big)

    if plan.ncon:
        t = _contact_terms(plan, model, data, contact)
        pos, active, k, b, imp, jv3 = t.pos, t.active, t.k, t.b, t.imp, t.jv3
        frame = contact.frame
        jfr = (frame @ t.s.transpose(-1, -2)[:, None] + t.q @ t.w.transpose(-1, -2)[:, None]) * t.diff_mask[
            None, :, None, :
        ]  # [B, ncon, 3, nv]
        jn = jfr[:, :, 0]
        jdirs = jfr[:, :, 1:]
        if plan.condim > 3:
            # rotational directions (torsional, rolling): the angular jacobian
            # difference on the contact frame, jrot[c,k] . qvel = frame[c,k] . wv
            jrot = (frame @ t.w.transpose(-1, -2)[:, None]) * t.diff_mask[None, :, None, :]
            jdirs = torch.cat([jdirs, jrot], dim=2)  # [B, ncon, 5, nv]
            jv_rot = (frame * t.wv[:, :, None, :]).sum(-1)  # [B, ncon, 3]

        cd1 = np.nonzero(plan.contact_condim == 1)[0]
        if len(cd1):
            c = static_tensor(plan, ("con", "cd1"), like, lambda: cd1)
            act = active[:, c]
            aref = torch.where(act, -b[..., c] * jv3[:, c, 0] - k[..., c] * imp[:, c] * pos[:, c], 0.0)
            D = imp[:, c] / torch.clamp((1.0 - imp[:, c]) * t.invweight_n[..., c], min=1e-12)
            push(torch.where(act[..., None], jn[:, c], 0.0), aref, D, pos[:, c], act, zero, big)

        cd3 = np.nonzero(plan.contact_condim >= 3)[0]
        if len(cd3) and plan.cone == CONE_ELLIPTIC:
            # condim-3 only: elliptic condim 4 and 6 are refused by put_model
            c = static_tensor(plan, ("con", "cd3"), like, lambda: cd3)
            act = active[:, c]
            aref, D, ell_mu = _cone_blocks(model, act, jv3[:, c], pos[:, c], k[..., c], b[..., c], imp[:, c],
                                           t.invweight_n[..., c], contact.friction[..., c, :2])
            j = torch.where(act[..., None, None], jfr[:, c], 0.0)
            zc = torch.zeros_like(pos[:, c])
            nr = 3 * len(cd3)
            push(j.reshape(bsz, nr, nv), aref.reshape(bsz, nr), D.reshape(bsz, nr),
                 torch.stack([pos[:, c], zc, zc], dim=-1).reshape(bsz, nr), act.repeat_interleave(3, dim=1),
                 zero, big)
        else:
            for cdim in sorted(set(int(x) for x in plan.contact_condim[cd3])):
                grp = cd3[plan.contact_condim[cd3] == cdim]
                g = static_tensor(plan, ("con", "grp", cdim), like, lambda: grp)
                nfr = cdim - 1  # friction directions: 2 tangential, then rotational
                mu = contact.friction[..., g, :nfr]  # [ng, nfr], or [B, ng, nfr]
                jng, jdg, act = jn[:, g], jdirs[:, g], active[:, g]
                pyr = []
                for i in range(nfr):
                    pyr += [jng + mu[..., i, None] * jdg[:, :, i], jng - mu[..., i, None] * jdg[:, :, i]]
                j = torch.where(act[..., None, None], torch.stack(pyr, dim=2), 0.0)  # [B, ng, 2 nfr, nv]
                # pyramid jv from the directions' jv (J is linear in them)
                jv_dirs = torch.cat([jv3[:, g, 1:], jv_rot[:, g, : nfr - 2]], dim=2) if nfr > 2 else jv3[:, g, 1:]
                jvn = jv3[:, g, 0]
                jv = []
                for i in range(nfr):
                    jv += [jvn + mu[..., i] * jv_dirs[..., i], jvn - mu[..., i] * jv_dirs[..., i]]
                jv = torch.where(act[..., None], torch.stack(jv, dim=2), 0.0)  # [B, ng, 2 nfr]
                aref = -b[..., g, None] * jv - (k[..., g] * imp[:, g] * pos[:, g])[..., None]
                aref = torch.where(act[..., None], aref, 0.0)
                # C regularizes every pyramid row with the first friction
                # coefficient; per-direction mu appears only in J
                mu0 = mu[..., 0:1]
                invweight_pyr = (t.invweight_n[..., g, None] * (1.0 + mu0**2) * 2.0 * mu0**2
                                 / env_view(model, "opt_impratio", 3))
                impg = imp[:, g, None]
                D = (impg / torch.clamp((1.0 - impg) * invweight_pyr, min=1e-12)).expand(-1, -1, 2 * nfr)
                nr = len(grp) * 2 * nfr
                push(j.reshape(bsz, nr, nv), aref.reshape(bsz, nr), D.reshape(bsz, nr),
                     pos[:, g].repeat_interleave(2 * nfr, dim=1), act.repeat_interleave(2 * nfr, dim=1), zero, big)

    j, aref, D, pos, active = (torch.cat(parts, dim=1) for parts in list(zip(*rows))[:5])
    # the force bounds [nefc], or [B, nefc] where a bound comes per env
    per_env = any(bound.dim() > 1 for row in rows for bound in row[5:])
    fmin, fmax = (
        torch.cat([torch.broadcast_to(row[i], (bsz, row[1].shape[1]) if per_env else (row[1].shape[1],))
                   for row in rows], dim=-1)
        for i in (5, 6)
    )
    return EfcData(aref=aref, D=D, pos=pos, active_row=active, J=j, fmin=fmin, fmax=fmax, ell_mu=ell_mu)
