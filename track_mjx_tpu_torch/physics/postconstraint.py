"""Post-constraint per-body contact wrenches (`cfrc_ext`).

Port of track_mjx_tpu/physics/postconstraint.py: the contact-accumulation
half of MuJoCo's `mj_rnePostConstraint`, an analysis-time function of the
Data that a step leaves behind (the offline rollouts log it as
`joint_forces`, analysis/rollout.py); the training step never computes it.

- `cfrc_ext[b]` is the wrench [torque(3), force(3)] in the world
  orientation about the subtree COM of body b's kinematic-tree root;
- a contact applies +wrench to geom2's body and -wrench to geom1's (the
  normal points from geom1 into geom2);
- pyramidal facet forces decode per condim group as fn = sum(pyr),
  ft_i = (pyr[2i] - pyr[2i+1]) mu_i (`mju_decodePyramid`); elliptic
  blocks are [normal, tangent1, tangent2] as they stand; condim-1 contacts
  carry their normal row only; components 3: of a condim-4/6 contact are
  its torsional and rolling moments;
- only active contacts (dist < includemargin) count, and the world body
  stays zero.

Contact forces only, as in the JAX module: equality wrenches and
`xfrc_applied` are not accumulated (zero in every workload). The row
layout (limits, condim-1 rows, condim-grouped contact rows) is the
constraint stage's; its index tables are built once per plan
(`static_tensor`). Batch-first: Data [B, ...] -> [B, nbody, 6].
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops.quaternion import cross
from track_mjx_tpu_torch.physics.collision import _combine_params, contact_bodies
from track_mjx_tpu_torch.physics.model import CONE_ELLIPTIC, Data, Model, PhysicsPlan, plan_cache, static_tensor


def _tables(plan: PhysicsPlan) -> dict:
    """The plan's static tables (numpy): contact geoms and bodies, their
    roots, and per decoded column group the contacts and efc rows it reads."""
    geom1, geom2, body1, body2 = contact_bodies(plan)
    n_lim = plan.ne + plan.nf + len(plan.limited_jnt_ids)
    cd1 = np.nonzero(plan.contact_condim == 1)[0]
    cd3 = np.nonzero(plan.contact_condim >= 3)[0]
    off = n_lim + len(cd1)
    groups = []  # (condim, contact ids, efc rows [n, rows per contact])
    if len(cd3) and plan.cone == CONE_ELLIPTIC:
        groups.append((0, cd3, off + np.arange(3 * len(cd3)).reshape(len(cd3), 3)))
    elif len(cd3):
        for cdim in sorted(set(int(c) for c in plan.contact_condim[cd3])):
            grp = cd3[plan.contact_condim[cd3] == cdim]
            nrows = 2 * (cdim - 1)
            groups.append((cdim, grp, off + np.arange(nrows * len(grp)).reshape(len(grp), nrows)))
            off += nrows * len(grp)
    return {
        "geom1": geom1,
        "geom2": geom2,
        "body1": body1,
        "body2": body2,
        "root1": plan.body_rootid[body1],
        "root2": plan.body_rootid[body2],
        "cd1": cd1,
        "cd1_rows": n_lim + np.arange(len(cd1)),
        "groups": groups,
    }


def cfrc_ext(plan: PhysicsPlan, model: Model, data: Data) -> torch.Tensor:
    """Net external (contact) wrench per body, [B, nbody, 6] = [torque,
    force], from the constraint outputs in `data` (contact_dist, _pos,
    _frame, efc_force, subtree_com): call it on the Data of a forward or a
    step."""
    like = data.qpos
    bsz = like.shape[0]
    out = like.new_zeros((bsz, plan.nbody, 6))
    if plan.ncon == 0:
        return out
    tables = plan_cache(plan, "cfrc_ext", lambda: _tables(plan))

    def idx(name, arr):
        return static_tensor(plan, ("cfrc_ext", name), like, lambda: np.asarray(arr, np.int64))

    friction, _, _, includemargin = _combine_params(model, idx("geom1", tables["geom1"]), idx("geom2", tables["geom2"]))
    active = data.contact_dist < includemargin

    # decoded contact wrench in the contact frame: [fn, ft1, ft2, tn, t1, t2]
    f_local = like.new_zeros((bsz, plan.ncon, 6))
    if len(tables["cd1"]):
        f_local[:, idx("cd1", tables["cd1"]), 0] = data.efc_force[:, idx("cd1_rows", tables["cd1_rows"])]
    for cdim, grp, rows in tables["groups"]:
        g = idx(("grp", cdim), grp)
        blocks = data.efc_force[:, idx(("rows", cdim), rows)]  # [B, n, rows per contact]
        if cdim == 0:  # elliptic cone blocks
            f_local[:, g, :3] = blocks
            continue
        nfr = cdim - 1
        mu = friction[..., g, :nfr]
        f_local[:, g, 0] = blocks.sum(-1)
        f_local[:, g, 1 : 1 + nfr] = (blocks[..., 0::2] - blocks[..., 1::2]) * mu
    f_local = torch.where(active[..., None], f_local, torch.zeros_like(f_local))

    # world frame: contact frames' rows are [normal, tangent1, tangent2]
    f_world = torch.einsum("bci,bcij->bcj", f_local[..., :3], data.contact_frame)
    t_world = torch.einsum("bci,bcij->bcj", f_local[..., 3:], data.contact_frame)
    com1 = data.subtree_com[:, idx("root1", tables["root1"])]
    com2 = data.subtree_com[:, idx("root2", tables["root2"])]
    trq2 = cross(data.contact_pos - com2, f_world) + t_world
    trq1 = cross(data.contact_pos - com1, f_world) + t_world
    out.index_add_(1, idx("body2", tables["body2"]), torch.cat([trq2, f_world], dim=-1))
    out.index_add_(1, idx("body1", tables["body1"]), -torch.cat([trq1, f_world], dim=-1))
    # C never accumulates into the world body (mj_rnePostConstraint skips it)
    out[:, 0] = 0.0
    return out
