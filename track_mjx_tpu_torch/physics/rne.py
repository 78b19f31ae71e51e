"""Recursive Newton-Euler bias forces (mj_rne, flg_acc=0 parity).

Port of track_mjx_tpu/physics/rne.py: the velocity-product accelerations
propagate level by level, the backward force accumulation is one static
subtree-mask matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from track_mjx_tpu_torch.ops import spatial
from track_mjx_tpu_torch.physics.com import subtree_mask
from track_mjx_tpu_torch.physics.model import Data, Model, PhysicsPlan, static_tensor


def body_acc(plan: PhysicsPlan, model: Model, data: Data, qacc=None) -> torch.Tensor:
    """Com-frame body accelerations [B, nbody, 6] from gravity, cdof_dot*qvel
    and, when `qacc` is given, cdof*qacc (the forward pass of mj_rne and of
    mj_rnePostConstraint)."""
    like = data.qpos
    bsz = like.shape[0]
    gravity = model.opt_gravity
    if gravity.dim() > 1:  # per env, [B, 3]
        world = torch.cat([like.new_zeros((bsz, 3)), -gravity], dim=-1)[:, None, :]
    else:
        world = torch.cat([like.new_zeros(3), -gravity]).expand(bsz, 1, 6)
    # level-order accumulation like kinematics: each level reads its
    # parents from the levels before it and is appended; one gather restores
    # body order at the end
    pos_in_acc = np.zeros(plan.nbody, dtype=np.int64)
    pos_in_acc[np.concatenate(plan.body_levels)] = np.arange(1, plan.nbody)
    cat = world
    for li, ids in enumerate(plan.body_levels):
        par = static_tensor(
            plan, ("rne", li, "par"), like, lambda: pos_in_acc[plan.body_parentid[ids]]
        )
        acc = cat[:, par]
        for k in range(int(plan.body_dofnum[ids].max()) if len(ids) else 0):
            active = plan.body_dofnum[ids] > k
            lsel = static_tensor(plan, ("rne", li, k, "sel"), like, lambda: np.nonzero(active)[0])
            dadr = static_tensor(
                plan, ("rne", li, k, "dadr"), like, lambda: plan.body_dofadr[ids[active]] + k
            )
            term = data.cdof_dot[:, dadr] * data.qvel[:, dadr, None]
            if qacc is not None:
                term = term + data.cdof[:, dadr] * qacc[:, dadr, None]
            acc = acc.index_add(1, lsel, term)
        cat = torch.cat([cat, acc], dim=1)
    inv = static_tensor(plan, ("rne", "inv"), like, lambda: pos_in_acc)
    return cat[:, inv]


def rne(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Computes qfrc_bias = C(qpos, qvel): centrifugal/Coriolis + gravity."""
    like = data.qpos
    cacc = body_acc(plan, model, data)
    iv = spatial.inert_mul(data.cinert, data.cvel)
    ia = spatial.inert_mul(data.cinert, cacc)
    cfrc = ia + spatial.force_cross(data.cvel, iv)
    mask = static_tensor(plan, ("rne", "subtree"), like, lambda: subtree_mask(plan))
    cfrc_total = mask @ cfrc  # [B, nbody, 6]
    dof_body = static_tensor(plan, ("rne", "dof_body"), like, lambda: plan.dof_bodyid)
    qfrc_bias = (data.cdof * cfrc_total[:, dof_body]).sum(-1)
    return data.replace(qfrc_bias=qfrc_bias)
