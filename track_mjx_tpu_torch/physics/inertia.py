"""Joint-space inertia: composite rigid body -> dense qM, Cholesky factor.

Port of track_mjx_tpu/physics/inertia.py. `crb`: qM = anc-masked buf @
cdof^T, symmetrized, plus diag(armature) (each env's own where the armature
is per env); `crb_buf` is exported so the fused
CG solves can rebuild qM from the (nv, 6) factors themselves. `factor_m`,
`solve_m` and `mul_m` serve the plans that are not fused (Newton): the
factor and the solve are the standalone kernels of ops/batched_linalg.
"""

from __future__ import annotations

import torch

from track_mjx_tpu_torch.ops import batched_linalg, spatial
from track_mjx_tpu_torch.ops.cg_solver_kernel import assemble_qm
from track_mjx_tpu_torch.physics.com import subtree_mask
from track_mjx_tpu_torch.physics.model import Data, Model, PhysicsPlan, static_tensor


def crb(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Composite-rigid-body mass matrix (mj_crb parity, dense layout)."""
    like = data.qpos
    mask = static_tensor(plan, ("crb", "subtree_mask"), like, lambda: subtree_mask(plan))
    dof_body = static_tensor(plan, ("crb", "dof_bodyid"), like, lambda: plan.dof_bodyid)
    anc = static_tensor(plan, ("crb", "anc"), like, lambda: plan.ancestry_mask)
    crb_inert = mask @ data.cinert  # [B, nbody, 10]
    buf = spatial.inert_mul(crb_inert[:, dof_body], data.cdof)  # [B, nv, 6]
    qm = assemble_qm(buf, data.cdof, anc, model.dof_armature)
    return data.replace(qM=qm, crb_buf=buf)


def factor_m(plan: PhysicsPlan, model: Model, data: Data) -> Data:
    """Dense Cholesky factor of qM into qLD (lower, upper triangle zero;
    replaces sparse mj_factorM)."""
    return data.replace(qLD=batched_linalg.cholesky(data.qM.contiguous()))


def solve_m(data: Data, x: torch.Tensor) -> torch.Tensor:
    """Solves qM res = x [B, nv] with the factor in qLD."""
    return batched_linalg.cho_solve(data.qLD, x.contiguous())


def mul_m(data: Data, x: torch.Tensor) -> torch.Tensor:
    """qM x for x [B, nv]."""
    return (data.qM @ x[..., None])[..., 0]
