"""Walker base: index tables and the egocentric observation helpers.

Port of track_mjx_tpu/envs/walker/base.py. The JAX walker builds its MjModel
from XML and resolves joint, body and end-effector names with MuJoCo; the
port's walker is built from those index tables alone (exported beside the
compiled-model snapshot by tools/export_torch_model.py), so it needs no
MuJoCo. The observation helpers take batch-first tensors: qpos [B, nq],
reference windows [B, L, ...], and return [B, features].

Indexing follows jnp's gather: a negative index counts from the end and an
index past the end is clamped to the last entry. The reference relies on
both: `compute_local_joint_distances` indexes with `joint_idxs - 1` (the
reference's deliberate "hot fix", behind `reproduce_joint_index_quirk`),
and `compute_local_body_positions` indexes `(ref - xpos[1:])` with body ids,
an offset of one, so the last body's id runs one past the end.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from benchmark.reference.plain.ops import quaternion as quat
from benchmark.reference.plain.physics import model as phys_model


def jnp_index(idx, n: int) -> np.ndarray:
    """`idx` as the in-range indices that jnp's gather reads on an axis of
    length `n`: negative indices wrap once, the rest are clamped."""
    idx = np.asarray(idx, np.int64)
    return np.clip(np.where(idx < 0, idx + n, idx), 0, n - 1)


class BaseWalker:
    """A walker's index tables and observation math, on [B, ...] tensors.
    `mj_model` is its compiled model (a `load_snapshot` result or a live
    MjModel), which the tracking env packs."""

    SNAPSHOT = ""  # the workload whose snapshot holds a walker class's model and tables

    def __init__(
        self,
        joint_idxs,
        body_idxs,
        endeff_idxs,
        torso_idx: int,
        mj_model: Any = None,
        reproduce_joint_index_quirk: bool = True,
    ):
        self._joint_idxs = np.asarray(joint_idxs, np.int64)
        self._body_idxs = np.asarray(body_idxs, np.int64)
        self._endeff_idxs = np.asarray(endeff_idxs, np.int64)
        self._torso_idx = int(torso_idx)
        self._mj_model = mj_model
        self.reproduce_joint_index_quirk = reproduce_joint_index_quirk
        self._index_cache: dict = {}

    @classmethod
    def from_snapshot(cls, snapshot: Any = None, reproduce_joint_index_quirk: bool = True) -> "BaseWalker":
        """The walker of a `load_snapshot` result (default: the snapshot of
        `SNAPSHOT`): its compiled model and the index tables that
        tools/export_torch_model.py resolved by name beside it."""
        if snapshot is None:
            snapshot = phys_model.load_snapshot(cls.SNAPSHOT)
        w = snapshot.walker
        return cls(
            w.joint_idxs,
            w.body_idxs,
            w.endeff_idxs,
            int(w.torso_idx),
            mj_model=snapshot,
            reproduce_joint_index_quirk=reproduce_joint_index_quirk,
        )

    # ---- index accessors -------------------------------------------------
    @property
    def joint_idxs(self) -> np.ndarray:
        return self._joint_idxs

    @property
    def body_idxs(self) -> np.ndarray:
        return self._body_idxs

    @property
    def endeff_idxs(self) -> np.ndarray:
        return self._endeff_idxs

    @property
    def torso_idx(self) -> int:
        return self._torso_idx

    def index(self, table: str, n: int, device) -> torch.Tensor:
        """Index table `table` ("joint", "joint - 1", "body", "endeff") read
        on an axis of length `n` as jnp reads it (`jnp_index`), an int64
        tensor on `device`, built once per (table, n, device)."""
        key = (table, n, str(device))
        if key not in self._index_cache:
            idx = {
                "joint": self._joint_idxs,
                "joint - 1": self._joint_idxs - 1,
                "body": self._body_idxs,
                "endeff": self._endeff_idxs,
            }[table]
            self._index_cache[key] = torch.as_tensor(jnp_index(idx, n), device=device)
        return self._index_cache[key]

    # ---- qpos/xpos accessors ---------------------------------------------
    def get_joint_positions(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, self.index("joint", qpos.shape[1], qpos.device)]

    def get_body_positions(self, xpos: torch.Tensor) -> torch.Tensor:
        return xpos[:, self.index("body", xpos.shape[1], xpos.device)]

    def get_end_effector_positions(self, xpos: torch.Tensor) -> torch.Tensor:
        return xpos[:, self.index("endeff", xpos.shape[1], xpos.device)]

    def get_torso_position(self, xpos: torch.Tensor) -> torch.Tensor:
        return xpos[:, self._torso_idx]

    def get_root_from_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, :3]

    def get_root_quaternion_from_qpos(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, 3:7]

    def get_all_loc_joints(self, qpos: torch.Tensor) -> torch.Tensor:
        return qpos[:, 7:]

    # ---- egocentric observation math -------------------------------------
    def compute_local_track_positions(
        self, ref_positions: torch.Tensor, qpos: torch.Tensor
    ) -> torch.Tensor:
        """Root-relative reference positions [B, L, 3] rotated by the root
        quaternion, [B, 3 L]."""
        root = self.get_root_from_qpos(qpos)[:, None]
        rquat = self.get_root_quaternion_from_qpos(qpos)[:, None]
        return quat.rotate(ref_positions - root, rquat).flatten(1)

    def compute_quat_distances(
        self, ref_quats: torch.Tensor, qpos: torch.Tensor
    ) -> torch.Tensor:
        """Relative quaternions between reference [B, L, 4] and agent root,
        [B, 4 L]."""
        rquat = self.get_root_quaternion_from_qpos(qpos)[:, None]
        return quat.relative_quat(ref_quats, rquat).flatten(1)

    def compute_local_joint_distances(
        self, ref_joints: torch.Tensor, qpos: torch.Tensor
    ) -> torch.Tensor:
        """Joint-space distance to the reference window [B, L, nq - 7]."""
        joints = self.get_all_loc_joints(qpos)[:, None]
        # the reference's deliberate off-by-one "hot fix" (base.py:227-229)
        table = "joint - 1" if self.reproduce_joint_index_quirk else "joint"
        diff = ref_joints - joints
        return diff[:, :, self.index(table, diff.shape[2], diff.device)].flatten(1)

    def compute_local_body_positions(
        self, ref_positions: torch.Tensor, xpos: torch.Tensor, qpos: torch.Tensor
    ) -> torch.Tensor:
        """Body-position distances [B, L, nbody - 1, 3] - [B, nbody - 1, 3]
        at the walker's body ids, rotated into the agent's root frame."""
        rquat = self.get_root_quaternion_from_qpos(qpos)[:, None, None]
        diff = ref_positions - xpos[:, None]
        diff = diff[:, :, self.index("body", diff.shape[2], diff.device)]
        return quat.rotate(diff, rquat).flatten(1)
