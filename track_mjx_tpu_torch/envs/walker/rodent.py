"""Rodent walker on the compiled-model snapshot.

Port of track_mjx_tpu/envs/walker/rodent.py. The JAX Rodent builds its
MjSpec from XML (torque actuators, the dm-style rescale), compiles it and
resolves the config's joint, body and end-effector names with
`mj_name2id`. All of that runs at export time: tools/export_torch_model.py
writes the compiled model and the resolved index tables into the snapshot,
and this walker reads them back.
"""

from __future__ import annotations

from typing import Any

from track_mjx_tpu_torch.envs.walker.base import BaseWalker
from track_mjx_tpu_torch.physics import model as phys_model


class Rodent(BaseWalker):
    """Rodent walker: the snapshot's index tables and compiled model."""

    def __init__(self, mj_model: Any, reproduce_joint_index_quirk: bool = True):
        w = mj_model.walker
        super().__init__(
            w.joint_idxs,
            w.body_idxs,
            w.endeff_idxs,
            int(w.torso_idx),
            mj_model=mj_model,
            reproduce_joint_index_quirk=reproduce_joint_index_quirk,
        )

    @classmethod
    def from_snapshot(
        cls, snapshot: Any = None, reproduce_joint_index_quirk: bool = True
    ) -> "Rodent":
        """The rodent of a `load_snapshot` result (default: the
        rodent-full-clips snapshot)."""
        if snapshot is None:
            snapshot = phys_model.load_snapshot("rodent-full-clips")
        return cls(snapshot, reproduce_joint_index_quirk=reproduce_joint_index_quirk)
