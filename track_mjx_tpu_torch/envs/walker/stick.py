"""Stick-insect walker on its exported snapshot.

Port of track_mjx_tpu/envs/walker/stick.py. The JAX Stick compiles
`stick/stick_fast.xml` with MuJoCo (nq 45, nv 44, nu 38; pyramidal cone,
Newton and RK4 in the XML; no geom collides, so its only constraint rows
are its 38 joint limits) and resolves the given joint, body and
end-effector names and its torso, "reference_base", with `mj_name2id`.
No workload config names it, so the port keeps the compiled model and its
joint and body name tables in `assets/stick.npz` (`python
tools/export_torch_model.py --stick`) and resolves names against those
tables as `mj_name2id` does: an unknown name is -1, which the
observation math then reads as jnp does (the last entry). As in the JAX
walker, torque actuators raise. The snapshot holds the XML's scale, 1.0,
so another `rescale_factor` raises too: it is the one scale the JAX
`Stick` builds (its `dm_scale_spec` looks for a root body "walker", which
the stick has not, and fails; ROADMAP, faults of the reference).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from track_mjx_tpu_torch.envs.walker.base import BaseWalker
from track_mjx_tpu_torch.physics import model as phys_model

EXPORT = "python tools/export_torch_model.py --stick"


def name2id(table, names: Sequence[str]) -> np.ndarray:
    """Each name's index in `table` (a snapshot's name table), -1 where it
    has none, as `mj_name2id`."""
    index = {str(n): i for i, n in enumerate(table)}
    return np.array([index.get(str(n), -1) for n in names], np.int64)


class Stick(BaseWalker):
    """Stick walker: its snapshot's compiled model and the index tables of
    the names it is given."""

    SNAPSHOT = "stick"
    TORSO = "reference_base"

    def __init__(
        self,
        joint_names: Sequence[str],
        body_names: Sequence[str],
        end_eff_names: Sequence[str],
        torque_actuators: bool = False,
        rescale_factor: float = 1.0,
        *,
        reproduce_joint_index_quirk: bool = True,
    ):
        if torque_actuators:
            raise ValueError("actuator modification for stick is not supported")
        snap = phys_model.load_snapshot(self.SNAPSHOT)
        exported = float(snap.stick.rescale_factor)
        if float(rescale_factor) != exported:
            raise ValueError(
                f"rescale_factor {rescale_factor}: the stick snapshot ({EXPORT}) holds the walker at its XML's "
                f"scale, {exported}, the one scale the JAX package's Stick builds"
            )
        self.joint_names = list(joint_names)
        self.body_names = list(body_names)
        self.end_eff_names = list(end_eff_names)
        self.torque_actuators = torque_actuators
        self.rescale_factor = rescale_factor
        super().__init__(
            name2id(snap.names.joint, self.joint_names),
            name2id(snap.names.body, self.body_names),
            name2id(snap.names.body, self.end_eff_names),
            int(name2id(snap.names.body, [self.TORSO])[0]),
            mj_model=snap,
            reproduce_joint_index_quirk=reproduce_joint_index_quirk,
        )
