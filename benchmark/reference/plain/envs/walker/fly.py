"""Fruit-fly walker on the compiled-model snapshot.

Port of track_mjx_tpu/envs/walker/fly.py. The JAX Fly builds its MjSpec from
XML (`ensure_fly_assets` fills in meshes missing from the asset tree,
optional torque actuators, the dm-style rescale), compiles it and resolves
the config's joint, body and end-effector names and the torso, "thorax",
with `mj_name2id`. All of that runs at export time: the walker of
tools/export_torch_model.py writes the compiled model and the resolved index
tables into the snapshot, and `Fly.from_snapshot` reads them back.
"""

from __future__ import annotations

from benchmark.reference.plain.envs.walker.base import BaseWalker


class Fly(BaseWalker):
    """Fly walker: the fly-mc-intention snapshot's index tables and compiled
    model."""

    SNAPSHOT = "fly-mc-intention"
