"""Rodent walker on the compiled-model snapshot.

Port of track_mjx_tpu/envs/walker/rodent.py. The JAX Rodent builds its
MjSpec from XML (torque actuators, the dm-style rescale), compiles it and
resolves the config's joint, body and end-effector names with
`mj_name2id`. All of that runs at export time: tools/export_torch_model.py
writes the compiled model and the resolved index tables into the snapshot,
and `Rodent.from_snapshot` reads them back.
"""

from __future__ import annotations

from track_mjx_tpu_torch.envs.walker.base import BaseWalker


class Rodent(BaseWalker):
    """Rodent walker: the rodent-full-clips snapshot's index tables and
    compiled model."""

    SNAPSHOT = "rodent-full-clips"
