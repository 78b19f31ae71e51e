"""A workload's env from its config, built in one place for the trainer
(train.py) and the rollout (rollout.py); both take the networks from
`ppo_networks.network_factory(cfg["network_config"])`.

The walker comes from the compiled-model snapshot of the config's workload
(`config_name`, which `utils.config.load_config` sets):
tools/export_torch_model.py compiled it with that workload's
walker_config, so a config whose walker_config differs from the exported
one (an override such as `walker_config.torque_actuators=false`) raises
rather than train another body. The env takes the config's env_args,
reward_weights and reference_config. A reward config without
`energy_cost_weight` gets 0.0, as the reference's own legacy backfill does
(track_mjx_tpu/analysis/rollout.py); the JAX CLI raises a TypeError there
instead (ROADMAP, known faults of the reference).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from benchmark.reference.plain.envs import base as envs
from benchmark.reference.plain.envs.task import tracking  # noqa: F401  (registers the tracking envs)
from benchmark.reference.plain.envs.task.reward import RewardConfig
from benchmark.reference.plain.envs.walker.fly import Fly
from benchmark.reference.plain.envs.walker.rodent import Rodent
from benchmark.reference.plain.io.load import ReferenceClip
from benchmark.reference.plain.physics import model as phys_model
CONFIG_NAME = "config_name"

# walker_name -> walker class
WALKERS = {"rodent": Rodent, "fly": Fly}


def make_walker(cfg: Mapping[str, Any]):
    """The config's walker on a fresh copy of its configuration's snapshot
    (`config_name`; the env writes the solver options into the model it is
    given)."""
    return WALKERS[cfg["env_config"]["walker_name"]].from_snapshot(phys_model.load_snapshot(cfg[CONFIG_NAME]))


def _plain(x):
    return x.to_dict() if hasattr(x, "to_dict") else x


def reward_config(cfg: Mapping[str, Any]) -> RewardConfig:
    """The env's RewardConfig, `energy_cost_weight` 0.0 where the config
    has none."""
    return RewardConfig(**{"energy_cost_weight": 0.0, **cfg["env_config"]["reward_weights"]})


def make_env(cfg: Mapping[str, Any], clips: ReferenceClip, device: torch.device | str = "cuda") -> envs.Env:
    """The unwrapped tracking env `env_config.env_name` over `clips`."""
    env_config = cfg["env_config"]
    return envs.get_environment(
        env_config["env_name"],
        reference_clip=clips,
        walker=make_walker(cfg),
        reward_config=reward_config(cfg),
        **env_config["env_args"],
        **cfg["reference_config"],
        device=device,
    )


def episode_length(cfg: Mapping[str, Any], env) -> int:
    """(clip_length - random_init_range - traj_length) control steps, scaled
    by the env's steps per reference frame, as the JAX trainer sets it."""
    ref = cfg["reference_config"]
    return int((ref["clip_length"] - ref["random_init_range"] - ref["traj_length"]) * env._steps_for_cur_frame)
