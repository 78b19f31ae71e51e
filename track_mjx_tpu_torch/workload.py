"""A workload's env from its config, built in one place for the trainer
(train.py) and the rollout (rollout.py); both take the networks from
`ppo_networks.network_factory(cfg["network_config"])`.

The walker comes from the compiled-model snapshot of its workload
(tools/export_torch_model.py exports the walker with the config's
walker_config), so `walker_config` is not read here; the env takes the
config's env_args, reward_weights and reference_config.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from track_mjx_tpu_torch.envs import base as envs
from track_mjx_tpu_torch.envs.task import tracking  # noqa: F401  (registers the tracking envs)
from track_mjx_tpu_torch.envs.task.reward import RewardConfig
from track_mjx_tpu_torch.envs.walker.fly import Fly
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.io.load import ReferenceClip

# walker_name -> walker class (its SNAPSHOT names the workload whose snapshot holds its model)
WALKERS = {"rodent": Rodent, "fly": Fly}


def make_walker(cfg: Mapping[str, Any]):
    """The config's walker on a fresh copy of its snapshot (the env writes
    the solver options into the model it is given)."""
    name = cfg["env_config"]["walker_name"]
    if name not in WALKERS:
        raise NotImplementedError(f"walker {name!r}: only {sorted(WALKERS)} are ported")
    return WALKERS[name].from_snapshot()


def make_env(cfg: Mapping[str, Any], clips: ReferenceClip, device: torch.device | str = "cuda") -> envs.Env:
    """The unwrapped tracking env `env_config.env_name` over `clips`."""
    env_config = cfg["env_config"]
    return envs.get_environment(
        env_config["env_name"],
        reference_clip=clips,
        walker=make_walker(cfg),
        reward_config=RewardConfig(**env_config["reward_weights"]),
        **env_config["env_args"],
        **cfg["reference_config"],
        device=device,
    )


def episode_length(cfg: Mapping[str, Any], env) -> int:
    """(clip_length - random_init_range - traj_length) control steps, scaled
    by the env's steps per reference frame, as the JAX trainer sets it."""
    ref = cfg["reference_config"]
    return int((ref["clip_length"] - ref["random_init_range"] - ref["traj_length"]) * env._steps_for_cur_frame)
