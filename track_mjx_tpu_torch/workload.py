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

from track_mjx_tpu_torch.envs import base as envs
from track_mjx_tpu_torch.envs.task import tracking  # noqa: F401  (registers the tracking envs)
from track_mjx_tpu_torch.envs.task.reward import RewardConfig
from track_mjx_tpu_torch.envs.walker.fly import Fly
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.envs.walker.stick import Stick
from track_mjx_tpu_torch.io.load import ReferenceClip
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import CONFIG_NAME, load_config

# walker_name -> walker class
WALKERS = {"rodent": Rodent, "fly": Fly, "stick": Stick}
# walkers that resolve their config's names against their own snapshot's
# name tables, as the JAX walker does with mj_name2id (no workload config
# exports them)
BY_NAME = {"stick"}


def snapshot_name(cfg: Mapping[str, Any]) -> str:
    """The workload whose snapshot holds the config's walker. Raises
    ValueError where the config's walker differs from the one the snapshot
    was exported with."""
    name = cfg["env_config"]["walker_name"]
    if name not in WALKERS:
        raise NotImplementedError(f"walker {name!r}: only {sorted(WALKERS)} are ported")
    workload = cfg.get(CONFIG_NAME)
    if workload not in phys_model.SNAPSHOTS:
        raise ValueError(
            f"{CONFIG_NAME} {workload!r} names no exported workload; have {sorted(phys_model.SNAPSHOTS)}"
        )
    exported = load_config(workload)
    want = {"env_config.walker_name": exported["env_config"]["walker_name"],
            **{f"walker_config.{k}": v for k, v in exported["walker_config"].items()}}
    got = {"env_config.walker_name": name,
           **{f"walker_config.{k}": v for k, v in _plain(cfg["walker_config"]).items()}}
    differ = {k: (got.get(k), want.get(k)) for k in sorted(set(want) | set(got)) if got.get(k) != want.get(k)}
    if differ:
        raise ValueError(
            "the config's walker is not the one the "
            f"{workload} snapshot was exported with: "
            + "; ".join(f"{k} {g!r} against {w!r}" for k, (g, w) in differ.items())
            + " (the snapshot holds the walker compiled from its own config; export another workload with "
            "tools/export_torch_model.py)"
        )
    return workload


def make_walker(cfg: Mapping[str, Any]):
    """The config's walker on a fresh copy of its workload's snapshot
    (`snapshot_name`; the env writes the solver options into the model it
    is given); a stick from its walker_config's names."""
    name = cfg["env_config"]["walker_name"]
    if name in BY_NAME:
        return WALKERS[name](**_plain(cfg["walker_config"]))
    workload = snapshot_name(cfg)
    return WALKERS[cfg["env_config"]["walker_name"]].from_snapshot(phys_model.load_snapshot(workload))


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
