"""A workload's rollout: the wrapped tracking env and the intention policy.

What the MLP trainer's inner loop runs, without losses or an optimizer: the
workload's walker (rodent-full-clips: the rodent, fly-mc-intention: the
fly) on its compiled-model snapshot, synthetic clips made on the device, the tracking env with the config's env_args, reward
weights and reference_config, the Episode -> AutoReset wrappers (episode
length clip_length - random_init_range - traj_length, as the JAX trainer
sets it), and the intention policy and value networks at the config's
widths behind the observation normalizer. The config comes from the JSON
that tools/export_torch_model.py writes beside the snapshot.

    ro = make_rollout(device="cuda")
    state = ro.env.reset(torch.Generator("cuda").manual_seed(0), 4096)
    state, transitions = acting.generate_unroll(
        ro.env, state, ro.policy(), generator, ro.unroll_length)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent import running_statistics
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.base import Wrapper
from track_mjx_tpu_torch.envs.task.tracking import MultiClipTracking
from track_mjx_tpu_torch.io.load import ReferenceClip
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config


@dataclasses.dataclass
class Rollout:
    """The pieces of a workload's rollout."""

    env: Wrapper  # wrapped: Episode -> AutoReset
    tracking: MultiClipTracking  # the unwrapped env
    networks: ppo_networks.PPOImitationNetworks
    normalizer: running_statistics.RunningStatisticsState
    config: dict
    unroll_length: int
    episode_length: int

    def policy(self, deterministic: bool = False):
        """The inference policy over the current normalizer."""
        return ppo_networks.make_inference_fn(self.networks)(self.normalizer, deterministic)


def make_rollout(
    config: str = "rodent-full-clips",
    clips: Optional[ReferenceClip] = None,
    n_clips: int = 8,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> Rollout:
    """Builds the rollout of workload `config` on `device`: `clips`, or
    `n_clips` synthetic clips of the config's clip_length (numpy seed
    `seed`); networks initialized from a generator seeded with `seed`."""
    cfg = load_config(config)
    env_args, ref = cfg.env_config.env_args, cfg.reference_config
    train = cfg.train_setup.train_config
    if clips is None:
        clips = synthesize_clips(
            phys_model.load_snapshot(config), n_clips=n_clips, n_frames=ref.clip_length,
            mocap_hz=env_args.mocap_hz, seed=seed, device=device,
        )
    tracking = workload.make_env(cfg, clips, device=device)
    episode_length = workload.episode_length(cfg, tracking)
    env = wrappers.wrap(tracking, episode_length=episode_length, action_repeat=train.action_repeat)
    networks = ppo_networks.network_factory(cfg.network_config, torch.Generator().manual_seed(seed))(
        tracking.observation_size,
        tracking.reference_obs_size,
        tracking.action_size,
        preprocess_observations_fn=running_statistics.normalize,
        device=device,
    )
    normalizer = running_statistics.init_state(tracking.observation_size, device=tracking.device)
    return Rollout(env, tracking, networks, normalizer, cfg, train.unroll_length, episode_length)
