"""MLP-pipeline binding over the PPO network factory.

Port of track_mjx_tpu/agent/mlp_ppo/ppo_networks.py: the feed-forward
decoder pinned over agent/ppo_factory.py.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping, Optional

import torch

from track_mjx_tpu_torch.agent import ppo_factory

PPOImitationNetworks = ppo_factory.PPOImitationNetworks

make_inference_fn = ppo_factory.make_inference_fn
make_intention_ppo_networks = functools.partial(
    ppo_factory.make_intention_ppo_networks, recurrent_decoder=False
)
params_from_flax = ppo_factory.params_from_flax
make_decoder_policy_fn = ppo_factory.make_decoder_policy_fn


def network_factory(network_config: Mapping[str, Any], generator: Optional[torch.Generator] = None):
    """make_intention_ppo_networks at a config's `network_config` widths:
    f(observation_size, reference_obs_size, action_size, **kw)."""
    net = network_config
    if net.get("arch_name", "intention") != "intention":
        raise ValueError(f"Unknown network architecture: {net['arch_name']}")
    return functools.partial(
        make_intention_ppo_networks,
        intention_latent_size=net["intention_size"],
        encoder_hidden_layer_sizes=tuple(net["encoder_layer_sizes"]),
        decoder_hidden_layer_sizes=tuple(net["decoder_layer_sizes"]),
        value_hidden_layer_sizes=tuple(net["critic_layer_sizes"]),
        generator=generator,
    )
