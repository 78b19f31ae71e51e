"""LSTM-pipeline binding over the PPO network factory.

Port of track_mjx_tpu/agent/lstm_ppo/ppo_networks.py: the recurrent decoder
pinned over agent/ppo_factory.py; its policies take and return the carry,
`policy(obs, key, carry) -> (action, extras, carry')`.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping, Optional

import torch

from track_mjx_tpu_torch.agent import ppo_factory

PPOImitationNetworks = ppo_factory.PPOImitationNetworks

make_inference_fn = functools.partial(ppo_factory.make_inference_fn, recurrent=True)
make_intention_ppo_networks = functools.partial(ppo_factory.make_intention_ppo_networks, recurrent_decoder=True)
params_from_flax = ppo_factory.params_from_flax


def network_factory(network_config: Mapping[str, Any], generator: Optional[torch.Generator] = None):
    """make_intention_ppo_networks at a config's `network_config` widths,
    hidden_state_size and hidden_layer_num included (the rodent's and the
    fly's YAML set neither; track_mjx_tpu/train.py reads both):
    f(observation_size, reference_obs_size, action_size, **kw)."""
    net = network_config
    if net.get("arch_name", "intention") != "intention":
        raise ValueError(f"Unknown network architecture: {net['arch_name']}")
    return functools.partial(
        make_intention_ppo_networks,
        intention_latent_size=net["intention_size"],
        hidden_state_size=net["hidden_state_size"],
        hidden_layer_num=net["hidden_layer_num"],
        encoder_hidden_layer_sizes=tuple(net["encoder_layer_sizes"]),
        decoder_hidden_layer_sizes=tuple(net["decoder_layer_sizes"]),
        value_hidden_layer_sizes=tuple(net["critic_layer_sizes"]),
        generator=generator,
    )
