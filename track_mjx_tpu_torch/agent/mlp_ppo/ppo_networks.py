"""MLP-pipeline binding over the PPO network factory.

Port of track_mjx_tpu/agent/mlp_ppo/ppo_networks.py: the feed-forward
decoder pinned over agent/ppo_factory.py.
"""

from __future__ import annotations

import functools

from track_mjx_tpu_torch.agent import ppo_factory

PPOImitationNetworks = ppo_factory.PPOImitationNetworks

make_inference_fn = ppo_factory.make_inference_fn
make_intention_ppo_networks = functools.partial(
    ppo_factory.make_intention_ppo_networks, recurrent_decoder=False
)
params_from_flax = ppo_factory.params_from_flax
