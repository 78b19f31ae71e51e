"""PPO network bundle and inference factory of the MLP pipeline.

A frozen copy of the port's agent/ppo_factory.py, cut to what the
benchmark's cells run (the feed-forward intention policy):

- `make_intention_ppo_networks` builds the intention policy, the value MLP
  and the NormalTanh action distribution; the networks are `nn.Module`s
  whose weights come from flax's initializers, drawn from `generator`.
- `make_inference_fn(networks)(normalizer_params, deterministic)` returns
  `policy(obs, key) -> (action, extras)` under `torch.no_grad()`. `key` is a
  `torch.Generator`: the latent noise [B, latents] is drawn first, then the
  action noise [B, action_size]. Deterministic extras: latent_mean and
  latent_logvar; stochastic extras add log_prob, raw_action and logits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch
from torch import nn

from benchmark.reference.plain.agent import distribution, networks, types
from benchmark.reference.plain.agent.intention import make_feedforward_intention_policy


@dataclasses.dataclass
class PPOImitationNetworks:
    policy_network: nn.Module
    value_network: nn.Module
    parametric_action_distribution: distribution.ParametricDistribution


def make_intention_ppo_networks(
    observation_size: int,
    reference_obs_size: int,
    action_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    intention_latent_size: int = 60,
    encoder_hidden_layer_sizes: Sequence[int] = (1024,) * 2,
    decoder_hidden_layer_sizes: Sequence[int] = (1024,) * 2,
    value_hidden_layer_sizes: Sequence[int] = (1024,) * 2,
    *,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> PPOImitationNetworks:
    """The intention policy, the value MLP and the NormalTanh distribution,
    their weights drawn on the CPU from `generator` (policy first), then
    moved to `device`."""
    dist = distribution.NormalTanhDistribution(event_size=action_size)
    kw = dict(
        latent_size=intention_latent_size,
        total_obs_size=observation_size,
        reference_obs_size=reference_obs_size,
        preprocess_observations_fn=preprocess_observations_fn,
        encoder_hidden_layer_sizes=encoder_hidden_layer_sizes,
        decoder_hidden_layer_sizes=decoder_hidden_layer_sizes,
        generator=generator,
        device=device,
    )
    policy = make_feedforward_intention_policy(dist.param_size, **kw)
    value = networks.make_value_network(
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=value_hidden_layer_sizes,
        generator=generator,
        device=device,
    )
    return PPOImitationNetworks(policy, value, dist)


def make_inference_fn(ppo_networks: PPOImitationNetworks):
    """Policy factory for acting: make_policy(normalizer_params,
    deterministic) -> policy(obs, key) -> (action, extras)."""

    def make_policy(params: Any, deterministic: bool = False) -> types.Policy:
        dist = ppo_networks.parametric_action_distribution

        @torch.no_grad()
        def policy(observations: torch.Tensor, key: Optional[torch.Generator] = None):
            if deterministic:
                logits, latent_mean, latent_logvar = ppo_networks.policy_network(params, observations, None)
                return dist.mode(logits), {"latent_mean": latent_mean, "latent_logvar": latent_logvar}
            logits, latent_mean, latent_logvar = ppo_networks.policy_network(params, observations, key)
            raw_actions = dist.sample_no_postprocessing(logits, key)
            log_prob = dist.log_prob(logits, raw_actions)
            extras = {
                "latent_mean": latent_mean,
                "latent_logvar": latent_logvar,
                "log_prob": log_prob,
                "raw_action": raw_actions,
                "logits": logits,
            }
            return dist.postprocess(raw_actions), extras

        return policy

    return make_policy
