"""PPO network bundle, inference factory and the flax weight converter.

Port of the feed-forward half of track_mjx_tpu/agent/ppo_factory.py.

- `make_intention_ppo_networks` builds the intention policy, the value MLP
  and the NormalTanh action distribution; the networks are `nn.Module`s
  whose weights come from flax's initializers, drawn from `generator`.
- `make_inference_fn(networks)(normalizer_params, deterministic)` returns
  `policy(obs, key) -> (action, extras)`, under `torch.no_grad()` (a
  rollout's actions; a trainer's loss recomputes what it differentiates).
  `key` is a `torch.Generator` or a `types.PolicyNoise`. The JAX policy
  splits its key into one key for the network's latent and one for the
  action; the port draws the latent noise [B, latents] first, then the
  action noise [B, action_size]. Deterministic extras: latent_mean and
  latent_logvar; stochastic extras add log_prob, raw_action and logits.
- `params_from_flax` carries the JAX package's parameters across, and
  `optimizer_state_from_optax` its Adam moments and count.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from track_mjx_tpu_torch.agent import distribution, networks, running_statistics, types
from track_mjx_tpu_torch.agent.intention import make_feedforward_intention_policy
from track_mjx_tpu_torch.physics.model import _device


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
    recurrent_decoder: bool = False,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> PPOImitationNetworks:
    """The intention policy, the value MLP and the NormalTanh distribution,
    their weights drawn on the CPU from `generator` (policy first), then
    moved to `device`."""
    if recurrent_decoder:
        raise NotImplementedError("the LSTM decoder is not ported")
    dist = distribution.NormalTanhDistribution(event_size=action_size)
    policy = make_feedforward_intention_policy(
        dist.param_size,
        latent_size=intention_latent_size,
        total_obs_size=observation_size,
        reference_obs_size=reference_obs_size,
        preprocess_observations_fn=preprocess_observations_fn,
        encoder_hidden_layer_sizes=encoder_hidden_layer_sizes,
        decoder_hidden_layer_sizes=decoder_hidden_layer_sizes,
        generator=generator,
        device=device,
    )
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
        policy_network = ppo_networks.policy_network
        dist = ppo_networks.parametric_action_distribution

        @torch.no_grad()
        def policy(observations: torch.Tensor, key: types.Key = None):
            if deterministic:
                logits, latent_mean, latent_logvar = policy_network(params, observations, None)
                extras = {"latent_mean": latent_mean, "latent_logvar": latent_logvar}
                return dist.mode(logits), extras
            if isinstance(key, types.PolicyNoise):
                latent_noise, action_noise = key.latent, key.action
            else:  # one generator: the latent's draw, then the action's
                latent_noise = action_noise = key
            logits, latent_mean, latent_logvar = policy_network(params, observations, latent_noise)
            raw_actions = dist.sample_no_postprocessing(logits, action_noise)
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


class PPOParams(NamedTuple):
    """The port's network state: the normalizer and the two modules'
    state dicts."""

    normalizer: running_statistics.RunningStatisticsState
    policy: dict
    value: dict


def _state_dict(tree: Mapping, prefix: str) -> dict:
    """A flax parameter tree ({"params": {...}} or its content) as a torch
    state dict: Dense kernels (in, out) become Linear weights (out, in),
    LayerNorm scales become weights, names join with dots."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, path):
        if "kernel" in node:
            out[path + ".weight"] = torch.as_tensor(np.array(node["kernel"], np.float32).T.copy())
            if "bias" in node:
                out[path + ".bias"] = torch.as_tensor(np.array(node["bias"], np.float32))
        elif "scale" in node:
            out[path + ".weight"] = torch.as_tensor(np.array(node["scale"], np.float32))
            out[path + ".bias"] = torch.as_tensor(np.array(node["bias"], np.float32))
        else:
            for name, child in node.items():
                walk(child, f"{path}.{name}" if path else name)

    walk(tree, "")
    return {prefix + k: v for k, v in out.items()}


def params_from_flax(
    policy_params: Mapping,
    value_params: Mapping,
    normalizer: Any,
    device: torch.device | str = "cuda",
) -> PPOParams:
    """The JAX package's flax parameter trees (nested dicts of numpy arrays)
    and normalizer (any object or mapping with count, mean, summed_variance
    and std) as the port's state: load `policy` into
    `networks.policy_network` and `value` into `networks.value_network`
    with `load_state_dict`."""
    device = _device(device)
    get = normalizer.get if isinstance(normalizer, Mapping) else lambda k: getattr(normalizer, k)
    norm = running_statistics.RunningStatisticsState(
        **{
            k: torch.as_tensor(np.array(get(k), np.float32), device=device)
            for k in ("count", "mean", "summed_variance", "std")
        }
    )
    return PPOParams(norm, _state_dict(policy_params, "module."), _state_dict(value_params, "mlp."))


def _tree(x, name: str):
    return x[name] if isinstance(x, Mapping) else getattr(x, name)


def optimizer_state_from_optax(
    count: Any,
    mu: Any,
    nu: Any,
    networks: PPOImitationNetworks,
    optimizer: torch.optim.Optimizer,
) -> dict:
    """The state dict of `optimizer` (a `torch.optim.Adam` over the policy's
    parameters, then the value's, as `gradients.make_optimizer` is given
    them) holding the JAX training state's optax Adam moments `mu` and `nu`
    (PPONetworkParams of flax trees, or mappings with `policy` and `value`)
    and step `count`. Load it with `optimizer.load_state_dict`."""
    named = [(n, p) for n, p in networks.policy_network.named_parameters()]
    named += [(n, p) for n, p in networks.value_network.named_parameters()]
    moments = {}
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        flat = {**_state_dict(_tree(tree, "policy"), "module."), **_state_dict(_tree(tree, "value"), "mlp.")}
        moments[key] = flat
    step = float(np.asarray(count))
    state = {
        i: {
            "step": torch.tensor(step, dtype=torch.float32),
            "exp_avg": moments["exp_avg"][n].to(p.device),
            "exp_avg_sq": moments["exp_avg_sq"][n].to(p.device),
        }
        for i, (n, p) in enumerate(named)
    }
    groups = optimizer.state_dict()["param_groups"]
    if sum(len(g["params"]) for g in groups) != len(named):
        raise ValueError("the optimizer does not hold the policy's and the value's parameters")
    return {"state": state, "param_groups": groups}
