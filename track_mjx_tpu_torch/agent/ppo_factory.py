"""PPO network bundle, inference factory and the flax weight converter.

Port of track_mjx_tpu/agent/ppo_factory.py, for both pipelines.

- `make_intention_ppo_networks` builds the intention policy (feed-forward
  decoder, or with `recurrent_decoder` the LSTM decoder), the value MLP and
  the NormalTanh action distribution; the networks are `nn.Module`s whose
  weights come from flax's initializers, drawn from `generator`.
- `make_inference_fn(networks)(normalizer_params, deterministic,
  get_activation=False, compute_dtype=None)` returns `policy(obs, key) ->
  (action, extras)`,
  the network body in `compute_dtype` where given (the trainers'
  `rollout_bf16`; outputs float32, agent/intention.py), under `torch.no_grad()` (a
  rollout's actions; a trainer's loss recomputes what it differentiates).
  `key` is a `torch.Generator` or a `types.PolicyNoise`. The JAX policy
  splits its key into one key for the network's latent and one for the
  action; the port draws the latent noise [B, latents] first, then the
  action noise [B, action_size]. Deterministic extras: latent_mean and
  latent_logvar; stochastic extras add log_prob, raw_action and logits.
  With `recurrent=True` the policy is `policy(obs, key, carry) -> (action,
  extras, carry')`; its latent is the mean, so it draws only the action
  noise (of a `PolicyNoise`, the `action` field). With `get_activation`
  the extras also carry `activations`, the policy's taps
  (agent/intention.py), deterministic or not; without it they carry no
  such key, where the JAX stochastic extras hold `activations: None`.
- `make_decoder_policy_fn(ckpt_path, step)` is the deterministic
  decoder-only policy of a checkpoint (`policy(x) -> (action, extras)`,
  x = [latent, egocentric obs]): the feed-forward decoder's weights and
  the egocentric slice of the normalizer, for `envs.wrappers.HighLevelWrapper`.
- `params_from_flax` carries the JAX package's parameters across (an
  LSTM cell's eight gate Dense layers stacked into its `weight_ih`,
  `weight_hh` and `bias_hh`), and `optimizer_state_from_optax` its Adam
  moments and count, behind the global-norm clip or plain.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from track_mjx_tpu_torch.agent import distribution, networks, running_statistics, types
from track_mjx_tpu_torch.agent.intention import (
    make_decoder_only_policy,
    make_feedforward_intention_policy,
    make_recurrent_intention_policy,
)
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
    hidden_state_size: int = 128,
    hidden_layer_num: int = 2,
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
    if recurrent_decoder:
        policy = make_recurrent_intention_policy(
            dist.param_size, hidden_state_size=hidden_state_size, hidden_layer_num=hidden_layer_num, **kw
        )
    else:
        policy = make_feedforward_intention_policy(dist.param_size, **kw)
    value = networks.make_value_network(
        observation_size,
        preprocess_observations_fn=preprocess_observations_fn,
        hidden_layer_sizes=value_hidden_layer_sizes,
        generator=generator,
        device=device,
    )
    return PPOImitationNetworks(policy, value, dist)


def make_inference_fn(ppo_networks: PPOImitationNetworks, recurrent: bool = False):
    """Policy factory for acting: make_policy(normalizer_params,
    deterministic) -> policy(obs, key) -> (action, extras), or with
    `recurrent` policy(obs, key, carry) -> (action, extras, carry')."""

    def make_policy(
        params: Any,
        deterministic: bool = False,
        compute_dtype: Optional[torch.dtype] = None,
        get_activation: bool = False,
    ) -> types.Policy:
        dist = ppo_networks.parametric_action_distribution

        def policy_network(*args):
            out = ppo_networks.policy_network(*args, compute_dtype=compute_dtype, get_activation=get_activation)
            return out if get_activation else (*out, None)

        def with_taps(extras: dict, taps) -> dict:
            if get_activation:
                extras["activations"] = taps
            return extras

        if recurrent:

            @torch.no_grad()
            def recurrent_policy(observations: torch.Tensor, key: types.Key, carry):
                logits, latent_mean, latent_logvar, carry, taps = policy_network(params, observations, carry)
                extras = with_taps({"latent_mean": latent_mean, "latent_logvar": latent_logvar}, taps)
                if deterministic:
                    return dist.mode(logits), extras, carry
                action_noise = key.action if isinstance(key, types.PolicyNoise) else key
                raw_actions = dist.sample_no_postprocessing(logits, action_noise)
                extras.update(log_prob=dist.log_prob(logits, raw_actions), raw_action=raw_actions, logits=logits)
                return dist.postprocess(raw_actions), extras, carry

            return recurrent_policy

        @torch.no_grad()
        def policy(observations: torch.Tensor, key: types.Key = None):
            if deterministic:
                logits, latent_mean, latent_logvar, taps = policy_network(params, observations, None)
                extras = with_taps({"latent_mean": latent_mean, "latent_logvar": latent_logvar}, taps)
                return dist.mode(logits), extras
            if isinstance(key, types.PolicyNoise):
                latent_noise, action_noise = key.latent, key.action
            else:  # one generator: the latent's draw, then the action's
                latent_noise = action_noise = key
            logits, latent_mean, latent_logvar, taps = policy_network(params, observations, latent_noise)
            raw_actions = dist.sample_no_postprocessing(logits, action_noise)
            log_prob = dist.log_prob(logits, raw_actions)
            extras = {
                "latent_mean": latent_mean,
                "latent_logvar": latent_logvar,
                "log_prob": log_prob,
                "raw_action": raw_actions,
                "logits": logits,
            }
            return dist.postprocess(raw_actions), with_taps(extras, taps)

        return policy

    return make_policy


class PPOParams(NamedTuple):
    """The port's network state: the normalizer and the two modules'
    state dicts."""

    normalizer: running_statistics.RunningStatisticsState
    policy: dict
    value: dict


LSTM_GATES = ("i", "f", "g", "o")  # flax's gate names, torch's row order


def _array(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32))


def _state_dict(tree: Mapping, prefix: str) -> dict:
    """A flax parameter tree ({"params": {...}} or its content) as a torch
    state dict: Dense kernels (in, out) become Linear weights (out, in),
    LayerNorm scales become weights, an LSTM cell's gate kernels stack into
    `weight_ih` and `weight_hh` and its hidden-side biases into `bias_hh`,
    names join with dots."""
    tree = tree.get("params", tree)
    out = {}

    def walk(node, path):
        if "hi" in node and "ii" in node:  # a flax LSTMCell
            for side, name in (("i", "weight_ih"), ("h", "weight_hh")):
                out[f"{path}.{name}"] = torch.cat([_array(node[side + g]["kernel"]).T for g in LSTM_GATES])
            out[f"{path}.bias_hh"] = torch.cat([_array(node["h" + g]["bias"]) for g in LSTM_GATES])
        elif "kernel" in node:
            out[path + ".weight"] = _array(node["kernel"]).T.contiguous()
            if "bias" in node:
                out[path + ".bias"] = _array(node["bias"])
        elif "scale" in node:
            out[path + ".weight"] = _array(node["scale"])
            out[path + ".bias"] = _array(node["bias"])
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
    and step `count`: those of the MLP trainer's `chain(clip, adam)` state's
    Adam, or of the LSTM trainer's plain `adam` state. Load it with
    `optimizer.load_state_dict`."""
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


def make_decoder_policy_fn(ckpt_path: str, step: Optional[int] = None, device: torch.device | str = "cuda"):
    """The deterministic decoder-only policy of a checkpoint of the MLP
    pipeline: `policy(x) -> (action, extras)`, x = [latent, egocentric obs]
    [B, intention_size + observation_size - reference_obs_size], the
    normalizer's egocentric slice on the egocentric part (the JAX
    reference builds no LSTM counterpart either)."""
    from track_mjx_tpu_torch.agent import checkpointing

    cfg = checkpointing.load_config_from_checkpoint(ckpt_path, step=step)
    if bool(cfg["train_setup"]["train_config"].get("use_lstm", False)):
        raise NotImplementedError("make_decoder_policy_fn: the LSTM pipeline's decoder is recurrent; the MLP one's only")
    net = cfg["network_config"]
    ref = net["reference_obs_size"]
    normalizer, params = checkpointing.load_policy(ckpt_path, cfg, step=step, device=device)
    dist = distribution.NormalTanhDistribution(event_size=net["action_size"])
    decoder = make_decoder_only_policy(
        dist.param_size,
        decoder_obs_size=net["observation_size"] - ref + net["intention_size"],
        preprocess_observations_fn=running_statistics.normalize,
        decoder_hidden_layer_sizes=net["decoder_layer_sizes"],
        device=device,
    )
    prefix = "module.decoder."
    decoder.decoder.load_state_dict({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)})
    decoder_normalizer = running_statistics.RunningStatisticsState(
        count=torch.zeros((), device=normalizer.mean.device),
        mean=normalizer.mean[ref:],
        summed_variance=normalizer.summed_variance[ref:],
        std=normalizer.std[ref:],
    )

    @torch.no_grad()
    def policy(observations: torch.Tensor):
        logits, extras = decoder(decoder_normalizer, observations)
        return dist.mode(logits), extras

    return policy
