"""PPO objective math: λ-return targets, the loss terms, the latent KLs and
the KL-weight schedules.

Port of track_mjx_tpu/agent/ppo_math.py. Where the JAX loss splits its key
into a latent key and an entropy key, `assemble_ppo_loss` takes the two
standard-normal draws themselves (time-major, [T, B, latents] and
[T, B, action_size]), or a `torch.Generator` to draw them from; so a test
can feed the JAX draws. The advantages are normalized with the population
std (ddof 0, `jnp.std`'s; `torch.std` defaults to ddof 1).

Data parallel (`batch`, a `parallel.mesh.BatchShard`): a rank holds some
rows of the minibatch; the advantages are normalized over the whole
minibatch (all-reduced sums) and every mean is this rank's share of the
mean over the whole minibatch, its sum over the global count, so that the
ranks' loss terms and gradients sum to the one-process ones. The loss
terms (`LOSS_TERMS`) are then those shares, to be summed over the ranks.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from track_mjx_tpu_torch.agent import types
from track_mjx_tpu_torch.agent.distribution import Noise
from track_mjx_tpu_torch.envs.base import map_tensors
from track_mjx_tpu_torch.parallel import mesh

Mean = Callable[[torch.Tensor], torch.Tensor]
# the metrics of `assemble_ppo_loss` that are means over the minibatch
LOSS_TERMS = ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss")


class PPONetworkParams(NamedTuple):
    """Policy and value parameters (state dicts): one optimizer over both."""

    policy: dict
    value: dict


# ---------------------------------------------------------------------------
# λ-return targets
# ---------------------------------------------------------------------------


def gae_targets(
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    *,
    continuation: torch.Tensor,
    valid: torch.Tensor,
    lambda_: float,
    discount: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TD(λ) value targets and one-step advantages against them, detached.

    All inputs time-major, [T, ...]. `continuation` is 0 on a true
    termination, `valid` 0 where the unroll crossed a truncation. The
    recursion runs backwards over T with the per-step weight
    w_t = λ·γ·continuation_t·valid_t."""
    with torch.no_grad():
        future = torch.cat([values[1:], bootstrap_value[None]], dim=0)
        carry = discount * continuation
        residual = (rewards + carry * future - values) * valid
        fold_w = lambda_ * carry * valid
        acc = torch.zeros_like(bootstrap_value)
        gae = [None] * rewards.shape[0]
        for t in range(rewards.shape[0] - 1, -1, -1):
            acc = residual[t] + fold_w[t] * acc
            gae[t] = acc
        targets = torch.stack(gae) + values
        future_targets = torch.cat([targets[1:], bootstrap_value[None]], dim=0)
        advantages = (rewards + carry * future_targets - values) * valid
    return targets, advantages


# ---------------------------------------------------------------------------
# loss terms
# ---------------------------------------------------------------------------


def clipped_surrogate(
    target_log_prob: torch.Tensor,
    behavior_log_prob: torch.Tensor,
    advantages: torch.Tensor,
    epsilon: float,
    mean: Mean = torch.mean,
) -> torch.Tensor:
    """PPO-clip policy objective (negated: a loss)."""
    ratio = torch.exp(target_log_prob - behavior_log_prob)
    clipped = torch.clamp(ratio, 1.0 - epsilon, 1.0 + epsilon)
    return -mean(torch.minimum(ratio * advantages, clipped * advantages))


def value_objective(targets: torch.Tensor, baseline: torch.Tensor, mean: Mean = torch.mean) -> torch.Tensor:
    """0.25 · MSE, the reference's halved half-quadratic."""
    return 0.25 * mean(torch.square(targets - baseline))


def gaussian_kl_ar1(
    mean: torch.Tensor, logvar: torch.Tensor, alpha: float = 0.95, reduce: Mean = torch.mean
) -> torch.Tensor:
    """Mean KL(q_t ‖ p_t) under the AR(1) latent prior over the time axis 0:
    p(z_0) = N(0, I), p(z_t | z_{t-1}) = N(α·mean_{t-1}, (1-α²)·I)."""
    prior_mean = torch.cat([torch.zeros_like(mean[:1]), alpha * mean[:-1]], dim=0)
    shape = (mean.shape[0],) + (1,) * (mean.dim() - 1)
    prior_var = torch.full(shape, 1.0 - alpha * alpha, dtype=mean.dtype, device=mean.device)
    prior_var[0] = 1.0
    kl = (
        torch.exp(logvar) / prior_var
        + torch.square(mean - prior_mean) / prior_var
        - 1.0
        + torch.log(prior_var)
        - logvar
    )
    return 0.5 * reduce(kl)


def gaussian_kl_standard(mean: torch.Tensor, logvar: torch.Tensor, reduce: Mean = torch.mean) -> torch.Tensor:
    """Mean KL(q ‖ N(0, I))."""
    return 0.5 * reduce(torch.exp(logvar) + torch.square(mean) - 1.0 - logvar)


# ---------------------------------------------------------------------------
# assembled loss
# ---------------------------------------------------------------------------

# (normalizer_params, time-major Transition, latent noise) -> (logits,
# latent_mean, latent_logvar): the pipeline's differentiable policy forward
PolicyForward = Callable[[Any, types.Transition, Noise], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def time_major(data: types.Transition) -> types.Transition:
    """Swaps the two leading axes of every tensor of a Transition."""
    return map_tensors(lambda x: x.transpose(0, 1), data)


def assemble_ppo_loss(
    normalizer_params: Any,
    data: types.Transition,
    latent_noise: Noise,
    entropy_noise: Noise,
    *,
    ppo_network,
    policy_forward: PolicyForward,
    latent_kl: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    kl_weight: Union[float, torch.Tensor],
    entropy_cost: float,
    discounting: float,
    reward_scaling: float,
    gae_lambda: float,
    clipping_epsilon: float,
    normalize_advantage: bool,
    batch: Optional[mesh.BatchShard] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The PPO loss over a batch-major Transition [B, T, ...], differentiable
    in the parameters of `ppo_network`'s modules. It is swapped to
    time-major once, for every consumer. A generator given as a noise is
    drawn from latent first, then entropy. With `batch` the rows are this
    rank's of a minibatch spread over the ranks (module docstring)."""
    mean = torch.mean if batch is None else batch.mean
    dist = ppo_network.parametric_action_distribution
    data = time_major(data)
    logits, latent_mean, latent_logvar = policy_forward(normalizer_params, data, latent_noise)
    value_apply = ppo_network.value_network
    baseline = value_apply(normalizer_params, data.observation)
    bootstrap = value_apply(normalizer_params, data.next_observation[-1])

    valid = 1.0 - data.extras["state_extras"]["truncation"]
    continuation = 1.0 - (1.0 - data.discount) * valid
    targets, advantages = gae_targets(
        data.reward * reward_scaling,
        baseline,
        bootstrap,
        continuation=continuation,
        valid=valid,
        lambda_=gae_lambda,
        discount=discounting,
    )
    if normalize_advantage and batch is None:
        advantages = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
    elif normalize_advantage:
        advantages = batch.normalize(advantages)

    policy_loss = clipped_surrogate(
        dist.log_prob(logits, data.extras["policy_extras"]["raw_action"]),
        data.extras["policy_extras"]["log_prob"],
        advantages,
        clipping_epsilon,
        mean,
    )
    v_loss = value_objective(targets, baseline, mean)
    entropy_loss = -entropy_cost * mean(dist.entropy(logits, entropy_noise))
    kl_latent_loss = kl_weight * latent_kl(latent_mean, latent_logvar, reduce=mean)

    total = policy_loss + v_loss + entropy_loss + kl_latent_loss
    return total, {
        "total_loss": total,
        "policy_loss": policy_loss,
        "v_loss": v_loss,
        "kl_latent_loss": kl_latent_loss,
        "entropy_loss": entropy_loss,
    }


# ---------------------------------------------------------------------------
# KL-weight schedules
# ---------------------------------------------------------------------------


def create_ramp_schedule(
    max_value: float = 0.1,
    min_value: float = 0.0001,
    ramp_steps: int = 1000,
    warmup_steps: int = 0,
    schedule: str = "linear",
    period: int = 45,
) -> Callable[[Any], torch.Tensor]:
    """KL-weight schedule of a step: a warmup-gated linear ramp, its
    fraction clipped to [min_value, 1], or a wave around the midpoint
    (offset by min_value). The step is taken as a float32 tensor, so a ramp
    of 0 steps divides to inf (the full weight) as in the JAX package."""

    def linear(step):
        frac = torch.clamp((step - warmup_steps) / ramp_steps, min_value, 1.0)
        return torch.where(step < warmup_steps, torch.full_like(step, min_value), frac * max_value)

    def wave(step, phase):
        half_span = 0.5 * (max_value - min_value)
        center = 0.5 * (max_value + min_value) + min_value
        return center + half_span * torch.cos(2.0 * math.pi * step / period + phase)

    shapes = {
        "linear": linear,
        "cosine": lambda step: wave(step, 0.0),
        "sine": lambda step: wave(step, -math.pi),  # sin(x - π/2) = cos(x - π)
    }
    if schedule not in shapes:
        raise ValueError(f"schedule must be 'linear', 'cosine', or 'sine', not {schedule}")
    fn = shapes[schedule]
    return lambda step: fn(torch.as_tensor(step, dtype=torch.float32))
