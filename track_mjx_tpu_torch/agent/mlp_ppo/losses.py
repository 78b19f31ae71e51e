"""PPO loss of the MLP intention pipeline.

Port of track_mjx_tpu/agent/mlp_ppo/losses.py: a direct, differentiable
policy forward over the stored observations (`policy_network(normalizer,
obs, noise)`, not the inference policy, which runs under `no_grad`) and the
AR(1) latent prior with a scheduled KL weight. Where the JAX loss splits its
`rng`, this one takes the latent noise [T, B, latents] and the entropy
noise [T, B, action_size] (or one generator to draw both from).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from track_mjx_tpu_torch.agent import ppo_math, types
from track_mjx_tpu_torch.agent.distribution import Noise
from track_mjx_tpu_torch.parallel import mesh
from track_mjx_tpu_torch.agent.ppo_math import (  # noqa: F401  (public API)
    PPONetworkParams,
    create_ramp_schedule,
)


def compute_gae(
    truncation: torch.Tensor,
    termination: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    lambda_: float = 1.0,
    discount: float = 0.99,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncation-masked TD(λ) targets (time-major [T, B] inputs)."""
    return ppo_math.gae_targets(
        rewards,
        values,
        bootstrap_value,
        continuation=1.0 - termination,
        valid=1.0 - truncation,
        lambda_=lambda_,
        discount=discount,
    )


def compute_ppo_loss(
    normalizer_params: Any,
    data: types.Transition,
    latent_noise: Noise,
    entropy_noise: Noise,
    step,
    ppo_network,
    entropy_cost: float = 1e-4,
    kl_weight: float = 1e-3,
    discounting: float = 0.9,
    reward_scaling: float = 1.0,
    gae_lambda: float = 0.95,
    clipping_epsilon: float = 0.3,
    normalize_advantage: bool = True,
    kl_schedule: Optional[Callable] = None,
    batch: Optional[mesh.BatchShard] = None,
) -> Tuple[torch.Tensor, types.Metrics]:
    """Clipped surrogate + value + entropy + scheduled AR(1) latent KL over a
    batch-major Transition [B, T, ...] (with `batch`, this rank's rows of a
    minibatch spread over the ranks: `ppo_math`)."""
    if kl_schedule is not None:
        kl_weight = kl_schedule(step)

    def forward(norm_params, tm_data, noise):
        return ppo_network.policy_network(norm_params, tm_data.observation, noise)

    total, metrics = ppo_math.assemble_ppo_loss(
        normalizer_params,
        data,
        latent_noise,
        entropy_noise,
        ppo_network=ppo_network,
        policy_forward=forward,
        latent_kl=ppo_math.gaussian_kl_ar1,
        kl_weight=kl_weight,
        entropy_cost=entropy_cost,
        discounting=discounting,
        reward_scaling=reward_scaling,
        gae_lambda=gae_lambda,
        clipping_epsilon=clipping_epsilon,
        normalize_advantage=normalize_advantage,
        batch=batch,
    )
    metrics["kl_weight"] = torch.as_tensor(kl_weight, dtype=torch.float32, device=total.device)
    return total, metrics
