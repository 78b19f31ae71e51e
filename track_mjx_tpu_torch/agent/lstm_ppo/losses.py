"""PPO loss of the LSTM intention pipeline.

Port of track_mjx_tpu/agent/lstm_ppo/losses.py: the policy forward re-unrolls
the recurrent policy over each stored sequence (backpropagation through
time) from the carry that produced its first action (extras "hidden_state"
and "cell_state" at t = 0), the carry zeroed after every step where
1 - discount says an episode ended; the latent prior is a standard normal
with a fixed KL weight (no schedule). The latent is the encoder's mean, so
`latent_noise` goes unused; the signature is the MLP loss's, so that
`mlp_ppo.ppo.Learner` serves both pipelines.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from track_mjx_tpu_torch.agent import ppo_math, types
from track_mjx_tpu_torch.agent.distribution import Noise
from track_mjx_tpu_torch.parallel import mesh
from track_mjx_tpu_torch.agent.mlp_ppo.losses import compute_gae  # noqa: F401  (public API)
from track_mjx_tpu_torch.agent.ppo_math import PPONetworkParams  # noqa: F401  (public API)


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
    """Clipped surrogate + value + entropy + standard-normal latent KL over a
    batch-major Transition [B, T, ...] (with `batch`, this rank's rows of a
    minibatch spread over the ranks: `ppo_math`)."""
    del latent_noise, step, kl_schedule  # z = latent_mean; no KL schedule (reference)

    def forward(norm_params, tm_data, noise):
        carry = (tm_data.extras["hidden_state"][0], tm_data.extras["cell_state"][0])
        keep = tm_data.discount[:, :, None, None]  # 0 where the step ended an episode
        logits, means, logvars = [], [], []
        for t in range(tm_data.observation.shape[0]):
            out = ppo_network.policy_network(norm_params, tm_data.observation[t], carry)
            logits.append(out[0])
            means.append(out[1])
            logvars.append(out[2])
            carry = tuple(s * keep[t] for s in out[3])
        return torch.stack(logits), torch.stack(means), torch.stack(logvars)

    return ppo_math.assemble_ppo_loss(
        normalizer_params,
        data,
        None,
        entropy_noise,
        ppo_network=ppo_network,
        policy_forward=forward,
        latent_kl=ppo_math.gaussian_kl_standard,
        kl_weight=kl_weight,
        entropy_cost=entropy_cost,
        discounting=discounting,
        reward_scaling=reward_scaling,
        gae_lambda=gae_lambda,
        clipping_epsilon=clipping_epsilon,
        normalize_advantage=normalize_advantage,
        batch=batch,
    )
