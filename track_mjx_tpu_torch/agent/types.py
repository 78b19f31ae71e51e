"""Shared agent-layer types.

Port of track_mjx_tpu/agent/types.py. A JAX PRNG key becomes either a
`torch.Generator`, from which a policy draws its noise, or the noise itself
(`PolicyNoise`), which lets a caller feed the exact draws of another run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

Observation = torch.Tensor
Action = torch.Tensor
Extra = Dict[str, Any]
Metrics = Dict[str, Any]
PreprocessObservationFn = Callable[[Observation, Any], Observation]


class PolicyNoise(NamedTuple):
    """The standard-normal draws of one stochastic policy step: the
    intention's reparameterization noise [B, latents] and the action's
    [B, action_size]."""

    latent: torch.Tensor
    action: torch.Tensor


Key = Union[torch.Generator, PolicyNoise, None]
Policy = Callable[[Observation, Key], Tuple[Action, Extra]]


def identity_observation_preprocessor(observation: Observation, params: Optional[Any]):
    """No-op observation preprocessor."""
    del params
    return observation


class Transition(NamedTuple):
    """Rollout transition (brax layout: extras carries policy/state extras)."""

    observation: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    discount: torch.Tensor
    next_observation: torch.Tensor
    extras: Mapping[str, Any] = ()
