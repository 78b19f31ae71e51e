"""Intention-bottleneck (CoMic-style VAE) policy with a feed-forward decoder.

A frozen copy of the port's agent/intention.py, cut to what the benchmark's
cells run. The observation is split into its reference slice (what to do)
and its egocentric slice (body state); the reference slice is compressed
into a diagonal-Gaussian intention (encoder), and the decoder maps
[intention, egocentric] to action-distribution parameters.

- trunks are Dense -> silu -> LayerNorm blocks; the decoder's last Dense
  is left raw. LayerNorm uses flax's epsilon, 1e-6 (torch's default is
  1e-5);
- trunk layers and the decoder output start lecun_uniform, the encoder's
  `fc2_mean` and `fc2_logvar` flax's default `lecun_normal`, biases zero;
- the latent is mean + exp(logvar / 2) * noise, with the noise given or
  drawn from a generator, or the mean itself when deterministic.

Module names follow the flax parameter tree: `encoder.trunk.hidden_i`,
`encoder.trunk.LayerNorm_i`, `encoder.fc2_mean`, `encoder.fc2_logvar`,
`decoder.trunk.hidden_i`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.plain.agent import types
from benchmark.reference.plain.agent.distribution import Noise, standard_normal
from benchmark.reference.plain.agent.networks import ActivationFn, dense, lecun_normal_
from benchmark.reference.plain.physics.model import _device

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class NormedTrunk(nn.Module):
    """Stack of Dense -> activation -> LayerNorm blocks; with
    `skip_final_norm` the last Dense is left raw."""

    def __init__(
        self,
        in_size: int,
        widths: Sequence[int],
        activation: ActivationFn = F.silu,
        skip_final_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.skip_final_norm = skip_final_norm
        sizes = [in_size, *widths]
        self.blocks = []  # (Dense, LayerNorm or None), registered by flax's names
        for i, width in enumerate(widths):
            self.add_module(f"hidden_{i}", dense(sizes[i], width, generator))
            norm = None
            if not (skip_final_norm and i == len(widths) - 1):
                norm = nn.LayerNorm(width, eps=LAYER_NORM_EPS)
                self.add_module(f"LayerNorm_{i}", norm)
            self.blocks.append((getattr(self, f"hidden_{i}"), norm))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, norm in self.blocks:
            x = layer(x)
            if norm is not None:
                x = norm(self.activation(x))
        return x


class Encoder(nn.Module):
    """Reference observations -> diagonal-Gaussian intention (mean, logvar)."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        latents: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.trunk = NormedTrunk(in_size, layer_sizes, generator=generator)
        self.fc2_mean = dense(layer_sizes[-1], latents, generator, init=lecun_normal_)
        self.fc2_logvar = dense(layer_sizes[-1], latents, generator, init=lecun_normal_)

    def forward(self, x: torch.Tensor):
        x = self.trunk(x)
        return self.fc2_mean(x), self.fc2_logvar(x)


class Decoder(nn.Module):
    """[intention, egocentric obs] -> action-distribution parameters."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.trunk = NormedTrunk(in_size, layer_sizes, skip_final_norm=True, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(x)


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: Noise) -> torch.Tensor:
    """Reparameterized draw from N(mean, exp(logvar))."""
    return mean + torch.exp(0.5 * logvar) * standard_normal(noise, logvar)


class IntentionPolicy(nn.Module):
    """Encoder + feed-forward decoder with the intention bottleneck between
    them. `forward(obs, noise)` returns (logits, latent_mean,
    latent_logvar); the latent is the mean when `noise` is None."""

    def __init__(
        self,
        total_obs_size: int,
        encoder_layers: Sequence[int],
        decoder_layers: Sequence[int],
        reference_obs_size: int,
        latents: int = 60,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.reference_obs_size = reference_obs_size
        self.encoder = Encoder(reference_obs_size, encoder_layers, latents, generator)
        egocentric = total_obs_size - reference_obs_size
        self.decoder = Decoder(latents + egocentric, decoder_layers, generator)

    def forward(self, obs: torch.Tensor, noise: Optional[Noise] = None):
        reference = obs[..., : self.reference_obs_size]
        egocentric = obs[..., self.reference_obs_size :]
        mean, logvar = self.encoder(reference)
        z = mean if noise is None else sample_latent(mean, logvar, noise)
        logits = self.decoder(torch.cat([z, egocentric], dim=-1))
        return logits, mean, logvar


class NormalizedIntentionPolicy(nn.Module):
    """An intention policy behind the observation normalizer:
    `forward(processor_params, obs, noise)`."""

    def __init__(self, module: nn.Module, preprocess_observations_fn: types.PreprocessObservationFn):
        super().__init__()
        self.module = module
        self.preprocess_observations_fn = preprocess_observations_fn

    def forward(self, processor_params, obs: torch.Tensor, noise: Optional[Noise] = None):
        return self.module(self.preprocess_observations_fn(obs, processor_params), noise)


def make_feedforward_intention_policy(
    action_param_size: int,
    latent_size: int,
    total_obs_size: int,
    reference_obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    encoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    decoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> NormalizedIntentionPolicy:
    """Feed-forward intention policy with normalizer preprocessing, its
    weights drawn on the CPU from `generator`, then moved to `device`."""
    module = IntentionPolicy(
        total_obs_size,
        tuple(encoder_hidden_layer_sizes),
        tuple(decoder_hidden_layer_sizes) + (action_param_size,),
        reference_obs_size,
        latent_size,
        generator,
    )
    return NormalizedIntentionPolicy(module, preprocess_observations_fn).to(_device(device))
