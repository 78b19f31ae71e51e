"""Dense layers with flax's initializers, the MLP and the value network.

Port of track_mjx_tpu/agent/networks.py. Layers are `torch.nn.Linear`
named as the flax modules name their `Dense` layers (`hidden_i`).

Initialization follows flax, not `torch.nn.Linear`'s default: kernels
`lecun_uniform` (U(-sqrt(3 / fan_in), +sqrt(3 / fan_in))) unless a layer
asks for `lecun_normal` (a normal of std sqrt(1 / fan_in) / 0.8796...
truncated at two of those stds, flax's default Dense init), biases zero.
Weights are drawn on the CPU from the caller's generator, so a seed gives
the same weights on every device; the streams differ from JAX's.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.plain.agent import types
from benchmark.reference.plain.physics.model import _device

ActivationFn = Callable[[torch.Tensor], torch.Tensor]

# std of a standard normal truncated to [-2, 2] (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


def lecun_uniform_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax lecun_uniform on a Linear weight (out, in): fan_in = in."""
    limit = math.sqrt(3.0 / weight.shape[1])
    with torch.no_grad():
        return nn.init.uniform_(weight, -limit, limit, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax lecun_normal on a Linear weight (out, in): a normal of std
    sqrt(1 / fan_in) / 0.8796..., truncated at two of those stds."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNCATED_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(
    in_size: int,
    out_size: int,
    generator: Optional[torch.Generator] = None,
    init: Callable = lecun_uniform_,
    bias: bool = True,
) -> nn.Linear:
    """A float32 Linear on the CPU with a flax initializer and zero bias."""
    layer = nn.Linear(in_size, out_size, bias=bias)
    init(layer.weight, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Vanilla MLP (brax parity: bias, optional final activation)."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        activation: ActivationFn = F.relu,
        activate_final: bool = False,
        bias: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.activate_final = activate_final
        sizes = [in_size, *layer_sizes]
        self.layers = []  # registered by flax's names, hidden_i
        for i in range(len(layer_sizes)):
            self.add_module(f"hidden_{i}", dense(sizes[i], sizes[i + 1], generator, bias=bias))
            self.layers.append(getattr(self, f"hidden_{i}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != last or self.activate_final:
                x = self.activation(x)
        return x


class ValueNetwork(nn.Module):
    """Value MLP with observation preprocessing; returns [B]."""

    def __init__(self, mlp: MLP, preprocess_observations_fn: types.PreprocessObservationFn):
        super().__init__()
        self.mlp = mlp
        self.preprocess_observations_fn = preprocess_observations_fn

    def forward(self, processor_params, obs: torch.Tensor) -> torch.Tensor:
        obs = self.preprocess_observations_fn(obs, processor_params)
        return self.mlp(obs).squeeze(-1)


def make_value_network(
    obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    hidden_layer_sizes: Sequence[int] = (256, 256),
    activation: ActivationFn = F.silu,
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> ValueNetwork:
    """Value MLP (swish activation, lecun_uniform) on `device`."""
    mlp = MLP(obs_size, list(hidden_layer_sizes) + [1], activation=activation, generator=generator)
    return ValueNetwork(mlp, preprocess_observations_fn).to(_device(device))
