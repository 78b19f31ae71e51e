"""Action distributions: tanh-squashed diagonal Normal.

Port of track_mjx_tpu/agent/distribution.py (brax's NormalTanhDistribution):
param_size = 2 * event_size, scale = (softplus(raw) + min_std) * var_scale,
tanh postprocessing with the softplus-form log-det-jacobian, and a
sample-estimated entropy. Sampling takes standard-normal noise shaped like
the distribution's loc, or a `torch.Generator` to draw it from (or a
`parallel.mesh.Rows`: this rank's rows of a draw at the global batch size).
"""

from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn.functional as F

from benchmark.reference.plain.parallel import mesh

Noise = Union[torch.Tensor, torch.Generator, mesh.Rows]


def standard_normal(noise: Noise, like: torch.Tensor) -> torch.Tensor:
    """`noise` itself, or a standard-normal draw shaped like `like` from the
    generator (or the Rows) `noise`."""
    if isinstance(noise, (torch.Generator, mesh.Rows)):
        return mesh.randn(noise, like.shape, like.device, like.dtype)
    return noise


class NormalDistribution:
    """Diagonal Gaussian."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    def sample(self, noise: Noise):
        return standard_normal(noise, self.loc) * self.scale + self.loc

    def mode(self):
        return self.loc

    def log_prob(self, x):
        log_unnormalized = -0.5 * torch.square(x / self.scale - self.loc / self.scale)
        log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)
        return log_unnormalized - log_normalization

    def entropy(self):
        log_normalization = 0.5 * math.log(2.0 * math.pi) + torch.log(self.scale)
        entropy = 0.5 + log_normalization
        return entropy * torch.ones_like(self.loc)


class TanhBijector:
    """Tanh squashing bijector."""

    def forward(self, x):
        return torch.tanh(x)

    def inverse(self, y):
        return torch.arctanh(y)

    def forward_log_det_jacobian(self, x):
        # log|d tanh(x)/dx| in the numerically-stable softplus form
        return 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))


class ParametricDistribution:
    """Distribution over a parameter vector, with postprocessing."""

    def __init__(self, param_size, postprocessor, event_ndims, reparametrizable):
        self._param_size = param_size
        self._postprocessor = postprocessor
        self._event_ndims = event_ndims
        self._reparametrizable = reparametrizable
        assert event_ndims in (0, 1)

    def create_dist(self, parameters):
        raise NotImplementedError

    @property
    def param_size(self):
        return self._param_size

    @property
    def reparametrizable(self):
        return self._reparametrizable

    def postprocess(self, event):
        return self._postprocessor.forward(event)

    def inverse_postprocess(self, event):
        return self._postprocessor.inverse(event)

    def sample_no_postprocessing(self, parameters, noise: Noise):
        return self.create_dist(parameters).sample(noise)

    def sample(self, parameters, noise: Noise):
        return self.postprocess(self.sample_no_postprocessing(parameters, noise))

    def mode(self, parameters):
        return self.postprocess(self.create_dist(parameters).mode())

    def log_prob(self, parameters, actions):
        """Log probability of raw (pre-tanh) actions."""
        dist = self.create_dist(parameters)
        log_probs = dist.log_prob(actions)
        log_probs = log_probs - self._postprocessor.forward_log_det_jacobian(actions)
        if self._event_ndims == 1:
            log_probs = log_probs.sum(-1)
        return log_probs

    def entropy(self, parameters, noise: Noise):
        """Sample-estimated entropy of the squashed distribution."""
        dist = self.create_dist(parameters)
        entropy = dist.entropy()
        entropy = entropy + self._postprocessor.forward_log_det_jacobian(dist.sample(noise))
        if self._event_ndims == 1:
            entropy = entropy.sum(-1)
        return entropy


class NormalTanhDistribution(ParametricDistribution):
    """Normal followed by tanh (brax parity)."""

    def __init__(self, event_size, min_std=0.001, var_scale=1.0):
        super().__init__(
            param_size=2 * event_size,
            postprocessor=TanhBijector(),
            event_ndims=1,
            reparametrizable=True,
        )
        self._min_std = min_std
        self._var_scale = var_scale

    def create_dist(self, parameters):
        loc, scale = torch.chunk(parameters, 2, dim=-1)
        scale = (F.softplus(scale) + self._min_std) * self._var_scale
        return NormalDistribution(loc=loc, scale=scale)
