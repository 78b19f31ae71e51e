"""Running observation statistics: state, normalize and denormalize.

Port of the inference half of track_mjx_tpu/agent/running_statistics.py
(the Welford `update` comes with the trainer). The state holds one flat
observation's statistics as float32 tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RunningStatisticsState:
    """Welford state: count, mean, summed variance and std."""

    count: torch.Tensor
    mean: torch.Tensor
    summed_variance: torch.Tensor
    std: torch.Tensor

    def replace(self, **changes) -> "RunningStatisticsState":
        return dataclasses.replace(self, **changes)


def init_state(size: int, device: torch.device | str = "cuda") -> RunningStatisticsState:
    """Zero statistics (std one) of a [size] observation on `device`."""
    zeros = torch.zeros((size,), dtype=torch.float32, device=device)
    return RunningStatisticsState(
        count=torch.zeros((), dtype=torch.float32, device=device),
        mean=zeros,
        summed_variance=zeros.clone(),
        std=torch.ones_like(zeros),
    )


def normalize(batch: torch.Tensor, mean_std: RunningStatisticsState, max_abs_value=None):
    """(x - mean) / std, optionally clipped to +-max_abs_value."""
    data = (batch - mean_std.mean) / mean_std.std
    if max_abs_value is not None:
        data = torch.clamp(data, -max_abs_value, max_abs_value)
    return data


def denormalize(batch: torch.Tensor, mean_std: RunningStatisticsState):
    """x * std + mean."""
    return batch * mean_std.std + mean_std.mean
