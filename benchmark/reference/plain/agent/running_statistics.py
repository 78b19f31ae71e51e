"""Running observation statistics: state, Welford update, normalize and
denormalize.

Port of track_mjx_tpu/agent/running_statistics.py. The state holds one flat
observation's statistics as float32 tensors; `update` reduces over every
leading batch dim of its batch on the batch's device, and with a `group`
(a `parallel.mesh.Mesh`: the batch spread over its ranks) over the whole
global batch, as the JAX trainer's update under its mesh does: the count
and the sum of the differences to the old mean are all-reduced, then the
summed cross terms against the new mean. Every rank ends with the same
state, the one-process state of the concatenated batch up to the order of
the sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from benchmark.reference.plain.parallel import mesh


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


def update(
    state: RunningStatisticsState,
    batch: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    std_min_value: float = 1e-6,
    std_max_value: float = 1e6,
    validate_shapes: bool = True,
    mask: Optional[torch.Tensor] = None,
    group: Optional[mesh.Mesh] = None,
) -> RunningStatisticsState:
    """Welford update over all leading batch dims of `batch` [..., size],
    and with `group` over every rank's batch (module docstring).

    `weights` (shaped like the batch dims) weight each sample; dims where
    `mask` > 0 keep their old statistics."""
    batch_dims = tuple(batch.shape[: batch.dim() - state.mean.dim()])
    if validate_shapes and tuple(batch.shape[len(batch_dims):]) != tuple(state.mean.shape):
        raise ValueError(f"batch {tuple(batch.shape)} does not end in {tuple(state.mean.shape)}")
    axes = tuple(range(len(batch_dims)))
    step_increment = float(math.prod(batch_dims)) if weights is None else weights.sum()
    diff_to_old_mean = batch - state.mean
    if weights is not None:
        diff_to_old_mean = diff_to_old_mean * weights.reshape(weights.shape + (1,) * (batch.dim() - weights.dim()))
    diff_sum = diff_to_old_mean.sum(axes)
    if group is not None:
        step_increment, diff_sum = mesh.all_reduce_sum(
            [torch.as_tensor(step_increment, dtype=torch.float32, device=batch.device), diff_sum], group
        )
    count = state.count + step_increment

    new_mean = state.mean + diff_sum / count
    variance_update = (diff_to_old_mean * (batch - new_mean)).sum(axes)
    if group is not None:
        (variance_update,) = mesh.all_reduce_sum([variance_update], group)
    # the cross-term sum is non-negative only in exact arithmetic: a constant
    # dim can drive it below zero in float32, and sqrt would NaN its std
    new_summed_variance = torch.clamp(state.summed_variance + variance_update, min=0.0)
    new_std = torch.clamp(torch.sqrt(new_summed_variance / count), std_min_value, std_max_value)

    if mask is not None:
        keep = mask > 0
        new_mean = torch.where(keep, state.mean, new_mean)
        new_summed_variance = torch.where(keep, state.summed_variance, new_summed_variance)
        new_std = torch.where(keep, state.std, new_std)
    return RunningStatisticsState(count=count, mean=new_mean, summed_variance=new_summed_variance, std=new_std)


def pin_tail(state: RunningStatisticsState, pinned: RunningStatisticsState) -> RunningStatisticsState:
    """`state` with the last len(pinned.mean) entries of its mean, summed
    variance and std set to `pinned`'s (the decoder-transfer trainer's
    proprioceptive slice); the count stays `state`'s."""
    n = pinned.mean.shape[0]
    return state.replace(
        **{k: torch.cat([getattr(state, k)[:-n], getattr(pinned, k)]) for k in ("mean", "summed_variance", "std")}
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
