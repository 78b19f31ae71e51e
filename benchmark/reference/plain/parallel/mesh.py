"""One-process stand-ins for the port's parallel/mesh.py.

The benchmark's cells train on one card, so no collective runs: the frozen
copy keeps the names its other modules use, and every caller takes the
one-process path (no mesh, no shard, draws from a `torch.Generator`)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class Mesh:
    """Never made here: every caller passes None."""


class Rows:
    """Never made here: draws come from a `torch.Generator`."""


class BatchShard:
    """Never made here: a minibatch is whole on the one process."""


Key = torch.Generator


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """The tensors themselves: one process."""
    if mesh is not None:
        raise ValueError("the reference runs on one process")
    return list(tensors)


def rand(rng: Key, shape: Sequence[int], device) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=rng, device=device)


def randn(rng: Key, shape: Sequence[int], device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=rng, device=device, dtype=dtype)


def randint(rng: Key, low: int, high: int, shape: Sequence[int], device) -> torch.Tensor:
    return torch.randint(low, high, tuple(shape), generator=rng, device=device)
