"""Environment core types: State, the Env/Wrapper protocol and the registry.

Port of track_mjx_tpu/envs/base.py. An env here steps a whole batch: every
tensor of a `State` is batch-first, [B, ...], where the JAX package steps
one env and vectorizes with `jax.vmap` (so the port has no VmapWrapper).
`map_tensors` stands in for `jax.tree.map` over states, clips and infos.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Applies `fn` to every tensor of a nest of dataclasses, dicts, lists,
    tuples and named tuples; other leaves (ints, None) pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(
            tree, **{f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)}
        )
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


@dataclasses.dataclass(frozen=True)
class State:
    """Environment state of a batch of envs carried through a rollout."""

    pipeline_state: Any
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    metrics: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **changes) -> "State":
        return dataclasses.replace(self, **changes)


class Env:
    """Minimal env interface (batched: reset makes `batch_size` envs)."""

    def reset(self, rng: torch.Generator, batch_size: int) -> State:
        raise NotImplementedError

    def step(self, state: State, action: torch.Tensor) -> State:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError

    @property
    def unwrapped(self) -> "Env":
        return self


class Wrapper(Env):
    """Delegating wrapper base (attribute fallthrough like brax Wrapper). A
    wrapper's work on a fresh state goes in `on_reset`, which both `reset`
    (random draws) and `reset_from_clip` (given inputs) apply."""

    def __init__(self, env: Env):
        self.env = env

    def on_reset(self, state: State) -> State:
        return state

    def reset(self, rng: torch.Generator, batch_size: int) -> State:
        return self.on_reset(self.env.reset(rng, batch_size))

    def reset_from_clip(self, *args, **kwargs) -> State:
        return self.on_reset(self.env.reset_from_clip(*args, **kwargs))

    def step(self, state: State, action: torch.Tensor) -> State:
        return self.env.step(state, action)

    @property
    def observation_size(self) -> int:
        return self.env.observation_size

    @property
    def action_size(self) -> int:
        return self.env.action_size

    @property
    def unwrapped(self) -> Env:
        return self.env.unwrapped

    def __getattr__(self, name: str):
        if name in ("__setstate__", "env"):
            raise AttributeError(name)
        return getattr(self.env, name)


_ENV_REGISTRY: Dict[str, Any] = {}


def register_environment(name: str, ctor) -> None:
    """Registers an env constructor under a name."""
    _ENV_REGISTRY[name] = ctor


def get_environment(name: str, **kwargs) -> Env:
    """Instantiates a registered environment."""
    if name not in _ENV_REGISTRY:
        raise KeyError(f"unknown env '{name}'; registered: {sorted(_ENV_REGISTRY)}")
    return _ENV_REGISTRY[name](**kwargs)
