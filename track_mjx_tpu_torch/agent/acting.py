"""Rollout collection: one policy and env step, and the unroll.

Port of `actor_step` and `generate_unroll` of track_mjx_tpu/agent/acting.py.
The JAX scan over `unroll_length` becomes a Python loop, and its stacked
outputs a Transition of [T, B, ...] tensors. `key` is a `torch.Generator`
the policy draws from step after step (where the JAX package splits its key
once per step), or a sequence of one policy key per step.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from track_mjx_tpu_torch.agent import types
from track_mjx_tpu_torch.envs.base import Env, State


def _record(env_state: State, nstate: State, actions, policy_extras, extra_fields) -> types.Transition:
    """The Transition of one step."""
    return types.Transition(
        observation=env_state.obs,
        action=actions,
        reward=nstate.reward,
        discount=1 - nstate.done,
        next_observation=nstate.obs,
        extras={
            "policy_extras": policy_extras,
            "state_extras": {x: nstate.info[x] for x in extra_fields},
        },
    )


def actor_step(
    env: Env,
    env_state: State,
    policy: types.Policy,
    key: types.Key,
    extra_fields: Sequence[str] = (),
) -> Tuple[State, types.Transition]:
    """One policy+env step, emitting a Transition."""
    actions, policy_extras = policy(env_state.obs, key)
    nstate = env.step(env_state, actions)
    return nstate, _record(env_state, nstate, actions, policy_extras, extra_fields)


def _stack(items: list):
    """Stacks a list of equal nests of tensors along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([it[i] for it in items]) for i in range(len(first))))
    raise TypeError(f"cannot stack {type(first)}")


def generate_unroll(
    env: Env,
    env_state: State,
    policy: types.Policy,
    key: Union[torch.Generator, Sequence[types.Key]],
    unroll_length: int,
    extra_fields: Sequence[str] = (),
) -> Tuple[State, types.Transition]:
    """Collects `unroll_length` transitions, stacked [T, B, ...]."""
    if not isinstance(key, torch.Generator) and len(key) != unroll_length:
        raise ValueError(f"{len(key)} step keys for an unroll of {unroll_length}")
    transitions = []
    state = env_state
    for t in range(unroll_length):
        step_key = key if isinstance(key, torch.Generator) else key[t]
        state, transition = actor_step(env, state, policy, step_key, extra_fields=extra_fields)
        transitions.append(transition)
    return state, _stack(transitions)
