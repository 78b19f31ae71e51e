"""Rollout collection and evaluation: one policy and env step, the unroll,
the eval wrapper and the evaluator.

Port of track_mjx_tpu/agent/acting.py. The JAX scan over `unroll_length`
becomes a Python loop, and its stacked outputs a Transition of [T, B, ...]
tensors. `key` is a `torch.Generator` the policy draws from step after step
(where the JAX package splits its key once per step; or a `parallel.mesh.
Rows`, this rank's rows of that stream), or a sequence of one policy key
per step. The evaluator resets its envs from its own generator.

The recurrent actor (the LSTM pipeline) threads the policy's carry (h, c),
each [B, layers, hidden]: a step records the carry that produced its action
(the loss's re-unroll starts from it) as extras "hidden_state" and
"cell_state", and where the step ended an episode the outgoing carry is
reseeded from the wrapper's info["hidden_state"] (zeros); the carry it
hands on is detached.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from track_mjx_tpu_torch.agent import types
from track_mjx_tpu_torch.envs.base import Env, State, Wrapper
from track_mjx_tpu_torch.parallel import mesh

_STREAMS = (torch.Generator, mesh.Rows)  # a key drawn from step after step


def _record(env_state: State, nstate: State, actions, policy_extras, extra_fields, carry_extras=None) -> types.Transition:
    """The Transition of one step."""
    extras = {
        "policy_extras": policy_extras,
        "state_extras": {x: nstate.info[x] for x in extra_fields},
    }
    if carry_extras:
        extras.update(carry_extras)
    return types.Transition(
        observation=env_state.obs,
        action=actions,
        reward=nstate.reward,
        discount=1 - nstate.done,
        next_observation=nstate.obs,
        extras=extras,
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


def recurrent_actor_step(
    env: Env,
    env_state: State,
    policy,
    key: types.Key,
    carry,
    extra_fields: Sequence[str] = (),
):
    """One step of a recurrent policy, `policy(obs, key, carry) -> (action,
    extras, carry')`: returns (next state, Transition, next carry)."""
    actions, policy_extras, carry_out = policy(env_state.obs, key, carry)
    reseed = env_state.info["hidden_state"]
    nstate = env.step(env_state, actions)
    transition = _record(
        env_state, nstate, actions, policy_extras, extra_fields, {"hidden_state": carry[0], "cell_state": carry[1]}
    )
    done = nstate.done > 0
    next_carry = tuple(
        torch.where(done.reshape((-1,) + (1,) * (live.dim() - 1)), init, live).detach()
        for init, live in zip(reseed, carry_out)
    )
    return nstate, transition, next_carry


def _stack(items: list):
    """Stacks a list of equal nests of tensors along a new leading axis."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack([it[i] for it in items]) for i in range(len(first))))
    if isinstance(first, (tuple, list)):  # e.g. an LSTM carry (h, c) among the activation taps
        return type(first)(_stack([it[i] for it in items]) for i in range(len(first)))
    raise TypeError(f"cannot stack {type(first)}")


def generate_unroll(
    env: Env,
    env_state: State,
    policy: types.Policy,
    key: Union[mesh.Key, Sequence[types.Key]],
    unroll_length: int,
    extra_fields: Sequence[str] = (),
) -> Tuple[State, types.Transition]:
    """Collects `unroll_length` transitions, stacked [T, B, ...]."""
    if not isinstance(key, _STREAMS) and len(key) != unroll_length:
        raise ValueError(f"{len(key)} step keys for an unroll of {unroll_length}")
    transitions = []
    state = env_state
    for t in range(unroll_length):
        step_key = key if isinstance(key, _STREAMS) else key[t]
        state, transition = actor_step(env, state, policy, step_key, extra_fields=extra_fields)
        transitions.append(transition)
    return state, _stack(transitions)


def recurrent_generate_unroll(
    env: Env,
    env_state: State,
    policy,
    key: Union[mesh.Key, Sequence[types.Key]],
    carry,
    unroll_length: int,
    extra_fields: Sequence[str] = (),
):
    """generate_unroll for a recurrent policy: (final state, transitions
    [T, B, ...], the carry after the last step)."""
    if not isinstance(key, _STREAMS) and len(key) != unroll_length:
        raise ValueError(f"{len(key)} step keys for an unroll of {unroll_length}")
    transitions = []
    state = env_state
    for t in range(unroll_length):
        step_key = key if isinstance(key, _STREAMS) else key[t]
        state, transition, carry = recurrent_actor_step(
            env, state, policy, step_key, carry, extra_fields=extra_fields
        )
        transitions.append(transition)
    return state, _stack(transitions), carry


@dataclasses.dataclass(frozen=True)
class EvalMetrics:
    """Episode-accumulated eval metrics, [B] each."""

    episode_metrics: Dict[str, torch.Tensor]
    active_episodes: torch.Tensor
    episode_steps: torch.Tensor


class EvalWrapper(Wrapper):
    """Sums each env's metrics (and reward) over its first episode."""

    def on_reset(self, state: State) -> State:
        metrics = dict(state.metrics, reward=state.reward)
        eval_metrics = EvalMetrics(
            episode_metrics={k: torch.zeros_like(v) for k, v in metrics.items()},
            active_episodes=torch.ones_like(state.reward),
            episode_steps=torch.zeros_like(state.reward),
        )
        return state.replace(metrics=metrics, info=dict(state.info, eval_metrics=eval_metrics))

    def step(self, state: State, action: torch.Tensor) -> State:
        info = dict(state.info)
        state_metrics = info.pop("eval_metrics")
        if not isinstance(state_metrics, EvalMetrics):
            raise ValueError(f"Incorrect type for state_metrics: {type(state_metrics)}")
        nstate = self.env.step(state.replace(info=info), action)
        metrics = dict(nstate.metrics, reward=nstate.reward)
        active = state_metrics.active_episodes
        episode_steps = torch.where(active > 0, nstate.info["steps"], state_metrics.episode_steps)
        # a physics blow-up leaves NaN or inf in the step's term metrics (the
        # env's NaN guard covers reward and obs only): each step's
        # contribution is sanitized so that one such step cannot poison an
        # aggregate (the `nan` metric records the event itself)
        episode_metrics = {
            k: state_metrics.episode_metrics[k]
            + torch.nan_to_num(metrics[k], nan=0.0, posinf=0.0, neginf=0.0) * active
            for k in state_metrics.episode_metrics
        }
        eval_metrics = EvalMetrics(
            episode_metrics=episode_metrics,
            active_episodes=active * (1 - nstate.done),
            episode_steps=episode_steps,
        )
        return nstate.replace(metrics=metrics, info=dict(nstate.info, eval_metrics=eval_metrics))


class Evaluator:
    """Deterministic-policy evaluator with data-split metric prefixes: each
    run resets `num_eval_envs` envs from its generator and unrolls
    episode_length // action_repeat steps. With `recurrent` the policy is
    `policy(obs, key, carry)` and the unroll starts from the wrapper's
    initial carry, info["hidden_state"]."""

    def __init__(
        self,
        eval_env: Env,
        eval_policy_fn: Callable[[Any], types.Policy],
        num_eval_envs: int,
        episode_length: int,
        action_repeat: int,
        key: torch.Generator,
        recurrent: bool = False,
    ):
        self._key = key
        self._recurrent = recurrent
        self._eval_walltime = 0.0
        self._eval_env = EvalWrapper(eval_env)
        self._eval_policy_fn = eval_policy_fn
        self._num_eval_envs = num_eval_envs
        self._length = episode_length // action_repeat
        self._steps_per_unroll = episode_length * num_eval_envs

    def _generate_eval_unroll(self, policy_params: Any) -> State:
        """The state after one eval unroll from a fresh reset."""
        first = self._eval_env.reset(self._key, self._num_eval_envs)
        policy = self._eval_policy_fn(policy_params)
        if self._recurrent:
            carry = first.info["hidden_state"]
            return recurrent_generate_unroll(self._eval_env, first, policy, self._key, carry, self._length)[0]
        return generate_unroll(self._eval_env, first, policy, self._key, self._length)[0]

    def run_evaluation(
        self,
        policy_params: Any,
        training_metrics: types.Metrics,
        aggregate_episodes: bool = True,
        data_split: str = "",
    ) -> types.Metrics:
        """Runs one eval epoch; metric keys get 'eval/{data_split}/'
        prefixes."""
        t = time.time()
        eval_state = self._generate_eval_unroll(policy_params)
        eval_metrics = eval_state.info["eval_metrics"]
        episode = {k: v.cpu().numpy() for k, v in eval_metrics.episode_metrics.items()}
        episode_steps = eval_metrics.episode_steps.cpu().numpy()  # waits for the unroll
        epoch_eval_time = time.time() - t
        metrics = {}
        prefix = f"{data_split}/" if data_split != "" else ""
        for fn in [np.mean, np.std]:
            suffix = "_std" if fn == np.std else ""
            metrics.update(
                {
                    f"eval/{prefix}episode_{name}{suffix}": (fn(value) if aggregate_episodes else value)
                    for name, value in episode.items()
                }
            )
        metrics[f"eval/{prefix}avg_episode_length"] = np.mean(episode_steps)
        metrics[f"eval/{prefix}epoch_eval_time"] = epoch_eval_time
        metrics[f"eval/{prefix}sps"] = self._steps_per_unroll / epoch_eval_time
        self._eval_walltime = self._eval_walltime + epoch_eval_time
        return {f"eval/{prefix}walltime": self._eval_walltime, **training_metrics, **metrics}
