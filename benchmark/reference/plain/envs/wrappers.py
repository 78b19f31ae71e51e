"""The training wrappers of the batched tracking env.

A frozen copy of the port's envs/wrappers.py, cut to what the benchmark's
cells run. The envs are batched already, so `wrap` composes Episode ->
AutoReset with no vmap wrapper between them.

- ``EpisodeWrapper`` counts steps and sets truncation (float32 [B]), with
  `action_repeat` as a loop over env steps.
- ``AutoResetWrapperTracking`` caches each env's first SlimData, obs and
  prev_ctrl at reset and swaps them back in wherever a step ends in done;
  the rest of the info (start frame, clip, action buffer) carries on, as in
  the JAX package.
"""

from __future__ import annotations

import torch

from benchmark.reference.plain.envs.base import Env, State, Wrapper
from benchmark.reference.plain.physics import forward as phys_forward


def wrap(env: Env, episode_length: int = 1000, action_repeat: int = 1) -> Wrapper:
    """The training wrapper stack: Episode -> AutoReset."""
    return AutoResetWrapperTracking(EpisodeWrapper(env, episode_length, action_repeat))


class EpisodeWrapper(Wrapper):
    """Maintains episode step count and truncation (brax parity)."""

    def __init__(self, env: Env, episode_length: int, action_repeat: int):
        super().__init__(env)
        self.episode_length = episode_length
        self.action_repeat = action_repeat

    def on_reset(self, state: State) -> State:
        info = dict(state.info)
        info["steps"] = torch.zeros_like(state.reward)
        info["truncation"] = torch.zeros_like(state.reward)
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        # keep the carried state's type: where the outer auto-reset wrapper
        # carries SlimData, the env's full-Data output is slimmed back
        slim_in = isinstance(state.pipeline_state, phys_forward.SlimData)
        rewards = []
        for _ in range(self.action_repeat):
            state = self.env.step(state, action)
            if slim_in:
                state = state.replace(pipeline_state=phys_forward.slim_data(state.pipeline_state))
            rewards.append(state.reward)
        state = state.replace(reward=torch.stack(rewards).sum(0))
        steps = state.info["steps"] + self.action_repeat
        over = steps >= self.episode_length
        info = dict(state.info)
        info["truncation"] = torch.where(over, 1 - state.done, torch.zeros_like(state.done))
        info["steps"] = steps
        return state.replace(done=torch.where(over, torch.ones_like(state.done), state.done), info=info)


def _where_done(done: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.where(done.reshape((x.shape[0],) + (1,) * (x.dim() - 1)) > 0, x, y)


class AutoResetWrapperTracking(Wrapper):
    """Swap-based auto-reset for done envs. The wrapped state, and the
    cached first state, carry only SlimData: the env re-derives every other
    stage on its next step."""

    def on_reset(self, state: State) -> State:
        slim = phys_forward.slim_data(state.pipeline_state)
        info = dict(state.info)
        info["first_pipeline_state"] = slim
        info["first_obs"] = state.obs
        info["first_prev_ctrl"] = info["prev_ctrl"]
        return state.replace(pipeline_state=slim, info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        if "steps" in state.info:
            info = dict(state.info)
            info["steps"] = torch.where(state.done > 0, torch.zeros_like(info["steps"]), info["steps"])
            state = state.replace(info=info)
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)
        done = state.done
        first = state.info["first_pipeline_state"]
        slim = phys_forward.slim_data(state.pipeline_state)
        pipeline_state = phys_forward.SlimData(
            **{f: _where_done(done, getattr(first, f), getattr(slim, f)) for f in phys_forward._CARRY_FIELDS}
        )
        obs = _where_done(done, state.info["first_obs"], state.obs)
        info = dict(state.info)
        info["prev_ctrl"] = _where_done(done, info["first_prev_ctrl"], info["prev_ctrl"])
        return state.replace(pipeline_state=pipeline_state, obs=obs, info=info)
