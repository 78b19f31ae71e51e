"""Training wrappers for the batched tracking env and for foreign envs.

Port of the training wrappers of track_mjx_tpu/envs/wrappers.py. The port's
envs are batched already, so `wrap` composes Episode -> AutoReset with no
vmap wrapper between them (with a `randomization_fn`, the domain
randomization wrapper stands there).

- ``EpisodeWrapper`` counts steps and sets truncation (float32 [B]), with
  `action_repeat` as a loop over env steps.
- ``AutoResetWrapperTracking`` caches each env's first SlimData, obs and
  prev_ctrl at reset and swaps them back in wherever a step ends in done;
  the rest of the info (start frame, clip, action buffer) carries on, as in
  the JAX package.
- ``LSTMAutoResetWrapperTracking`` (the LSTM pipeline's) does the same and
  puts each env's initial LSTM carry in info["hidden_state"] at reset: (h,
  c), zeros [B, layers, hidden] (flax's `initialize_carry`; the reference
  passes a fixed PRNGKey(0) that a zero initializer ignores). A step leaves
  it alone: `acting.recurrent_actor_step` reseeds a finished episode's
  carry from it.
- ``DomainRandomizationVmapWrapper`` steps the envs on a model some of whose
  leaves carry a leading env axis. `randomization_fn(model)` returns that
  model and the names of its randomized leaves, where the JAX one returns
  vmap's `in_axes`; the trainers bind the port's signature
  `randomization_fn(model, generator, num_envs)` to one generator stream
  for the training envs and one for the eval envs. Any of the 71 Model
  fields may be randomized: each such leaf is [num_envs] + its shared shape
  (physics/model.py's convention), and every stage reads each env's own
  value (the fused CG kernels each env's armature, contact rows, damping,
  tolerance and timestep). A name that is no Model field raises ValueError.
  The constraint rows stay the plan's: a randomized dof_frictionloss acts on
  the dofs whose frictionloss is positive in the shared model, as in the JAX
  package.
- ``ExternalEnvAdapter``, ``AutoResetWrapper`` and ``wrap_external`` train a
  foreign env (not a port `Env`): duck-typed and batch-first, `reset(generator,
  batch_size)` and `step(state, action)` on a state with obs, reward, done,
  metrics, info, `pipeline_state` (or `data`) and `replace(**changes)`,
  and an `action_size`. Unlike the reference (ADVICE.md), dict
  observations raise a ValueError, and the adapter writes the wrappers'
  obs back into the foreign state before a step, so a foreign step that
  reads its observation sees the auto-reset one.
- ``HighLevelWrapper`` folds a frozen decoder into the env: its actions are
  latent intentions, decoded together with the egocentric part of the
  observation.

The render wrappers reset the unwrapped tracking env for the trainer's
logging rollout (agent/wandb_logging.py), batch-first, with no auto-reset:
the rollout steps past done, as the JAX one does.

- ``RenderRolloutWrapperMulticlipTracking``: frame 0 of a random or given
  clip, prev_ctrl zero; ``RenderRolloutWrapperTrackingLSTM`` the same with a
  zero LSTM carry in info["hidden_state"], [B, hidden_layer_num,
  lstm_features] twice; ``RenderRolloutWrapperSingleclipTracking`` a given
  start frame of the one clip. `reset(rng, clip_idx=None, batch_size=1)`
  draws the clip (unless given), then the qpos and the qvel noise from the
  generator; `reset_from_draws` takes them as given (the parity tests feed
  the JAX reset's draws there).
- ``RenderRolloutVmapWrapper`` resets a batch of them to `clip_idx` [B]
  (default clip 0 for each of `batch_size` envs).

The analysis wrappers (offline evaluation of a trained policy):

- ``EvalClipWrapperTracking``: frame 0 of a given clip (one, or one per
  env), qvel zero. As in the JAX package (`reset_from_clip(..., noise=False)`)
  the qpos noise stays: `noise=False` zeroes the qvel draw only.
- ``AutoAlignWrapperTracking``: where a step ends in done, the env is not
  reset but teleported: qpos and qvel set to the current reference frame
  and kinematics run again on them, per env (`_where_done` over every field
  of the Data); the obs is taken again from the merged Data. The step's
  done stays in the state (the next step starts from done zero), so a
  caller sees which envs were realigned. The wrapped env carries full Data
  (no auto-reset wrapper under it).
"""

from __future__ import annotations

import torch

import dataclasses
from collections.abc import Mapping
from typing import Callable, Optional

from track_mjx_tpu_torch.envs.base import Env, State, Wrapper
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import kinematics as phys_kinematics
from track_mjx_tpu_torch.physics.model import LEAF_RANK


def wrap(
    env: Env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
    use_lstm: bool = False,
    hidden_state_dim: int = 128,
    hidden_layer_num: int = 2,
) -> Wrapper:
    """The training wrapper stack: Episode -> (domain randomization, with a
    `randomization_fn`) -> AutoReset (the LSTM one with `use_lstm`)."""
    env = EpisodeWrapper(env, episode_length, action_repeat)
    if randomization_fn is not None:
        env = DomainRandomizationVmapWrapper(env, randomization_fn)
    if use_lstm:
        return LSTMAutoResetWrapperTracking(env, lstm_features=hidden_state_dim, hidden_layer_num=hidden_layer_num)
    return AutoResetWrapperTracking(env)


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


def initialize_lstm_hidden(
    num_envs: int, lstm_features: int, hidden_layer_num: int, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero per-env LSTM (h, c) stacks, [num_envs, hidden_layer_num,
    lstm_features] each."""
    shape = (num_envs, hidden_layer_num, lstm_features)
    return torch.zeros(shape, device=device), torch.zeros(shape, device=device)


class LSTMAutoResetWrapperTracking(AutoResetWrapperTracking):
    """Auto-reset that also holds each env's initial LSTM carry."""

    def __init__(self, env: Env, lstm_features: int = 128, hidden_layer_num: int = 2):
        super().__init__(env)
        self.lstm_features = lstm_features
        self.hidden_layer_num = hidden_layer_num

    def on_reset(self, state: State) -> State:
        state = super().on_reset(state)
        hidden = initialize_lstm_hidden(
            state.obs.shape[0], self.lstm_features, self.hidden_layer_num, state.obs.device
        )
        return state.replace(info=dict(state.info, hidden_state=hidden))


class DomainRandomizationVmapWrapper(Wrapper):
    """Steps the envs on a model whose randomized leaves carry a leading env
    axis (module docstring). `randomization_fn(model)` returns (that
    model, the names of its randomized leaves); a reset or step must cover
    exactly those envs. The model is swapped into the unwrapped env for the
    duration of each call, so other wrappers of the same env (the trainer's
    evaluator) keep theirs."""

    def __init__(self, env: Env, randomization_fn: Callable):
        super().__init__(env)
        base = self.env.unwrapped.model
        self._model_v, names = randomization_fn(base)
        self.randomized = tuple(names)
        unknown = sorted(set(self.randomized) - set(LEAF_RANK))
        if unknown:
            raise ValueError(f"randomizing {unknown}: not fields of the physics Model")
        sizes = set()
        for name in self.randomized:
            leaf, shared = getattr(self._model_v, name), getattr(base, name)
            if tuple(leaf.shape[1:]) != tuple(shared.shape):
                raise ValueError(f"{name}: {tuple(leaf.shape)} is not [num_envs] + {tuple(shared.shape)}")
            sizes.add(leaf.shape[0])
        if len(sizes) != 1:
            raise ValueError(f"the randomized leaves {self.randomized} disagree on the number of envs: {sizes}")
        (self.num_envs,) = sizes

    def _on_model(self, batch: int, fn: Callable[[], State]) -> State:
        if batch != self.num_envs:
            raise ValueError(f"{batch} envs against a model randomized for {self.num_envs}")
        unwrapped = self.env.unwrapped
        shared = unwrapped.model
        unwrapped.model = self._model_v
        try:
            return fn()
        finally:
            unwrapped.model = shared

    def reset(self, rng, batch_size: int) -> State:
        return self._on_model(batch_size, lambda: self.on_reset(self.env.reset(rng, batch_size)))

    def reset_from_clip(self, start_frame, *args, **kwargs) -> State:
        return self._on_model(
            start_frame.shape[0], lambda: self.on_reset(self.env.reset_from_clip(start_frame, *args, **kwargs))
        )

    def step(self, state: State, action: torch.Tensor) -> State:
        return self._on_model(action.shape[0], lambda: self.env.step(state, action))


def _where_done_tree(done: torch.Tensor, x, y):
    """`_where_done` over two equal nests of tensors (dataclasses, dicts,
    tuples and lists)."""
    if isinstance(x, torch.Tensor):
        return _where_done(done, x, y)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(
            x, **{f.name: _where_done_tree(done, getattr(x, f.name), getattr(y, f.name)) for f in dataclasses.fields(x)}
        )
    if isinstance(x, Mapping):
        return {k: _where_done_tree(done, x[k], y[k]) for k in x}
    if isinstance(x, (tuple, list)):
        return type(x)(_where_done_tree(done, a, b) for a, b in zip(x, y))
    return y


class AutoResetWrapper(Wrapper):
    """Generic swap-based auto-reset for foreign envs: caches the first
    pipeline state and obs at reset and swaps them back per env on done
    (the tracking variant also restores prev_ctrl)."""

    def on_reset(self, state: State) -> State:
        info = dict(state.info, first_pipeline_state=state.pipeline_state, first_obs=state.obs)
        return state.replace(info=info)

    def step(self, state: State, action: torch.Tensor) -> State:
        if "steps" in state.info:
            info = dict(state.info)
            info["steps"] = torch.where(state.done > 0, torch.zeros_like(info["steps"]), info["steps"])
            state = state.replace(info=info)
        state = state.replace(done=torch.zeros_like(state.done))
        state = self.env.step(state, action)
        done = state.done
        pipeline_state = _where_done_tree(done, state.info["first_pipeline_state"], state.pipeline_state)
        obs = _where_done(done, state.info["first_obs"], state.obs)
        return state.replace(pipeline_state=pipeline_state, obs=obs)


class ExternalEnvAdapter(Env):
    """A foreign env (module docstring) as a port `Env`: its states become
    `State`s, the foreign state riding in info["_foreign_state"]."""

    def __init__(self, env):
        self._env = env

    @property
    def action_size(self) -> int:
        return int(self._env.action_size)

    @property
    def unwrapped(self):
        return self._env

    def _to_state(self, s) -> State:
        if isinstance(s.obs, Mapping):
            raise ValueError(
                f"the foreign env returned dict observations ({sorted(s.obs)}): the trainers take one "
                "[num_envs, features] tensor; flatten them in the env"
            )
        ps = s.pipeline_state if hasattr(s, "pipeline_state") else getattr(s, "data", None)
        return State(
            pipeline_state=ps,
            obs=s.obs,
            reward=s.reward,
            done=s.done,
            metrics=dict(getattr(s, "metrics", {}) or {}),
            info=dict(getattr(s, "info", {}) or {}),
        )

    def reset(self, rng, batch_size: int) -> State:
        foreign = self._env.reset(rng, batch_size)
        state = self._to_state(foreign)
        state.info["_foreign_state"] = foreign
        return state

    def step(self, state: State, action: torch.Tensor) -> State:
        # write back what the wrappers may have changed: done (zeroed), the
        # pipeline state and the obs (swapped in by an auto-reset)
        foreign = state.info["_foreign_state"].replace(done=state.done, obs=state.obs)
        if hasattr(foreign, "pipeline_state"):
            foreign = foreign.replace(pipeline_state=state.pipeline_state)
        elif hasattr(foreign, "data"):
            foreign = foreign.replace(data=state.pipeline_state)
        nforeign = self._env.step(foreign, action)
        nstate = self._to_state(nforeign)
        nstate.info.update({k: v for k, v in state.info.items() if k not in nstate.info})
        nstate.info["_foreign_state"] = nforeign
        return nstate


def wrap_external(
    env,
    episode_length: int = 1000,
    action_repeat: int = 1,
    randomization_fn: Optional[Callable] = None,
    **_unused,
) -> Wrapper:
    """`wrap` for a foreign env: Adapter -> Episode -> (domain
    randomization) -> generic AutoReset."""
    env = EpisodeWrapper(ExternalEnvAdapter(env), episode_length, action_repeat)
    if randomization_fn is not None:
        env = DomainRandomizationVmapWrapper(env, randomization_fn)
    return AutoResetWrapper(env)


class HighLevelWrapper(Wrapper):
    """Folds a frozen decoder into the env: a step's actions are latent
    intentions [B, latents], decoded by `decoder_inference_fn(x) ->
    (action, extras)` from [latents, obs[..., reference_obs_size:]]."""

    def __init__(self, env: Env, decoder_inference_fn: Callable, reference_obs_size: int):
        super().__init__(env)
        self._decoder_inference_fn = decoder_inference_fn
        self._reference_obs_size = reference_obs_size

    def step(self, state: State, latents: torch.Tensor) -> State:
        action, _ = self._decoder_inference_fn(
            torch.cat([latents, state.obs[..., self._reference_obs_size :]], dim=-1)
        )
        return self.env.step(state, action)


class RenderRolloutWrapperMulticlipTracking(Wrapper):
    """Logging rollouts: frame 0 of a random or given clip, prev_ctrl zero."""

    def reset(self, rng: torch.Generator, clip_idx=None, batch_size: int = 1) -> State:
        if clip_idx is None:
            clip_idx = torch.randint(0, self._n_clips, (batch_size,), generator=rng, device=self.device)
        clip_idx = torch.as_tensor(clip_idx, device=self.device).reshape(-1).expand(batch_size)
        qpos_noise = self._uniform(rng, (batch_size, self.plan.nq))
        qvel_noise = self._uniform(rng, (batch_size, self.plan.nv))
        return self.reset_from_draws(clip_idx, qpos_noise, qvel_noise)

    def reset_from_draws(self, clip_idx, qpos_noise: torch.Tensor, qvel_noise: torch.Tensor) -> State:
        """The reset at given draws: clip [B], qpos noise [B, nq], qvel noise [B, nv]."""
        bsz = qpos_noise.shape[0]
        clip_idx = torch.as_tensor(clip_idx, device=self.device).reshape(-1).expand(bsz)
        start = torch.zeros((bsz,), dtype=torch.int64, device=self.device)
        return self.reset_from_clip(start, qpos_noise, qvel_noise, clip_idx=clip_idx)


class RenderRolloutWrapperTrackingLSTM(RenderRolloutWrapperMulticlipTracking):
    """The LSTM pipeline's: as the multi-clip one, with a zero carry."""

    def __init__(self, env: Env, lstm_features: int = 128, hidden_layer_num: int = 2):
        super().__init__(env)
        self.lstm_features = lstm_features
        self.hidden_layer_num = hidden_layer_num

    def on_reset(self, state: State) -> State:
        hidden = initialize_lstm_hidden(state.obs.shape[0], self.lstm_features, self.hidden_layer_num, state.obs.device)
        return state.replace(info=dict(state.info, hidden_state=hidden))


class RenderRolloutWrapperSingleclipTracking(Wrapper):
    """Logging rollouts of the single-clip env: a given start frame."""

    def reset(self, rng: torch.Generator, start_frame: int = 0, batch_size: int = 1) -> State:
        qpos_noise = self._uniform(rng, (batch_size, self.plan.nq))
        qvel_noise = self._uniform(rng, (batch_size, self.plan.nv))
        return self.reset_from_draws(start_frame, qpos_noise, qvel_noise)

    def reset_from_draws(self, start_frame, qpos_noise: torch.Tensor, qvel_noise: torch.Tensor) -> State:
        bsz = qpos_noise.shape[0]
        start = torch.as_tensor(start_frame, dtype=torch.int64, device=self.device).reshape(-1).expand(bsz)
        return self.reset_from_clip(start, qpos_noise, qvel_noise)


class RenderRolloutVmapWrapper(Wrapper):
    """A batch of render-wrapper envs: `reset(rng, clip_idx)` with one clip
    per env (default: clip 0 for each of `batch_size` envs)."""

    def __init__(self, env: Env, batch_size: Optional[int] = None):
        super().__init__(env)
        self.batch_size = batch_size

    def reset(self, rng: torch.Generator, clip_idx=None) -> State:
        if clip_idx is None:
            if self.batch_size is None:
                raise ValueError("RenderRolloutVmapWrapper.reset needs clip_idx or a batch_size")
            clip_idx = torch.zeros((self.batch_size,), dtype=torch.int64)
        clip_idx = torch.as_tensor(clip_idx).reshape(-1)
        return self.env.reset(rng, clip_idx, batch_size=clip_idx.shape[0])


class EvalClipWrapperTracking(Wrapper):
    """Deterministic evaluation: frame 0 of clip `clip_idx` (an int, or [B]
    one per env), prev_ctrl zero, qvel zero; the qpos noise is drawn from
    the generator (module docstring)."""

    def reset(self, rng: torch.Generator, clip_idx=0, batch_size: int = 1) -> State:
        return self.reset_from_draws(clip_idx, self._uniform(rng, (batch_size, self.plan.nq)))

    def reset_from_draws(self, clip_idx, qpos_noise: torch.Tensor) -> State:
        """The reset at a given qpos noise [B, nq] (the parity tests feed
        the JAX reset's draw)."""
        bsz = qpos_noise.shape[0]
        clip_idx = torch.as_tensor(clip_idx, device=self.device).reshape(-1).expand(bsz)
        start = torch.zeros((bsz,), dtype=torch.int64, device=self.device)
        zeros = torch.zeros((bsz, self.plan.nv), device=self.device)
        return self.reset_from_clip(start, qpos_noise, zeros, clip_idx=clip_idx, noise=False)


class AutoAlignWrapperTracking(Wrapper):
    """On done, teleports the env to the current reference frame and runs
    kinematics again instead of resetting it (module docstring)."""

    def step(self, state: State, action: torch.Tensor) -> State:
        if "steps" in state.info:
            info = dict(state.info)
            info["steps"] = torch.where(state.done > 0, torch.zeros_like(info["steps"]), info["steps"])
            state = state.replace(info=info)
        state = self.env.step(state.replace(done=torch.zeros_like(state.done)), action)
        done = state.done
        ref = state.info["reference_frame"]
        data = state.pipeline_state
        aligned = data.replace(
            qpos=torch.cat((ref.position, ref.quaternion, ref.joints), dim=-1),
            qvel=torch.cat((ref.velocity, ref.angular_velocity, ref.joints_velocity), dim=-1),
        )
        aligned = phys_kinematics.kinematics(self.plan, self.model, aligned)
        data = data.replace(
            **{f.name: _where_done(done, getattr(aligned, f.name), getattr(data, f.name)) for f in dataclasses.fields(data)}
        )
        reference_obs, proprioceptive_obs = self._get_obs(data, state.info)
        return state.replace(pipeline_state=data, obs=torch.cat([reference_obs, proprioceptive_obs], dim=-1))
