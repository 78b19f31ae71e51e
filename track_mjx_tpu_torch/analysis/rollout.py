"""Offline rollouts of a trained policy over reference clips.

Port of track_mjx_tpu/analysis/rollout.py, the path users take from a
checkpoint to analysis (`agent.checkpointing.load_checkpoint_for_eval`,
`create_environment`, `load_inference_fn`, `create_rollout_generator`).

- `create_environment(cfg)` rebuilds the tracking env of a (checkpoint's)
  config: the clips of its data_path (`.npz`; `.h5` in the stac-mjx flat
  layout at the config's clip_length, else the grouped layout, where h5py
  is installed), the walker of its walker_name (the rodent and the fly
  from their workloads' snapshots, the stick by name from its own), the
  reward weights with the legacy `energy_cost_weight` backfill, env_args
  and reference_config. It is `workload.make_env` over those clips.
- `create_rollout_generator(...)` returns `generate_rollout(clip_idx,
  seed)`. The render wrapper follows the env's type (multi- or
  single-clip) and, with use_lstm, is the LSTM one at the configured
  hidden sizes (the JAX fix of the reference's default sizes). Where the
  JAX generator is jitted and vmapped over clip indices, the port's is
  batch-first: N clip indices (a LongTensor [N]) are one env batch of N,
  stepped together, and every output is [N, T, ...]; an int, or None (a
  clip drawn from the generator), gives [T, ...]. Over
  clip_length x steps-per-frame - 1 control steps it returns
  `qposes_ref` (the clip's qpos, each frame repeated steps-per-frame
  times), `qposes_rollout` (the reset's qpos first), `ctrl`,
  `state_rewards` (the reset's 0 first), and on request
  `rollout_metrics` ({"<name>s": [N, T]} of the config's
  logging_config.rollout_metrics), `activations` (the policy's taps: the
  inference function must be made with get_activation), `joint_forces`
  (`physics.postconstraint.cfrc_ext` of each step's Data, [N, T - 1,
  nbody, 6]) and `sensor_readings` (sensordata). Only these are kept per
  step, not the Data. The generator draws the reset's clip (where none is
  given) and noises, and a stochastic policy's noise, from one
  torch.Generator seeded with `seed`, on the env's device; the LSTM
  pipeline's activation leaves are [N, T - 1, ...] where the JAX ones are
  [T - 1, 1, ...].
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Mapping

import torch

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent import acting
from track_mjx_tpu_torch.envs import base as envs
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.task.tracking import MultiClipTracking, SingleClipTracking
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.physics import postconstraint


def _load_reference(data_path: str, clip_length: int, device: torch.device | str = "cuda") -> load.ReferenceClip:
    """The clips of `data_path`: `.npz`, or HDF5 in the stac-mjx flat layout
    cut into clips of `clip_length` frames, else the grouped layout."""
    if str(data_path).endswith(".npz"):
        return load.load_npz(data_path, device)
    try:
        return load.make_multiclip_data(data_path, n_frames_per_clip=clip_length, device=device)
    except KeyError:
        logging.info("Loading from stac-mjx format failed. Loading from ReferenceClip format.")
        return load.load_reference_clip_data(data_path, device=device)


def create_environment(cfg: Mapping[str, Any], device: torch.device | str = "cuda") -> envs.Env:
    """The unwrapped tracking env that `cfg` (a checkpoint's config)
    describes, on `device`."""
    logging.info("Loading data: %s", cfg["data_path"])
    clips = _load_reference(cfg["data_path"], cfg["reference_config"]["clip_length"], device)
    return workload.make_env(cfg, clips, device=device)


def _stack(items: list):
    """A list of equal nests of [N, ...] tensors as one nest of [N, T, ...]
    tensors."""
    return envs.map_tensors(lambda x: x.movedim(0, 1).contiguous(), acting._stack(items))


def _first(tree):
    """Env 0 of a nest of [N, ...] tensors."""
    return envs.map_tensors(lambda x: x[0], tree)


def create_rollout_generator(
    cfg: Mapping[str, Any],
    environment: envs.Env,
    inference_fn: Callable,
    model: str = "mlp",
    log_activations: bool = False,
    log_metrics: bool = False,
    log_sensor_data: bool = False,
) -> Callable[..., Dict]:
    """`generate_rollout(clip_idx=None, seed=42)` over `environment` (the
    unwrapped env of `create_environment`) with `inference_fn`, `policy(obs,
    key)` or, for model "lstm", `policy(obs, key, carry)` (module
    docstring)."""
    if model not in ("mlp", "lstm"):
        raise ValueError(f"unknown model type {model}")
    rollout_env = environment
    if type(environment) is MultiClipTracking:
        rollout_env = wrappers.RenderRolloutWrapperMulticlipTracking(environment)
    elif type(environment) is SingleClipTracking:
        rollout_env = wrappers.RenderRolloutWrapperSingleclipTracking(environment)
    if cfg["train_setup"]["train_config"].get("use_lstm", False):
        rollout_env = wrappers.RenderRolloutWrapperTrackingLSTM(
            environment,
            lstm_features=cfg["network_config"]["hidden_state_size"],
            hidden_layer_num=cfg["network_config"]["hidden_layer_num"],
        )
    per_frame = int(environment._steps_for_cur_frame)
    num_steps = int(cfg["reference_config"]["clip_length"] * environment._steps_for_cur_frame) - 1
    metric_names = list(cfg["logging_config"]["rollout_metrics"]) if log_metrics else []

    def reset(gen: torch.Generator, clip_idx, n: int):
        if isinstance(rollout_env, wrappers.RenderRolloutWrapperSingleclipTracking):
            return rollout_env.reset(gen, batch_size=n)
        return rollout_env.reset(gen, clip_idx, batch_size=n)

    @torch.no_grad()
    def generate_rollout(clip_idx=None, seed: int = 42) -> Dict:
        gen = torch.Generator(device=environment.device).manual_seed(seed)
        single = clip_idx is None or isinstance(clip_idx, int) or torch.as_tensor(clip_idx).dim() == 0
        if clip_idx is not None:
            clip_idx = torch.as_tensor(clip_idx, dtype=torch.int64, device=environment.device).reshape(-1)
        n = 1 if clip_idx is None else clip_idx.shape[0]
        state = reset(gen, clip_idx, n)
        hidden = state.info["hidden_state"] if model == "lstm" else None

        def kept_metrics(state):
            return {k: state.metrics[k] for k in metric_names}

        qposes, rewards, metrics = [state.pipeline_state.qpos], [state.reward], [kept_metrics(state)]
        ctrls, activations, joint_forces, sensor_readings = [], [], [], []
        for _ in range(num_steps):
            if model == "lstm":
                ctrl, extras, hidden = inference_fn(state.obs, gen, hidden)
            else:
                ctrl, extras = inference_fn(state.obs, gen)
            state = rollout_env.step(state, ctrl)
            data = state.pipeline_state
            qposes.append(data.qpos)
            rewards.append(state.reward)
            metrics.append(kept_metrics(state))
            ctrls.append(ctrl)
            if log_activations:
                activations.append(extras["activations"])
            if log_sensor_data:
                joint_forces.append(postconstraint.cfrc_ext(environment.plan, environment.model, data))
                sensor_readings.append(data.sensordata)

        clip = environment._unpack(
            environment._pack[
                rollout_env._clip_row_base(state.info)[:, None]
                + torch.arange(environment._clip_frames, device=environment.device)
            ]
        )
        qposes_ref = torch.cat([clip.position, clip.quaternion, clip.joints], dim=-1)
        result = {
            "qposes_ref": torch.repeat_interleave(qposes_ref, per_frame, dim=1),
            "qposes_rollout": _stack(qposes),
            "ctrl": _stack(ctrls),
            "state_rewards": _stack(rewards),
        }
        if log_metrics:
            result["rollout_metrics"] = {f"{k}s": _stack([m[k] for m in metrics]) for k in metric_names}
        if log_activations:
            result["activations"] = _stack(activations)
        if log_sensor_data:
            result["joint_forces"] = _stack(joint_forces)
            result["sensor_readings"] = _stack(sensor_readings)
        return _first(result) if single else result

    return generate_rollout
