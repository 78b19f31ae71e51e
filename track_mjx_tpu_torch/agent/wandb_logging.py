"""Per-eval rollout logging: latent statistics, metric curves, ghost videos.

Port of track_mjx_tpu/agent/wandb_logging.py. `collect_rollout` rolls the
trainer's deterministic policy over one full clip of one env (B = 1, the
render wrapper's reset: frame 0, no auto-reset; it steps past done, as the
JAX one does) and returns a `RolloutTrace`; three emitters read it: the
latent statistics, the per-frame metric curves and the ghost-pair video.
The trace stays on the rollout's device; what the curves and the video
read comes to the host once, stacked.

`rollout_logging_fn` keeps the trainer-facing contract: train.py binds
(env, cfg, model_path, renderer) and the trainer calls
`policy_params_fn(current_step=, jit_logging_inference_fn=, params=,
policy_params_fn_key=, render_video=)`, where `jit_logging_inference_fn` is
its deterministic policy, `policy(obs, key)` (the LSTM one `policy(obs,
key, carry)`), and the key a torch.Generator (the deterministic policy
draws nothing from it).

The video is written with imageio where it imports (`<step>.mp4` where
imageio_ffmpeg is there, else `<step>.gif`, as the JAX path); without
imageio the frames go to `<step>.npz` (uint8 [T, H, W, 3] under `frames`,
with the fps) and a warning names the file. Either way `videos/rollout`
logs the path.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from track_mjx_tpu_torch.utils.wandb_compat import wandb


@dataclasses.dataclass
class RolloutTrace:
    """One full-clip rollout of one env: per state (the reset's and one per
    control step) the qpos [T + 1, nq] and the metrics {name: [T + 1]}; per
    control step the latents [T, latent]; and the reset state's info."""

    qpos: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    latent_means: torch.Tensor
    latent_logvars: torch.Tensor
    info: Dict[str, Any]


def episode_length(env, cfg) -> int:
    """Control steps of the logging rollout: the clip's frames times the
    control steps per frame."""
    if "reference_config" in cfg:
        return int(cfg["reference_config"]["clip_length"] * env._steps_for_cur_frame)
    return int(cfg["train_setup"]["train_config"]["episode_length"])


def collect_rollout(env, cfg, policy, key: Optional[torch.Generator], steps: Optional[int] = None):
    """Rolls `policy` (deterministic; recurrent where the config sets
    use_lstm, its carry from the reset's info["hidden_state"]) over one clip
    of one env from `env.reset(key)`: `steps` control steps, default the
    full clip (`episode_length`)."""
    state = env.reset(key)
    info = state.info
    use_lstm = bool(cfg["train_setup"]["train_config"].get("use_lstm", False))
    hidden = state.info["hidden_state"] if use_lstm else None
    qpos, metrics, means, logvars = [state.pipeline_state.qpos], [state.metrics], [], []
    for _ in range(episode_length(env, cfg) if steps is None else steps):
        if use_lstm:
            ctrl, extras, hidden = policy(state.obs, key, hidden)
        else:
            ctrl, extras = policy(state.obs, key)
        means.append(extras["latent_mean"])
        logvars.append(extras["latent_logvar"])
        state = env.step(state, ctrl)
        qpos.append(state.pipeline_state.qpos)
        metrics.append(state.metrics)
    return RolloutTrace(
        qpos=torch.cat(qpos),
        metrics={k: torch.cat([m[k].reshape(-1) for m in metrics]) for k in metrics[0]},
        latent_means=torch.cat(means),
        latent_logvars=torch.cat(logvars),
        info=info,
    )


def _masked_stats(x: torch.Tensor, finite: torch.Tensor):
    """(mean, std) over axis 0 of the frames where `finite` is True."""
    w = finite[:, None]
    n = torch.clamp(w.sum().to(x.dtype), min=1.0)
    xz = torch.where(w, x, torch.zeros_like(x))  # where, not a product: NaN * 0 is NaN
    mean = xz.sum(0) / n
    var = torch.where(w, (xz - mean) ** 2, torch.zeros_like(x)).sum(0) / n
    return mean, torch.sqrt(var)


def latent_statistics(trace: RolloutTrace) -> Dict[str, float]:
    """The `latents/*` values: per latent dimension the mean and std of
    the latent means and logvars over the frames whose latents are all
    finite, and how many frames were not (`latents/nonfinite_frames`).
    Without the mask, one frame of a walker that blew up would make every
    value NaN."""
    finite = (torch.isfinite(trace.latent_means) & torch.isfinite(trace.latent_logvars)).all(1)
    means_mean, means_std = _masked_stats(trace.latent_means, finite)
    logvars_mean, logvars_std = _masked_stats(trace.latent_logvars, finite)
    names = ("latent_means_mean", "latent_means_std", "latent_logvars_mean", "latent_logvars_std")
    host = torch.stack([means_mean, means_std, logvars_mean, logvars_std]).double().cpu().numpy()
    out = {"latents/nonfinite_frames": float((~finite).sum())}
    for i in range(host.shape[1]):
        out.update({f"latents/{name}{i}": float(host[k, i]) for k, name in enumerate(names)})
    return out


def log_latent_statistics(trace: RolloutTrace) -> None:
    wandb.log(latent_statistics(trace), commit=False)


def metric_curves(trace: RolloutTrace, metric_names) -> Dict[str, list]:
    """{name: [(frame, value), ...]} over the trace's states."""
    host = torch.stack([trace.metrics[name] for name in metric_names]).double().cpu().numpy()
    return {name: list(enumerate(host[k].tolist())) for k, name in enumerate(metric_names)}


def log_metric_curves(trace: RolloutTrace, metric_names) -> None:
    """One (frame, value) line plot per configured rollout metric."""
    for name, data in metric_curves(trace, metric_names).items():
        log_lineplot_to_wandb(f"eval/rollout_{name}", name, data, title=f"{name} for each rollout frame")


def log_lineplot_to_wandb(name: str, metric_name: str, data, title: str) -> None:
    """Logs a (frame, value) table and its line plot."""
    if isinstance(data[0], tuple):
        frames, values = zip(*data)
    else:
        frames, values = data
    table = wandb.Table(data=[[x, y] for x, y in zip(frames, values)], columns=["frame", metric_name])
    wandb.log({name: wandb.plot.line(table, "frame", metric_name, title=title)}, commit=False)


def reference_qpos(env, info: Dict[str, Any]) -> torch.Tensor:
    """The rollout env's reference clip as qposes [frames * steps per frame,
    nq]: each frame's position, quaternion and joints, repeated for each
    control step of the frame."""
    row0 = env._clip_row_base(info)[:1]
    clip = env._unpack(env._pack[row0 + torch.arange(env._clip_frames, device=row0.device)])
    qref = torch.cat([clip.position, clip.quaternion, clip.joints], dim=-1)
    return qref.repeat_interleave(int(env._steps_for_cur_frame), dim=0)


def write_video(frames: np.ndarray, path_stem: str, fps: float) -> str:
    """`frames` uint8 [T, H, W, 3] to `<path_stem>.mp4` (or `.gif`) with
    imageio, or without it to `<path_stem>.npz`; returns the path."""
    try:
        import imageio
    except ImportError:
        path = path_stem + ".npz"
        np.savez_compressed(path, frames=frames, fps=np.float64(fps))
        logging.warning("imageio is not installed: the rollout's %d frames went to %s", len(frames), path)
        return path
    try:
        import imageio_ffmpeg  # noqa: F401

        ext = "mp4"
    except ImportError:
        ext = "gif"
    path = f"{path_stem}.{ext}"
    # imageio's GIF writer takes the frame time in ms, its ffmpeg writer the fps
    timing = {"fps": fps} if ext == "mp4" else {"duration": 1000.0 / fps}
    with imageio.get_writer(path, **timing) as video:
        for frame in frames:
            video.append_data(frame)
    return path


def render_ghost_video(trace: RolloutTrace, env, cfg, model_path: str, current_step: int, renderer) -> str:
    """Draws the rollout's qposes beside the reference clip's (the ghost)
    from the config's `render_camera_name`, writes `<model_path>/<step>`
    (.mp4, .gif or .npz) and logs `videos/rollout`; returns the path."""
    render_fps = cfg["env_config"].get("render_fps") or int(1.0 / env.dt)
    qref = reference_qpos(env, trace.info)
    n = min(trace.qpos.shape[0], qref.shape[0])
    qpos = torch.cat([trace.qpos[:n], qref[:n].to(trace.qpos.device)], dim=-1)
    frames = renderer.render(qpos, cfg["env_config"]["render_camera_name"])
    os.makedirs(model_path, exist_ok=True)
    path = write_video(frames, os.path.join(model_path, str(current_step)), render_fps)
    wandb.log({"videos/rollout": wandb.Video(path, format=os.path.splitext(path)[1][1:])}, commit=False)
    return path


def rollout_logging_fn(
    env,
    cfg,
    model_path: str,
    renderer,
    current_step: int,
    jit_logging_inference_fn,
    params,
    policy_params_fn_key: Optional[torch.Generator],
    render_video: bool = True,
) -> None:
    """Trainer hook: one logging rollout, then its statistics, curves and
    (with `render_video`) video."""
    del params  # the policy carries its parameters
    trace = collect_rollout(env, cfg, jit_logging_inference_fn, policy_params_fn_key)
    log_latent_statistics(trace)
    if render_video:
        log_metric_curves(trace, cfg["logging_config"]["rollout_metrics"])
        render_ghost_video(trace, env, cfg, model_path, current_step, renderer)
