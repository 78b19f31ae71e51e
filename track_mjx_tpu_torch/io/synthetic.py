"""Synthetic reference-clip generation on the compiled model.

Port of track_mjx_tpu/io/synthetic.py. The random draws are the JAX
package's, numpy `RandomState` in the same order, so qpos and the finite
difference velocities equal its clips'. Body positions and quaternions come
from the port's own forward kinematics, run in float64 over every frame of
every clip at once on `device`, where the JAX package runs MuJoCo C's
`mj_kinematics` frame by frame; `mj_model` may be a `load_snapshot` result,
so no MuJoCo is needed.

As a script it writes clips of a workload's walker to an .npz that the
trainer's `data_path` reads:

    python -m track_mjx_tpu_torch.io.synthetic --config rodent-full-clips \
        --clips 8 --frames 250 --out build/clips.npz [--device cpu]

at the config's mocap rate (rodent-full-clips 50 Hz, fly-mc-intention
500 Hz) unless --mocap-hz says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any

import numpy as np
import torch

from track_mjx_tpu_torch.io.load import ReferenceClip, clip_from_numpy, save_npz
from track_mjx_tpu_torch.physics import kinematics as phys_kinematics
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config


def body_frames(mj_model: Any, qpos: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(xpos, xquat) in float64 of every body but the world body,
    [F, nbody - 1, 3] and [F, nbody - 1, 4], for the poses qpos [F, nq]."""
    plan, model = phys_model.put_model(mj_model, device=device)
    model = phys_model.Model(
        **{f.name: getattr(model, f.name).double() for f in dataclasses.fields(model)}
    )
    data = phys_model.make_data(plan, model, qpos.shape[0]).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float64, device=model.qpos0.device)
    )
    data = phys_kinematics.kinematics(plan, model, data)
    return data.xpos[:, 1:], data.xquat[:, 1:]


def synthesize_clips(
    mj_model: Any,
    n_clips: int = 2,
    n_frames: int = 250,
    mocap_hz: float = 50.0,
    seed: int = 0,
    joint_amplitude: float = 0.2,
    root_speed: float = 0.05,
    device: torch.device | str = "cuda",
) -> ReferenceClip:
    """Generates (n_clips, n_frames, ...) kinematically-consistent clips on
    `device`."""
    rng = np.random.RandomState(seed)
    nq = mj_model.nq
    qpos_all = np.zeros((n_clips, n_frames, nq))
    t = np.arange(n_frames) / mocap_hz
    for c in range(n_clips):
        qpos = np.tile(mj_model.qpos0, (n_frames, 1))
        # slow root drift in the horizontal plane
        heading = rng.uniform(0, 2 * np.pi)
        qpos[:, 0] += root_speed * t * np.cos(heading)
        qpos[:, 1] += root_speed * t * np.sin(heading)
        # band-limited joint motion within ranges
        for j in range(mj_model.njnt):
            if mj_model.jnt_type[j] not in (2, 3):  # slide/hinge only
                continue
            adr = mj_model.jnt_qposadr[j]
            freq = rng.uniform(0.3, 2.0)
            phase = rng.uniform(0, 2 * np.pi)
            amp = joint_amplitude * rng.uniform(0.2, 1.0)
            wave = amp * np.sin(2 * np.pi * freq * t + phase)
            if mj_model.jnt_limited[j]:
                lo, hi = mj_model.jnt_range[j]
                center = qpos[0, adr]
                span = min(center - lo, hi - center)
                wave = np.clip(wave, -0.9 * span, 0.9 * span)
            qpos[:, adr] += wave
        qpos_all[c] = qpos

    xpos, xquat = body_frames(mj_model, qpos_all.reshape(n_clips * n_frames, nq), device)
    nb = xpos.shape[1]

    # velocities by finite difference at the mocap rate (translational and
    # joint; the angular velocity stays zero, as in the JAX package)
    qvel_all = np.zeros((n_clips, n_frames, mj_model.nv))
    dt = 1.0 / mocap_hz
    qvel_all[:, 1:, :3] = np.diff(qpos_all[:, :, :3], axis=1) / dt
    qvel_all[:, 1:, 6:] = np.diff(qpos_all[:, :, 7:], axis=1) / dt

    clip = clip_from_numpy(
        {
            "position": qpos_all[:, :, :3],
            "quaternion": qpos_all[:, :, 3:7],
            "joints": qpos_all[:, :, 7:],
            "body_positions": np.zeros((0,)),
            "velocity": qvel_all[:, :, :3],
            "angular_velocity": qvel_all[:, :, 3:6],
            "joints_velocity": qvel_all[:, :, 6:],
            "body_quaternions": np.zeros((0,)),
        },
        xpos.device,
    )
    return clip.replace(
        body_positions=xpos.reshape(n_clips, n_frames, nb, 3).float(),
        body_quaternions=xquat.reshape(n_clips, n_frames, nb, 4).float(),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Writes synthetic clips of a workload's walker to an .npz.")
    ap.add_argument("--config", default="rodent-full-clips", choices=sorted(phys_model.SNAPSHOTS))
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--mocap-hz", type=int, default=None, help="default: the config's env_args.mocap_hz")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.mocap_hz is None:
        args.mocap_hz = int(load_config(args.config).env_config.env_args.mocap_hz)
    clips = synthesize_clips(
        phys_model.load_snapshot(args.config), n_clips=args.clips, n_frames=args.frames,
        mocap_hz=args.mocap_hz, seed=args.seed, device=args.device,
    )
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_npz(clips, args.out)
    print(f"wrote {args.clips} clips of {args.frames} frames at {args.mocap_hz} Hz to {args.out}")


if __name__ == "__main__":
    main()
