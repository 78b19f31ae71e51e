"""Synthetic reference clips from the seed, written as the `.npz` that the
trainer's `data_path` reads.

The generator of the port's `io/synthetic.py`, kept here so that the inputs
do not depend on the program under test: band-limited joint motion within
each joint's range and a slow root drift, drawn by numpy from the seed;
body positions and quaternions from the reference's own forward kinematics
in float64; velocities by finite differences at the mocap rate. Every seed
gives clips of the same shapes; only the motions differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.plain.io.load import clip_from_numpy, save_npz
from benchmark.reference.plain.physics import kinematics, model as phys_model


def _body_frames(mj_model, qpos: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    plan, model = phys_model.put_model(mj_model, device=device)
    model = phys_model.Model(**{f.name: getattr(model, f.name).double() for f in dataclasses.fields(model)})
    data = phys_model.make_data(plan, model, qpos.shape[0]).replace(
        qpos=torch.as_tensor(qpos, dtype=torch.float64, device=model.qpos0.device)
    )
    data = kinematics.kinematics(plan, model, data)
    return data.xpos[:, 1:], data.xquat[:, 1:]


def synthesize(config_name: str, n_clips: int, n_frames: int, mocap_hz: float, seed: int, device,
               joint_amplitude: float = 0.2, root_speed: float = 0.05):
    """(n_clips, n_frames, ...) kinematically consistent clips of the walker
    of `config_name`'s snapshot, drawn from `seed` (any whole number)."""
    mj_model = phys_model.load_snapshot(config_name)
    rng = np.random.RandomState(np.random.SeedSequence(seed).generate_state(1)[0])
    nq = mj_model.nq
    qpos_all = np.zeros((n_clips, n_frames, nq))
    t = np.arange(n_frames) / mocap_hz
    for c in range(n_clips):
        qpos = np.tile(mj_model.qpos0, (n_frames, 1))
        heading = rng.uniform(0, 2 * np.pi)
        qpos[:, 0] += root_speed * t * np.cos(heading)
        qpos[:, 1] += root_speed * t * np.sin(heading)
        for j in range(mj_model.njnt):
            if mj_model.jnt_type[j] not in (2, 3):  # slide and hinge joints only
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

    xpos, xquat = _body_frames(mj_model, qpos_all.reshape(n_clips * n_frames, nq), device)
    nb = xpos.shape[1]
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


def write(path: str, config_name: str, n_clips: int, n_frames: int, mocap_hz: float, seed: int, device) -> None:
    """Synthesizes the clips and writes them to `path` (.npz)."""
    save_npz(synthesize(config_name, n_clips, n_frames, mocap_hz, seed, device), path)
