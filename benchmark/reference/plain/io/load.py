"""Reference clips: the ReferenceClip container and its `.npz` files.

A frozen copy of the port's io/load.py, cut to what the benchmark reads.
`ReferenceClip` holds float32 tensors, (clips, frames, ...) or
(frames, ...). Every reader puts its tensors on the card unless the caller
names another device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from benchmark.reference.plain.physics.model import _device


@dataclasses.dataclass(frozen=True)
class ReferenceClip:
    """Trajectory features used by the tracking task."""

    # qpos split
    position: torch.Tensor
    quaternion: torch.Tensor
    joints: torch.Tensor
    # xpos (bodies 1..nbody-1: the world body is left out)
    body_positions: torch.Tensor
    # qvel split (inferred)
    velocity: torch.Tensor
    angular_velocity: torch.Tensor
    joints_velocity: torch.Tensor
    # xquat
    body_quaternions: torch.Tensor
    # original clip order index (used to recover per-clip metadata)
    original_clip_idx: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "ReferenceClip":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "ReferenceClip":
        return ReferenceClip(
            **{
                f.name: (None if v is None else v.to(device))
                for f in dataclasses.fields(self)
                for v in (getattr(self, f.name),)
            }
        )


# the features of every clip file
CLIP_KEYS = (
    "angular_velocity",
    "body_positions",
    "body_quaternions",
    "joints",
    "joints_velocity",
    "position",
    "quaternion",
    "velocity",
)


def clip_from_numpy(arrays, device: torch.device | str = "cuda") -> ReferenceClip:
    """ReferenceClip of float32 tensors on `device` from a mapping of
    feature name -> array (CLIP_KEYS, optionally `original_clip_idx`)."""
    device = _device(device)
    fields = {k: torch.as_tensor(np.array(arrays[k]), dtype=torch.float32, device=device) for k in CLIP_KEYS}
    if "original_clip_idx" in arrays and arrays["original_clip_idx"] is not None:
        fields["original_clip_idx"] = torch.as_tensor(
            np.array(arrays["original_clip_idx"]), dtype=torch.int64, device=device
        )
    return ReferenceClip(**fields)


def clip_to_numpy(clip: ReferenceClip) -> dict:
    """{feature name: numpy array} of a ReferenceClip."""
    out = {k: getattr(clip, k).detach().cpu().numpy() for k in CLIP_KEYS}
    if clip.original_clip_idx is not None:
        out["original_clip_idx"] = clip.original_clip_idx.detach().cpu().numpy()
    return out


def save_npz(clip: ReferenceClip, path: Union[str, Path]) -> None:
    """Writes a ReferenceClip as an uncompressed .npz (round-trips with
    `load_npz` bit for bit)."""
    np.savez(path, **clip_to_numpy(clip))


def load_npz(path: Union[str, Path], device: torch.device | str = "cuda") -> ReferenceClip:
    """Reads a ReferenceClip written by `save_npz`."""
    with np.load(path, allow_pickle=False) as z:
        return clip_from_numpy({k: z[k] for k in z.files}, device)


def load_data(data_path: Union[str, Path], device: torch.device | str = "cuda") -> ReferenceClip:
    """Loads the clips of a `.npz` file."""
    if not str(data_path).endswith(".npz"):
        raise ValueError(f"{data_path}: the benchmark writes and reads .npz clips only")
    return load_npz(data_path, device)
