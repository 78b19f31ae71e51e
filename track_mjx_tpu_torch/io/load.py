"""Reference clips: the ReferenceClip container, its files, and the splits.

Port of track_mjx_tpu/io/load.py. `ReferenceClip` holds float32 tensors,
(clips, frames, ...) or (frames, ...). Clips move between machines as
`.npz` (`save_npz`, `load_npz`), which needs numpy alone; the HDF5 readers
and writer of the JAX package (stac-mjx flat and grouped "all_clips"
layouts) import h5py, and the stac-mjx reader PyYAML, inside the function
that needs them, so nothing else here depends on either. Every reader puts
its tensors on the card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from track_mjx_tpu_torch.physics.model import _device


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


# the features of every clip file, in the order of the JAX package's
# grouped HDF5 layout
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


def _h5py():
    try:
        import h5py
    except ImportError as e:  # the reader is optional; .npz needs numpy only
        raise ImportError(
            "reading or writing .h5 clip files needs h5py; convert the clips to "
            ".npz (io.load.save_npz) where h5py is installed"
        ) from e
    return h5py


def _yaml_load(text: str):
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a stac-mjx .h5 file's embedded config needs PyYAML") from e
    return yaml.safe_load(text)


def load_data(data_path: Union[str, Path], device: torch.device | str = "cuda") -> ReferenceClip:
    """Loads clips: `.npz` directly, `.h5` trying the stac-mjx flat format,
    then the grouped format."""
    if str(data_path).endswith(".npz"):
        return load_npz(data_path, device)
    try:
        return make_multiclip_data(data_path, device=device)
    except KeyError:
        return load_reference_clip_data(data_path, device=device)


def _from_qpos(qpos, qvel, xpos, xquat, device) -> ReferenceClip:
    return clip_from_numpy(
        {
            "position": qpos[..., :3],
            "quaternion": qpos[..., 3:7],
            "joints": qpos[..., 7:],
            "body_positions": xpos,
            "velocity": qvel[..., :3],
            "angular_velocity": qvel[..., 3:6],
            "joints_velocity": qvel[..., 6:],
            "body_quaternions": xquat,
        },
        device,
    )


def make_singleclip_data(
    traj_data_path: Union[str, Path], device: torch.device | str = "cuda"
) -> ReferenceClip:
    """Single-clip loader from flat qpos/qvel/xpos/xquat datasets."""
    with _h5py().File(traj_data_path, "r") as data:
        arrays = [data[k][()] for k in ("qpos", "qvel", "xpos", "xquat")]
    return _from_qpos(*arrays, device)


def make_multiclip_data(
    traj_data_path: Union[str, Path],
    n_frames_per_clip: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> ReferenceClip:
    """stac-mjx flat HDF5 -> (clips, frames, dims) ReferenceClip."""

    def reshape_frames(arr, clip_len):
        flat = arr[()]
        return flat.reshape(flat.shape[0] // clip_len, clip_len, *flat.shape[1:])

    with _h5py().File(traj_data_path, "r") as data:
        if n_frames_per_clip is None:
            yaml_str = data["config"][()]
            if isinstance(yaml_str, bytes):
                yaml_str = yaml_str.decode("utf-8")
            n_frames_per_clip = _yaml_load(yaml_str)["stac"]["n_frames_per_clip"]
        arrays = [reshape_frames(data[k], n_frames_per_clip) for k in ("qpos", "qvel", "xpos", "xquat")]
    return _from_qpos(*arrays, device)


def load_reference_clip_data(
    filepath: Union[str, Path], group_name: str = "all_clips", device: torch.device | str = "cuda"
) -> ReferenceClip:
    """Grouped-HDF5 loader ("all_clips/<feature>" datasets)."""
    with _h5py().File(filepath, "r") as f:
        if group_name not in f:
            raise KeyError(f"Group '{group_name}' not found in the HDF5 file.")
        group = f[group_name]
        data = {}
        for key in CLIP_KEYS:
            if key not in group:
                raise KeyError(f"Dataset '{key}' not found in group '{group_name}'.")
            data[key] = group[key][()]
    return clip_from_numpy(data, device)


def save_reference_clip_data(
    clip: ReferenceClip, filepath: Union[str, Path], group_name: str = "all_clips"
) -> None:
    """Writes a ReferenceClip in the grouped-HDF5 layout (round-trips with
    load_reference_clip_data)."""
    with _h5py().File(filepath, "w") as f:
        group = f.create_group(group_name)
        for key in CLIP_KEYS:
            group.create_dataset(key, data=getattr(clip, key).detach().cpu().numpy())


def draw_test_indices(num_clips: int, test_ratio: float = 0.1, seed: Optional[int] = None) -> np.ndarray:
    """The test clips of generate_train_test_split, unsorted: the JAX
    package's numpy draw (numpy's global stream without a seed)."""
    rng = np.random if seed is None else np.random.RandomState(seed)
    return rng.choice(np.arange(num_clips), size=int(num_clips * test_ratio), replace=False)


def split_at(data: ReferenceClip, test_idx) -> Tuple[ReferenceClip, ReferenceClip]:
    """(train, test): the clips not in test_idx and those in it, each in
    increasing order."""
    indices = np.arange(data.position.shape[0])
    test_idx = np.sort(np.asarray(test_idx))
    return select_clips(data, indices[~np.isin(indices, test_idx)]), select_clips(data, test_idx)


def generate_train_test_split(
    data: ReferenceClip, test_ratio: float = 0.1, seed: Optional[int] = None
) -> Tuple[ReferenceClip, ReferenceClip]:
    """Random clip-level split; returns (train, test) with sorted indices.
    The draw is the JAX package's numpy one, so a seed gives its indices."""
    return split_at(data, draw_test_indices(data.position.shape[0], test_ratio, seed))


def load_clips_metadata(traj_data_path: Union[str, Path]) -> list:
    """Behaviour-group metadata [(name, number), ...] from the snips_order
    paths (`.../<name>_<number>.p`) of a stac-mjx file's embedded config;
    needs h5py and PyYAML."""
    with _h5py().File(traj_data_path, "r") as data:
        yaml_str = data["config"][()]
    if isinstance(yaml_str, bytes):
        yaml_str = yaml_str.decode("utf-8")
    config = _yaml_load(yaml_str)
    pattern = re.compile(r"/([^/]+)_([0-9]+)\.p$")
    clip_metadata = []
    for path in config["model"]["snips_order"]:
        match = pattern.search(path)
        if match:
            name, number = match.groups()
            clip_metadata.append((name, int(number)))
    return clip_metadata


def sub_sample_training_set(train_idx, train_ratio: float = 0.1, seed: Optional[int] = None) -> np.ndarray:
    """A sorted random subset, without replacement, of int(len * ratio)
    training clip indices; the draw is the JAX package's numpy one, so a
    seed gives its indices."""
    rng = np.random if seed is None else np.random.RandomState(seed)
    train_idx = np.asarray(train_idx)
    sampled_idx = rng.choice(train_idx, size=int(len(train_idx) * train_ratio), replace=False)
    sampled_idx.sort()
    return sampled_idx


def select_clips(clips: ReferenceClip, indices) -> ReferenceClip:
    """Gathers a subset of clips, recording original indices [k, 1]."""
    idx = torch.as_tensor(np.array(indices, dtype=np.int64), device=clips.position.device)
    return ReferenceClip(
        **{k: getattr(clips, k)[idx] for k in CLIP_KEYS},
        original_clip_idx=idx[:, None],
    )
