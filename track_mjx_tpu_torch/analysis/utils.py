"""Recursive nest <-> HDF5 persistence of analysis results.

Port of track_mjx_tpu/analysis/utils.py, in the same file layout, so that a
file written by either package loads in the other: dicts become groups,
lists and tuples groups marked `__list__` with members "0", "1", ...,
scalars and strings attributes, None the attribute "__none__", arrays
datasets (a tensor is copied to the host first), and an object with a
`__dict__` the group of its attributes. `load_from_h5py` rebuilds dicts and
lists of numpy arrays, unwrapping the default "root" container.

h5py is imported inside the two functions, where the JAX module imports it
with the module: without it they raise an ImportError that names it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("saving or loading analysis results as HDF5 needs h5py") from e
    return h5py


def save_to_h5py(group: Any, data: Any, name: str = "root") -> None:
    """Recursively writes `data` under `group` (an h5py File or Group, or a
    path, which is created)."""
    if isinstance(group, str):
        with _h5py().File(group, "w") as f:
            save_to_h5py(f, data, name)
        return
    if isinstance(data, dict):
        sub = group.create_group(name) if name else group
        for key, value in data.items():
            save_to_h5py(sub, value, str(key))
    elif isinstance(data, (list, tuple)):
        sub = group.create_group(name)
        sub.attrs["__list__"] = True
        for i, value in enumerate(data):
            save_to_h5py(sub, value, str(i))
    elif isinstance(data, (int, float, str, bool, np.integer, np.floating)):
        group.attrs[name] = data
    elif data is None:
        group.attrs[name] = "__none__"
    elif isinstance(data, torch.Tensor):
        group.create_dataset(name, data=data.detach().cpu().numpy())
    elif hasattr(data, "shape"):  # numpy arrays
        group.create_dataset(name, data=np.asarray(data))
    elif hasattr(data, "__dict__"):
        save_to_h5py(group, vars(data), name)
    else:
        raise TypeError(f"cannot serialize {type(data)} at {name}")


def load_from_h5py(group: Any) -> Any:
    """Recursively rebuilds dicts, lists and numpy arrays from an HDF5 group,
    file or path."""
    h5py = _h5py()
    if isinstance(group, str):
        with h5py.File(group, "r") as f:
            return load_from_h5py(f)

    def load_node(node):
        if isinstance(node, h5py.Dataset):
            return node[()]
        out = {}
        for key in node.attrs:
            if key == "__list__":
                continue
            v = node.attrs[key]
            out[key] = None if (isinstance(v, str) and v == "__none__") else v
        for key in node.keys():
            out[key] = load_node(node[key])
        if node.attrs.get("__list__", False):
            return [out[str(i)] for i in range(len(out))]
        return out

    result = load_node(group)
    # unwrap the default "root" container
    if isinstance(result, dict) and set(result.keys()) == {"root"}:
        return result["root"]
    return result
