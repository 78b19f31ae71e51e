"""Workload configs with dotted overrides.

Port of track_mjx_tpu/utils/config.py. A config is the JSON that
tools/export_torch_model.py writes beside a workload's model snapshot
(`track_mjx_tpu_torch/assets/<name>.json`, the whole of the JAX package's
`config/<name>.yaml`), so the port reads it with the standard library.
Overrides use Hydra's `a.b.c=value` syntax; a value is parsed as JSON
(`null`, `true`, `1e-4`, `[16, 16]`, `"text"`) and anything that is not
JSON is kept as a plain string. That differs from the JAX package's YAML
parsing on YAML-only forms: `~` and `yes` are strings here, null and true
there.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Any, Iterable, Optional, Union

ASSETS = Path(__file__).resolve().parent.parent / "assets"
# the key under which `load_config` records the workload a config was loaded
# as, which names its compiled-model snapshot (workload.make_walker)
CONFIG_NAME = "config_name"


class ConfigDict(dict):
    """dict with attribute access, deep conversion, and to_dict()."""

    def __init__(self, data: Optional[dict] = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, key, value):
        super().__setitem__(key, _convert(value))

    def to_dict(self) -> dict:
        """Plain nested dict (JSON serializable)."""

        def conv(v):
            if isinstance(v, ConfigDict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return {k: conv(v) for k, v in self.items()}

    def copy(self) -> "ConfigDict":
        return ConfigDict(copy.deepcopy(self.to_dict()))


def _convert(v: Any) -> Any:
    if isinstance(v, ConfigDict):
        return v
    if isinstance(v, dict):
        return ConfigDict(v)
    if isinstance(v, list):
        return [_convert(x) for x in v]
    return v


def config_path(name: str) -> Path:
    """The exported JSON of workload `name` (rodent-full-clips ->
    assets/rodent_full_clips.json)."""
    return ASSETS / (name.replace("-", "_") + ".json")


def load_config(name_or_path: Union[str, Path], overrides: Iterable[str] = ()) -> ConfigDict:
    """Loads a workload's exported JSON by name, or a JSON file by path, and
    applies dotted overrides like "train_setup.train_config.num_envs=128".
    A workload loaded by name gets its name under CONFIG_NAME."""
    path = Path(name_or_path)
    named = path.suffix != ".json" or not path.exists()
    if named:
        path = config_path(str(name_or_path))
    if not path.exists():
        have = sorted(p.stem.replace("_", "-") for p in ASSETS.glob("*.json"))
        raise FileNotFoundError(f"no config {name_or_path!r}; have {have}")
    with open(path) as f:
        cfg = ConfigDict(json.load(f))
    if named:
        cfg[CONFIG_NAME] = str(name_or_path)
    return apply_overrides(cfg, overrides)


def parse_value(raw: str) -> Any:
    """An override's value: JSON, else the string itself (empty: None)."""
    if raw == "":
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def apply_overrides(cfg: ConfigDict, overrides: Iterable[str]) -> ConfigDict:
    """Applies `a.b.c=value` overrides in place, creating missing levels."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' is not of the form key=value")
        key, _, raw = ov.partition("=")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigDict):
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = parse_value(raw)
    return cfg

