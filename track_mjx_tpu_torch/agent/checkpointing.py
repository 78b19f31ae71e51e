"""Checkpoints of PPO runs: save, load for eval, resume.

Port of track_mjx_tpu/agent/checkpointing.py. The JAX package saves three
items per step with Orbax; the port saves the same three with `torch.save`
(and the config as JSON) in the same layout, one directory per step:

    <checkpoint_path>/PPONetwork_<step>/policy.pt       (normalizer, policy state dict)
    <checkpoint_path>/PPONetwork_<step>/train_state.pt  TrainingState.state_dict() (an LSTM
                                                        run's with its rollout carry)
    <checkpoint_path>/PPONetwork_<step>/config.json     the run's config

Tensors are stored on the CPU and read back with `weights_only=True`. A step
is written into a temporary directory and renamed into place, so a reader
never sees half of one, and a reader counts a step only where all three
files are there (`committed_steps`). As with Orbax's CheckpointManager, a step at or
below the newest one in the directory is not written and no step is ever
overwritten: a resumed run, whose eval iterations count from 0 again,
leaves the steps it resumed from as they are. The stored config is
authoritative on resume (train.py). Orbax checkpoints of the JAX package
are not read.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Callable, Optional

import torch

from track_mjx_tpu_torch.agent import running_statistics
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as lstm_ppo_networks
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks
from track_mjx_tpu_torch.physics.model import _device

STEP_PREFIX = "PPONetwork"
STEP_FILES = ("policy.pt", "train_state.pt", "config.json")


def normalizer_to_dict(state: running_statistics.RunningStatisticsState) -> dict:
    return {k: getattr(state, k).detach().to("cpu", copy=True) for k in ("count", "mean", "summed_variance", "std")}


def normalizer_from_dict(d: dict, device: torch.device | str = "cuda") -> running_statistics.RunningStatisticsState:
    device = _device(device)
    return running_statistics.RunningStatisticsState(**{k: v.to(device) for k, v in d.items()})


def cpu_copy(tree):
    """A copy of a nest of dicts, lists and tuples with every tensor on the
    CPU (a copy also of tensors already there)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_copy(v) for v in tree)
    return tree


def _step_dirs(path: str) -> dict:
    pattern = re.compile(rf"^{STEP_PREFIX}_(\d+)$")
    out = {}
    if os.path.isdir(path):
        for name in os.listdir(path):
            m = pattern.match(name)
            if m and os.path.isdir(os.path.join(path, name)):
                out[int(m.group(1))] = os.path.join(path, name)
    return out


def committed_steps(path: str) -> dict:
    """{step: directory} of the steps in `path` that hold all three files."""
    return {
        step: d for step, d in _step_dirs(path).items() if all(os.path.isfile(os.path.join(d, f)) for f in STEP_FILES)
    }


class CheckpointManager:
    """Writes the steps of one run's checkpoint directory, which the first
    save creates. `max_to_keep` keeps the newest steps (None: all),
    `keep_period` also keeps every step that is a multiple of it, as
    Orbax's options do."""

    def __init__(self, checkpoint_path: str, max_to_keep: Optional[int] = None, keep_period: Optional[int] = None):
        self.path = os.path.abspath(checkpoint_path)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period

    def steps(self) -> list:
        return sorted(_step_dirs(self.path))

    def _dir(self, step: int) -> str:
        return os.path.join(self.path, f"{STEP_PREFIX}_{step}")

    def save(self, step: int, policy, training_state: dict, config: dict) -> bool:
        """Writes `step` unless the directory holds it or a later step, as
        Orbax's `should_save` decides; returns whether it wrote."""
        steps = self.steps()
        if steps and step <= steps[-1]:
            logging.info("Not saving step %s: %s already holds step %s", step, self.path, steps[-1])
            return False
        final = self._dir(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        normalizer, policy_params = policy
        torch.save((normalizer_to_dict(normalizer), cpu_copy(policy_params)), os.path.join(tmp, "policy.pt"))
        torch.save(cpu_copy(training_state), os.path.join(tmp, "train_state.pt"))
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(config, f, indent=1, sort_keys=True)
        os.rename(tmp, final)
        self._prune()
        return True

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.max_to_keep)]:
            if not (self.keep_period and s % self.keep_period == 0):
                shutil.rmtree(self._dir(s))


class CheckpointStore:
    """Read access to one checkpoint directory."""

    def __init__(self, checkpoint_path: str):
        self.path = checkpoint_path
        self._steps = committed_steps(checkpoint_path)
        if not self._steps:
            raise FileNotFoundError(f"no committed {STEP_PREFIX}_<step> checkpoint in {checkpoint_path}")

    def resolve_step(self, step: Optional[int]) -> int:
        return max(self._steps) if step is None else step

    def _file(self, step: Optional[int], name: str) -> str:
        return os.path.join(self._steps[self.resolve_step(step)], name)

    def config(self, step: Optional[int] = None) -> dict:
        """The stored config."""
        logging.info("Loading config from %s at step %s", self.path, step)
        with open(self._file(step, "config.json")) as f:
            return json.load(f)

    def training_state(self, step: Optional[int] = None) -> dict:
        """The stored `TrainingState.state_dict()` (CPU tensors)."""
        logging.info("Loading training state from %s at step %s", self.path, step)
        return torch.load(self._file(step, "train_state.pt"), weights_only=True)

    def policy(self, step: Optional[int] = None, device: torch.device | str = "cuda"):
        """(normalizer state on `device`, policy state dict)."""
        normalizer, params = torch.load(self._file(step, "policy.pt"), weights_only=True)
        return normalizer_from_dict(normalizer, device), params

    def for_eval(self, step: Optional[int] = None, device: torch.device | str = "cuda") -> dict:
        """{cfg, policy} bundle for offline analysis."""
        logging.info("Loading checkpoint from %s at step %s", self.path, step)
        return {"cfg": self.config(step), "policy": self.policy(step, device)}


def _networks_module(cfg: dict):
    """The pipeline's network bindings: the LSTM one where the config's
    train_config sets use_lstm."""
    if bool(cfg["train_setup"]["train_config"].get("use_lstm", False)):
        return lstm_ppo_networks
    return ppo_networks


def make_ppo_network_from_cfg(cfg: dict, device: torch.device | str = "cuda"):
    """The PPO networks of a checkpoint's config (network_config carries the
    sizes the trainer recorded; an LSTM run's also its hidden_state_size and
    hidden_layer_num)."""
    net_cfg = cfg["network_config"]
    normalize = running_statistics.normalize if net_cfg["normalize_observations"] else (lambda x, y: x)
    return _networks_module(cfg).network_factory(net_cfg)(
        net_cfg["observation_size"],
        net_cfg["reference_obs_size"],
        net_cfg["action_size"],
        preprocess_observations_fn=normalize,
        device=device,
    )


def load_inference_fn(
    cfg: dict,
    policy_params,
    deterministic: bool = True,
    get_activation: bool = True,
    device: torch.device | str = "cuda",
) -> Callable:
    """A policy from a config and restored (normalizer, policy state dict):
    `policy(obs, key)`, or for an LSTM run the recurrent `policy(obs, key,
    carry) -> (action, extras, carry')`; with `get_activation` (the JAX
    package's default) its extras carry the activation taps."""
    networks = make_ppo_network_from_cfg(cfg, device)
    normalizer, params = policy_params
    networks.policy_network.load_state_dict(params)
    return _networks_module(cfg).make_inference_fn(networks)(
        normalizer, deterministic=deterministic, get_activation=get_activation
    )


def load_config_from_checkpoint(checkpoint_path: str, step: Optional[int] = None) -> dict:
    return CheckpointStore(checkpoint_path).config(step)


def load_training_state(checkpoint_path: str, step: Optional[int] = None) -> dict:
    return CheckpointStore(checkpoint_path).training_state(step)


def load_policy(
    checkpoint_path: str,
    cfg: Optional[dict] = None,
    ckpt_mgr=None,
    step: Optional[int] = None,
    device: torch.device | str = "cuda",
):
    """(normalizer state on `device`, policy state dict) of a checkpoint's
    step (default: the newest). `cfg` and `ckpt_mgr` are accepted for the
    JAX signature's sake; the stored state needs neither."""
    del cfg, ckpt_mgr
    return CheckpointStore(checkpoint_path).policy(step, device)


def load_checkpoint_for_eval(
    checkpoint_path: str, step: Optional[int] = None, device: torch.device | str = "cuda"
) -> dict:
    """The {cfg, policy} bundle of a checkpoint's step for offline analysis:
    `load_inference_fn(bundle["cfg"], bundle["policy"])` acts with it."""
    return CheckpointStore(checkpoint_path).for_eval(step, device)
