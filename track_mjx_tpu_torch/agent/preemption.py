"""Preemption auto-resume: run-state records keyed by (job, config).

Port of track_mjx_tpu/agent/preemption.py. A `RunStateStore` owns one
record, `run_state_{job}_{config_hash}.json` in `logging_config.model_path`,
with the keys run_id, checkpoint_path, wandb_run_id, config_hash and
timestamp (and latest_checkpoint_step once a checkpoint was written):

- the job is the scheduler's (SLURM array or job, PBS, SGE), else
  `local_<host>_<pid>`, which no restart finds again;
- the config hash is md5 over `json.dumps(config, sort_keys=True,
  default=str)`, its first 12 hex digits: the JAX package's digest of the
  same dict;
- writes go to a temporary file that is renamed into place; reads take a
  shared fcntl lock;
- a record is used only when it has its keys, its config hash is this
  config's and its checkpoint directory holds a committed step (a
  `PPONetwork_<step>` directory with all three files,
  `checkpointing.committed_steps`);
- only the coordinator writes or removes records: rank 0 of an initialized
  torch.distributed process group, else this process.
"""

from __future__ import annotations

import dataclasses
import fcntl
import hashlib
import json
import logging
import os
import socket
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

from track_mjx_tpu_torch.agent import checkpointing

_REQUIRED_KEYS = ("run_id", "checkpoint_path", "wandb_run_id", "config_hash")

# scheduler identity probes, most specific first: (prefix, env keys, number of
# optional trailing keys); the first probe whose required keys are all set wins
_SCHEDULERS = (
    ("slurm", ("SLURM_ARRAY_JOB_ID", "SLURM_ARRAY_TASK_ID"), 0),
    ("slurm", ("SLURM_JOB_ID",), 0),
    ("pbs", ("PBS_JOBID",), 0),
    ("sge", ("JOB_ID", "SGE_TASK_ID"), 1),
)


def job_identifier() -> str:
    """This job's id, the same across a preemption and requeue."""
    env = os.environ
    for prefix, keys, n_optional in _SCHEDULERS:
        required = keys[: len(keys) - n_optional]
        if all(env.get(k) for k in required):
            return "_".join((prefix, *(env[k] for k in keys if env.get(k))))
    return f"local_{socket.gethostname()}_{os.getpid()}"


def _config_dict(cfg) -> dict:
    if isinstance(cfg, dict):
        return cfg
    if hasattr(cfg, "to_dict"):
        return cfg.to_dict()
    if hasattr(cfg, "__dict__"):
        return dict(cfg.__dict__)
    raise TypeError(f"cannot hash a config of type {type(cfg)}")


def config_hash(cfg) -> str:
    """12 hex digits of md5 over the config's sorted JSON dump."""
    payload = json.dumps(_config_dict(cfg), sort_keys=True, default=str)
    return hashlib.md5(payload.encode()).hexdigest()[:12]


def _is_coordinator() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def read_locked(path: Union[Path, str]) -> Dict[str, Any]:
    """A run-state file's record, read under a shared lock."""
    with open(path, "r") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_SH)
        try:
            return json.load(f)
        finally:
            fcntl.flock(f.fileno(), fcntl.LOCK_UN)


@dataclasses.dataclass
class RunStateStore:
    """The run-state record of one (job, config)."""

    cfg: Any

    def __post_init__(self):
        base = Path(_config_dict(self.cfg)["logging_config"]["model_path"]).resolve()
        self._hash = config_hash(self.cfg)
        self._path = base / f"run_state_{job_identifier()}_{self._hash}.json"

    @property
    def path(self) -> Path:
        return self._path

    def _read_locked(self) -> Optional[Dict[str, Any]]:
        if not self._path.exists():
            return None
        try:
            return read_locked(self._path)
        except (json.JSONDecodeError, OSError) as e:
            logging.warning("Failed to read run state %s: %s", self._path, e)
            return None

    def _write_atomic(self, record: Dict[str, Any]) -> None:
        self._path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(mode="w", dir=self._path.parent, delete=False, suffix=".tmp") as tmp:
            json.dump(record, tmp, indent=2)
            name = tmp.name
        Path(name).rename(self._path)

    def discover(self) -> Optional[Dict[str, Any]]:
        """The record, checked, with latest_checkpoint_step from the
        checkpoint directory; None where there is none or it fails a check."""
        logging.info("Looking for existing run state at: %s", self._path)
        record = self._read_locked()
        if not record:
            logging.info("No existing run state found")
            return None
        if not all(k in record for k in _REQUIRED_KEYS):
            logging.warning("Run state file is missing required keys, ignoring")
            return None
        if record["config_hash"] != self._hash:
            logging.warning(
                "Config hash mismatch (saved: %s, current: %s), ignoring run state", record["config_hash"], self._hash
            )
            return None
        step = _latest_committed_step(Path(record["checkpoint_path"]))
        if step is None:
            return None
        record["latest_checkpoint_step"] = step
        logging.info("Found valid run state with checkpoint at step %s", step)
        return record

    def save(
        self,
        run_id: str,
        checkpoint_path: Union[Path, str],
        wandb_run_id: str,
        latest_step: Optional[int] = None,
    ) -> None:
        if not _is_coordinator():
            return
        record = {
            "run_id": run_id,
            "checkpoint_path": str(Path(checkpoint_path).resolve()),
            "wandb_run_id": wandb_run_id,
            "config_hash": self._hash,
            "timestamp": time.time(),
        }
        if latest_step is not None:
            record["latest_checkpoint_step"] = latest_step
        try:
            self._write_atomic(record)
            logging.info("Saved run state to %s", self._path)
        except Exception as e:  # noqa: BLE001 - a record it cannot write must not stop training
            logging.error("Failed to save run state: %s", e)

    def clear(self) -> None:
        if not _is_coordinator():
            return
        try:
            if self._path.exists():
                self._path.unlink()
                logging.info("Cleaned up run state file: %s", self._path)
        except Exception as e:  # noqa: BLE001
            logging.warning("Failed to cleanup run state file: %s", e)

    def checkpoint_callback(
        self, run_id: str, checkpoint_path: Union[Path, str], wandb_run_id: str
    ) -> Callable[[int], None]:
        """A hook for each checkpoint written: the record with its step."""

        def on_checkpoint(step: int):
            try:
                self.save(run_id, checkpoint_path, wandb_run_id, latest_step=step)
            except Exception as e:  # noqa: BLE001
                logging.warning("Failed to update run state after checkpoint save: %s", e)

        return on_checkpoint


def _latest_committed_step(checkpoint_path: Path) -> Optional[int]:
    """The newest committed step in the checkpoint directory, or None."""
    if not checkpoint_path.exists():
        logging.warning("Checkpoint directory %s not found, ignoring run state", checkpoint_path)
        return None
    steps = checkpointing.committed_steps(str(checkpoint_path))
    if not steps:
        logging.warning("No valid checkpoints found in directory, ignoring run state")
        return None
    return max(steps)


# ---- functional API (what train.py calls) ----------------------------------


def discover_existing_run_state(cfg) -> Optional[Dict[str, Any]]:
    return RunStateStore(cfg).discover()


def save_run_state(
    cfg, run_id: str, checkpoint_path: Union[Path, str], wandb_run_id: str, latest_step: Optional[int] = None
) -> None:
    RunStateStore(cfg).save(run_id, checkpoint_path, wandb_run_id, latest_step)


def cleanup_run_state(cfg) -> None:
    RunStateStore(cfg).clear()


def create_checkpoint_callback(cfg, run_id: str, checkpoint_path: Union[Path, str], wandb_run_id: str):
    return RunStateStore(cfg).checkpoint_callback(run_id, checkpoint_path, wandb_run_id)
