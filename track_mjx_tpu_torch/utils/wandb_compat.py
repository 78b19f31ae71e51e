"""wandb where it is installed, else a local stand-in that writes JSONL.

Port of track_mjx_tpu/utils/wandb_compat.py. `wandb` is the real module
where it imports and WANDB_API_KEY is set; otherwise a local stand-in with
the API the trainer's logging uses (init / log / run.id / Video / Table /
plot.line / finish). The JAX module takes the real one whenever it imports;
the port asks for the key as well, because the real module's init without
one fails after trying to reach wandb's servers (a login prompt, then its
error reporting), which a machine without a network must not do. Without
the key the real module is not even imported. The stand-in's records are
the JAX stand-in's, so a reader of one reads the other:

    <dir or "wandb_local">/<project>/<run id>/config.json    the run's config
    <dir or "wandb_local">/<project>/<run id>/metrics.jsonl  one JSON object per committed log

`init(resume="must" | "allow")` appends to metrics.jsonl, any other resume
starts it anew. torch tensors and numpy arrays of no dimension become
numbers, others of up to 64 elements lists, larger ones "<array (shape)>".
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Optional

wandb = None
if os.environ.get("WANDB_API_KEY"):  # pragma: no cover - depends on the installation
    try:
        import wandb
    except Exception:  # not installed, or a broken install
        wandb = None
USING_REAL_WANDB = wandb is not None


class _Run:
    def __init__(self, run_id: str, dir_: Path):
        self.id = run_id
        self.dir = str(dir_)


class Video:
    def __init__(self, path: str, format: str = "mp4", **kw):
        self.path = path
        self.format = format

    def to_json(self):
        return {"_type": "video-file", "path": self.path}


class Table:
    def __init__(self, data=None, columns=None, **kw):
        self.data = data or []
        self.columns = columns or []

    def to_json(self):
        return {"_type": "table", "columns": self.columns, "nrows": len(self.data)}


class _Plot:
    @staticmethod
    def line(table, x, y, title=""):
        return {"_type": "line-plot", "x": x, "y": y, "title": title}


def jsonable(v: Any):
    """`v` as a JSON value, as the JAX stand-in writes it."""
    if hasattr(v, "to_json"):
        return v.to_json()
    if isinstance(v, dict):
        return {k: jsonable(x) for k, x in v.items()}
    if isinstance(v, (bool, int, float, str, type(None))):
        return v
    if hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist") and hasattr(v, "shape"):
        return v.tolist() if v.size <= 64 else f"<array {tuple(v.shape)}>"
    return str(v)


class LocalWandb:
    """The local stand-in for the wandb module."""

    Video = Video
    Table = Table

    def __init__(self):
        self.run: Optional[_Run] = None
        self._file = None
        self._pending: dict = {}
        self.plot = _Plot()

    def init(
        self,
        project: str = "local",
        config: Any = None,
        id: Optional[str] = None,
        resume: str = "allow",
        group: str = "",
        notes: str = "",
        dir: Optional[str] = None,
        **kw,
    ) -> _Run:
        self.finish()
        run_id = id or time.strftime("%y%m%d_%H%M%S")
        out_dir = Path(dir or "wandb_local") / project / run_id
        out_dir.mkdir(parents=True, exist_ok=True)
        self.run = _Run(run_id, out_dir)
        self._file = open(out_dir / "metrics.jsonl", "a" if resume in ("must", "allow") else "w")
        if config is not None:
            with open(out_dir / "config.json", "w") as f:
                json.dump(jsonable(config), f, indent=2, default=str)
        return self.run

    def log(self, metrics: dict, commit: bool = True, step: Optional[int] = None) -> None:
        self._pending.update({k: jsonable(v) for k, v in metrics.items()})
        if commit:
            record = {"_timestamp": time.time(), **self._pending}
            if step is not None:
                record["_step"] = step
            if self._file is not None:
                self._file.write(json.dumps(record, default=str) + "\n")
                self._file.flush()
            self._pending = {}

    def finish(self) -> None:
        if self._pending:
            self.log({}, commit=True)
        if self._file is not None:
            self._file.close()
            self._file = None


if wandb is None:
    wandb = LocalWandb()
