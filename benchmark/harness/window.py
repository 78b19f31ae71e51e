"""The measured window over the trainer's batch callbacks.

The trainer calls its batch callback once per training step, after the
step's rollout, which ends in the trainer's synchronize. The window opens
when callback `start_at` returns: the warm-up before it covers one whole
training step and the next rollout at the cell's shapes. Each later callback
closes one whole training step (a learning half and a rollout). The window
closes at the first callback at least `seconds` after it opened (and not
before callback `min_callbacks`, which the check of `correct` needs); it
counts every step up to that callback, over the time from the window's start
to that callback. A stall inside the window lowers the rate.
"""

from __future__ import annotations

from typing import List, Optional


class Window:
    def __init__(self, seconds: float, start_at: int = 2, min_callbacks: int = 4):
        if start_at < 1 or min_callbacks < start_at:
            raise ValueError("the window opens at a callback, and closes no earlier")
        self.seconds = float(seconds)
        self.start_at = start_at
        self.min_callbacks = min_callbacks
        self.callbacks = 0
        self.start: Optional[float] = None
        self.end: Optional[float] = None
        self.times: List[float] = []  # each callback's time inside the window, the start first

    def open(self, t: float) -> None:
        """The window opens at `t` (when callback `start_at` returns)."""
        self.start = t
        self.times = [t]

    def callback(self, t: float) -> bool:
        """Records callback number `self.callbacks + 1` at time `t`; True when
        the window closes at it."""
        self.callbacks += 1
        if self.start is None or self.callbacks <= self.start_at:
            return False
        self.times.append(t)
        if t - self.start >= self.seconds and self.callbacks >= self.min_callbacks:
            self.end = t
            return True
        return False

    @property
    def steps(self) -> int:
        """Whole training steps inside the window."""
        return len(self.times) - 1

    @property
    def span(self) -> float:
        return self.times[-1] - self.start

    def rate(self, env_steps_per_step: int) -> float:
        """Env steps of the window's whole training steps over its span."""
        if self.steps < 1:
            raise RuntimeError("the window holds no whole training step")
        return self.steps * env_steps_per_step / self.span
