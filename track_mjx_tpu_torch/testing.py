"""A foreign env for exercising `envs.wrappers.wrap_external`.

`PointMassEnv` is the brax-style point mass of tests/test_external_env.py
in the port's foreign-env contract (envs/wrappers.py): batch-first, its own
state type, and deliberately not a port `Env`. Actions push a 2-D point;
the reward is minus its distance from the origin, and an env is done once
that distance passes 2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from track_mjx_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class PointMassState:
    pipeline_state: torch.Tensor  # [B, 4]: position, velocity
    obs: torch.Tensor  # [B, 4]
    reward: torch.Tensor  # [B]
    done: torch.Tensor  # [B]
    metrics: Dict[str, torch.Tensor]
    info: Dict[str, Any]

    def replace(self, **changes) -> "PointMassState":
        return dataclasses.replace(self, **changes)


class PointMassEnv:
    """Point mass on `device`; `reset(generator, batch_size)` draws each
    position from U(-0.5, 0.5) (a `parallel.mesh.Rows` as the generator:
    this rank's rows of the draw)."""

    action_size = 2
    observation_size = 4

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)

    def reset_at(self, pos: torch.Tensor) -> PointMassState:
        """A state at positions `pos` [B, 2], at rest."""
        x = torch.cat([pos, torch.zeros_like(pos)], dim=-1)
        zero = torch.zeros(pos.shape[0], device=pos.device)
        return PointMassState(x, x, zero, zero, {"reward": zero, "dist": pos.abs().sum(-1)}, {})

    def reset(self, rng: mesh.Key, batch_size: int) -> PointMassState:
        u = mesh.rand(rng, (batch_size, 2), self.device)
        return self.reset_at(u - 0.5)

    def step(self, state: PointMassState, action: torch.Tensor) -> PointMassState:
        pos, vel = state.pipeline_state[:, :2], state.pipeline_state[:, 2:]
        vel = 0.9 * vel + 0.1 * torch.tanh(action)
        pos = pos + 0.05 * vel
        dist = torch.linalg.vector_norm(pos, dim=-1)
        reward = -dist
        done = (dist > 2.0).to(pos.dtype)
        x = torch.cat([pos, vel], dim=-1)
        return state.replace(
            pipeline_state=x, obs=x, reward=reward, done=done, metrics={"reward": reward, "dist": dist}
        )
