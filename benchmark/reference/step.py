"""One control step of the reference, stage by stage, each from the
program's own input to that stage (the rollout is chaotic in float32, so
each stage is checked by itself): the policy's forward with the trainer's
own draws (the stream's state as the program's step found it), the first
physics substep, the whole control step's physics, and the env layer
(reward, observation, termination, auto-reset) over a given physics
output."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from benchmark.harness import snapshot
from benchmark.reference import build
from benchmark.reference.plain.agent.mlp_ppo import ppo_networks
from benchmark.reference.plain.ops import cg_solver_kernel
from benchmark.reference.plain.physics import forward, model as phys_model

FUSED = ("cg_solve", "ell_cg_solve")


@contextlib.contextmanager
def solve_shapes(seen: dict):
    """Records, by name, the shapes of the fused solves the reference's
    physics calls: (envs, n, limit rows, contacts, iterations, linesearch
    iterations)."""
    saved = {name: getattr(cg_solver_kernel, name) for name in FUSED}

    def recording(name, fn):
        def solve(buf, cdof, fq, sw, ll, *args, iterations, ls_iterations, **kw):
            seen[name] = (buf.shape[0], buf.shape[1], ll.shape[1], fq.shape[1], iterations, ls_iterations)
            return fn(buf, cdof, fq, sw, ll, *args, iterations=iterations, ls_iterations=ls_iterations, **kw)
        return solve

    for name, fn in saved.items():
        setattr(cg_solver_kernel, name, recording(name, fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(cg_solver_kernel, name, fn)


def action(nets, acting_with: dict, obs: torch.Tensor, key_state: torch.Tensor, device,
           alter_action: float = 0.0) -> torch.Tensor:
    """The policy's action on `obs`, with the parameters and normalizer in
    `acting_with` and the draws of a generator at `key_state`, on the host.
    `alter_action` adds to env 0's first action (a planted fault)."""
    build.load_params(nets, {k: v.to(device) for k, v in acting_with["params"].items()})
    policy = ppo_networks.make_inference_fn(nets)(build.normalizer(acting_with["normalizer"], device))
    gen = torch.Generator(device=device)
    gen.set_state(key_state)
    with torch.no_grad():
        out, _ = policy(obs.to(device), gen)
    out = out.cpu()
    if alter_action:
        out[0, 0] += alter_action
    return out


def _carried(env, carried: Dict[str, torch.Tensor], device):
    """A zeroed Data holding only the fields a substep carries, as the
    control step's loop builds each substep's input."""
    base = env.unwrapped
    given = {f: v.to(device) for f, v in carried.items() if v is not None}
    return phys_model.make_data(base.plan, base.model, given["qpos"].shape[0]).replace(**given)


def first_substep(env, carried: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    """(qpos, qvel) after one physics substep from the carried fields, on
    the host."""
    base = env.unwrapped
    with torch.no_grad():
        out = forward.step(base.plan, base.model, _carried(env, carried, device))
    return {"qpos": out.qpos.cpu(), "qvel": out.qvel.cpu()}


def physics(env, carried: Dict[str, torch.Tensor], device):
    """The whole control step's physics (the env's substeps) from the
    carried fields of its input, ctrl among them: the Data after it, on the
    device."""
    base = env.unwrapped
    with torch.no_grad():
        return forward.n_step(base.plan, base.model, _carried(env, carried, device), base._n_frames)


def env_layer(env, state_host: dict, physics_out, action_in: torch.Tensor, device,
              alter: float = 0.0) -> Dict[str, torch.Tensor]:
    """(obs, reward, done) of the wrapped env's step from the copied state
    with `action_in`, its physics replaced by `physics_out` (a Data on the
    device): the reward terms, observation, termination, NaN guard, episode
    count and auto-reset. `alter` adds to env 0's reward and first
    observation where the env makes them (a planted fault)."""
    base = env.unwrapped
    state = snapshot.rebuild(state_host, build.CLASSES, device)
    base.pipeline_step = lambda data, ctrl: physics_out
    try:
        with torch.no_grad():
            nstate = env.step(state, action_in.to(device))
    finally:
        del base.pipeline_step
    obs, reward = nstate.obs.cpu(), nstate.reward.cpu()
    if alter:
        obs[0, 0] += alter
        reward[0] += alter
    return {"obs": obs, "reward": reward, "done": nstate.done.cpu()}


def physics_on_device(physics_host: dict, device):
    """A host copy of the program's physics output as the reference's Data."""
    return snapshot.rebuild(physics_host, build.CLASSES, device)
