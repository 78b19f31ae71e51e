"""One run of one cell: the port's training CLI entry (`train.main`) driven
from the seed, the measured window over its batch callbacks, the copies of
its state that the check of `correct` reads, and in a traced run one
profiled control step.

The program is driven through its own entry and hooks; the harness only
wraps, to observe them, these of the program's functions for the length
of the run: `ppo.seeded_generators` (to know the trainer's stream of draws),
`acting.actor_step` (to copy one control step's input and output, and in a
traced run to profile another), within that copied step
`physics.forward.n_step` (the control step's physics: its input and its
output) and `physics.forward.step` (the first substep's input and output),
`ppo.Learner.__call__` (the learning half's boundaries and loss) and the
optimizer's first step (the first gradient, from Adam's state). Each wrapper
calls the original with the same arguments and returns what it returned.
Every copy is taken before the window opens, except the parameters after
the checked steps (a few MB, at the callback that ends them).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from benchmark.harness import clips as clip_gen
from benchmark.harness import snapshot, trace
from benchmark.harness.window import Window

# the Data fields one physics substep carries to the next (physics/forward.py)
CARRY_FIELDS = ("time", "qpos", "qvel", "act", "ctrl", "qacc_warmstart")


class WindowClosed(Exception):
    """Raised from the batch callback to end training once the window has
    closed and the check has what it needs."""


@dataclasses.dataclass
class Plan:
    """What a run of a cell does, from its configuration and traffic files."""

    config_name: str
    config: dict  # the program's config as run (the configuration file's "config")
    clips: int
    start_at: int  # the callback at which the window opens
    checked_steps: int  # training steps the reference follows (their batches are copied before the window)
    check_step: tuple  # (training step, control step) whose input and output are copied
    profile_step: tuple  # (training step, control step) profiled in a traced run

    @property
    def train_config(self) -> dict:
        return self.config["train_setup"]["train_config"]

    @property
    def num_envs(self) -> int:
        return int(self.train_config["num_envs"])

    @property
    def unroll_length(self) -> int:
        return int(self.train_config["unroll_length"])

    @property
    def unrolls_per_step(self) -> int:
        tc = self.train_config
        return int(tc["batch_size"]) * int(tc["num_minibatches"]) // self.num_envs

    @property
    def env_steps_per_step(self) -> int:
        tc = self.train_config
        return int(tc["batch_size"]) * self.unroll_length * int(tc["num_minibatches"]) * int(tc.get("action_repeat", 1))

    @property
    def control_steps_per_step(self) -> int:
        return self.unroll_length * self.unrolls_per_step


def set_dotted(cfg: dict, key: str, value: Any) -> None:
    node = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def make_plan(config_file: dict, traffic: dict, overrides: Optional[Dict[str, Any]] = None) -> Plan:
    """The run's plan: the configuration as run, with `overrides` (dotted
    keys; the sweep's env counts) applied and the batch kept at one unroll
    of every env per training step where the traffic asks for it."""
    cfg = copy.deepcopy(config_file["config"])
    for k, v in (overrides or {}).items():
        set_dotted(cfg, k, v)
    tc = cfg["train_setup"]["train_config"]
    if "unrolls_per_step" in traffic:
        tc["batch_size"] = int(tc["num_envs"]) * int(traffic["unrolls_per_step"]) // int(tc["num_minibatches"])
    if int(traffic["checked_steps"]) > int(traffic["window_opens_at_step"]):
        raise ValueError("checked_steps exceeds window_opens_at_step: a checked step's batch would be "
                         "copied inside the window")
    return Plan(
        config_name=config_file["config_name"],
        config=cfg,
        clips=int(traffic["clips"]),
        start_at=int(traffic["window_opens_at_step"]),
        checked_steps=int(traffic["checked_steps"]),
        check_step=tuple(traffic["checked_control_step"]),
        profile_step=tuple(traffic["profiled_control_step"]),
    )


def program_config(plan: Plan, seed: int, workdir: str, clips_path: str, device: str) -> dict:
    """The config handed to `train.main`: the plan's, with the seed, the
    clips, a model path under the run's own directory, and one epoch longer
    than any run (num_evals 1: no eval, checkpoint or reset before the end,
    which a run never reaches)."""
    cfg = copy.deepcopy(plan.config)
    cfg["config_name"] = plan.config_name
    cfg["device"] = device
    cfg["data_path"] = clips_path
    cfg["logging_config"]["model_path"] = os.path.join(workdir, "model")
    ts = cfg["train_setup"]
    ts["train_subset_ratio"] = None
    ts["train_test_split_info"] = None
    ts["checkpoint_to_restore"] = None
    epoch = plan.env_steps_per_step * 10_000
    ts["train_config"]["num_timesteps"] = epoch
    ts["eval_every"] = epoch
    ts["reset_every"] = 2 * epoch
    ts["train_config"]["seed"] = int(seed)
    return cfg


def _learner_inputs(data) -> Dict[str, torch.Tensor]:
    """What the learning half reads of a batch [N, T, ...]."""
    extras = data.extras
    return {
        "observation": data.observation,
        "next_observation_last": data.next_observation[:, -1],
        "reward": data.reward,
        "discount": data.discount,
        "truncation": extras["state_extras"]["truncation"],
        "raw_action": extras["policy_extras"]["raw_action"],
        "log_prob": extras["policy_extras"]["log_prob"],
    }


def _carried_copy(data) -> Dict[str, Optional[torch.Tensor]]:
    """Host copies of the fields one physics substep carries to the next."""
    return {f: None if getattr(data, f) is None else getattr(data, f).detach().to("cpu", copy=True)
            for f in CARRY_FIELDS}


def _params(training_state) -> Dict[str, torch.Tensor]:
    nets = training_state.networks
    return {
        **{"policy." + k: v for k, v in nets.policy_network.state_dict().items()},
        **{"value." + k: v for k, v in nets.value_network.state_dict().items()},
    }


class Recorder:
    """The hooks of one run and what they saw."""

    def __init__(self, plan: Plan, seconds: float, trace_on: bool, t0: float, device: str):
        self.plan = plan
        self.t0 = t0
        self.device = device
        self.trace_on = trace_on
        self.window = Window(seconds, start_at=plan.start_at, min_callbacks=plan.checked_steps + 1)
        self.setup_s: Optional[float] = None
        self.train_generator = None
        self.actor_calls = 0
        self.learner_spans: List[tuple] = []  # (entry, exit) host times of each learning half
        self.learner_losses: List[torch.Tensor] = []  # each learning half's mean total loss (on device)
        self.callback_times: List[float] = []
        self.batches: List[Dict[str, torch.Tensor]] = []  # the learner's inputs of each checked step, on the host
        self.generator_states: List[torch.Tensor] = []  # the train stream at each checked step's learning half
        self.params: List[Dict[str, torch.Tensor]] = []  # params at callbacks 1 and checked_steps + 1
        self.first_exp_avg: Optional[Dict[str, torch.Tensor]] = None
        self.step_copy: Optional[dict] = None
        self.profile: Optional[dict] = None
        self.memory_peak_window: Optional[int] = None
        self.memory_peak_setup = 0
        self._hook = None

    # ---- hooks -----------------------------------------------------------
    def wrap_generators(self, original):
        def seeded_generators(seed, device, n):
            gens = original(seed, device, n)
            self.train_generator = gens[2]  # init (CPU), env, train, eval, ...
            return gens
        return seeded_generators

    def wrap_actor_step(self, original):
        def actor_step(env, env_state, policy, key, extra_fields=()):
            call = self.actor_calls
            self.actor_calls += 1
            per_step = self.plan.control_steps_per_step
            here = (call // per_step + 1, call % per_step)
            if here == self.plan.check_step:
                return self._copy_step(original, env, env_state, policy, key, extra_fields)
            if self.trace_on and here == self.plan.profile_step:
                with trace.profiled(self.device) as prof:
                    out = original(env, env_state, policy, key, extra_fields=extra_fields)
                self.profile = prof.summary
                return out
            return original(env, env_state, policy, key, extra_fields=extra_fields)
        return actor_step

    def _copy_step(self, original, env, env_state, policy, key, extra_fields):
        from track_mjx_tpu_torch.physics import forward as phys_forward

        state_in = snapshot.to_host(env_state)
        key_state = key.get_state().clone()
        n_step_fn, substep_fn, seen = phys_forward.n_step, phys_forward.step, {}

        def control_physics(plan, model, data, n):
            if "physics_in" not in seen:  # the control step's physics: its carried input and its output
                seen["physics_in"] = _carried_copy(data)
                out = n_step_fn(plan, model, data, n)
                seen["physics_out"] = snapshot.to_host(out)
                return out
            return n_step_fn(plan, model, data, n)

        def first_substep(plan, model, data):
            out = substep_fn(plan, model, data)
            if "substep_in" not in seen:  # the control step's first substep: its carried input and its output
                seen["substep_in"] = _carried_copy(data)
                seen["substep"] = {"qpos": out.qpos.detach().to("cpu", copy=True),
                                   "qvel": out.qvel.detach().to("cpu", copy=True)}
            return out

        phys_forward.n_step, phys_forward.step = control_physics, first_substep
        try:
            nstate, transition = original(env, env_state, policy, key, extra_fields=extra_fields)
        finally:
            phys_forward.n_step, phys_forward.step = n_step_fn, substep_fn
        self.step_copy = {
            "state": state_in,
            "key_state": key_state,
            **seen,
            "action": transition.action.detach().to("cpu", copy=True),
            "obs": nstate.obs.detach().to("cpu", copy=True),
            "reward": nstate.reward.detach().to("cpu", copy=True),
            "done": nstate.done.detach().to("cpu", copy=True),
        }
        return nstate, transition

    def wrap_learner(self, original):
        recorder = self

        def __call__(learner, training_state, data, it, generator=None, draws=None):
            entry = time.perf_counter()
            metrics = original(learner, training_state, data, it, generator=generator, draws=draws)
            recorder.learner_spans.append((entry, time.perf_counter()))
            if len(recorder.learner_losses) < recorder.plan.checked_steps:
                recorder.learner_losses.append(torch.stack([m["total_loss"] for m in metrics]).mean())
            return metrics
        return __call__

    def _first_step_hook(self, optimizer, args, kwargs):
        self.first_exp_avg = {}
        names = self._param_names
        for p, name in zip((p for g in optimizer.param_groups for p in g["params"]), names):
            st = optimizer.state.get(p, {})
            if "exp_avg" in st:
                self.first_exp_avg[name] = st["exp_avg"].detach().to("cpu", copy=True)
        self._hook.remove()
        self._hook = None

    # ---- the batch callback ----------------------------------------------
    def callback(self, training_state, data, make_learner) -> None:
        t = time.perf_counter()
        self.callback_times.append(t)
        k = len(self.callback_times)
        plan = self.plan
        if k == 1:
            nets = training_state.networks
            self._param_names = ["policy." + n for n, _ in nets.policy_network.named_parameters()] + [
                "value." + n for n, _ in nets.value_network.named_parameters()]
            self._hook = training_state.optimizer.register_step_post_hook(self._first_step_hook)
        if k == 1 or k == plan.checked_steps + 1:  # the start, and the state the checked steps leave
            self.params.append(snapshot.to_host(_params(training_state)))
        if k <= plan.checked_steps:  # the batch the learning half reads, and the trainer's draws for it
            self.generator_states.append(self.train_generator.get_state().clone())
            self.batches.append(snapshot.to_host(_learner_inputs(data)))
        stop = self.window.callback(t)
        if k == plan.start_at:
            if self.device.startswith("cuda"):
                torch.cuda.synchronize()
                self.memory_peak_setup = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            now = time.perf_counter()
            self.setup_s = now - self.t0
            self.window.open(now)
        if stop:
            if self.device.startswith("cuda"):
                self.memory_peak_window = torch.cuda.max_memory_allocated()
            raise WindowClosed()

    # ---- what the window measured ----------------------------------------
    def phase_ms(self) -> Dict[str, float]:
        """Mean host ms per training step inside the window of the rollout
        (from the end of a learning half to the next callback) and of the
        learning half (normalizer update and SGD, to its closing
        synchronize)."""
        start, end = self.window.start, self.window.end
        spans = [s for s in self.learner_spans if s[0] >= start and s[1] <= end]
        rollouts = []
        for entry, exit_ in spans:
            nxt = [c for c in self.callback_times if c > exit_]
            if nxt and nxt[0] <= end:
                rollouts.append(nxt[0] - exit_)
        out = {}
        if spans:
            out["sgd_ms"] = 1e3 * sum(b - a for a, b in spans) / len(spans)
        if rollouts:
            out["rollout_ms"] = 1e3 * sum(rollouts) / len(rollouts)
        return out


@contextlib.contextmanager
def patched(recorder: Recorder):
    """The program's functions wrapped for the length of the run."""
    from track_mjx_tpu_torch.agent import acting
    from track_mjx_tpu_torch.agent.mlp_ppo import ppo

    saved = (ppo.seeded_generators, acting.actor_step, ppo.Learner.__call__)
    ppo.seeded_generators = recorder.wrap_generators(saved[0])
    acting.actor_step = recorder.wrap_actor_step(saved[1])
    ppo.Learner.__call__ = recorder.wrap_learner(saved[2])
    try:
        yield
    finally:
        ppo.seeded_generators, acting.actor_step, ppo.Learner.__call__ = saved


def _no_logging(**_) -> None:
    """The per-eval logging hook, which no run reaches."""


def drive(plan: Plan, seed: int, seconds: float, trace_on: bool, t0: float, device: str, workdir: str) -> dict:
    """Runs the program until the window closes; returns what it measured
    and the copies the check reads. The program's state is gone when it
    returns."""
    from track_mjx_tpu_torch import train
    from track_mjx_tpu_torch.utils.config import ConfigDict

    tc = plan.config
    clips_path = os.path.join(workdir, "clips.npz")
    clip_gen.write(clips_path, plan.config_name, plan.clips, int(tc["reference_config"]["clip_length"]),
                   float(tc["env_config"]["env_args"]["mocap_hz"]), seed, device)
    cfg = program_config(plan, seed, workdir, clips_path, device)
    recorder = Recorder(plan, seconds, trace_on, t0, device)
    launches_before = train.kernel_launches()
    closed = False
    with patched(recorder):
        try:
            train.main(ConfigDict(cfg), batch_callback=recorder.callback, policy_params_fn=_no_logging)
        except WindowClosed:
            closed = True
    if not closed:
        raise RuntimeError("training ended before the window closed")
    launches = {k: v - launches_before[k] for k, v in train.kernel_launches().items()}
    memory_peak = 0
    if device.startswith("cuda"):
        memory_peak = max(recorder.memory_peak_setup, torch.cuda.max_memory_allocated())
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return {"recorder": recorder, "launches": launches, "memory_peak_bytes": memory_peak, "config": cfg,
            "clips_path": clips_path}


@contextlib.contextmanager
def workdir():
    """The run's own directory under TMPDIR, removed at the end."""
    path = tempfile.mkdtemp(prefix="benchmark-run-")
    try:
        yield path
    finally:
        shutil.rmtree(path, ignore_errors=True)
