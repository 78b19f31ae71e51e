"""The check of `correct`: what the timed path produced, held against the
plain reference under `benchmark/reference/`.

The rollout is chaotic in float32, so the reference cannot follow it over
whole training steps; it follows the program stage by stage, each stage from
the program's own input to it (see PERF.md), at the timed sizes:

- the start: the initial weights, which the reference draws itself from the
  seed (`init_gap`: the largest difference over the largest weight, exact);
- the learning halves of the first `checked_steps` training steps, from
  those weights, on the batches the program's rollouts made: each step's
  mean total loss (`loss_gap`, the worst step's relative difference), the
  first gradient as Adam got it (`grad_gap`) and the parameters' change over
  the steps (`change_gap`), each by the worst leaf: the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf. Leaves whose reference first
  gradient is under a thousandth of the median leaf's move by round-off
  alone under Adam and are left out of `change_gap`;
- one control step of a later rollout, every env of it: the policy's action
  from the program's observations with the parameters and normalizer that
  the reference's own learning halves left, and the trainer's own draws
  (`action_gap`: the widest difference); the first physics substep from the
  program's carried input (`substep_gap`) and the whole control step's
  physics from the program's input to it (`state_gap`), each the median
  env's relative distance in (qpos, qvel); the env layer (reward terms,
  observation, termination, NaN guard, auto-reset) over the program's own
  physics output, by the widest env: the relative distance in the
  observation (`obs_gap`) and the reward's difference (`reward_gap`).

Each number has its limit in `benchmark/limits/<workload>.json`; the run is
correct when every number is finite and within its limit.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import torch

from benchmark.reference import build, learner, step

NAMES = ("action_gap", "substep_gap", "state_gap", "obs_gap", "reward_gap", "loss_gap", "grad_gap", "change_gap")
ROUNDOFF_LEAF = 1e-3


def load_limits(root: str, workload: str) -> Dict[str, Optional[float]]:
    """Each number's limit in the cell; None where the cell does not compare
    it (PERF.md gives why)."""
    with open(os.path.join(root, "benchmark", "limits", workload + ".json")) as f:
        limits = json.load(f)["limits"]
    missing = [n for n in NAMES if n not in limits]
    if missing:
        raise ValueError(f"limits of {workload} lack {missing}")
    return {n: None if limits[n] is None else float(limits[n]) for n in NAMES}


def _median_env(rel: torch.Tensor) -> float:
    return float(rel.double().median())


def _rel_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per env (row), |a - b| / |b| in float64."""
    a, b = a.double().reshape(a.shape[0], -1), b.double().reshape(b.shape[0], -1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-12)


def _state_gap(prog: dict, ref: dict) -> float:
    return _median_env(_rel_rows(torch.cat([prog["qpos"], prog["qvel"]], dim=1),
                                 torch.cat([ref["qpos"], ref["qvel"]], dim=1)))


def step_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The control step's numbers of the stages `prog` answers."""
    out = {"action_gap": float((prog["action"].double() - ref["action"].double()).abs().max()),
           "substep_gap": _state_gap(prog["substep"], ref["substep"]),
           "state_gap": _state_gap(prog["physics"], ref["physics"])}
    if "obs" in prog:
        out["obs_gap"] = float(_rel_rows(prog["obs"], ref["obs"]).max())
        out["reward_gap"] = float((prog["reward"].double() - ref["reward"].double()).abs().max())
    return out


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep: Optional[List[str]] = None) -> float:
    names = keep if keep is not None else list(ref)
    ref_norms = {k: float(ref[k].double().norm()) for k in names}
    median = float(torch.tensor(list(ref_norms.values()), dtype=torch.float64).median())
    worst = 0.0
    for k in names:
        if k not in prog:
            return math.inf
        gap = abs(float(prog[k].double().norm()) - ref_norms[k]) / max(ref_norms[k], median, 1e-30)
        worst = max(worst, gap) if math.isfinite(gap) else math.inf
    return worst


def learn_numbers(prog: dict, ref: dict, prog0: Dict[str, torch.Tensor], ref0: Dict[str, torch.Tensor]) -> Dict[str, float]:
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(losses) if all(math.isfinite(x) for x in losses) else math.inf
    grad_norms = {k: float(v.double().norm()) for k, v in ref["first_grad"].items()}
    median_grad = float(torch.tensor(list(grad_norms.values()), dtype=torch.float64).median())
    moved = [k for k, v in grad_norms.items() if v >= ROUNDOFF_LEAF * median_grad]
    change_p = {k: prog["params"][k] - prog0[k] for k in moved}
    change_r = {k: ref["params"][k] - ref0[k] for k in moved}
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gaps(prog["first_grad"], ref["first_grad"]),
        "change_gap": _leaf_gaps(change_p, change_r),
    }


def init_number(prog0: Dict[str, torch.Tensor], ref0: Dict[str, torch.Tensor]) -> float:
    scale = max(float(v.abs().max()) for v in ref0.values())
    return max(float((prog0[k].double() - ref0[k].double()).abs().max()) for k in ref0) / scale


def mlp_flops(nets) -> Dict[str, int]:
    """Operations of one sample's forward pass through each network's dense
    layers (a multiply-add counts 2)."""
    def count(module):
        return sum(2 * m.in_features * m.out_features for m in module.modules() if isinstance(m, torch.nn.Linear))
    return {"policy_fwd": count(nets.policy_network), "value_fwd": count(nets.value_network)}


def _qpos_qvel(data) -> Dict[str, torch.Tensor]:
    return {"qpos": data.qpos.cpu(), "qvel": data.qvel.cpu()}


class Stages:
    """The reference's control step, stage by stage from the program's
    copied inputs (`recorder.step_copy`)."""

    def __init__(self, env, nets, copy: dict, device):
        self.env, self.nets, self.copy, self.device = env, nets, copy, device

    def action(self, acting_with: dict, alter_action: float = 0.0) -> torch.Tensor:
        c = self.copy
        return step.action(self.nets, acting_with, c["state"]["obs"], c["key_state"], self.device,
                           alter_action=alter_action)

    def substep(self) -> Dict[str, torch.Tensor]:
        return step.first_substep(self.env, self.copy["substep_in"], self.device)

    def physics(self):
        return step.physics(self.env, self.copy["physics_in"], self.device)

    def env_layer(self, physics_out, alter: float = 0.0) -> Dict[str, torch.Tensor]:
        c = self.copy
        return step.env_layer(self.env, c["state"], physics_out, c["physics_in"]["ctrl"], self.device, alter=alter)

    def reference(self, acting_with: dict) -> dict:
        """The float32 reference's answer at every stage; the env layer over
        the program's own physics output. Keeps its substep and physics for
        the faults planted in float32."""
        self.substep_f32, self.physics_f32 = self.substep(), self.physics()
        out = {"action": self.action(acting_with), "substep": self.substep_f32,
               "physics": _qpos_qvel(self.physics_f32)}
        out.update(self.env_layer(step.physics_on_device(self.copy["physics_out"], self.device)))
        return out

    def in_place(self, acting_with: dict, alter_action: float = 0.0, alter_env: float = 0.0,
                 still_physics: bool = False, in_f32: bool = False) -> tuple:
        """(answers, reference) with the reference in the program's place,
        in the precision in force (`in_f32`: float32, its substep and
        physics taken from `reference`), and the reference's float32 answers
        that the check would hold them to: its env layer over this physics
        output. The faults: an altered action or env output, and physics
        that returns its input unchanged."""
        if still_physics:
            carried = self.copy["physics_in"]
            still = {"qpos": carried["qpos"], "qvel": carried["qvel"]}
            return {"action": self.action(acting_with), "substep": still, "physics": still}, None
        sub, phys = (self.substep_f32, self.physics_f32) if in_f32 else (self.substep(), self.physics())
        out = {"action": self.action(acting_with, alter_action), "substep": sub, "physics": _qpos_qvel(phys)}
        out.update(self.env_layer(phys, alter=alter_env))
        with build.precision(False):
            held = self.env_layer(phys)
        return out, held


def _against(answers: dict, held: Optional[dict], ref: dict) -> Dict[str, float]:
    """The step numbers of answers given in the program's place, the env
    layer held to the float32 reference's over the same physics output."""
    return step_numbers(answers, {**ref, **(held or {})})


def run(recorder, cfg: dict, clips_path: str, seed: int, device, control: bool = False) -> dict:
    """The numbers of this run against the reference; with `control`, also
    those of the control (the reference in TF32) and of the planted faults,
    each against the float32 reference. Returns {"program": {...},
    "control": {...}, "faults": {...}, "notes": {...}, "shapes": ..., "flops": ...}."""
    plan = recorder.plan
    env = build.env(cfg, clips_path, device)
    copy = recorder.step_copy
    obs_size, action_size = copy["obs"].shape[-1], copy["action"].shape[-1]
    reference_obs = int(copy["state"]["info"]["reference_obs_size"])
    nets = build.networks(cfg, obs_size, reference_obs, action_size, seed, device)
    initial = {k: v.detach().to("cpu", copy=True) for k, v in build.params(nets).items()}
    normalizer0 = build.initial_normalizer(obs_size)
    prog_learn = {"losses": [float(x) for x in recorder.learner_losses[: plan.checked_steps]],
                  "first_grad": {k: v / 0.1 for k, v in (recorder.first_exp_avg or {}).items()},
                  "params": recorder.params[1]}

    def follow(**fault):
        return learner.follow(nets, cfg, initial, normalizer0, recorder.batches, recorder.generator_states, device,
                              **fault)

    def acting_with(learned: dict) -> dict:
        """What the checked control step's policy acts with: the state the
        learning halves before its training step left."""
        done = plan.check_step[0] - 1
        if done == 0:
            return {"params": initial, "normalizer": normalizer0}
        return learned["after"][done - 1]

    missing = [k for k in ("substep_in", "substep", "physics_in", "physics_out") if k not in copy]
    if missing:
        raise RuntimeError(f"the checked control step's {missing} were not seen: the program no longer calls "
                           "physics.forward.n_step once and physics.forward.step per substep, where the harness "
                           "copies them (benchmark/harness/cell.py)")
    stages = Stages(env, nets, copy, device)
    out = {"shapes": {}, "flops": mlp_flops(nets), "notes": {"init_gap": init_number(recorder.params[0], initial)}}
    with build.precision(False):
        ref_learn = follow()
        with step.solve_shapes(out["shapes"]):
            ref_step = stages.reference(acting_with(ref_learn))
    prog_step = {"action": copy["action"], "obs": copy["obs"], "reward": copy["reward"], "substep": copy["substep"],
                 "physics": {k: copy["physics_out"][k] for k in ("qpos", "qvel")}}
    out["program"] = {**step_numbers(prog_step, ref_step),
                      **learn_numbers(prog_learn, ref_learn, recorder.params[0], initial)}
    if control:
        with build.precision(True):
            ctl_learn = follow()
            ctl_step, ctl_held = stages.in_place(acting_with(ctl_learn))
        out["control"] = {**_against(ctl_step, ctl_held, ref_step), **learn_numbers(ctl_learn, ref_learn, initial, initial)}
        with build.precision(False):
            faults = {"half_batch": follow(half_batch=True), "state_unchanged": follow(frozen_state=True)}
            out["faults"] = {name: {"action_gap": float((stages.action(acting_with(f)).double()
                                                         - ref_step["action"].double()).abs().max()),
                                    **learn_numbers(f, ref_learn, initial, initial)} for name, f in faults.items()}
            acting = acting_with(ref_learn)
            out["faults"]["altered_action"] = _against(*stages.in_place(acting, alter_action=0.5, in_f32=True), ref_step)
            out["faults"]["altered_env_output"] = _against(*stages.in_place(acting, alter_env=0.5, in_f32=True),
                                                           ref_step)
            out["faults"]["physics_unchanged"] = _against(*stages.in_place(acting, still_physics=True), ref_step)
    return out


def compared(limits: Dict[str, Optional[float]]) -> list:
    return [n for n in NAMES if limits[n] is not None]


def failed(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> list:
    """The compared numbers that are not finite or exceed their limits."""
    return [n for n in compared(limits) if not (math.isfinite(numbers[n]) and numbers[n] <= limits[n])]
