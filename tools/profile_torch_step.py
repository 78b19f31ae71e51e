"""Where the time of the torch port's control step goes, on one device.

Usage (from the repository root):

    python3 tools/profile_torch_step.py [--config rodent-full-clips]
        [--solver cg|newton] [--envs 4096] [--reps 5] [--out FILE]

It loads the `--config` snapshot (rodent-full-clips or fly-mc-intention),
sets its opt.solver to `--solver` (both configs run CG; newton is the
env_args.solver: newton plan, which factors qM in its own stage), puts `--envs` envs at rest (with reset noise) and runs one warm-up control
step of `forward.n_step(..., 10)` with controls drawn as chip_smoke.py draws
them (0.2 x U(-1, 1) for the rodent, U(-1, 1) for the fly). Then it
measures, from that state:

- each forward stage of one substep, timed on the host clock between two
  device synchronizations, median over `--stage-reps` substeps;
- the wall time of `--reps` control steps, each between two
  synchronizations, so their spread is a noise bound within one run;
- one control step under `torch.profiler` (CUDA only): the number of device
  kernels and their summed device time, and from those and the median wall
  time the share of the control step in which the device is idle; the
  launches and device ms of each of the port's CUDA kernels.

With `--rollout` (rodent-full-clips) it profiles one control step of the
rollout instead (track_mjx_tpu_torch/rollout.py: the wrapped tracking env
and the stochastic intention policy, as chip_smoke.py's phase 4 builds
them), from the state after one warm-up unroll of the config's
unroll_length: the step's parts timed between two synchronizations
(median of `--stage-reps`): the policy forward, the physics (n_step), the
reference gather, the reward, the obs, the NaN guard and the auto-reset
swap; `--reps` whole rollout control steps (policy and wrapped env step);
and one of them under `torch.profiler`.

It prints one JSON object as its last line and writes it to `--out` when
given. `--device cpu` runs the same phases at a small `--envs` (no profile).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from track_mjx_tpu_torch.physics import actuation as _actuation  # noqa: E402
from track_mjx_tpu_torch.physics import collision as _collision  # noqa: E402
from track_mjx_tpu_torch.physics import com as _com  # noqa: E402
from track_mjx_tpu_torch.physics import constraint as _constraint  # noqa: E402
from track_mjx_tpu_torch.physics import forward as tf  # noqa: E402
from track_mjx_tpu_torch.physics import inertia as _inertia  # noqa: E402
from track_mjx_tpu_torch.physics import kinematics as _kinematics  # noqa: E402
from track_mjx_tpu_torch.physics import model as tm  # noqa: E402
from track_mjx_tpu_torch.physics import passive as _passive  # noqa: E402
from track_mjx_tpu_torch.physics import rne as _rne  # noqa: E402
from track_mjx_tpu_torch.physics import sensors as _sensors  # noqa: E402
from track_mjx_tpu_torch.physics import solver as _solver  # noqa: E402

SUBSTEPS = 10
CTRL_SCALE = {"rodent-full-clips": 0.2, "fly-mc-intention": 1.0}  # as chip_smoke.py
SOLVERS = {"cg": tm.SOLVER_CG, "newton": tm.SOLVER_NEWTON}


def _stages(plan, model, data):
    """forward() then euler(), as (name, callable) pairs over a shared state.
    Plans that are not fused CG factor qM in a stage of its own."""
    state = {"data": data}

    def run(fn):
        def call():
            state["data"] = fn(state["data"])
        return call

    def collide():
        state["data"], state["contact"] = _collision.collide(plan, model, state["data"])

    def make_constraint():
        state["efc"] = _constraint.make_constraint(plan, model, state["data"], state["contact"])

    def solve():
        state["data"] = _solver.solve(plan, model, state["data"], state["efc"])

    factor_m = [] if _solver.fused_cg(plan) else [
        ("factor_m", run(lambda d: _inertia.factor_m(plan, model, d)))
    ]
    return [
        ("kinematics", run(lambda d: _kinematics.kinematics(plan, model, d))),
        ("com_pos", run(lambda d: _com.com_pos(plan, model, d))),
        ("tendon", run(lambda d: _actuation.tendon(plan, model, d))),
        ("crb", run(lambda d: _inertia.crb(plan, model, d))),
        *factor_m,
        ("collide", collide),
        ("make_constraint", make_constraint),
        ("com_vel", run(lambda d: _com.com_vel(plan, model, d))),
        ("passive", run(lambda d: _passive.passive(plan, model, d))),
        ("rne", run(lambda d: _rne.rne(plan, model, d))),
        ("actuation", run(lambda d: _actuation.actuation(plan, model, d))),
        ("fwd_acceleration", run(lambda d: tf.fwd_acceleration(plan, model, d))),
        ("solve", solve),
        ("sensors", run(lambda d: _sensors.sensor(plan, model, d))),
        ("euler", run(lambda d: tf.euler(plan, model, d))),
    ]


def _port_kernel(key: str) -> str | None:
    """The wrapper whose hand-written CUDA kernel a profiler row is, or None:
    csrc/batched_linalg.cu's tiled factor serves cholesky (kSolve false)
    and solve_spd (true)."""
    if "::tiled_kernel<" in key:
        return "solve_spd" if "tiled_kernel<true>" in key else "cholesky"
    for name in ("ell_cg_solve", "cg_solve", "cho_solve"):
        if f"::{name}_kernel(" in key:
            return name
    return None


def _rollout_parts(ro, state, policy, gen):
    """One rollout control step cut into its parts, as (name, callable)
    pairs over a shared dict (the swap takes the NaN guard's flags for
    done)."""
    from track_mjx_tpu_torch.envs.task.reward import compute_tracking_rewards
    from track_mjx_tpu_torch.envs.wrappers import _where_done

    env = ro.tracking
    s = {"state": state}

    def policy_forward():
        s["action"], _ = policy(s["state"].obs, gen)

    def physics():
        s["data"] = env.pipeline_step(s["state"].pipeline_state, s["action"])

    def reference():
        s["frame"], s["traj"] = env._get_step_reference(s["state"].info, s["data"])

    def reward():
        info = dict(s["state"].info, prev_ctrl=s["state"].info["prev_ctrl"])
        s["terms"] = compute_tracking_rewards(s["data"], s["frame"], env.walker, s["action"], info,
                                              env._reward_config)

    def obs():
        ref_obs, prop_obs = env._get_obs_from_traj(s["data"], s["traj"])
        s["obs"] = torch.cat([ref_obs, prop_obs], dim=1)

    def nan_guard():
        s["obs"] = torch.nan_to_num(s["obs"])
        s["nan"] = env.nan_count(s["data"]) > 0

    def auto_reset_swap():
        first = s["state"].info["first_pipeline_state"]
        done = s["nan"].float()
        slim = tf.slim_data(s["data"])
        s["slim"] = tf.SlimData(**{f: _where_done(done, getattr(first, f), getattr(slim, f))
                                   for f in tf._CARRY_FIELDS})
        s["obs"] = _where_done(done, s["state"].info["first_obs"], s["obs"])

    parts = [("policy_forward", policy_forward), ("physics", physics), ("reference_gather", reference),
             ("reward", reward), ("obs", obs), ("nan_guard", nan_guard), ("auto_reset_swap", auto_reset_swap)]
    return parts, s


def rollout_main(args, dev, sync, card) -> dict:
    """The --rollout profile: see the module docstring."""
    from track_mjx_tpu_torch import rollout as trollout
    from track_mjx_tpu_torch.agent import acting

    ro = trollout.make_rollout(args.config, seed=args.seed, device=dev)
    policy = ro.policy()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = ro.env.reset(gen, args.envs)
    state, _ = acting.generate_unroll(ro.env, state, policy, gen, ro.unroll_length)  # warm-up
    sync()

    part_ms: dict[str, list[float]] = {}
    for _ in range(args.stage_reps):
        parts, s = _rollout_parts(ro, state, policy, gen)
        for name, call in parts:
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            part_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        # the next state, untimed: the wrapped env's own step on the same
        # action, so the parts stay on the trajectory the rollout follows
        state = ro.env.step(state, s["action"])
    parts = {k: statistics.median(v) for k, v in part_ms.items()}
    step_ms = []
    for _ in range(args.reps):
        sync()
        t0 = time.perf_counter()
        state, _ = acting.actor_step(ro.env, state, policy, gen)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(state.obs).all():
        raise RuntimeError("obs not finite after the timed rollout steps")
    wall_ms = statistics.median(step_ms)
    summary = {
        "card": card,
        "config": args.config,
        "rollout": True,
        "torch": torch.__version__,
        "envs": args.envs,
        "substeps": SUBSTEPS,
        "rollout_part_ms": parts,
        "rollout_step_ms": step_ms,
        "rollout_step_ms_median": wall_ms,
        "env_steps_per_s_median": args.envs / (wall_ms / 1e3),
    }
    if dev.type == "cuda":
        summary.update(_profile(lambda: acting.actor_step(ro.env, state, policy, gen), sync, wall_ms))
    return summary


def _profile(fn, sync, wall_ms) -> dict:
    """One call of `fn` under torch.profiler: device kernels, device ms,
    idle share against `wall_ms`, the biggest kernels and the port's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    events = prof.key_averages()
    device_rows = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device_rows) / 1e3
    top = sorted(device_rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    port = {}
    for e in device_rows:
        name = _port_kernel(e.key)
        if name:
            row = port.setdefault(name, {"count": 0, "ms": 0.0})
            row["count"] += e.count
            row["ms"] += e.self_device_time_total / 1e3
    return {
        "profiled_device_kernels": sum(e.count for e in device_rows),
        "profiled_cuda_launch_calls": sum(
            e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel")
        ),
        "profiled_device_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms,
        "top_device_kernels": [
            {"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3} for e in top
        ],
        "port_kernels": port,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CTRL_SCALE), default="rodent-full-clips")
    ap.add_argument("--solver", choices=sorted(SOLVERS), default="cg")
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5, help="timed control steps")
    ap.add_argument("--stage-reps", type=int, default=3, help="substeps timed stage by stage")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON summary here")
    ap.add_argument("--rollout", action="store_true", help="profile a rollout control step (policy + env)")
    args = ap.parse_args()

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    card = "cpu"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    print(card)
    tf.set_full_f32()
    if args.rollout:
        _write(rollout_main(args, dev, sync, card), args.out)
        return
    snap = tm.load_snapshot(args.config)
    snap.opt.solver = SOLVERS[args.solver]
    plan, model = tm.put_model(snap, device=dev)
    scale = CTRL_SCALE[args.config]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def ctrl():
        return scale * (2.0 * torch.rand((args.envs, plan.nu), generator=gen, device=dev) - 1.0)

    data = tm.make_data(plan, model, args.envs)
    qpos = data.qpos.clone()
    qpos[:, 7:] += 0.002 * torch.rand((args.envs, plan.nq - 7), generator=gen, device=dev) - 0.001
    data = tf.n_step(plan, model, data.replace(qpos=qpos, ctrl=ctrl()), SUBSTEPS)  # warm-up
    sync()
    carry = {f: getattr(data, f) for f in tf._CARRY_FIELDS}
    template = tm.make_data(plan, model, args.envs)

    # stages of one substep, each between two synchronizations
    stage_ms: dict[str, list[float]] = {}
    for _ in range(args.stage_reps):
        for name, call in _stages(plan, model, template.replace(**carry)):
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            stage_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    stages = {k: statistics.median(v) for k, v in stage_ms.items()}

    # control steps, each between two synchronizations
    step_ms = []
    for _ in range(args.reps):
        data = data.replace(ctrl=ctrl())
        sync()
        t0 = time.perf_counter()
        data = tf.n_step(plan, model, data, SUBSTEPS)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    for name in ("qpos", "qvel", "qacc"):
        if not torch.isfinite(getattr(data, name)).all():
            raise RuntimeError(f"{name} is not finite after the timed control steps")
    wall_ms = statistics.median(step_ms)

    summary = {
        "card": card,
        "config": args.config,
        "solver": args.solver,
        "torch": torch.__version__,
        "envs": args.envs,
        "substeps": SUBSTEPS,
        "stage_ms_one_substep": stages,
        "stage_ms_total": sum(stages.values()),
        "control_step_ms": step_ms,
        "control_step_ms_median": wall_ms,
        "env_steps_per_s_median": args.envs / (wall_ms / 1e3),
    }

    if cuda:
        data = data.replace(ctrl=ctrl())
        summary.update(_profile(lambda: tf.n_step(plan, model, data, SUBSTEPS), sync, wall_ms))
    _write(summary, args.out)


def _write(summary: dict, out: str | None) -> None:
    line = json.dumps(summary)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
