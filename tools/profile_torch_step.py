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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        data = data.replace(ctrl=ctrl())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            data = tf.n_step(plan, model, data, SUBSTEPS)
            sync()
        events = prof.key_averages()
        device_rows = [e for e in events if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in device_rows) / 1e3
        top = sorted(device_rows, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        summary.update({
            "profiled_device_kernels": sum(e.count for e in device_rows),
            "profiled_cuda_launch_calls": sum(
                e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel")
            ),
            "profiled_device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms,
            "top_device_kernels": [
                {"name": e.key[:80], "count": e.count, "ms": e.self_device_time_total / 1e3}
                for e in top
            ],
        })
        port = {}
        for e in device_rows:
            name = _port_kernel(e.key)
            if name:
                row = port.setdefault(name, {"count": 0, "ms": 0.0})
                row["count"] += e.count
                row["ms"] += e.self_device_time_total / 1e3
        summary["port_kernels"] = port

    line = json.dumps(summary)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
