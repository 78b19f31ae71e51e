"""Smoke run of the torch port's rodent physics control step on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA device and nvcc):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each of which raises on failure:

1. Device: requires CUDA, prints the card's name and power limit as
   nvidia-smi reports them, builds csrc/cg_solve.cu for sm_90a.
2. Kernel against plain: 4096 contact-rich rodent states (the main path's
   batch) made on the card with the port's forward stages go through the
   CUDA kernel and its plain PyTorch version; each output's error is held
   to a bar. Then both are timed on the same inputs with CUDA events.
3. Main path: the rodent-full-clips snapshot, 4096 envs, 1 warm-up and 5
   timed control steps of forward.n_step(..., 10). Every substep must launch
   the kernel once (60 launches), the state must stay finite and contacts
   must be active. For 64 of those envs, the warm-up control step and one
   substep from the state after it are repeated on the CPU (plain version)
   from the same state and controls and compared.
4. Prints the kernels' JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 4096
N_CPU = 64
SUBSTEPS = 10
CONTROL_STEPS = 5  # timed, after one warm-up control step
SEED = 0
# Controls are drawn from CTRL_SCALE * U(-1, 1). At full scale, U(-1, 1)
# drawn afresh each control step drives a share of rodents non-finite within
# a few control steps, in the JAX package as in the port (PERF.md): the
# torque actuators are strong for the light segments. This amplitude keeps
# every env finite over the run.
CTRL_SCALE = 0.2
# Kernel against plain, relative to max(1, max |plain|): the bars of the
# JAX package's kernel parity test (tests/test_cg_kernel_parity.py).
KERNEL_REL = {
    "qacc_smooth": 5e-5,
    "qacc": 1e-4,
    "efc_force": 1e-3,
    "qfrc_constraint": 1e-3,
    "qacc_eff": 5e-4,
}
# Card against CPU over the warm-up control step (10 substeps from rest),
# per env relative to max(1, max |cpu|). The rodent under contact amplifies
# f32 roundoff across substeps, so the bar is on the median env for qvel
# and on the worst env for qpos (see PERF.md, "Open questions").
STEP_REL = {"qpos_max": 1e-2, "qvel_median": 1e-3}
# Card against CPU over one substep from the state after the warm-up control
# step, on the worst env, relative to max(1, max |cpu|) of that env. One
# substep is too short for the amplification above, so qacc and efc_force
# are held to the kernel's own bars. qacc_eff = (M + h D)^-1 (qfrc_smooth +
# qfrc_constraint) takes qfrc_constraint's roundoff through the inverse and
# carries its bar, 1e-3, as in the JAX package's fused Euler test; so does
# qvel = qvel + h qacc_eff.
SUBSTEP_REL = {"qacc": 1e-4, "qacc_eff": 1e-3, "efc_force": 1e-3, "qvel": 1e-3}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, REPO)
    from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.physics import solver as ts

    # 1. device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    path, build_s, log = tk.build_library()
    print(f"built {os.path.relpath(path, REPO)} from {os.path.relpath(tk.SOURCE, REPO)} "
          f"with nvcc for sm_90a in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    tf.set_full_f32()
    dev = torch.device("cuda")
    plan, model = tm.put_model(tm.load_snapshot(), device=dev)
    its, ls = plan.iterations, plan.ls_iterations
    print(f"rodent: nq={plan.nq} nv={plan.nv} nu={plan.nu} ncon={plan.ncon} "
          f"nefc={plan.nefc} cg {its}/{ls} dt={float(model.opt_timestep)}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    # 2. kernel against plain on contact-rich states
    def solver_inputs(bsz):
        d = tm.make_data(plan, model, bsz)
        qpos = d.qpos.clone()
        qpos[:, 2] -= uniform((bsz,), 0.008, 0.016)
        qpos[:, 7:] += uniform((bsz, plan.nq - 7), -0.08, 0.08)
        d = d.replace(
            qpos=qpos,
            qvel=uniform((bsz, plan.nv), -0.5, 0.5),
            ctrl=uniform((bsz, plan.nu), -0.5, 0.5),
            qacc_warmstart=uniform((bsz, plan.nv), -1.0, 1.0),
        )
        d, efc = tf.fwd_position(plan, model, d)
        d = tf.fwd_velocity(plan, model, d)
        d = tf.fwd_actuation(plan, model, d)
        d = tf.fwd_acceleration(plan, model, d)
        return ts.solve_inputs(plan, model, d, efc)

    inputs = solver_inputs(N_ENVS)
    before = tk.cg_solve.launches
    kernel = tk.cg_solve(**inputs, iterations=its, ls_iterations=ls)
    torch.cuda.synchronize()
    assert tk.cg_solve.launches == before + 1, "the wrapper did not launch the kernel"
    plain = tk.cg_solve_plain(**inputs, iterations=its, ls_iterations=ls)
    torch.cuda.synchronize()
    rich = float((plain.efc_force != 0).any(dim=1).float().mean())
    print(f"{N_ENVS} states, share with active constraint rows {rich:.3f}")
    assert rich > 0.9, "states are not contact-rich"
    max_abs = 0.0
    for name, bar in KERNEL_REL.items():
        a, b = getattr(kernel, name), getattr(plain, name)
        assert torch.isfinite(a).all(), f"kernel {name} not finite"
        err = _rel(a, b)
        abs_err = float((a - b).abs().max())
        max_abs = max(max_abs, abs_err)
        print(f"kernel vs plain {name}: max rel err {err:.3e} (bar {bar:.0e}), "
              f"max abs err {abs_err:.3e}, max |plain| {float(b.abs().max()):.3e}")
        assert err < bar, f"kernel {name} disagrees with plain: {err:.3e} >= {bar:.0e}"

    kernel_ms = _time_ms(lambda: tk.cg_solve(**inputs, iterations=its, ls_iterations=ls), 20)
    plain_ms = _time_ms(lambda: tk.cg_solve_plain(**inputs, iterations=its, ls_iterations=ls), 3)
    print(f"cg_solve at B={N_ENVS}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    del inputs, kernel, plain

    # 3. main path: 1 warm-up + 5 timed control steps of n_step(..., 10)
    data = tm.make_data(plan, model, N_ENVS)
    qpos = data.qpos.clone()
    qpos[:, 7:] += uniform((N_ENVS, plan.nq - 7), -0.001, 0.001)  # reset noise
    data = data.replace(qpos=qpos)
    ctrls = [CTRL_SCALE * uniform((N_ENVS, plan.nu), -1.0, 1.0) for _ in range(1 + CONTROL_STEPS)]
    start = tf.slim_data(data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.cg_solve.launches = 0
    data = tf.n_step(plan, model, data.replace(ctrl=ctrls[0]), SUBSTEPS)
    torch.cuda.synchronize()
    after_warmup = tf.slim_data(data)
    t0 = time.perf_counter()
    for c in range(1, 1 + CONTROL_STEPS):
        data = tf.n_step(plan, model, data.replace(ctrl=ctrls[c]), SUBSTEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tk.cg_solve.launches
    peak = torch.cuda.max_memory_allocated()
    expected = (1 + CONTROL_STEPS) * SUBSTEPS
    assert launches == expected, f"cg_solve launched {launches} times, expected {expected}"
    for name in ("qpos", "qvel", "act", "qacc", "qacc_eff", "efc_force", "sensordata", "xpos"):
        t = getattr(data, name)
        assert t.shape[0] == N_ENVS and torch.isfinite(t).all(), f"{name} is not finite"
    active = (data.contact_dist < 0).sum(dim=1)
    assert active.sum() > 0, "no contact is active"
    env_steps = CONTROL_STEPS * N_ENVS / seconds
    print(f"main path: {N_ENVS} envs x {CONTROL_STEPS} control steps x {SUBSTEPS} substeps in "
          f"{seconds:.3f} s: {env_steps:.1f} env-steps/s, {env_steps * SUBSTEPS:.1f} env-substeps/s; "
          f"kernel launches {launches}; active contacts/env {float(active.float().mean()):.2f}; "
          f"peak memory {peak} B ({card})")

    # the warm-up control step of the first N_CPU envs, again on the CPU
    cpu_plan, cpu_model = tm.put_model(tm.load_snapshot())
    cpu = tm.make_data(cpu_plan, cpu_model, N_CPU).replace(
        **{k: getattr(start, k)[:N_CPU].cpu() for k in ("time", "qpos", "qvel", "act", "qacc_warmstart")},
        ctrl=ctrls[0][:N_CPU].cpu(),
    )
    cpu = tf.n_step(cpu_plan, cpu_model, cpu, SUBSTEPS)
    errs = {}
    for name in ("qpos", "qvel"):
        a, b = getattr(after_warmup, name)[:N_CPU].cpu(), getattr(cpu, name)
        per_env = (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0)
        errs[name] = (float(per_env.median()), float(per_env.max()))
        print(f"card vs CPU, one control step, {N_CPU} envs, {name}: per-env rel err "
              f"median {errs[name][0]:.3e} max {errs[name][1]:.3e}")
    assert errs["qpos"][1] < STEP_REL["qpos_max"], f"card and CPU qpos differ: {errs['qpos']}"
    assert errs["qvel"][0] < STEP_REL["qvel_median"], f"card and CPU qvel differ: {errs['qvel']}"

    # one substep of the same envs from the state after the warm-up step
    slim = tf.SlimData(**{f: getattr(after_warmup, f)[:N_CPU] for f in tf._CARRY_FIELDS})
    card_sub = tf.step(plan, model, tf.expand_slim(plan, model, slim))
    cpu_sub = tf.step(cpu_plan, cpu_model, tf.expand_slim(
        cpu_plan, cpu_model, tf.SlimData(**{f: getattr(slim, f).cpu() for f in tf._CARRY_FIELDS})))
    worst = {}
    for name, bar in SUBSTEP_REL.items():
        a, b = getattr(card_sub, name).cpu(), getattr(cpu_sub, name)
        per_env = (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0)
        worst[name] = float(per_env.max())
        print(f"card vs CPU, one substep, {N_CPU} envs, {name}: per-env rel err "
              f"max {worst[name]:.3e} (bar {bar:.0e})")
    for name, bar in SUBSTEP_REL.items():
        assert worst[name] < bar, f"card and CPU {name} differ after one substep: {worst[name]:.3e}"

    # 4. results
    print(json.dumps({"kernels": [{
        "name": "cg_solve",
        "route": "cuda",
        "source": "track_mjx_tpu_torch/csrc/cg_solve.cu",
        "replaces": "track_mjx_tpu/ops/cg_solver_kernel.py:146",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
