"""What the per-layer readers (`benchmark/metrics/<metric>.py`, each a
`read(run)` that returns a number or None) are given: the profiled control
step's summary, the trainer's phase times in the window, the window's peak
memory, the fused solves' shapes and the operations counted at the cell's
shapes."""

from __future__ import annotations


def context(recorder, driven: dict, plan) -> dict:
    window = recorder.window
    env_args = plan.config["env_config"]["env_args"]
    return {
        "profile": recorder.profile,
        "phase_ms": recorder.phase_ms(),
        "memory_peak_window": recorder.memory_peak_window,
        "solve_shapes": driven.get("solve_shapes", {}),
        "flops": driven.get("flops", {}),
        "window_steps": window.steps,
        "window_s": window.span,
        "num_envs": plan.num_envs,
        "unroll_length": plan.unroll_length,
        "control_steps_per_step": plan.control_steps_per_step,
        "passes": int(plan.train_config["num_updates_per_batch"]),
        "substeps": int(env_args["physics_steps_per_control_step"]),
    }
