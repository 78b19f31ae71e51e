"""train.mfu_pct: the operations the window's training steps need, as
counted at the cell's shapes (`roofline.training_step_flops`: the networks'
dense layers in the rollout and the learning half, and the fused constraint
solves), over the window's host seconds, as a share of the card's float32
peak."""

from benchmark.harness import roofline


def read(run):
    flops, shapes = run.get("flops"), run.get("solve_shapes")
    if not flops or not shapes or run["window_steps"] < 1:
        return None
    (name, (b, n, nl, nc, its, ls)), = shapes.items()
    per_solve = roofline.solve_flops(n, nl, nc, 4 if name == "cg_solve" else 3, its, ls)
    step = roofline.training_step_flops(
        envs=run["num_envs"], unroll=run["control_steps_per_step"], passes=run["passes"],
        policy_fwd=flops["policy_fwd"], value_fwd=flops["value_fwd"],
        solve_per_env_substep=per_solve, substeps=run["substeps"],
    )
    return 100.0 * step * run["window_steps"] / run["window_s"] / roofline.F32_FLOP_PER_S
