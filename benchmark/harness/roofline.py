"""Peaks of one NVIDIA H100 and the operations and bytes the work needs at a
cell's shapes, counted from the problem, not from how the program computes
it.

Peaks: NVIDIA's data sheet for the SXM part at its 700 W limit: 3.35 TB/s of
HBM and 67 TFLOP/s in float32 outside the tensor cores (the port runs
float32 with TF32 off). `solve_flops` is the count of the fused constraint
solve from the repository's chip_smoke.py, copied here so that a later change
to the program cannot change the yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32 = 4


def solve_flops(n: int, nl: int, nc: int, rows_per_con: int, its: int, ls: int, *,
                dense_rows: int | None = None, with_euler: bool = True) -> int:
    """Floating-point operations of one env's fused solve (a multiply-add
    counts 2): qM and J builds, two Cholesky factorizations (n^3 / 3 each),
    its + 3 (L L^T)^-1 applies (2 n^2 each), the J, J^T and M products, and the
    linesearch's row passes (about 6 operations per limit or pyramid row and
    60 per cone block). `rows_per_con` is 4 for pyramidal contacts (K2), 3
    for elliptic cones (K3); without the Euler solve, one factor and one
    apply less."""
    e = nl + rows_per_con * nc if dense_rows is None else dense_rows
    qm = 6 * n * (n + 1)
    jb = 0 if dense_rows is not None else nc * n * (36 + (8 if rows_per_con == 4 else 0)) + nl * n
    factor = (2 if with_euler else 1) * n**3 // 3
    applies = (its + (3 if with_euler else 2)) * 2 * n * n
    if rows_per_con == 4:  # incremental jar / M dx: 2 J, 1 M, 1 J^T per iteration
        mv_j, mv_jt, mv_m = 2 + its, 1 + its + 1, 1 + its
        row_pass = (ls + 1) * 6 * e
    else:  # fresh jar / M (x - smooth): 2 J, 2 M, 1 J^T per iteration
        mv_j, mv_jt, mv_m = 2 + 2 * its, 1 + its + 1, 1 + 2 * its
        row_pass = (ls + 3) * (6 * nl + 60 * nc)
    return (qm + jb + factor + applies + 2 * e * n * (mv_j + mv_jt) + 2 * n * n * mv_m
            + its * row_pass)


def solve_bytes(b: int, n: int, nl: int, nc: int, rows_per_con: int, with_euler: bool = True) -> int:
    """Bytes a fused solve of `b` envs must move, each input read once and
    each output written once: per env buf, cdof, sw [n, 6], fq [nc, 3, 6],
    ll [nl], mu [nc, 2] (K2) or [nc] (K3), aref and D [e], qfrc_smooth, warm,
    hd [n], tolscale; shared anc [n, n], arm [n], dm [nc, n], lim1h [nl, n];
    out qacc_smooth, qacc, qfrc_constraint (and qacc_eff) [n], efc_force [e]."""
    e = nl + rows_per_con * nc
    mu = 2 * nc if rows_per_con == 4 else nc
    per_env_in = 3 * n * 6 + nc * 18 + nl + mu + 2 * e + 3 * n + 1
    shared = n * n + n + nc * n + nl * n
    per_env_out = (4 if with_euler else 3) * n + e
    return F32 * (b * (per_env_in + per_env_out) + shared)


def least_seconds(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate against
    operations over the float32 rate; returns (seconds, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def mlp_flops(widths) -> int:
    """Operations of one sample's forward pass through dense layers of
    widths [in, h1, ..., out] (a multiply-add counts 2)."""
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def training_step_flops(*, envs: int, unroll: int, passes: int, policy_fwd: int, value_fwd: int,
                        solve_per_env_substep: int, substeps: int) -> int:
    """Operations one training step needs, as counted: the rollout's policy
    forward and constraint solves (envs x unroll control steps of `substeps`
    solves each), and the learning half's `passes` over every sample, each a
    forward and a backward (3 forwards' worth) of the policy and the value
    network plus the bootstrap value's forward on the last step."""
    samples = envs * unroll
    rollout = samples * (policy_fwd + substeps * solve_per_env_substep)
    learn = passes * (3 * samples * (policy_fwd + value_fwd) + envs * value_fwd)
    return rollout + learn
