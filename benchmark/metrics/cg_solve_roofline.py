"""cg_solve_roofline: K2, the fused pyramidal solve (csrc/cg_solve.cu), as a
share of its roofline: the least time at the cell's shapes (the larger of
its bytes over the HBM rate and its operations over the float32 rate,
counted from the envs, n, limit rows, contacts and iterations) over the
kernel's mean device time per launch in the profiled control step."""

from benchmark.harness import roofline


def read(run):
    prof, shapes = run.get("profile"), run["solve_shapes"].get("cg_solve")
    if not prof or not shapes:
        return None
    hits = [v for name, v in prof["by_kernel"].items() if "cg_solve_kernel" in name and "ell_cg_solve" not in name
            and "dense" not in name]
    count = sum(c for c, _ in hits)
    if not count:
        return None
    b, n, nl, nc, its, ls = shapes
    least, _ = roofline.least_seconds(roofline.solve_bytes(b, n, nl, nc, 4),
                                      b * roofline.solve_flops(n, nl, nc, 4, its, ls))
    return 100.0 * least / (sum(s for _, s in hits) / count)
