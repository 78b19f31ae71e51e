"""Batched small-matrix Cholesky routines, [B, n, n]: plain PyTorch
versions, and the standalone CUDA kernels with their wrappers.

Plain versions of the device routines of track_mjx_tpu/ops/batched_linalg.py
that the fused CG solves run inside themselves: `factor` (factor_in_place,
the right-looking Cholesky with c = row * rsqrt(diag)), `invert_diag_blocks`
(inverses of the 8x8 diagonal panels of L), `blocked_substitution_pinv`
(L L^T x = b by panel substitution through those inverses; the scalar
solve) and `blocked_substitution` (the exact panel-8 forward and back
substitution; the elliptic solve and cho_solve). They are the arithmetic of
the CUDA device routines in csrc/tiled_cholesky.cuh and csrc/cholesky.cuh,
written as batched torch ops.

The standalone kernels (csrc/batched_linalg.cu) replace the TPU kernels
`_cholesky_kernel`, `_cho_solve_kernel` and `_solve_spd_kernel` of the same
JAX module, which the non-fused plans run (`inertia.factor_m`/`solve_m`, the
Newton solve, Euler's implicit-damping solve). `cholesky(a)`,
`cho_solve(l, b)` and `solve_spd(a, b)` are their wrappers: they check their
arguments, run the plain version (`cholesky_plain`, `cho_solve_plain`,
`solve_spd_plain`) for CPU tensors and launch the kernel for CUDA tensors,
raising if the build or the launch fails. `<wrapper>.launches` counts kernel
launches. All three keep the lower triangle of their matrix in the tiles of
csrc/tiled_cholesky.cuh, which take n <= MAX_N, and read nothing above the
diagonal, as the plain versions do; their wrappers raise for a larger n on
the card. `cholesky` and `solve_spd` run its tiled factor, `cho_solve` and
`solve_spd` its exact substitution (`cho_solve` on one warp per env).
"""

from __future__ import annotations

import torch


PANEL = 8
# The kernels on csrc/batched_linalg.cu's tiled factor, and the largest n
# any kernel of the port takes (the TPU kernels' documented range).
TILED = ("cholesky", "solve_spd")
MAX_N = 128


def factor(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD [B, n, n] matrices (upper triangle zero).

    Right-looking: step j scales column j by rsqrt(diag) and subtracts the
    rank-1 update from the trailing block. Works in place on a copy of `a`."""
    n = a.shape[-1]
    l = a.clone()
    for j in range(n):
        c = l[:, j:, j] * torch.rsqrt(l[:, j, j])[:, None]
        l[:, j:, j] = c
        colm = c[:, 1:]
        l[:, j + 1 :, j + 1 :] -= colm[:, :, None] * colm[:, None, :]
    return torch.tril(l)


def invert_diag_blocks(l: torch.Tensor, panel: int = PANEL) -> torch.Tensor:
    """[B, n, panel]: rows p0..p0+m of the result hold inv(L[p0:p0+m, p0:p0+m])
    for every panel (columns >= m of a short last panel are zero)."""
    bsz, n, _ = l.shape
    out = l.new_zeros((bsz, n, panel))
    for p0 in range(0, n, panel):
        m = min(panel, n - p0)
        lpan = l[:, p0 : p0 + m, p0 : p0 + m]
        eye = torch.eye(m, dtype=l.dtype, device=l.device)
        rows = []
        for jj in range(m):
            s = l.new_zeros((bsz, m))
            if jj:
                xk = torch.stack(rows, dim=1)  # [B, jj, m]
                s = (lpan[:, jj, :jj, None] * xk).sum(1)
            rows.append((eye[jj] - s) / lpan[:, jj, jj, None])
        out[:, p0 : p0 + m, :m] = torch.stack(rows, dim=1)
    return out


def blocked_substitution_pinv(
    l: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor, panel: int = PANEL
) -> torch.Tensor:
    """Solves L L^T x = b for [B, n, n] lower factors and [B, n] right-hand
    sides, one panel at a time: y_p = inv(L_pp) r_p forward, x_p =
    inv(L_pp)^T y_p backward, each followed by one update of the remaining
    right-hand side (in place, on this function's own copies)."""
    n = l.shape[-1]
    out = b.clone()
    y = torch.zeros_like(b)
    for p0 in range(0, n, panel):
        m = min(panel, n - p0)
        yp = (dinv[:, p0 : p0 + m, :m] * out[:, None, p0 : p0 + m]).sum(-1)
        y[:, p0 : p0 + m] = yp
        if p0 + m < n:
            out[:, p0 + m :] -= (l[:, p0 + m :, p0 : p0 + m] * yp[:, None, :]).sum(-1)
    for p0 in reversed(range(0, n, panel)):
        m = min(panel, n - p0)
        xp = (dinv[:, p0 : p0 + m, :m] * y[:, p0 : p0 + m, None]).sum(1)
        out[:, p0 : p0 + m] = xp
        if p0 > 0:
            y[:, :p0] -= (l[:, p0 : p0 + m, :p0] * xp[:, :, None]).sum(1)
    return out


def blocked_substitution(l: torch.Tensor, b: torch.Tensor, panel: int = PANEL) -> torch.Tensor:
    """Solves L L^T x = b for [B, n, n] lower factors and [B, n] right-hand
    sides by panel forward and back substitution: within a panel each row is
    solved in turn, (r_j - sum_{k<j} L_jk y_k) / L_jj, then one update takes
    the panel's solution out of the remaining right-hand side. Reads only
    the lower triangle of `l`."""
    n = l.shape[-1]
    out = b.clone()
    y = torch.zeros_like(b)
    for p0 in range(0, n, panel):
        m = min(panel, n - p0)
        lpan = l[:, p0 : p0 + m, p0 : p0 + m]
        for jj in range(m):
            s = (lpan[:, jj, :jj] * y[:, p0 : p0 + jj]).sum(-1)
            y[:, p0 + jj] = (out[:, p0 + jj] - s) / lpan[:, jj, jj]
        if p0 + m < n:
            out[:, p0 + m :] -= (l[:, p0 + m :, p0 : p0 + m] * y[:, None, p0 : p0 + m]).sum(-1)
    for p0 in reversed(range(0, n, panel)):
        m = min(panel, n - p0)
        lpan = l[:, p0 : p0 + m, p0 : p0 + m]
        for jj in range(m - 1, -1, -1):
            s = (lpan[:, jj + 1 :, jj] * out[:, p0 + jj + 1 : p0 + m]).sum(-1)
            out[:, p0 + jj] = (y[:, p0 + jj] - s) / lpan[:, jj, jj]
        if p0 > 0:
            y[:, :p0] -= (l[:, p0 : p0 + m, :p0] * out[:, p0 : p0 + m, None]).sum(1)
    return out


# ---------------------------------------------------------------------------
# standalone kernels: plain versions, wrappers
# ---------------------------------------------------------------------------


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """The cholesky kernel's computation in batched torch: `factor`."""
    return factor(a)


def cho_solve_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cho_solve kernel's computation: `blocked_substitution`."""
    return blocked_substitution(l, b)


def solve_spd_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The solve_spd kernel's computation: factor, then substitute."""
    return blocked_substitution(factor(a), b)


def _check(op: str, mat: torch.Tensor, rhs: torch.Tensor | None = None) -> tuple[int, int]:
    """Validates a [B, n, n] matrix (and a [B, n] right-hand side): tensors
    on one CPU or CUDA device, float32 (or float64 on the CPU, a reference
    solve), contiguous, non-empty. Returns (B, n)."""
    named = {"matrix": mat} if rhs is None else {"matrix": mat, "rhs": rhs}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a tensor")
    device = mat.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {device}")
    dtype = torch.float64 if device.type == "cpu" and mat.dtype == torch.float64 else torch.float32
    if mat.dim() != 3 or mat.shape[1] != mat.shape[2]:
        raise ValueError(f"{op}: matrix shape {tuple(mat.shape)}, expected (B, n, n)")
    bsz, n = mat.shape[0], mat.shape[1]
    want = {"matrix": (bsz, n, n), "rhs": (bsz, n)}
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{op}: {name} on {t.device}, matrix on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype} like the matrix (float32, or float64 on the CPU), got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    if bsz == 0 or n == 0:
        raise ValueError(f"{op}: empty batch or matrix")
    return bsz, n


def cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of SPD [B, n, n] matrices (only the lower
    triangle is read), upper triangle zero. float32, contiguous; CPU tensors
    run `cholesky_plain` (in float64 too), CUDA tensors launch the kernel
    (n <= MAX_N) or raise."""
    _check("cholesky", a)
    return cholesky_plain(a)


def cho_solve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves L L^T x = b for lower factors [B, n, n] (only the lower
    triangle is read) and right-hand sides [B, n]. float32, contiguous; CPU
    tensors run `cho_solve_plain` (in float64 too), CUDA tensors launch the
    kernel (n <= MAX_N) or raise."""
    _check("cho_solve", l, b)
    return cho_solve_plain(l, b)


def solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solves A x = b for SPD [B, n, n] A (only the lower triangle is read)
    and [B, n] b, factor and substitution in one launch. float32,
    contiguous; CPU tensors run `solve_spd_plain` (in float64 too), CUDA
    tensors launch the kernel (n <= MAX_N) or raise."""
    _check("solve_spd", a, b)
    return solve_spd_plain(a, b)
