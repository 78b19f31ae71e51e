"""Batched small-matrix Cholesky routines in plain PyTorch, [B, n, n].

Port of the device routines of track_mjx_tpu/ops/batched_linalg.py that the
fused CG solves run: `factor` (factor_in_place, the right-looking Cholesky
with c = row * rsqrt(diag)), `invert_diag_blocks` (inverses of the 8x8
diagonal panels of L), `blocked_substitution_pinv` (L L^T x = b by panel
substitution through those inverses; the scalar solve) and
`blocked_substitution` (the exact panel-8 forward and back substitution; the
elliptic solve). They are the arithmetic of the CUDA device routines in
csrc/cholesky.cuh, written as batched torch ops, and serve as the plain
versions of the kernels (ops/cg_solver_kernel.cg_solve_plain and
ell_cg_solve_plain).
"""

from __future__ import annotations

import torch

PANEL = 8


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
