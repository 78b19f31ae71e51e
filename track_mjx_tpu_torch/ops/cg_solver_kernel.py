"""Fused smooth + CG + Euler constraint solve: CUDA kernel, wrapper, plain version.

Replaces the TPU kernel track_mjx_tpu/ops/cg_solver_kernel.py::_cg_kernel,
launched through `_cg_solve_tpu` in its production configuration (qM built
from the CRB factors, J built from the compact per-contact operands, Euler
implicit-damping solve fused). Per env it builds qM and J, factors qM,
solves qacc_smooth, picks the cheaper of the warm and smooth starts, runs
`iterations` M-preconditioned Polak-Ribiere CG steps with an
`ls_iterations` Newton linesearch (jar and M dx advance by incremental axpy
updates, as MuJoCo's mj_solCG does), extracts force and qfrc, and solves
qacc_eff = (M + diag(hd))^-1 (qfrc_smooth + qfrc) from a second factor.

On the H100 the kernel (csrc/cg_solve.cu) is bound by a serial dependency
chain per env, not by bytes or flops: 2 factorizations and about 7
(L L^T)^-1 applies, each a chain of dependent steps separated by block
barriers, over operands (J 187x73, qM and L 73x73, about 104 KB for the
rodent) that live in shared memory for the whole solve. The design keeps
one env per CTA with everything in shared memory, so device memory is read
once (the compact operands) and written once (the outputs); the triangular
solves use the 8x8 panel-diagonal inverses so an apply is about 2n/8 panel
steps instead of 2n row steps. The CTA is 256 threads and two CTAs share an
SM; shortening the chain further (warp-level panels, fewer barriers) is
later work.

`cg_solve` is the wrapper: it checks its arguments, runs the plain version
for CPU tensors and launches the kernel for CUDA tensors, raising if the
build or the launch fails. `cg_solve.launches` counts kernel launches.
`cg_solve_plain` is the same computation in batched torch; the tests and
chip_smoke.py compare the kernel with it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from track_mjx_tpu_torch.ops.batched_linalg import (
    blocked_substitution_pinv,
    factor,
    invert_diag_blocks,
)

_EPS = 1e-12
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "cg_solve.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class CGOut(NamedTuple):
    qacc_smooth: torch.Tensor  # [B, n]
    qacc: torch.Tensor  # [B, n]
    efc_force: torch.Tensor  # [B, e], efc row order
    qfrc_constraint: torch.Tensor  # [B, n]
    qacc_eff: torch.Tensor  # [B, n]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def assemble_qm(buf, cdof, anc, armature) -> torch.Tensor:
    """qM[i, j] = buf[i] . cdof[j] for j ancestor-or-self of i, mirrored to
    the upper triangle, plus diag(armature). buf/cdof [B, n, 6], anc (n, n)
    0/1 float, armature (n,) -> [B, n, n]."""
    lower = (buf @ cdof.transpose(-1, -2)) * anc
    diag = torch.diagonal(lower, dim1=-2, dim2=-1)
    return lower + lower.transpose(-1, -2) - torch.diag_embed(diag) + torch.diag(armature)


def build_j(fq, sw, ll, mu, dm, lim1h) -> torch.Tensor:
    """Dense J [B, nl + 4 nc, n] in efc row order from the compact operands:
    limit rows lim1h * ll, then per contact the pyramid rows
    jfr0 + mu0 jfr1, jfr0 - mu0 jfr1, jfr0 + mu1 jfr2, jfr0 - mu1 jfr2 with
    jfr[k][c, d] = (sum_j fq[c, k, j] sw[d, j]) dm[c, d]."""
    bsz = fq.shape[0]
    jfr = torch.einsum("bckj,bdj->bckd", fq, sw) * dm[None, :, None, :]
    m0, m1 = mu[..., 0, None], mu[..., 1, None]
    j0, j1, j2 = jfr[:, :, 0], jfr[:, :, 1], jfr[:, :, 2]
    pyr = torch.stack([j0 + m0 * j1, j0 - m0 * j1, j0 + m1 * j2, j0 - m1 * j2], dim=2)
    lim = lim1h[None] * ll[:, :, None]
    return torch.cat([lim, pyr.reshape(bsz, -1, sw.shape[1])], dim=1)


def cg_solve_plain(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int,
) -> CGOut:
    """The kernel's computation in batched torch (any device)."""
    qm = assemble_qm(buf, cdof, anc, arm)
    j = build_j(fq, sw, ll, mu, dm, lim1h)
    l = factor(qm)
    dinv = invert_diag_blocks(l)

    def chosolve(b):
        return blocked_substitution_pinv(l, dinv, b)

    def matv_j(x):
        return (j @ x[..., None])[..., 0]

    def matv_jt(f):
        return (f[:, None, :] @ j)[:, 0]

    def matv_m(v):
        return (qm @ v[..., None])[..., 0]

    def force_of(jar):
        return torch.where(jar < 0, -D * jar, torch.zeros_like(jar))

    def cost_rows(jar):
        return 0.5 * torch.where(jar < 0, D * jar * jar, torch.zeros_like(jar)).sum(-1)

    smooth = chosolve(qfrc_smooth)
    # warm vs smooth start, the cheaper per env; cost(smooth) has no
    # quadratic term, and both candidates' jar and M dx are kept for reuse
    jar_warm = matv_j(warm) - aref
    dxw = warm - smooth
    mdxw = matv_m(dxw)
    cost_warm = 0.5 * (dxw * mdxw).sum(-1) + cost_rows(jar_warm)
    jar_sm = matv_j(smooth) - aref
    take_warm = (cost_warm < cost_rows(jar_sm))[:, None]
    x = torch.where(take_warm, warm, smooth)
    jar = torch.where(take_warm, jar_warm, jar_sm)
    mdx = torch.where(take_warm, mdxw, torch.zeros_like(mdxw))
    grad = mdx - matv_jt(force_of(jar))
    mgrad = chosolve(grad)
    p = -mgrad
    imp = torch.ones_like(tolscale)

    for _ in range(iterations):
        mp = matv_m(p)
        jp = matv_j(p)
        pmp = (p * mp).sum(-1)
        dmx = (mp * (x - smooth)).sum(-1)

        def phi_derivs(alpha):
            jr = jar + alpha[:, None] * jp
            active = jr < 0
            zero = torch.zeros_like(jr)
            d1 = alpha * pmp + dmx + torch.where(active, D * jr * jp, zero).sum(-1)
            d2 = pmp + torch.where(active, D * jp * jp, zero).sum(-1)
            return d1, torch.clamp(d2, min=_EPS)

        d1, d2 = phi_derivs(torch.zeros_like(pmp))
        alpha = -d1 / d2
        for _ in range(ls_iterations):
            d1, d2 = phi_derivs(alpha)
            alpha = alpha - d1 / d2
        # converged envs freeze by taking zero-length steps
        alpha = alpha * imp
        x = x + alpha[:, None] * p
        jar = jar + alpha[:, None] * jp
        mdx = mdx + alpha[:, None] * mp
        gradn = mdx - matv_jt(force_of(jar))
        mgradn = chosolve(gradn)
        num = (gradn * (mgradn - mgrad)).sum(-1)
        den = torch.clamp((grad * mgrad).sum(-1), min=_EPS)
        beta = torch.clamp(num / den, min=0.0)
        p = -mgradn + beta[:, None] * p
        grad, mgrad = gradn, mgradn
        imp = imp * (torch.sqrt((gradn * gradn).sum(-1)) > tolscale).to(imp.dtype)

    force = force_of(jar)
    qfrc = matv_jt(force)
    l2 = factor(qm + torch.diag_embed(hd))
    dinv2 = invert_diag_blocks(l2)
    eff = blocked_substitution_pinv(l2, dinv2, qfrc_smooth + qfrc)
    return CGOut(smooth, x, force, qfrc, eff)


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libcg_solve_{digest}.so")


def build_library() -> tuple[str, float, str]:
    """Compiles csrc/cg_solve.cu for sm_90a into build/torch_kernels/ unless
    a library built from the same source and flags is there. Returns (path,
    build seconds, nvcc output); raises if nvcc fails."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library()[0])
    lib.cg_solve_f32.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.cg_solve_f32.restype = ctypes.c_int
    lib.cg_solve_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.cg_solve_smem_bytes.restype = ctypes.c_long
    return lib


def _check(buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
           anc, arm, dm, lim1h):
    """Validates devices, dtypes, shapes and contiguity; returns (B, n, nl, nc)."""
    named = dict(buf=buf, cdof=cdof, fq=fq, sw=sw, ll=ll, mu=mu, aref=aref, D=D,
                 qfrc_smooth=qfrc_smooth, warm=warm, hd=hd, tolscale=tolscale,
                 anc=anc, arm=arm, dm=dm, lim1h=lim1h)
    bsz, n = qfrc_smooth.shape[0], qfrc_smooth.shape[-1]
    nc, nl = fq.shape[1], lim1h.shape[0]
    e = nl + 4 * nc
    want = dict(
        buf=(bsz, n, 6), cdof=(bsz, n, 6), fq=(bsz, nc, 3, 6), sw=(bsz, n, 6),
        ll=(bsz, nl), mu=(bsz, nc, 2), aref=(bsz, e), D=(bsz, e),
        qfrc_smooth=(bsz, n), warm=(bsz, n), hd=(bsz, n), tolscale=(bsz,),
        anc=(n, n), arm=(n,), dm=(nc, n), lim1h=(nl, n),
    )
    device = buf.device
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"cg_solve: {name} must be a tensor")
        if t.device != device:
            raise ValueError(f"cg_solve: {name} on {t.device}, buf on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"cg_solve: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"cg_solve: {name} shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"cg_solve: {name} must be contiguous")
    if bsz == 0 or n == 0:
        raise ValueError("cg_solve: empty batch or model")
    return bsz, n, nl, nc


def _launch(args, bsz, n, nl, nc, iterations, ls_iterations) -> CGOut:
    lib = load_library()
    smem = lib.cg_solve_smem_bytes(n, nl, nc)
    if smem > 227 * 1024:
        raise ValueError(f"cg_solve: model needs {smem} B of shared memory per env (max 232448)")
    like = args[0]
    out = CGOut(
        qacc_smooth=torch.empty((bsz, n), dtype=like.dtype, device=like.device),
        qacc=torch.empty((bsz, n), dtype=like.dtype, device=like.device),
        efc_force=torch.empty((bsz, nl + 4 * nc), dtype=like.dtype, device=like.device),
        qfrc_constraint=torch.empty((bsz, n), dtype=like.dtype, device=like.device),
        qacc_eff=torch.empty((bsz, n), dtype=like.dtype, device=like.device),
    )
    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = lib.cg_solve_f32(
            *[t.data_ptr() for t in args],
            out.qacc_smooth.data_ptr(), out.qacc.data_ptr(),
            out.qfrc_constraint.data_ptr(), out.qacc_eff.data_ptr(),
            out.efc_force.data_ptr(),
            bsz, n, nl, nc, iterations, ls_iterations, stream,
        )
    if err != 0:
        raise RuntimeError(f"cg_solve: CUDA kernel launch failed with cudaError {err}")
    cg_solve.launches += 1
    return out


def cg_solve(
    buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
    anc, arm, dm, lim1h, *, iterations: int, ls_iterations: int,
) -> CGOut:
    """Fused smooth + CG + Euler solve of a batch of envs.

    Per env: buf, cdof, sw [B, n, 6]; fq [B, nc, 3, 6]; ll [B, nl];
    mu [B, nc, 2]; aref, D [B, nl + 4 nc]; qfrc_smooth, warm, hd [B, n];
    tolscale [B]. Static: anc (n, n) 0/1, arm (n,), dm (nc, n),
    lim1h (nl, n). All float32 and contiguous on one device. CPU tensors run
    `cg_solve_plain`; CUDA tensors launch the kernel or raise."""
    args = (buf, cdof, fq, sw, ll, mu, aref, D, qfrc_smooth, warm, hd, tolscale,
            anc, arm, dm, lim1h)
    bsz, n, nl, nc = _check(*args)
    if buf.device.type == "cpu":
        return cg_solve_plain(*args, iterations=iterations, ls_iterations=ls_iterations)
    if buf.device.type != "cuda":
        raise ValueError(f"cg_solve: unsupported device {buf.device}")
    return _launch(args, bsz, n, nl, nc, iterations, ls_iterations)


cg_solve.launches = 0
