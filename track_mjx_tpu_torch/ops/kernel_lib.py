"""Build and load the port's CUDA kernels: every csrc/*.cu compiled by its own
nvcc call, all started together, and linked into one shared library with a
plain C interface, bound with ctypes.

The library is keyed by a hash of every file under csrc/ and of the flags,
so a change to a shared header rebuilds it. It is built at first use into
build/torch_kernels/ next to the package (listed in .gitignore); nothing is
built or loaded when a module is imported.
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

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
# compiled in parallel, linked into one library
SOURCES = tuple(
    os.path.join(CSRC, f) for f in ("cg_solve.cu", "ell_cg_solve.cu", "batched_linalg.cu")
)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# dynamic shared memory one CTA may use on sm_90 (232,448 B)
MAX_SMEM_BYTES = 227 * 1024


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(defines: tuple[str, ...] = ()) -> str:
    """Where the library built from the current csrc/ (every file in it, so
    a change to a shared header rebuilds), NVCC_FLAGS and `defines` lives."""
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtorch_kernels_{h.hexdigest()[:16]}.so")


def build_library(defines: tuple[str, ...] = ()) -> tuple[str, float, str]:
    """Compiles the csrc/ kernels for sm_90a, one nvcc call per source, all
    started together, and links them into one library under
    build/torch_kernels/ unless a library built from the same sources and
    flags is there. `defines` ("NAME=VALUE") are for the one build-time
    switch the sources take, CG_SOLVE_STAMPS=1: the phase stamps of cg_solve
    and ell_cg_solve, read by tools/compare_torch_kernels.py (the port loads
    the library built without). Returns (path, build seconds, nvcc output);
    raises if nvcc fails."""
    path = library_path(defines)
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        objs = [os.path.join(work, os.path.basename(src) + ".o") for src in SOURCES]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [proc.communicate()[0] for proc in procs]
        for proc, src, log in zip(procs, SOURCES, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
        tmp = os.path.join(work, "lib.so")
        link = subprocess.run([_nvcc(), "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path, seconds, "".join(logs) + link.stdout + link.stderr


def _bind(fn, argtypes, restype):
    fn.argtypes = argtypes
    fn.restype = restype


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's C signature set. Each
    `*_f32` launches on the stream it is given and returns cudaGetLastError();
    each `*_smem_bytes` gives the dynamic shared memory of one CTA."""
    return open_library(build_library()[0])


def open_library(path: str) -> ctypes.CDLL:
    """The library at `path` (built by build_library) with every entry
    point's C signature set."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    # the fused solves take with_euler after ls_iterations, then arm_stride
    # (0: one armature for every env; n: an armature per env)
    for op in ("cg_solve", "ell_cg_solve"):
        _bind(getattr(lib, f"{op}_f32"), [ptr] * 21 + [i32] * 8 + [ptr], i32)
        _bind(getattr(lib, f"{op}_smem_bytes"), [i32] * 3, i64)
    _bind(lib.cg_solve_dense_f32, [ptr] * 16 + [i32] * 7 + [ptr], i32)
    _bind(lib.cg_solve_dense_smem_bytes, [i32] * 2, i64)
    _bind(lib.cg_solve_dense_kernel_info, [i32, i32, ptr], i32)
    _bind(lib.ell_cg_solve_dense_f32, [ptr] * 17 + [i32] * 8 + [ptr], i32)
    _bind(lib.ell_cg_solve_dense_smem_bytes, [i32] * 3, i64)
    _bind(lib.ell_cg_solve_dense_kernel_info, [i32] * 3 + [ptr], i32)
    _bind(lib.cg_solve_dense_panels, [i32, i32, ptr], i32)
    _bind(lib.ell_cg_solve_dense_panels, [i32] * 3 + [ptr], i32)
    _bind(lib.cholesky_f32, [ptr, ptr, i32, i32, ptr], i32)
    _bind(lib.cho_solve_f32, [ptr, ptr, ptr, i32, i32, ptr], i32)
    _bind(lib.solve_spd_f32, [ptr, ptr, ptr, i32, i32, ptr], i32)
    for op in ("cholesky", "cho_solve", "solve_spd"):
        _bind(getattr(lib, f"{op}_smem_bytes"), [i32], i64)
    _bind(lib.tiled_kernel_info, [i32, i32, ptr], i32)
    _bind(lib.cho_solve_kernel_info, [i32, ptr], i32)
    for op in ("cg_solve", "ell_cg_solve"):
        _bind(getattr(lib, f"{op}_kernel_info"), [i32, i32, i32, ptr], i32)
        _bind(getattr(lib, f"{op}_stamps"), [ptr], i32)
    return lib
