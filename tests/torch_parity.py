"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

The same inputs, made with numpy from a seed, go through the JAX package and
through the port; outputs are compared as numpy float64 arrays.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Tolerances, relative to max(1, max |reference|) like tests/test_cg_kernel_parity.py.
# Each stage is the same formula in both packages; only the order of f32 sums
# (torch vs XLA reductions, matmul vs multiply-reduce) differs.
STAGE_REL = 2e-5
# The solve amplifies roundoff by cond(M) ~ 6e5 and by the large D weights of
# the force rows; bars of tests/test_cg_kernel_parity.py (qacc_eff there:
# 5e-4, "measured 1.3e-4").
SOLVE_REL = {
    "qacc_smooth": 5e-5,
    "qacc": 1e-4,
    "efc_force": 1e-3,
    "qfrc_constraint": 1e-3,
    "qacc_eff": 5e-4,
}


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"shape {got.shape} != {want.shape}"
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max())) if want.size else 0.0


def assert_close(name: str, got, want, rel: float) -> float:
    """Asserts max |got - want| / max(1, max |want|) < rel; returns the error."""
    err = rel_err(got, want)
    assert err < rel, f"{name}: rel err {err:.3e} >= {rel:.1e}"
    return err


def load_export_tool():
    """tools/export_torch_model.py as a module (tools/ is not a package)."""
    path = os.path.join(REPO, "tools", "export_torch_model.py")
    spec = importlib.util.spec_from_file_location("export_torch_model", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def contact_rich_states(nq: int, nv: int, nu: int, qpos0, n_envs: int, seed: int):
    """Dropped and perturbed rodent states as tests/test_cg_kernel_parity.py
    makes them: (qpos, qvel, ctrl, warm) float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(np.asarray(qpos0, np.float64), (n_envs, 1))
    qpos[:, 2] -= rng.uniform(0.008, 0.016, n_envs)
    qpos[:, 7:] += rng.uniform(-0.08, 0.08, (n_envs, nq - 7))
    qvel = rng.uniform(-0.5, 0.5, (n_envs, nv))
    ctrl = rng.uniform(-0.5, 0.5, (n_envs, nu))
    warm = rng.uniform(-1.0, 1.0, (n_envs, nv))
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, warm))


def rodent_full_clips_model():
    """The rodent MjModel compiled as the rodent-full-clips workload does."""
    return load_export_tool().rodent_model()
