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


def contact_rich_fly_states(m, n_envs: int, seed: int):
    """Fly states as tests/test_cg_kernel_parity.py makes them: legs dropped
    into the floor, joints perturbed, random qvel, ctrl and warmstart; the
    last two envs are static drops warm-started at MuJoCo C's qacc, which
    puts cone blocks in the static-friction (bottom) zone. (qpos, qvel,
    ctrl, warm) float32 numpy arrays; `m` is the live MjModel."""
    import mujoco

    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0, (n_envs, 1))
    qpos[:, 2] -= rng.uniform(0.02, 0.12, n_envs)
    qpos[:, 7:] += rng.uniform(-0.10, 0.10, (n_envs, m.nq - 7))
    qvel = rng.uniform(-2.0, 2.0, (n_envs, m.nv))
    ctrl = rng.uniform(-0.3, 0.3, (n_envs, m.nu))
    warm = rng.uniform(-5.0, 5.0, (n_envs, m.nv))
    qpos[-2:] = m.qpos0
    qpos[-2:, 7:] += rng.uniform(-0.02, 0.02, (2, m.nq - 7))
    qpos[-2:, 2] -= [0.02, 0.04]
    qvel[-2:] = 0.0
    ctrl[-2:] = 0.0
    md = mujoco.MjData(m)
    for k in (-2, -1):
        md.qpos[:], md.qvel[:], md.ctrl[:] = qpos[k], qvel[k], ctrl[k]
        mujoco.mj_forward(m, md)
        warm[k] = md.qacc
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, warm))


def ell_objective_f64(qm, j, aref, d, mu, smooth, x, nl: int):
    """Per-env objective of the elliptic solve in float64: 0.5 dx M dx plus
    the limit rows' and the cone blocks' costs, with dx = x - smooth.
    qm [B, n, n], j [B, e, n], aref and d [B, e], mu [B, nc] (mu_1 /
    sqrt(impratio)), smooth and x [B, n]."""
    qm, j, aref, d, mu, smooth, x = (
        np.asarray(t, np.float64) for t in (qm, j, aref, d, mu, smooth, x)
    )
    bsz = x.shape[0]
    dx = x - smooth
    jar = np.einsum("ben,bn->be", j, x) - aref
    jar_s, u = jar[:, :nl], jar[:, nl:].reshape(bsz, -1, 3)
    d_s, d_b = d[:, :nl], d[:, nl:].reshape(bsz, -1, 3)
    cs = 0.5 * np.where(jar_s < 0, d_s * jar_s**2, 0.0).sum(1)
    p = -np.sqrt(d_b) * u
    t = np.sqrt(np.maximum(p[..., 1] ** 2 + p[..., 2] ** 2, 1e-24))
    bottom = mu * p[..., 0] >= t
    top = p[..., 0] <= -mu * t
    quad = 0.5 * (p * p).sum(-1)
    mid = quad - 0.5 * (t - mu * p[..., 0]) ** 2 / (1 + mu * mu)
    cb = np.where(bottom, quad, np.where(top, 0.0, mid)).sum(1)
    return 0.5 * np.einsum("bn,bnm,bm->b", dx, qm, dx) + cs + cb


def assert_plan_equal(a, b):
    """Every PhysicsPlan field of the port's plan `a` equals the JAX plan's."""
    import dataclasses

    assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "pair_groups":
            assert len(x) == len(y)
            for gx, gy in zip(x, y):
                assert gx[:2] == gy[:2]
                np.testing.assert_array_equal(gx[2], gy[2])
                np.testing.assert_array_equal(gx[3], gy[3])
        elif f.name == "body_levels":
            assert len(x) == len(y)
            for lx, ly in zip(x, y):
                np.testing.assert_array_equal(lx, ly)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def rodent_full_clips_model():
    """The rodent MjModel compiled as the rodent-full-clips workload does."""
    return load_export_tool().workload_model("rodent-full-clips")
