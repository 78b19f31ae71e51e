"""Models without contacts through the port's forward, against the JAX
package: the ToyWalker of track_mjx_tpu/testing.py with its floor's
collision bits cleared (a free body with 4 limited hinges, nv 10, no
contacts), once with its limit rows (nefc 4: the fused scalar CG solve with
no contact rows) and once with jnt_limited cleared before both packages
compile it (nefc 0: qacc = qacc_smooth through the non-fused factor, solve
and Euler stages). The same numpy states, warm starts and controls go into
both packages; their step and n_step are compared."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_parity import SOLVE_REL, STAGE_REL, assert_close
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.testing import ToyWalker
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_ENVS = 4
N_SUB = 3
VARIANTS = ("limits", "no_rows")
STATE = ("qpos", "qvel")
# The forward's outputs after one step, each held to its bar in
# tests/torch_parity.py: qacc_smooth and qacc (cond(qM) of the free body
# and its light legs) and the constraint forces to the fused solves' bars.
DERIVED = {
    "qacc_smooth": SOLVE_REL["qacc_smooth"],
    "qacc": SOLVE_REL["qacc"],
    "qfrc_constraint": SOLVE_REL["qfrc_constraint"],
    "efc_force": SOLVE_REL["efc_force"],
}


def _mj_model(variant: str):
    m = ToyWalker(contact=False)._mj_model
    if variant == "no_rows":
        m.jnt_limited[:] = 0
    return m


def _start(m) -> dict:
    """Hinges drawn across their +-1.2 ranges and past them (limit rows
    active in every env of the limited variant), random velocities,
    controls and warm starts, float32."""
    rng = np.random.RandomState(17)
    qpos = np.tile(m.qpos0, (N_ENVS, 1))
    qpos[:, 7:] = rng.uniform(-1.35, 1.35, (N_ENVS, m.nq - 7))
    qpos[np.arange(N_ENVS), 7 + np.arange(N_ENVS) % (m.nq - 7)] = 1.3  # one hinge past its range each
    qvel = rng.uniform(-1.0, 1.0, (N_ENVS, m.nv))
    ctrl = rng.uniform(-1.0, 1.0, (N_ENVS, m.nu))
    warm = rng.uniform(-1.0, 1.0, (N_ENVS, m.nv))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm).items()}


@pytest.fixture(scope="module", params=VARIANTS)
def case(request):
    """One jit of the JAX package's step and n_step(..., N_SUB) over the
    variant's states, and the port's plan and model of the same MjModel."""
    m = _mj_model(request.param)
    jplan, jmodel = jm.put_model(m)
    start = _start(m)

    def run(qpos, qvel, ctrl, warm):
        d = jm.make_data(jplan, jmodel).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
        return jf.step(jplan, jmodel, d), jf.n_step(jplan, jmodel, d, N_SUB)

    one, many = jax.jit(jax.vmap(run))(*(start[k] for k in ("qpos", "qvel", "ctrl", "qacc_warmstart")))
    as_np = lambda d: {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    return dict(variant=request.param, jplan=jplan, plan=plan, model=model, start=start,
                one=as_np(one), many=as_np(many))


def _port(case, n: int):
    plan, model = case["plan"], case["model"]
    data = tm.make_data(plan, model, N_ENVS).replace(**{k: torch.tensor(v) for k, v in case["start"].items()})
    return tf.step(plan, model, data) if n == 1 else tf.n_step(plan, model, data, n)


def test_the_models_have_no_contacts(case):
    plan, jplan = case["plan"], case["jplan"]
    assert plan.ncon == 0 and plan.ne == 0 and plan.nf == 0
    assert (plan.nlimit, plan.nefc) == ((4, 4) if case["variant"] == "limits" else (0, 0))
    assert (jplan.nlimit, jplan.nefc) == (plan.nlimit, plan.nefc)


@pytest.mark.parametrize("name", list(DERIVED))
def test_step_forward_matches_jax(case, name):
    """The forward inside one step: measured on an x86 CPU at most 2.9e-6
    (qacc_smooth, both variants)."""
    got = _port(case, 1)
    assert_close(name, getattr(got, name), case["one"][name], DERIVED[name])
    if case["variant"] == "limits" and name == "efc_force":  # the limits act in every env
        assert (np.abs(case["one"][name]).max(axis=1) > 0).all()


@pytest.mark.parametrize("n", [1, N_SUB])
@pytest.mark.parametrize("name", STATE)
def test_step_state_matches_jax(case, name, n):
    """qpos and qvel after one step and after N_SUB, held to the stages'
    bar: the solve's roundoff reaches them times the timestep (measured on
    an x86 CPU at most 4.4e-6, qvel of the limited variant after N_SUB)."""
    got = _port(case, n)
    want = case["one"] if n == 1 else case["many"]
    assert_close(f"{name} after {n}", getattr(got, name), want[name], STAGE_REL)
    assert np.isfinite(want[name]).all()


def test_routing(case, monkeypatch):
    """With limit rows the fused scalar CG solve runs with no contact rows
    (nc = 0) and factors qM itself; with no rows the non-fused stages run:
    cholesky, cho_solve and Euler's solve_spd once each, and no CG solve."""
    calls = {}

    def counted(name, op):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            if name == "cg_solve":
                calls["nc"] = kwargs["fq"].shape[1]
            return op(*args, **kwargs)
        return call

    for name in ("cholesky", "cho_solve", "solve_spd"):
        monkeypatch.setattr(bl, name, counted(name, getattr(bl, name)))
    for name in ("cg_solve", "ell_cg_solve"):
        monkeypatch.setattr(tsolver.cg_solver_kernel, name, counted(name, getattr(tk, name)))
    _port(case, 1)
    if case["variant"] == "limits":
        assert calls == {"cg_solve": 1, "nc": 0}
    else:
        assert calls == {"cholesky": 1, "cho_solve": 1, "solve_spd": 1}
