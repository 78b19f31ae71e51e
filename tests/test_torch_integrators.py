"""The RK4, implicit and implicitfast integrators through the port, against
the JAX package and MuJoCo C: RK4 on tests/test_physics_parity.py's toy
model (ball, slide, hinge and free joints, actuators, contacts; the probe of
its test_rk4_trajectory), implicit and implicitfast on
tests/test_integrators.py's PROBE_XML (joint and tendon damping, fluid drag,
a velocity-affine actuator). The same numpy states go into both packages;
one step and ten are compared, and qDeriv itself against the JAX package's
`_qderiv` on the same Data."""

import dataclasses
import functools

import jax
import mujoco
import numpy as np
import pytest
import torch

import test_integrators as ti
import test_physics_parity as tpp
from torch_parity import STAGE_REL, assert_close, to_torch
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_ENVS = 3
N_STEPS = 10
STATE = ("qpos", "qvel", "act", "time", "qacc_warmstart")
# The bars of tests/test_torch_step.py after one step and after ten.
# Measured on an x86 CPU at most 1.9e-5 (qacc_warmstart, implicit, after
# ten steps): the solve's roundoff, through cond(qM).
BARS = {1: 1e-4, N_STEPS: 1e-3}


def _mj_model(name: str):
    if name == "rk4":
        m = mujoco.MjModel.from_xml_string(tpp.TOY_XML)
        m.opt.integrator = mujoco.mjtIntegrator.mjINT_RK4
        return m
    return mujoco.MjModel.from_xml_string(ti.PROBE_XML.format(integrator=name))


def _start(m) -> dict:
    """Joints drawn around qpos0, a random unit root quaternion, random
    velocities and controls, float32 (test_integrators' draws, per env)."""
    rng = np.random.default_rng(3)
    qpos = np.tile(m.qpos0, (N_ENVS, 1))
    qpos[:, 7:] += rng.uniform(-0.2, 0.2, (N_ENVS, m.nq - 7))
    q = rng.normal(size=(N_ENVS, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = rng.uniform(-0.5, 0.5, (N_ENVS, m.nv))
    ctrl = rng.uniform(-0.3, 0.3, (N_ENVS, m.nu))
    return {k: np.asarray(v, np.float32) for k, v in dict(qpos=qpos, qvel=qvel, ctrl=ctrl).items()}


@functools.lru_cache(maxsize=None)
def _build(name: str) -> dict:
    """One jit of the JAX package's step, run N_STEPS times from the carried
    state as its n_step does, its qDeriv on the first step's Data, and the
    port's step and n_step from the same start."""
    m = _mj_model(name)
    jplan, jmodel = jm.put_model(m)
    start = _start(m)

    def run(carry):
        # jf.step, spelled out so that qDeriv comes from the same trace
        d = jf.forward(jplan, jmodel, jm.make_data(jplan, jmodel).replace(**carry))
        if name == "rk4":
            return jf.rk4(jplan, jmodel, d), d, d.qacc
        with jax.default_matmul_precision("highest"):
            qd = jf._qderiv(jplan, jmodel, d, include_rne=name == "implicit")
        return jf.implicit(jplan, jmodel, d), d, qd

    step = jax.jit(jax.vmap(run))
    template = jm.make_data(jplan, jmodel)
    carry = {f: np.broadcast_to(np.asarray(getattr(template, f)), (N_ENVS,) + np.shape(getattr(template, f)))
             for f in jf._CARRY_FIELDS}
    carry.update(start)
    want = {}
    for n in range(1, N_STEPS + 1):
        d, fwd, qd = step(carry)
        carry = {f: getattr(d, f) for f in jf._CARRY_FIELDS}
        if n in BARS:
            want[n] = {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
        if n == 1:
            first, qd_first = fwd, np.asarray(qd)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    case = dict(name=name, m=m, plan=plan, model=model, start=start, want=want, first=first, qderiv=qd_first)
    case["got"] = {n: _port(case, n) for n in BARS}
    return case


@pytest.fixture(scope="module", params=("rk4", "implicitfast", "implicit"))
def case(request):
    return _build(request.param)


@pytest.fixture(scope="module", params=("implicitfast", "implicit"))
def implicit_case(request):
    return _build(request.param)


def _port(case, n: int):
    plan, model = case["plan"], case["model"]
    d = tm.make_data(plan, model, N_ENVS).replace(**{k: torch.tensor(v) for k, v in case["start"].items()})
    return tf.step(plan, model, d) if n == 1 else tf.n_step(plan, model, d, n)


def test_plan_integrator(case):
    want = {"rk4": tm.INT_RK4, "implicitfast": tm.INT_IMPLICITFAST, "implicit": tm.INT_IMPLICIT}
    assert case["plan"].integrator == want[case["name"]]
    assert tsolver.fused_scalar_cg(case["plan"]) and not tsolver.fused_euler(case["plan"])


@pytest.mark.parametrize("n", list(BARS))
@pytest.mark.parametrize("name", STATE + ("qacc", "qfrc_constraint"))
def test_step_matches_jax(case, name, n):
    got = case["got"][n]
    want = case["want"][n][name]
    assert_close(f"{name} after {n}", getattr(got, name), want, BARS[n])
    assert np.isfinite(want).all()


def test_qderiv_matches_jax(implicit_case):
    """qDeriv by torch.func.jvp under vmap against the JAX package's
    jax.jacfwd, on the same post-forward Data (the first step's): measured
    on an x86 CPU at most 1.1e-8 (implicit)."""
    case = implicit_case
    data = to_torch(case["first"])
    got = tf.qderiv(case["plan"], case["model"], data, include_rne=case["name"] == "implicit")
    assert_close("qDeriv", got, case["qderiv"], STAGE_REL)
    assert float(np.abs(case["qderiv"]).max()) > 0.01


def test_trajectory_matches_mujoco(case):
    """Env 0 over N_STEPS against mj_step, with the JAX package's bars (qpos
    2e-3; qvel 5e-3 for RK4, 2e-3 for the implicit integrators)."""
    m, start = case["m"], case["start"]
    md = mujoco.MjData(m)
    md.qpos[:], md.qvel[:], md.ctrl[:] = start["qpos"][0], start["qvel"][0], start["ctrl"][0]
    for _ in range(N_STEPS):
        mujoco.mj_step(m, md)
    got = case["got"][N_STEPS]
    assert_close("qpos", got.qpos[0], md.qpos, 2e-3)
    assert_close("qvel", got.qvel[0], md.qvel, 5e-3 if case["name"] == "rk4" else 2e-3)


def test_routing(case, monkeypatch):
    """One step: RK4 runs four forwards, each one compact cg_solve without
    the Euler solve; the implicit integrators one, then implicitfast one
    solve_spd of M - h qDeriv, implicit none (torch.linalg.solve)."""
    calls = []

    def counted(op):
        def call(*args, **kwargs):
            calls.append((op.__name__, kwargs.get("with_euler")))
            return op(*args, **kwargs)
        return call

    monkeypatch.setattr(tsolver.cg_solver_kernel, "cg_solve", counted(tk.cg_solve))
    monkeypatch.setattr(bl, "solve_spd", counted(bl.solve_spd))
    monkeypatch.setattr(bl, "cholesky", None)
    monkeypatch.setattr(bl, "cho_solve", None)
    _port(case, 1)
    want = {"rk4": [("cg_solve", False)] * 4, "implicitfast": [("cg_solve", False), ("solve_spd", None)],
            "implicit": [("cg_solve", False)]}
    assert calls == want[case["name"]]


def test_euler_raises_on_other_integrators(case):
    """euler() keeps the JAX package's error for a non-Euler plan; step()
    dispatches instead."""
    with pytest.raises(NotImplementedError, match="use step"):
        tf.euler(case["plan"], case["model"], tm.make_data(case["plan"], case["model"], 1))


def test_implicit_integrators_differ():
    """implicit and implicitfast must not alias: with fluid drag and
    Coriolis terms their ten-step trajectories differ."""
    fast, full = (_build(name)["got"][N_STEPS].qpos for name in ("implicitfast", "implicit"))
    assert not torch.allclose(fast, full, atol=1e-7)
