"""The rodent under the Newton solver: the port's factor_m, solve_m and
non-fused Euler, its Newton solve, forward, step and n_step against the JAX
package on the same states; its forward against MuJoCo C's Newton; the
routing of every dense solve through the standalone kernels' wrappers; and
the solver dispatch's errors.

The Newton plan is the rodent-full-clips model with opt.solver = Newton (as
envs/task/tracking.py sets it for env_args.solver: newton): the port edits
its snapshot, the JAX package and MuJoCo C the compiled MjModel."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import SOLVE_REL, STAGE_REL, assert_close, contact_rich_states
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import sensors as jsens
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import inertia
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver
from track_mjx_tpu_torch.physics.constraint import EfcData

torch.set_num_threads(1)
N_ENVS = 4
N_SUB = 10


def _port(name: str = "rodent-full-clips", solver: int = tm.SOLVER_NEWTON):
    tf.set_full_f32()
    snap = tm.load_snapshot(name)
    snap.opt.solver = solver
    return tm.put_model(snap, device="cpu")


@pytest.fixture(scope="module")
def mj_newton():
    m = torch_parity.rodent_full_clips_model()
    m.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
    return m


@pytest.fixture(scope="module")
def port():
    plan, model = _port()
    assert plan.solver == tm.SOLVER_NEWTON and not tsolver.fused_cg(plan)
    return plan, model


# ---------------------------------------------------------------------------
# contact-rich states: the stages, the Newton solve and Euler against JAX
# ---------------------------------------------------------------------------


def _gentle_states(m):
    """The gentle states of tests/test_torch_step.py (feet just touching,
    small offsets, velocities and controls), where f32 roundoff stays near
    1e-5 over 10 substeps: (qpos, qvel, ctrl, act) float32."""
    rng = np.random.RandomState(11)
    qpos = np.tile(m.qpos0, (N_ENVS, 1))
    qpos[:, 2] -= rng.uniform(0.0015, 0.003, N_ENVS)
    qpos[:, 7:] += rng.uniform(-0.01, 0.01, (N_ENVS, m.nq - 7))
    qvel = rng.uniform(-0.05, 0.05, (N_ENVS, m.nv))
    ctrl = rng.uniform(-0.005, 0.005, (N_ENVS, m.nu))
    act = rng.uniform(-0.005, 0.005, (N_ENVS, m.na))
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, act))


@pytest.fixture(scope="module")
def ref(mj_newton):
    """One jit of the JAX package over 2 x N_ENVS states: the forward
    stages, the Newton solve, sensors and the Euler step (together, one
    `step`), and n_step(..., 10). The first N_ENVS states are contact-rich,
    the last N_ENVS gentle."""
    m = mj_newton
    jplan, jmodel = jm.put_model(m)
    assert jplan.solver == 2
    rich = contact_rich_states(m.nq, m.nv, m.nu, m.qpos0, N_ENVS, seed=23)
    gentle = _gentle_states(m)
    start = dict(
        qpos=np.concatenate([rich[0], gentle[0]]),
        qvel=np.concatenate([rich[1], gentle[1]]),
        ctrl=np.concatenate([rich[2], gentle[2]]),
        act=np.concatenate([np.zeros_like(gentle[3]), gentle[3]]),
        qacc_warmstart=np.concatenate([rich[3], np.zeros_like(rich[3])]),
    )

    def run(qpos, qvel, ctrl, act, warm):
        d = jm.make_data(jplan, jmodel).replace(
            qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=warm
        )
        many = jf.n_step(jplan, jmodel, d, N_SUB)
        with jax.default_matmul_precision("highest"):
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_velocity(jplan, jmodel, d)
            d = jf.fwd_actuation(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, d)
            solved = jsens.sensor(jplan, jmodel, jsolver.solve(jplan, jmodel, d, efc))
            stepped = jf.euler(jplan, jmodel, solved)
        return d, efc, solved, stepped, many

    d, efc, solved, stepped, many = jax.jit(jax.vmap(run))(
        *(start[k] for k in ("qpos", "qvel", "ctrl", "act", "qacc_warmstart"))
    )
    rows = {"rich": slice(0, N_ENVS), "gentle": slice(N_ENVS, 2 * N_ENVS)}

    def as_np(x, which):
        return {f.name: np.asarray(getattr(x, f.name))[rows[which]] for f in dataclasses.fields(jm.Data)}

    return dict(
        data=as_np(d, "rich"),
        efc={k: np.asarray(getattr(efc, k))[rows["rich"]]
             for k in ("aref", "D", "jb_sw", "jb_fq", "jb_ll", "jb_mu")},
        solved=as_np(solved, "rich"),
        stepped=as_np(stepped, "rich"),
        gentle_start={k: v[rows["gentle"]] for k, v in start.items()},
        gentle={1: as_np(stepped, "gentle"), N_SUB: as_np(many, "gentle")},
    )


def _efc(e) -> EfcData:
    t = lambda k: torch.tensor(e[k])
    return EfcData(
        aref=t("aref"), D=t("D"), pos=torch.zeros_like(t("aref")),
        active_row=torch.zeros_like(t("aref"), dtype=torch.bool),
        jb_sw=t("jb_sw"), jb_fq=t("jb_fq"), jb_ll=t("jb_ll"), jb_mu=t("jb_mu")[0],
    )


# factor_m and fwd_position: the port's blocked factor against LAPACK's f32
# Cholesky in the JAX package, the same factor up to f32 roundoff in another
# order (L's entries are under 1), held to the stages' bar; qacc_smooth
# carries it through cond(qM) (about 6e5) and is held to the fused solves'
# smooth bar. Measured on an x86 CPU: qLD 6.0e-8, qacc_smooth 4.0e-7.
def test_factor_m_matches_jax(port, ref):
    plan, model = port
    got = inertia.factor_m(plan, model, tm.data_from_numpy(ref["data"], device="cpu"))
    assert_close("qLD", got.qLD, ref["data"]["qLD"], STAGE_REL)
    assert not torch.triu(got.qLD, diagonal=1).any()


def test_fwd_position_factors_qm(port, ref):
    plan, model = port
    d = tm.data_from_numpy({**ref["data"], "qLD": np.zeros_like(ref["data"]["qLD"])}, device="cpu")
    got, _ = tf.fwd_position(plan, model, d)
    assert_close("qLD", got.qLD, ref["data"]["qLD"], STAGE_REL)


def test_solve_m_matches_jax(ref):
    d = tm.data_from_numpy(ref["data"], device="cpu")
    got = inertia.solve_m(d, d.qfrc_smooth)
    assert_close("qacc_smooth", got, ref["data"]["qacc_smooth"], SOLVE_REL["qacc_smooth"])
    # M (M^-1 f) returns f up to the same roundoff
    assert_close("mul_m", inertia.mul_m(d, got), ref["data"]["qfrc_smooth"], SOLVE_REL["qacc_smooth"])


def test_fwd_acceleration_matches_jax(port, ref):
    plan, model = port
    got = tf.fwd_acceleration(plan, model, tm.data_from_numpy(ref["data"], device="cpu"))
    assert_close("qfrc_smooth", got.qfrc_smooth, ref["data"]["qfrc_smooth"], STAGE_REL)
    assert_close("qacc_smooth", got.qacc_smooth, ref["data"]["qacc_smooth"], SOLVE_REL["qacc_smooth"])


# The Newton solve. Its Hessian solves run the port's blocked factor where
# the JAX package calls LAPACK's, so the iterates differ by f32 roundoff
# through cond(H); held to the fused solves' bars (SOLVE_REL). Newton
# converges within the 5 iterations, so the roundoff does not grow: measured
# on an x86 CPU, qacc 2.5e-7, efc_force 6.3e-7, qfrc_constraint 1.2e-7.
@pytest.mark.parametrize("output", ("qacc", "efc_force", "qfrc_constraint"))
def test_newton_solve_matches_jax(port, ref, output):
    plan, model = port
    got = tsolver.solve(plan, model, tm.data_from_numpy(ref["data"], device="cpu"), _efc(ref["efc"]))
    assert_close(output, getattr(got, output), ref["solved"][output], SOLVE_REL[output])
    if output == "efc_force":  # contact-rich: every env has active rows
        assert (np.abs(ref["solved"][output]).max(axis=1) > 0).all()


def test_newton_hessian_solve_matches_jax_on_an_unsymmetric_qm():
    """The reference factors H with jnp.linalg.cholesky, which symmetrizes
    its input, and solves with cho_solve; the port's newton_hessian returns
    (H + H^T) / 2 for solve_spd, which reads only the lower triangle. With
    qM's upper triangle perturbed (by up to 5% of its largest entry) the two
    agree to f32 roundoff through cond(H) (measured on an x86 CPU 2.8e-6);
    the lower triangle alone solves another system (0.15)."""
    rng = np.random.RandomState(5)
    bsz, nv, nefc = 4, 20, 30
    q = np.linalg.qr(rng.normal(size=(bsz, nv, nv)))[0]
    qm = (q * np.logspace(-2.0, 0.0, nv)[None, None, :]) @ q.transpose(0, 2, 1)
    qm += np.triu(rng.uniform(-0.05, 0.05, (bsz, nv, nv)), 1) * np.abs(qm).max()
    j = rng.normal(size=(bsz, nefc, nv))
    d = rng.uniform(0.1, 1.0, (bsz, nefc))
    jar = rng.uniform(-1.0, 1.0, (bsz, nefc))
    grad = rng.uniform(-1.0, 1.0, (bsz, nv))
    qm, j, d, jar, grad = (x.astype(np.float32) for x in (qm, j, d, jar, grad))

    def jax_step(qm, j, d, jar, grad):  # solver.py's _newton body
        dj = j * (d * (jar < 0).astype(d.dtype))[:, None]
        l = jnp.linalg.cholesky(qm + j.T @ dj)
        return jax.scipy.linalg.cho_solve((l, True), grad)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.vmap(jax_step))(qm, j, d, jar, grad))
    t = [torch.tensor(x) for x in (qm, j, d, jar, grad)]
    h = tsolver.newton_hessian(*t[:4])
    assert torch.equal(h, h.transpose(-1, -2))
    assert_close("H^-1 grad", bl.solve_spd(h, t[4]), want, 1e-5)
    unsym = t[0] + t[1].transpose(-1, -2) @ (t[1] * (t[2] * (t[3] < 0).float())[..., None])
    with pytest.raises(AssertionError):
        assert_close("lower triangle only", bl.solve_spd(unsym, t[4]), want, 1e-2)


# Euler's (M + h D) solve: qacc_eff carries qfrc_constraint's roundoff
# through the inverse (SOLVE_REL's qacc_eff bar), and qvel = qvel + h
# qacc_eff takes it times h. Measured on an x86 CPU: qvel 6.1e-7.
@pytest.mark.parametrize("output", ("qpos", "qvel", "act", "time", "qacc_warmstart"))
def test_euler_matches_jax(port, ref, output):
    plan, model = port
    got = tf.euler(plan, model, tm.data_from_numpy(ref["solved"], device="cpu"))
    assert_close(output, getattr(got, output), ref["stepped"][output], SOLVE_REL["qacc_eff"])


def test_newton_path_runs_through_the_kernel_wrappers(port, monkeypatch):
    """One step of the Newton plan calls cholesky once, cho_solve once and
    solve_spd iterations + 1 times, and nothing else solves."""
    plan, model = port
    calls = {}
    for name in ("cholesky", "cho_solve", "solve_spd"):
        def counted(*args, _name=name, _op=getattr(bl, name)):
            calls[_name] = calls.get(_name, 0) + 1
            return _op(*args)
        monkeypatch.setattr(bl, name, counted)

    def no_fused(*args, **kwargs):
        raise AssertionError("a Newton plan must not call the fused CG solve")

    monkeypatch.setattr(tsolver.cg_solver_kernel, "cg_solve", no_fused)
    d = tm.make_data(plan, model, 1)
    qpos = d.qpos.clone()
    qpos[:, 2] -= 0.012
    tf.step(plan, model, d.replace(qpos=qpos))
    assert calls == {"cholesky": 1, "cho_solve": 1, "solve_spd": plan.iterations + 1}


# ---------------------------------------------------------------------------
# forward against MuJoCo C's Newton
# ---------------------------------------------------------------------------


def test_forward_matches_mujoco_newton(port, mj_newton):
    """The JAX suite's Newton parity state (tests/test_physics_parity.py):
    dropped 0.012, joints perturbed by U(-0.05, 0.05), qvel and ctrl
    U(-0.5, 0.5), seed 1; its bar, rel 1e-4 (measured on an x86 CPU:
    qacc_smooth 3.9e-6, qacc 1.4e-6, qfrc_constraint 9.6e-7)."""
    plan, model = port
    m = mj_newton
    rng = np.random.RandomState(1)
    qpos = m.qpos0.copy()
    qpos[2] -= 0.012
    qpos[7:] += rng.uniform(-0.05, 0.05, m.nq - 7)
    qvel = rng.uniform(-0.5, 0.5, m.nv)
    ctrl = rng.uniform(-0.5, 0.5, m.nu)
    md = mujoco.MjData(m)
    md.qpos[:], md.qvel[:], md.ctrl[:] = qpos, qvel, ctrl
    mujoco.mj_forward(m, md)
    assert md.ncon > 0, "test state must be contact-rich"
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))[None]
    d = tm.make_data(plan, model, 1).replace(qpos=f32(qpos), qvel=f32(qvel), ctrl=f32(ctrl))
    got = tf.forward(plan, model, d)
    for name in ("qacc_smooth", "qacc", "qfrc_constraint"):
        assert_close(name, got.__dict__[name][0], getattr(md, name), 1e-4)


# ---------------------------------------------------------------------------
# step and n_step from gentle states against JAX
# ---------------------------------------------------------------------------


# The bars of tests/test_torch_step.py. Measured on an x86 CPU: largest
# error 5.7e-6 after one substep (qacc) and 3.9e-6 after ten (qacc).
STATE = ("qpos", "qvel", "act", "time", "qacc_warmstart")
DERIVED = ("qacc", "qacc_smooth", "qLD", "qfrc_constraint", "efc_force", "sensordata", "xpos", "cvel")
BARS = {1: 1e-4, N_SUB: 1e-3}


@pytest.mark.parametrize("n", [1, N_SUB])
def test_step_matches_jax(port, ref, n):
    """step and n_step(..., 10) from the gentle states."""
    plan, model = port
    start, want = ref["gentle_start"], ref["gentle"][n]
    data = tm.make_data(plan, model, N_ENVS).replace(**{k: torch.tensor(v) for k, v in start.items()})
    got = tf.step(plan, model, data) if n == 1 else tf.n_step(plan, model, data, n)
    for name in STATE + DERIVED:
        assert_close(f"{name} after {n}", getattr(got, name), want[name], BARS[n])
    assert np.isfinite(want["qpos"]).all()
    if n == N_SUB:  # contacts and constraint forces act in every env
        assert (want["contact_dist"] < 0).any(axis=1).all()
        assert (want["efc_force"] != 0).any(axis=1).all()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _jax_message(plan) -> str:
    """The JAX package's solve() error for the same plan (it reads only
    nefc, solver and ncon_ell before raising)."""
    with pytest.raises(NotImplementedError) as err:
        jsolver.solve(plan, None, types.SimpleNamespace(qpos=jnp.zeros(1)), None)
    return str(err.value)


@pytest.mark.parametrize(
    "name, solver",
    [("rodent-full-clips", tm.SOLVER_PGS), ("fly-mc-intention", tm.SOLVER_NEWTON)],
    ids=["pgs", "newton-elliptic"],
)
def test_unsupported_solver_raises_like_jax(name, solver):
    plan, model = _port(name, solver)
    assert plan.nefc > 0
    d = tm.make_data(plan, model, 1)
    with pytest.raises(NotImplementedError) as err:
        tf.forward(plan, model, d)
    assert str(err.value) == _jax_message(plan)


def test_no_constraint_rows_take_the_smooth_acceleration(port):
    plan, model = port
    plan0 = dataclasses.replace(plan, nefc=0)
    d = tm.make_data(plan0, model, 2)
    d = d.replace(qacc_smooth=torch.arange(2 * plan.nv, dtype=torch.float32).reshape(2, -1))
    got = tsolver.solve(plan0, model, d, None)
    assert torch.equal(got.qacc, d.qacc_smooth)
    assert not got.qfrc_constraint.any()
