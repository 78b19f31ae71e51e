"""Equality and frictionloss rows through the port, against the JAX package
and MuJoCo C: the connect, weld, joint, tendon, site-anchored weld and
frictionloss probes of tests/test_equality.py, each compiled by MuJoCo into
both packages (its site-anchored connect and mixed-order probes against C
only). The same numpy states (test_equality's randomized state and
two more seeds) go into both; the rows (J, aref, D, pos, fmin, fmax) and the
bounded CG solve's qacc, efc_force and qfrc_constraint are compared, and
where test_equality holds the JAX package to MuJoCo C, the port is held to
it with the same bars. The friction probe also runs under the Newton solver
(the bounded active set)."""

import types

import jax
import mujoco
import numpy as np
import pytest
import torch

import test_equality as te
from torch_parity import SOLVE_REL, STAGE_REL, assert_close, load_export_tool
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.physics import constraint as tc
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_ENVS = 3  # env 0 is test_equality's state (seed 0), the others seeds 1, 2
PROBES = {
    "connect": te.CONNECT_XML,
    "weld": te.WELD_XML,
    "joint": te.JOINT_XML,
    "tendon": te.TENDON_XML,
    "friction": te.FRICTION_XML,
    "site_weld": te.SITE_WELD_XML,
}
# held to MuJoCo C only (the JAX package's compile of each probe costs
# seconds): the site-anchored connect, and test_equality's mixed order (a
# joint equality declared before a connect)
C_ONLY = {"site_connect": te.SITE_CONNECT_XML, "mixed_order": te.MIXED_XML}
ROWS = ("J", "aref", "D", "pos", "fmin", "fmax")
SOLVED = ("qacc", "efc_force", "qfrc_constraint")


def _solved_jax(jplan, jmodel, qpos, qvel):
    """One jit of the JAX package over the states: the rows and the solve
    (forward's stages up to the solver, then solve)."""

    def run(q, v):
        d = jm.make_data(jplan, jmodel).replace(qpos=q, qvel=v)
        with jax.default_matmul_precision("highest"):
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_velocity(jplan, jmodel, d)
            d = jf.fwd_actuation(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, d)
            return efc, jsolver.solve(jplan, jmodel, d, efc)

    efc, d = jax.jit(jax.vmap(run))(qpos, qvel)
    return {k: np.asarray(getattr(efc, k)) for k in ROWS}, {k: np.asarray(getattr(d, k)) for k in SOLVED}


def _case(xml: str, solver=None, floss_scale: float = 1.0, qvel_scale: float = 0.3) -> dict:
    m = mujoco.MjModel.from_xml_string(xml)
    if solver is not None:
        m.opt.solver = solver
    m.dof_frictionloss[:] *= floss_scale
    m.tendon_frictionloss[:] *= floss_scale
    cs = [te._c_state(xml, seed=s, qvel_scale=qvel_scale) for s in range(N_ENVS)]
    qpos = np.array([d.qpos for _, d in cs], np.float32)
    qvel = np.array([d.qvel for _, d in cs], np.float32)
    jplan, jmodel = jm.put_model(m)
    rows, solved = _solved_jax(jplan, jmodel, qpos, qvel)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    d = tm.make_data(plan, model, N_ENVS).replace(qpos=torch.tensor(qpos), qvel=torch.tensor(qvel))
    _, efc = tf.fwd_position(plan, model, d)
    return dict(m=m, c=cs[0][1], plan=plan, model=model, jplan=jplan, data=d, efc=efc,
                out=tf.forward(plan, model, d), rows=rows, solved=solved)


@pytest.fixture(scope="module", params=list(PROBES))
def case(request):
    return dict(_case(PROBES[request.param]), name=request.param)


def test_plans_match_jax(case):
    plan, jplan = case["plan"], case["jplan"]
    for f in ("ne", "nf", "nefc", "ncon", "nlimit", "eq_connect", "eq_weld", "eq_joint", "eq_tendon"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.ne + plan.nf > 0
    assert case["efc"].J is not None and case["efc"].jb_fq is None  # off the compact layout


# The rows are the same float32 formulas in both packages (the weld's
# quaternion products, the connect/weld Jdot qvel by forward-mode through
# kinematics); measured on an x86 CPU at most 2.9e-7 (site_weld's aref).
@pytest.mark.parametrize("row", ROWS)
def test_rows_match_jax(case, row):
    got = getattr(case["efc"], row)
    if row in ("fmin", "fmax"):  # model constants, one row vector for every env
        got = got.expand(N_ENVS, -1)
    assert_close(row, got, case["rows"][row], STAGE_REL)


# The bounded CG (50/25, tolerance 0) in both packages over the same rows;
# the port's applies run its blocked substitution where the JAX package
# calls LAPACK's. Measured on an x86 CPU at most 1.9e-5 (weld's efc_force).
@pytest.mark.parametrize("output", SOLVED)
def test_solve_matches_jax(case, output):
    assert_close(output, getattr(case["out"], output), case["solved"][output], SOLVE_REL[output])


def test_rows_and_qacc_match_mujoco(case):
    """test_equality's checks on its state (env 0): rows within its bars
    (J, pos, D 1e-5, aref 2e-4), qacc within 5e-3."""
    efc = case["efc"]
    env0 = types.SimpleNamespace(**{k: getattr(efc, k)[0].numpy() for k in ("J", "pos", "aref", "D")})
    te._assert_rows(case["plan"], env0, case["m"], case["c"])
    c = case["c"]
    err = float(np.abs(case["out"].qacc[0].numpy() - c.qacc).max())
    assert err / max(1.0, float(np.abs(c.qacc).max())) < 5e-3


def test_connect_aref_has_the_jdot_term():
    """At qvel U(-0.5, 0.5) C's -Jdot qvel term is well above the bar
    (test_equality's check); the port's aref carries it."""
    m, c = te._c_state(te.CONNECT_XML, qvel_scale=0.5)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    d = tm.make_data(plan, model, 1).replace(
        qpos=torch.tensor(c.qpos, dtype=torch.float32)[None], qvel=torch.tensor(c.qvel, dtype=torch.float32)[None])
    _, efc = tf.fwd_position(plan, model, d)
    ne = plan.ne
    kbip = c.efc_KBIP[:ne]
    first_order = -kbip[:, 1] * c.efc_vel[:ne] - kbip[:, 0] * kbip[:, 2] * c.efc_pos[:ne]
    scale = float(np.abs(c.efc_aref[:ne]).max())
    assert float(np.abs(c.efc_aref[:ne] - first_order).max()) / scale > 5e-5
    assert float(np.abs(efc.aref[0, :ne].numpy() - c.efc_aref[:ne]).max()) / scale < 2e-5


def test_friction_force_saturates():
    """Frictionloss rows box-clamp: at qvel U(-2, 2) some rows saturate at
    +-frictionloss, none exceeds it, and the forces match C's (5e-3)."""
    m, c = te._c_state(te.FRICTION_XML, qvel_scale=2.0)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    d = tm.make_data(plan, model, 1).replace(
        qpos=torch.tensor(c.qpos, dtype=torch.float32)[None], qvel=torch.tensor(c.qvel, dtype=torch.float32)[None])
    out = tf.forward(plan, model, d)
    nf = plan.nf
    floss = c.efc_frictionloss[:nf]
    ours = out.efc_force[0, plan.ne : plan.ne + nf].numpy()
    assert (np.abs(ours) <= floss + 1e-5).all()
    assert (np.abs(np.abs(ours) - floss) < 1e-6).any(), "no row saturates"
    c_force = c.efc_force[plan.ne : plan.ne + nf]
    assert np.abs(ours - c_force).max() / max(1.0, np.abs(c_force).max()) < 5e-3


def test_bounded_cg_runs_through_cho_solve(monkeypatch):
    """A CG plan with frictionloss rows factors qM in forward (cholesky
    once), solves qacc_smooth (cho_solve once) and runs the bounded CG, one
    cho_solve per apply (iterations + 1), with no fused solve."""
    m = mujoco.MjModel.from_xml_string(te.FRICTION_XML)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    calls = {}
    for name in ("cholesky", "cho_solve", "solve_spd"):
        def counted(*args, _name=name, _op=getattr(bl, name)):
            calls[_name] = calls.get(_name, 0) + 1
            return _op(*args)
        monkeypatch.setattr(bl, name, counted)
    for name in ("cg_solve", "cg_solve_dense", "ell_cg_solve"):
        monkeypatch.setattr(tsolver.cg_solver_kernel, name, None)
    tf.step(plan, model, tm.make_data(plan, model, 1))
    assert calls == {"cholesky": 1, "cho_solve": 2 + plan.iterations, "solve_spd": 1}


@pytest.fixture(scope="module")
def newton_friction():
    """The friction probe under Newton, its frictionloss ten times the
    probe's and qvel U(-0.03, 0.03): at the probe's own, gravity saturates
    every row, and the quadratic zone would go untested."""
    return _case(te.FRICTION_XML, solver=mujoco.mjtSolver.mjSOL_NEWTON, floss_scale=10.0, qvel_scale=0.03)


# Newton over the bounded rows: the Hessian takes the quadratic zone's rows
# only. Measured on an x86 CPU at most 9.2e-7 (qacc).
@pytest.mark.parametrize("output", SOLVED)
def test_bounded_newton_matches_jax(newton_friction, output):
    case = newton_friction
    assert case["plan"].solver == tm.SOLVER_NEWTON and case["plan"].nf == 3
    assert_close(output, getattr(case["out"], output), case["solved"][output], SOLVE_REL[output])
    force, floss = case["solved"]["efc_force"], case["rows"]["fmax"]
    saturated = np.abs(np.abs(force) - floss) < 1e-6 * floss
    assert saturated.any() and not saturated.all(), "both zones must be present"


def test_bounded_newton_hessian_takes_the_quadratic_zone():
    """newton_hessian with force bounds: a saturated frictionloss row adds
    nothing to H, an equality row always adds, a unilateral row while jar <
    0."""
    j = torch.eye(3)[None]
    d = torch.tensor([[2.0, 3.0, 5.0]])
    jar = torch.tensor([[-1.0, 0.5, -1.0]])  # -D jar: 2, -1.5, 5
    fmin = torch.tensor([-tc.BIG_FORCE, -1.0, 0.0])
    fmax = torch.tensor([tc.BIG_FORCE, 1.0, tc.BIG_FORCE])
    h = tsolver.newton_hessian(torch.zeros(1, 3, 3), j, d, jar, fmin, fmax)
    assert torch.equal(torch.diagonal(h[0]), torch.tensor([2.0, 0.0, 5.0]))
    wide = torch.tensor([tc.BIG_FORCE, 2.0, tc.BIG_FORCE])  # the frictionloss row unclamped
    h = tsolver.newton_hessian(torch.zeros(1, 3, 3), j, d, jar, -wide * (fmin != 0), wide)
    assert torch.equal(torch.diagonal(h[0]), torch.tensor([2.0, 3.0, 5.0]))


@pytest.mark.parametrize("name", list(C_ONLY))
def test_c_only_probes_match_mujoco(name):
    """test_equality's row and qacc checks on its state. In MIXED_XML the
    rows come in eq-id order (the joint row, then the connect's three), as
    in C."""
    xml = C_ONLY[name]
    m, c = te._c_state(xml)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    d = tm.make_data(plan, model, 1).replace(
        qpos=torch.tensor(c.qpos, dtype=torch.float32)[None], qvel=torch.tensor(c.qvel, dtype=torch.float32)[None])
    _, efc = tf.fwd_position(plan, model, d)
    te._assert_rows(plan, types.SimpleNamespace(**{k: getattr(efc, k)[0].numpy() for k in ("J", "pos", "aref", "D")}),
                    m, c)
    qacc = tf.forward(plan, model, d).qacc[0].numpy()
    assert float(np.abs(qacc - c.qacc).max()) / max(1.0, float(np.abs(c.qacc).max())) < 5e-3


@pytest.mark.parametrize("name", ("connect", "weld", "joint", "tendon", "friction"))
def test_probe_snapshots_match_a_fresh_export(name):
    """The committed probe snapshots (track_mjx_tpu_torch/assets/probes, read
    on the card, where MuJoCo is not installed) are what
    tools/export_torch_model.py --probes writes from tests/test_equality.py's
    XML, field for field, and put_model builds the same plan from either."""
    tool = load_export_tool()
    m = tool.xml_model(tool.probe_xmls()[name])
    fresh = tool.snapshot_arrays(m)
    with np.load(tm.PROBE_SNAPSHOTS["probe-" + name]) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)
    plan, _ = tm.put_model(tm.load_snapshot("probe-" + name), device="cpu")
    live, _ = tm.put_model(m, device="cpu")
    for f in ("nq", "nv", "ne", "nf", "nefc", "eq_connect", "eq_weld", "eq_joint", "eq_tendon", "solver",
              "iterations", "ls_iterations"):
        assert getattr(plan, f) == getattr(live, f), f
