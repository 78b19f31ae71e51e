"""Condim-1, -4 and -6 contacts through the port: the rows and trajectory of
tests/test_physics_parity.py's CONDIM_XML (a condim-6 and a condim-4
sphere spinning and rolling on a plane, pyramidal) against the JAX package
and MuJoCo C; and the dense-J fused solve's plain version against the JAX
package's dense-J TPU kernel in the Pallas interpreter, on the rodent with
mixed condims. Elliptic plans off their compact layout are
tests/test_torch_elliptic.py's.

The kernel comparison feeds one mixed-condim rodent forward of the port
(4 contact-rich envs) to both, as numpy arrays: no JAX rodent jit."""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import chip_smoke
import test_physics_parity as tpp
from torch_parity import SOLVE_REL, STAGE_REL, assert_close, contact_rich_states
from track_mjx_tpu.ops import cg_solver_kernel as jk
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import sensors as jsens
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_STEPS = 20  # tests/test_physics_parity.py's spin-and-roll trajectory
ROWS = ("J", "aref", "D", "pos", "fmin", "fmax")
STATE = ("qpos", "qvel", "time", "qacc_warmstart")
# The bars of tests/test_torch_step.py after one step and after 20 (the
# spheres' spin decays smoothly; measured on an x86 CPU at most 9.4e-7).
BARS = {1: 1e-4, N_STEPS: 1e-3}
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")


def _condim_start():
    """test_spin_roll_trajectory's start (ball6 spinning about the normal
    and rolling, ball4 spinning) and a second env with the spins reversed
    and ball4 rolling too."""
    m = mujoco.MjModel.from_xml_string(tpp.CONDIM_XML)
    qvel = np.zeros((2, m.nv))
    qvel[0, 3:6] = [1.0, 0.0, 6.0]
    qvel[0, 0] = 0.5
    qvel[0, 9:12] = [0.0, 0.0, 8.0]
    qvel[1, 3:6] = [0.0, -2.0, -5.0]
    qvel[1, 6] = -0.4
    qvel[1, 9:12] = [1.5, 0.0, -7.0]
    return m, {"qpos": np.tile(m.qpos0, (2, 1)).astype(np.float32), "qvel": qvel.astype(np.float32)}


@pytest.fixture(scope="module")
def condim():
    """One jit of the JAX package's step (spelled out, to return the first
    forward's rows), run N_STEPS times from the carried state, and the
    port's rows, step and n_step from the same start."""
    m, start = _condim_start()
    jplan, jmodel = jm.put_model(m)

    def run(carry):
        d = jm.make_data(jplan, jmodel).replace(**carry)
        with jax.default_matmul_precision("highest"):
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_velocity(jplan, jmodel, d)
            d = jf.fwd_actuation(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, d)
            d = jsens.sensor(jplan, jmodel, jsolver.solve(jplan, jmodel, d, efc))
        return jf.euler(jplan, jmodel, d), efc

    step = jax.jit(jax.vmap(run))
    template = jm.make_data(jplan, jmodel)
    carry = {f: np.broadcast_to(np.asarray(getattr(template, f)), (2,) + np.shape(getattr(template, f)))
             for f in jf._CARRY_FIELDS}
    carry.update(start)
    want = {}
    for n in range(1, N_STEPS + 1):
        d, efc = step(carry)
        carry = {f: getattr(d, f) for f in jf._CARRY_FIELDS}
        if n == 1:
            rows = {k: np.asarray(getattr(efc, k)) for k in ROWS}
        if n in BARS:
            want[n] = {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    data = tm.make_data(plan, model, 2).replace(**{k: torch.tensor(v) for k, v in start.items()})
    _, efc = tf.fwd_position(plan, model, data)
    got = {1: tf.step(plan, model, data), N_STEPS: tf.n_step(plan, model, data, N_STEPS)}
    return dict(m=m, start=start, jplan=jplan, plan=plan, model=model, data=data, efc=efc, rows=rows,
                want=want, got=got)


def test_condim_plan(condim):
    plan = condim["plan"]
    assert plan.condim == 6 and sorted(set(plan.contact_condim.tolist())) == [4, 6]
    assert plan.nefc == condim["jplan"].nefc == int((2 * (plan.contact_condim - 1)).sum())
    assert tsolver.fused_scalar_cg(plan) and condim["efc"].J is not None and condim["efc"].jb_fq is None


@pytest.mark.parametrize("row", ROWS)
def test_rows_match_jax(condim, row):
    """Pyramid rows over the tangential and rotational directions (J, aref,
    D, pos and the bounds) at the start: measured on an x86 CPU at most
    8.8e-8 (aref)."""
    got = getattr(condim["efc"], row)
    if row in ("fmin", "fmax"):
        got = got.expand(2, -1)
    assert_close(row, got, condim["rows"][row], STAGE_REL)


@pytest.mark.parametrize("n", list(BARS))
@pytest.mark.parametrize("name", STATE + ("qacc", "efc_force"))
def test_step_matches_jax(condim, name, n):
    assert_close(f"{name} after {n}", getattr(condim["got"][n], name), condim["want"][n][name], BARS[n])


def test_trajectory_matches_mujoco(condim):
    """test_spin_roll_trajectory on env 0: the spins decelerate in C, and the
    port follows C within its bars (qvel 5e-3, qpos 2e-3)."""
    m = condim["m"]
    md = mujoco.MjData(m)
    md.qpos[:], md.qvel[:] = condim["start"]["qpos"][0], condim["start"]["qvel"][0]
    for _ in range(N_STEPS):
        mujoco.mj_step(m, md)
    assert md.qvel[5] < 5.6 and md.qvel[11] < 7.7
    got = condim["got"][N_STEPS]
    assert_close("qvel", got.qvel[0], md.qvel, 5e-3)
    assert_close("qpos", got.qpos[0], md.qpos, 2e-3)


def test_dense_plan_routes_through_cg_solve_dense(condim, monkeypatch):
    """An Euler step of the dense plan: one cg_solve_dense with the Euler
    solve, no other solve, and forward does not factor qM."""
    calls = []
    op = tk.cg_solve_dense

    def counted(*args, **kwargs):
        calls.append(kwargs["with_euler"])
        return op(*args, **kwargs)

    monkeypatch.setattr(tsolver.cg_solver_kernel, "cg_solve_dense", counted)
    for name in ("cg_solve", "ell_cg_solve"):
        monkeypatch.setattr(tsolver.cg_solver_kernel, name, None)
    from track_mjx_tpu_torch.ops import batched_linalg as bl

    for name in ("cholesky", "cho_solve", "solve_spd"):
        monkeypatch.setattr(bl, name, None)
    out = tf.step(condim["plan"], condim["model"], condim["data"])
    assert calls == [True] and torch.isfinite(out.qpos).all()


# ---------------------------------------------------------------------------
# the dense-J kernel's plain version against the JAX package's kernel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed():
    """One forward of the rodent with mixed condims, 4 contact-rich envs
    (contact_rich_states, seed 7), to the solve's inputs."""
    tf.set_full_f32()
    snap = chip_smoke.mixed_condim(tm.load_snapshot("rodent-full-clips"))
    plan, model = tm.put_model(snap, device="cpu")
    qpos, qvel, ctrl, warm = (torch.tensor(a) for a in contact_rich_states(
        plan.nq, plan.nv, plan.nu, snap.qpos0, 4, seed=7))
    d = tm.make_data(plan, model, 4).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    d, efc = tf.fwd_position(plan, model, d)
    d = tf.fwd_velocity(plan, model, d)
    d = tf.fwd_actuation(plan, model, d)
    d = tf.fwd_acceleration(plan, model, d)
    return plan, model, d, efc, tsolver.dense_solve_inputs(plan, model, d, efc)


def test_mixed_rodent_rows(mixed):
    """Every condim is present and active, the rows leave the compact
    layout, and the plan is a fused (dense) CG plan."""
    plan, _, _, efc, a = mixed
    counts = {c: int((plan.contact_condim == c).sum()) for c in (1, 3, 4, 6)}
    assert counts[3] == 0 and min(counts[1], counts[4], counts[6]) > 0
    assert plan.nefc == plan.nlimit + counts[1] + 6 * counts[4] + 10 * counts[6]
    assert tuple(a["J"].shape) == (4, plan.nefc, plan.nv)
    assert tsolver.fused_scalar_cg(plan) and efc.jb_fq is None
    rows_per = np.concatenate([np.ones(counts[1]), np.full(counts[4], 6), np.full(counts[6], 10)]).astype(int)
    order = np.concatenate([np.nonzero(plan.contact_condim == c)[0] for c in (1, 4, 6)])
    act = efc.active_row[:, plan.nlimit:]
    contact_active = torch.stack([a.any(1) for a in torch.split(act, rows_per.tolist(), dim=1)], dim=1)
    for c in (1, 4, 6):
        assert contact_active[:, plan.contact_condim[order] == c].any(), f"no active condim-{c} contact"


@pytest.fixture(scope="module", params=(True, False), ids=("euler", "no_euler"))
def kernel_pair(request, mixed):
    """cg_solve_dense_plain and the JAX package's _cg_solve_tpu with jb=None
    (the dense-J mode, qM built from the CRB factors) in the Pallas
    interpreter, on the same inputs, with and without hd (the Euler
    solve)."""
    plan, model, d, _, a = mixed
    with_euler = request.param
    its, ls = plan.iterations, plan.ls_iterations
    got = tk.cg_solve_dense_plain(**a, iterations=its, ls_iterations=ls, with_euler=with_euler)
    n = lambda t: jnp.asarray(t.numpy())
    want = jk._cg_solve_tpu(
        n(d.qM), n(a["J"]), n(a["aref"]), n(a["D"]), n(a["qfrc_smooth"]), n(a["warm"]),
        jnp.float32(float(model.opt_tolerance)), hd=n(a["hd"]) if with_euler else None,
        crb=(n(a["buf"]), n(a["cdof"]), n(a["anc"]), n(a["arm"])),
        iterations=its, ls_iterations=ls, interpret=True,
    )
    return with_euler, got, dict(zip(OUTS, (np.asarray(w) for w in want)))


# Both run K2's schedule (jar and M dx advanced by increments, the panel
# inverses); the sums go in another order. Measured on an x86 CPU at most
# 3.9e-5 (qacc_eff).
@pytest.mark.parametrize("output", OUTS)
def test_dense_plain_matches_jax_kernel(kernel_pair, output):
    with_euler, got, want = kernel_pair
    if output == "qacc_eff" and not with_euler:
        assert got.qacc_eff is None and output not in want
        return
    assert_close(output, getattr(got, output), want[output], SOLVE_REL[output])
    if output == "efc_force":
        assert (np.abs(want[output]).max(axis=1) > 0).all()


def test_dense_plain_matches_the_reference_unfused_cg(mixed):
    """The reference's unfused solve of these plans, `_smooth_scalar_cg_single`
    (factor, smooth solve, the CG with every product fresh and the exact
    substitution, the Euler solve), batched here over `scalar_cg`, agrees
    with cg_solve_dense_plain within the solve's bars, as
    tests/test_cg_kernel_parity.py holds the TPU kernel to it: measured on
    an x86 CPU at most 1.3e-5 (qacc_eff)."""
    from track_mjx_tpu_torch.ops import batched_linalg as bl

    plan, _, _, _, a = mixed
    its, ls = plan.iterations, plan.ls_iterations
    got = tk.cg_solve_dense_plain(**a, iterations=its, ls_iterations=ls, with_euler=True)
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    l = bl.cholesky_plain(qm)
    smooth = bl.cho_solve_plain(l, a["qfrc_smooth"])
    x, force, qfrc = tk.scalar_cg(qm, lambda b: bl.cho_solve_plain(l, b), a["J"], a["aref"], a["D"], smooth,
                                  a["warm"], a["tolscale"], iterations=its, ls_iterations=ls)
    eff = bl.solve_spd_plain(qm + torch.diag_embed(a["hd"]), a["qfrc_smooth"] + qfrc)
    for name, want in zip(OUTS, (smooth, x, force, qfrc, eff)):
        assert_close(name, getattr(got, name), want, SOLVE_REL[name])
