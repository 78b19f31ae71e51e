"""Elliptic plans off the compact layout through the port, against the JAX
package and MuJoCo C.

Edits of the fly-mc-intention model, each made alike on the live MjModel
(the JAX package) and on the port's snapshot:

- "condim1": the floor and one leg capsule (geom 79) at condim 1. That leg's
  floor contacts become condim-1 rows beside the other contacts' cone
  blocks: the fused dense-J elliptic solve (`ell_cg_solve_dense`, K3's
  dense-J mode; the reference's `_ell_cg_solve_tpu` with jb None).
- "frictionloss": dof_frictionloss 0.01 on every dof after the free root:
  the general elliptic CG (`cg_solver_kernel.elliptic_cg`, every apply a
  cho_solve on forward's factor).
- RK4 and implicitfast: the compact elliptic solve without its Euler solve
  (`ell_cg_solve(with_euler=False)`; the reference's hd=None).

And a small elliptic probe (PROBE_XML: a capsule torso with a limited hinge
arm and a free ball on a floor; the floor and the arm at condim 1, the rest
at condim 3), plain ("dense": the dense-J fused solve) and with a connect
and hinge frictionloss ("general": the general elliptic CG). The converged
solve of both is held against MuJoCo C's own objective.

Iterate-level bars hold at one CG iteration with one Newton step of the
linesearch (chip_smoke.py's FLY_KERNEL_REL, tests/test_torch_fly.py's
ONE_ITER_REL); at the plans' iterations the float32 elliptic linesearch is a
knife edge (PERF.md): once Newton has converged to an ulp, the sign of phi'
is roundoff. So a fused solve is held there by its optimality gap against a
converged float64 solve of the same rows, gap <= 2 gap_ref + 1e-3 |cost*|
(tests/test_cg_kernel_parity.py's bound), and the general CG, whose float32
runs part by more than that bound on the fly's static drops, in float64
against the JAX package's solve in float64, iterate for iterate."""

import copy
import dataclasses
import functools

import jax
import jax.experimental
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import torch_parity
from test_torch_fly import ONE_ITER_REL, STEP_BARS, _gentle_start
from torch_parity import STAGE_REL, assert_close, assert_plan_equal, ell_objective_f64
from track_mjx_tpu.ops import cg_solver_kernel as jk
from track_mjx_tpu.physics import constraint as jcon
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import constraint as tc
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
CONFIG = "fly-mc-intention"
N_ENVS = 6  # contact_rich_fly_states: 4 sliding envs, then 2 static drops
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")
ROWS = ("J", "aref", "D", "pos", "fmin", "fmax")
FLOSS = 0.01

PROBE_XML = """
<mujoco>
  <option cone="elliptic" impratio="2" timestep="0.002" solver="CG" iterations="4"
          ls_iterations="4" jacobian="dense"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1" condim="1"/>
    <body name="torso" pos="0 0 0.05">
      <freejoint/>
      <geom type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.05" condim="3" friction="0.8 0.02 0.002"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" range="-0.3 0.3" limited="true"{floss}/>
        <geom type="capsule" fromto="0 0 0 0.12 0 -0.04" size="0.02" condim="1"/>
      </body>
    </body>
    <body name="ball" pos="0.4 0 0.05">
      <freejoint/>
      <geom type="sphere" size="0.05" condim="3" friction="0.6 0.01 0.002"/>
    </body>
  </worldbody>{equality}
</mujoco>
"""
PROBES = {
    "dense": PROBE_XML.format(floss="", equality=""),
    "compact": PROBE_XML.format(floss="", equality="").replace('condim="1"', 'condim="3"'),
    "general": PROBE_XML.format(
        floss=' frictionloss="0.05"',
        equality='\n  <equality><connect body1="ball" body2="torso" anchor="-0.2 0 0"/></equality>',
    ),
}


def condim1(m):
    """The floor and geom 79 (a leg capsule, body 28) at condim 1; the other
    legs' pairs keep condim 3 (a pair takes the larger condim)."""
    m.geom_condim[[0, 79]] = 1


def frictionloss(m):
    m.dof_frictionloss[6:] = FLOSS


def integrator(kind):
    def edit(m):
        m.opt.integrator = kind
    return edit


EDITS = {"condim1": condim1, "frictionloss": frictionloss, "rk4": integrator(tm.INT_RK4),
         "implicitfast": integrator(tm.INT_IMPLICITFAST)}


@functools.lru_cache(maxsize=1)
def _live():
    return torch_parity.load_export_tool().workload_model(CONFIG)


def _fly(name):
    """(live MjModel, port plan, port model) of the fly edited by EDITS[name]."""
    m = copy.deepcopy(_live())
    EDITS[name](m)
    snap = tm.load_snapshot(CONFIG)
    EDITS[name](snap)
    tf.set_full_f32()
    plan, model = tm.put_model(snap, device="cpu")
    return m, plan, model


def _np(tree, fields):
    return {k: np.asarray(getattr(tree, k)) for k in fields}


DATA_FIELDS = [f.name for f in dataclasses.fields(jm.Data)]
EFC_FIELDS = ("J", "aref", "D", "pos", "active_row", "fmin", "fmax", "ell_mu")


def _jax_case(m, qpos, qvel, ctrl, warm):
    """One jit of the JAX package's forward stages and solve on the states,
    with the same solve at one iteration with one Newton step: (pre-solve
    data, rows, solve at the plan's iterations, at 1/0) as numpy dicts."""
    jplan, jmodel = jm.put_model(m)
    one = dataclasses.replace(jplan, iterations=1, ls_iterations=0)

    def run(qpos, qvel, ctrl, warm):
        with jax.default_matmul_precision("highest"):
            d = jm.make_data(jplan, jmodel).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, jf.fwd_actuation(jplan, jmodel, jf.fwd_velocity(jplan, jmodel, d)))
            return d, efc, jsolver.solve(jplan, jmodel, d, efc), jsolver.solve(one, jmodel, d, efc)

    d, efc, full, one_it = jax.jit(jax.vmap(run))(qpos, qvel, ctrl, warm)
    return dict(
        jplan=jplan, jmodel=jmodel, data=_np(d, DATA_FIELDS), efc=_np(efc, [k for k in EFC_FIELDS if getattr(efc, k) is not None]),
        full=_np(full, DATA_FIELDS), one=_np(one_it, DATA_FIELDS),
    )


def _port_efc(case) -> tc.EfcData:
    """The JAX rows as the port's EfcData (dense J, per-row bounds)."""
    e = case["efc"]
    t = torch.tensor
    return tc.EfcData(aref=t(e["aref"]), D=t(e["D"]), pos=t(e["pos"]), active_row=t(e["active_row"]), J=t(e["J"]),
                      fmin=t(e["fmin"][0]), fmax=t(e["fmax"][0]), ell_mu=t(e["ell_mu"][0]))


@functools.lru_cache(maxsize=None)
def _fly_case(name):
    m, plan, model = _fly(name)
    states = torch_parity.contact_rich_fly_states(m, N_ENVS, seed=7)
    case = _jax_case(m, *states)
    return dict(case, m=m, plan=plan, model=model, states=states)


@functools.lru_cache(maxsize=None)
def _probe_case(name):
    m = mujoco.MjModel.from_xml_string(PROBES[name])
    rng = np.random.RandomState(5)
    n = 4
    qpos = np.tile(m.qpos0, (n, 1))
    qpos[:, 2] -= rng.uniform(0.0, 0.01, n)
    qpos[:, 7] = rng.uniform(-0.36, 0.36, n)
    qpos[:, 10] -= rng.uniform(0.0, 0.01, n)
    qvel = rng.uniform(-0.5, 0.5, (n, m.nv))
    warm = rng.uniform(-2.0, 2.0, (n, m.nv))
    states = tuple(np.asarray(a, np.float32) for a in (qpos, qvel, np.zeros((n, m.nu)), warm))
    case = _jax_case(m, *states)
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    return dict(case, m=m, plan=plan, model=model, states=states)


@pytest.fixture(scope="module", params=("dense", "general"))
def probe_case(request):
    return _probe_case(request.param)


def _case(name):
    return _fly_case(name) if name in EDITS else _probe_case(name)


def _port_rows(case):
    plan, model = case["plan"], case["model"]
    qpos, qvel, ctrl, warm = (torch.tensor(a) for a in case["states"])
    d = tm.make_data(plan, model, qpos.shape[0]).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    return tf.fwd_position(plan, model, d)


def _check_rows(case, ns_want=None):
    """The port's rows against the JAX package's: every row field, the
    active rows, each cone block's mu_1, and the efc order (scalar rows,
    then the cone blocks), with active condim-1 rows and cone blocks."""
    plan, jplan = case["plan"], case["jplan"]
    assert_plan_equal(plan, jplan)
    _, got = _port_rows(case)
    want = case["efc"]
    assert got.jb_fq is None and got.J is not None
    for name in ROWS:
        w = want[name][0] if name in ("fmin", "fmax") else want[name]
        assert_close(name, getattr(got, name), w, STAGE_REL)
    np.testing.assert_array_equal(got.active_row.numpy(), want["active_row"])
    np.testing.assert_array_equal(got.ell_mu.numpy(), want["ell_mu"][0])
    ns = plan.nefc - 3 * plan.ncon_ell
    if ns_want is not None:
        assert ns == ns_want
    # the last 3 ncon_ell rows are the cone blocks: their normal rows carry
    # the contact's distance, the friction rows none
    blocks = got.pos[:, ns:].reshape(-1, plan.ncon_ell, 3)
    assert float(blocks[..., 1:].abs().max()) == 0 and float(blocks[..., 0].abs().max()) > 0
    assert bool(got.active_row[:, ns:].any())
    return got, ns


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------


def test_fly_condim1_rows_match_jax():
    """nefc 113 = 36 limits + 2 condim-1 rows + 25 cone blocks; the condim-1
    rows (geom 79's floor contacts) active on every env."""
    case = _fly_case("condim1")
    plan = case["plan"]
    assert (plan.ncon, plan.ncon_ell, plan.nlimit, plan.nefc) == (27, 25, 36, 113)
    assert tsolver.fused_elliptic_cg(plan) and not tc._jb_supported_ell(plan)
    got, ns = _check_rows(case, ns_want=38)
    assert bool(got.active_row[:, 36:38].any(dim=1).all())
    assert torch.equal(got.fmax, torch.full_like(got.fmax, tk.BIG_FORCE)) and not got.fmin.any()


def test_fly_frictionloss_rows_match_jax():
    """nefc 153 = 36 frictionloss + 36 limits + 27 cone blocks, the
    frictionloss rows bounded by +-0.01."""
    case = _fly_case("frictionloss")
    plan = case["plan"]
    assert (plan.nf, plan.ncon_ell, plan.nlimit, plan.nefc) == (36, 27, 36, 153)
    assert not tsolver.fused_cg(plan)
    got, ns = _check_rows(case, ns_want=72)
    assert torch.equal(got.fmax[:36], torch.full((36,), FLOSS)) and torch.equal(got.fmin[:36], -got.fmax[:36])


def test_probe_rows_match_jax(probe_case):
    plan = probe_case["plan"]
    assert set(plan.contact_condim.tolist()) == {1, 3} and plan.nlimit == 1
    got, ns = _check_rows(probe_case)
    cd1 = plan.ne + plan.nf + plan.nlimit + np.arange(int((plan.contact_condim == 1).sum()))
    assert bool(got.active_row[:, cd1].any())


# ---------------------------------------------------------------------------
# the dense-J fused solve
# ---------------------------------------------------------------------------


def _dense_inputs(case) -> dict:
    """ell_cg_solve_dense's keyword arguments from the JAX package's data
    and rows (float32 numpy), and the same as JAX arrays for the JAX paths."""
    plan, m = case["plan"], case["m"]
    d, e = case["data"], case["efc"]
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    bsz = d["qpos"].shape[0]
    mu = f32(e["ell_mu"] / np.sqrt(max(m.opt.impratio, 1e-12)))
    scale = np.maximum((d["crb_buf"] * d["cdof"]).sum((-2, -1)) + m.dof_armature.sum(), 1e-12)
    return dict(
        buf=f32(d["crb_buf"]), cdof=f32(d["cdof"]), J=f32(e["J"]), aref=f32(e["aref"]), D=f32(e["D"]), mu=mu,
        qfrc_smooth=f32(d["qfrc_smooth"]), warm=f32(d["qacc_warmstart"]),
        hd=f32(np.broadcast_to(m.opt.timestep * m.dof_damping, (bsz, m.nv))),
        tolscale=f32(np.float32(m.opt.tolerance) * scale), anc=f32(plan.ancestry_mask), arm=f32(m.dof_armature),
    )


@functools.lru_cache(maxsize=None)
def _interp(name: str, with_euler: bool):
    """The JAX dense-J kernel (`_ell_cg_solve_tpu` with jb None) in the
    Pallas interpreter at 1/0 on `_dense_inputs`, with hd or with hd None."""
    case = _case(name)
    a = _dense_inputs(case)
    plan, m = case["plan"], case["m"]
    got = jk._ell_cg_solve_tpu(
        case["data"]["qM"], a["J"], a["aref"], a["D"], a["mu"], a["qfrc_smooth"], a["warm"],
        jnp.asarray(m.opt.tolerance, jnp.float32), hd=jnp.asarray(a["hd"]) if with_euler else None,
        crb=(a["buf"], a["cdof"], jnp.asarray(a["anc"]), jnp.asarray(a["arm"])), jb=None,
        ns=plan.nefc - 3 * plan.ncon_ell, ncon_ell=plan.ncon_ell, iterations=1, ls_iterations=0, interpret=True,
    )
    assert len(got) == (5 if with_euler else 4)
    return dict(zip(OUTS, (np.asarray(x) for x in got)))


def _gap_check(case, got_qacc, want_qacc):
    """The optimality gap of `got_qacc` within the bound set by `want_qacc`
    on every env, against the dense plain version's float64 solve of the
    same rows at 60/15."""
    plan, d, e = case["plan"], case["data"], case["efc"]
    ns = plan.nefc - 3 * plan.ncon_ell
    a = {k: torch.tensor(v).double() for k, v in _dense_inputs(case).items()}
    star = tk.ell_cg_solve_dense_plain(**a, ns=ns, with_euler=False, iterations=60, ls_iterations=15)
    cost = lambda x: ell_objective_f64(d["qM"], e["J"], e["aref"], e["D"], a["mu"].numpy(),
                                       star.qacc_smooth.numpy(), np.asarray(x), ns)
    cost_star = cost(star.qacc.numpy())
    gap_got, gap_want = cost(got_qacc) - cost_star, cost(want_qacc) - cost_star
    assert np.all(gap_got <= 2.0 * gap_want + 1e-3 * np.abs(cost_star)), (gap_got, gap_want)
    assert np.all(gap_got >= -1e-6 * np.abs(cost_star)), (gap_got, "the converged solve is not converged")


DENSE_ONE_ITER = [("dense", True), ("dense", False), ("condim1", True)]


@pytest.mark.parametrize("name, with_euler", DENSE_ONE_ITER, ids=["-".join(map(str, c)) for c in DENSE_ONE_ITER])
def test_dense_plain_matches_jax_one_iteration(name, with_euler):
    """ell_cg_solve_dense_plain at 1/0 against the JAX dense-J kernel in the
    interpreter (with hd, and on the probe also with hd None: no qacc_eff)
    and against the JAX CPU path (solve(): `_elliptic_cg_single`, then the
    Euler solve) at ONE_ITER_REL: measured on an x86 CPU at most 1.9e-6
    (qacc_eff, the fly against the interpreter). Without Euler the port's
    four outputs are the with-Euler run's bit for bit."""
    case = _case(name)
    a = {k: torch.tensor(v) for k, v in _dense_inputs(case).items()}
    plan = case["plan"]
    ns = plan.nefc - 3 * plan.ncon_ell
    got = tk.ell_cg_solve_dense(**a, ns=ns, with_euler=with_euler, iterations=1, ls_iterations=0)
    if not with_euler:
        full = tk.ell_cg_solve_dense(**a, ns=ns, with_euler=True, iterations=1, ls_iterations=0)
        assert got.qacc_eff is None
        for out in OUTS[:4]:
            assert torch.equal(getattr(got, out), getattr(full, out)), out
    for ref, want in (("interp", _interp(name, with_euler)), ("cpu", case["one"])):
        for out in OUTS[: 5 if with_euler else 4]:
            assert_close(f"{out} against {ref}", getattr(got, out), want[out], ONE_ITER_REL[out])
    assert (np.abs(case["one"]["efc_force"][:, :ns]).max(1) > 0).any()  # scalar rows active


def test_dense_plain_matches_jax_by_optimality_gap():
    """At the fly's 4/4 the plain version solves as well as the JAX
    package's solve() (the JAX CPU path of the dense-J kernel), by the
    optimality gap; qacc_smooth at its bar."""
    case = _fly_case("condim1")
    plan = case["plan"]
    a = {k: torch.tensor(v) for k, v in _dense_inputs(case).items()}
    got = tk.ell_cg_solve_dense(**a, ns=plan.nefc - 3 * plan.ncon_ell, with_euler=True,
                                iterations=plan.iterations, ls_iterations=plan.ls_iterations)
    assert_close("qacc_smooth", got.qacc_smooth, case["full"]["qacc_smooth"], ONE_ITER_REL["qacc_smooth"])
    _gap_check(case, got.qacc.numpy(), case["full"]["qacc"])


def test_dense_solve_matches_the_jax_solve():
    """solve() on the fly condim-1 plan routes to ell_cg_solve_dense with the
    Euler solve, on the inputs `ell_dense_solve_inputs` makes, and lands as
    well as the JAX package's solve() by the gap."""
    case = _fly_case("condim1")
    plan, model = case["plan"], case["model"]
    d = tm.data_from_numpy(case["data"], device="cpu")
    efc = _port_efc(case)
    got = tsolver.solve(plan, model, d, efc)
    inputs = tsolver.ell_dense_solve_inputs(plan, model, d, efc)
    for k, v in _dense_inputs(case).items():
        assert_close(k, inputs[k], v, STAGE_REL)
    want = tk.ell_cg_solve_dense(**inputs, with_euler=True, iterations=plan.iterations,
                                 ls_iterations=plan.ls_iterations)
    for name in OUTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    _gap_check(case, got.qacc.numpy(), case["full"]["qacc"])


def test_no_euler_compact_plain_matches_jax_kernel():
    """ell_cg_solve_plain(with_euler=False) against the JAX compact kernel in
    the interpreter with hd None, at 1/0 on the probe with every geom at
    condim 3 (the compact elliptic layout), from the port's forward; its
    four outputs are the with-Euler run's bit for bit."""
    m = mujoco.MjModel.from_xml_string(PROBES["compact"])
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    assert tsolver.fused_elliptic_cg(plan) and tc._jb_supported_ell(plan)
    qpos, qvel, ctrl, warm = (torch.tensor(a) for a in _probe_case("dense")["states"])
    d = tm.make_data(plan, model, qpos.shape[0]).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    d, efc = tf.fwd_position(plan, model, d)
    d = tf.fwd_acceleration(plan, model, tf.fwd_actuation(plan, model, tf.fwd_velocity(plan, model, d)))
    a = tsolver.ell_solve_inputs(plan, model, d, efc)
    got = tk.ell_cg_solve(**a, iterations=1, ls_iterations=0, with_euler=False)
    full = tk.ell_cg_solve(**a, iterations=1, ls_iterations=0, with_euler=True)
    assert got.qacc_eff is None
    for name in OUTS[:4]:
        assert torch.equal(getattr(got, name), getattr(full, name)), name
    n = {k: v.numpy() for k, v in a.items()}
    want = jk._ell_cg_solve_tpu(
        d.qM.numpy(), None, n["aref"], n["D"], n["mu"], n["qfrc_smooth"], n["warm"],
        jnp.asarray(m.opt.tolerance, jnp.float32), hd=None, crb=(n["buf"], n["cdof"], n["anc"], n["arm"]),
        jb=(n["fq"], n["sw"], n["ll"], n["dm"], n["lim1h"]), jb_nl=plan.nlimit, ns=plan.nlimit,
        ncon_ell=plan.ncon_ell, iterations=1, ls_iterations=0, interpret=True,
    )
    assert len(want) == 4  # no Euler solve, no qacc_eff
    for name, w in zip(OUTS[:4], want):
        assert_close(name, getattr(got, name), np.asarray(w), ONE_ITER_REL[name])
    assert bool((got.efc_force != 0).any())


# ---------------------------------------------------------------------------
# the general elliptic CG
# ---------------------------------------------------------------------------


def _solve(case, dtype=torch.float32, **steps):
    """The port's solve() on the JAX package's pre-solve data and rows, in
    `dtype`, at `steps` (the plan's iterations by default)."""
    plan = dataclasses.replace(case["plan"], **steps)

    def cast(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(dtype) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor) and getattr(obj, f.name).is_floating_point()})

    model = cast(case["model"])
    return tsolver.solve(plan, model, cast(tm.data_from_numpy(case["data"], device="cpu")), cast(_port_efc(case)))


@functools.lru_cache(maxsize=None)
def _jax_solve_f64(name):
    """The JAX package's solve() of the case's rows in float64, at the plan's
    iterations with one bracketed Newton step (F64_STEPS). A fused plan's
    qM is the one the port's solve builds from the CRB factors."""
    case = _case(name)
    jplan = dataclasses.replace(case["jplan"], **F64_STEPS)
    data = dict(case["data"])
    if tsolver.fused_cg(case["plan"]):
        a = {k: torch.tensor(v).double() for k, v in _dense_inputs(case).items()}
        data["qM"] = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"]).numpy()
    with jax.enable_x64(True):
        f64 = lambda t: jnp.asarray(t, jnp.float64) if jnp.issubdtype(jnp.asarray(t).dtype, jnp.floating) else t
        jmodel = jax.tree.map(f64, case["jmodel"])
        d = jm.Data(**{k: f64(v) for k, v in data.items()})
        efc = jcon.EfcData(**{f.name: (f64(case["efc"][f.name]) if f.name in case["efc"] else None)
                              for f in dataclasses.fields(jcon.EfcData)})
        out = jax.jit(jax.vmap(lambda d, e: jsolver.solve(jplan, jmodel, d, e)))(d, efc)
        return _np(out, OUTS)


@pytest.mark.parametrize("name", ("frictionloss", "general"))
def test_general_cg_matches_jax_one_iteration(name):
    """elliptic_cg (through solve(), over forward's qM and its factor) against
    the JAX package's solve() at 1/0 on the same rows: qacc, efc_force and
    qfrc_constraint at ONE_ITER_REL (measured on an x86 CPU at most 1.1e-6);
    frictionloss rows and cone blocks active on every env."""
    case = _case(name)
    got = _solve(case, iterations=1, ls_iterations=0)
    for out in ("qacc", "efc_force", "qfrc_constraint"):
        assert_close(out, getattr(got, out), case["one"][out], ONE_ITER_REL[out])
    plan = case["plan"]
    assert bool(got.efc_force[:, plan.ne : plan.ne + plan.nf].any(dim=1).all())
    assert bool(got.efc_force[:, plan.nefc - 3 * plan.ncon_ell :].any(dim=1).all())


# A solve in float64 against the JAX package's in float64 at the plans'
# iterations, per output relative to max(1, max |JAX|): the same float64
# algorithm, sums in another order. The linesearch takes one bracketed
# Newton step: with more, once Newton has converged to an ulp the bracket's
# bisection fallback parts two float64 runs too (on the probe's env 1 at
# 1/4: 6e-3), which test_linesearch_matches_jax_through_bisection holds on
# its own. Measured on an x86 CPU at most 4.6e-14 (efc_force, the fly with
# frictionloss); the bar leaves 20x.
F64_STEPS = dict(ls_iterations=1)
F64_REL = 1e-12


@pytest.mark.parametrize("name", ("frictionloss", "general", "dense", "condim1"))
def test_solve_matches_jax_in_float64(name):
    """At the plans' iterations, where the float32 linesearch is a knife
    edge, the port's solve() in float64 (the general elliptic CG; on "dense"
    and "condim1" the dense-J fused solve's plain version) agrees with the
    JAX package's solve() in float64 iterate for iterate (F64_REL); the
    float32 solve at the plan's 4/4 lowers the objective below both starts'
    and stays finite."""
    case = _case(name)
    got = _solve(case, torch.float64, **F64_STEPS)
    want = _jax_solve_f64(name)
    plan, d, e = case["plan"], case["data"], case["efc"]
    for out in OUTS if tsolver.fused_euler(plan) else OUTS[1:4]:
        assert_close(out, getattr(got, out), want[out], F64_REL)
    f32 = _solve(case)
    ns = plan.nefc - 3 * plan.ncon_ell
    mu = e["ell_mu"] / np.sqrt(case["m"].opt.impratio)
    smooth = np.linalg.solve(d["qM"].astype(np.float64), d["qfrc_smooth"].astype(np.float64)[..., None])[..., 0]
    cost = lambda x: ell_objective_f64(d["qM"], e["J"], e["aref"], e["D"], mu, smooth, np.asarray(x), ns,
                                       e["fmin"][0], e["fmax"][0])
    assert np.isfinite(f32.qacc.numpy()).all()
    assert np.all(cost(f32.qacc.numpy()) < np.minimum(cost(d["qacc_warmstart"]), cost(smooth)))


def test_linesearch_matches_jax_through_bisection():
    """The general CG's safeguarded linesearch (`_ell_linesearch` with the
    bounded scalar terms) against the reference's `_linesearch` in float64,
    on the general probe's env 1 at its first iteration, for 0 to 5 steps:
    Newton converges within 2, then the bracket bisects; alpha within 1e-12
    at every count."""
    case = _case("general")
    env = 1
    jplan = case["jplan"]
    with jax.enable_x64(True):
        f64 = lambda t: jnp.asarray(t, jnp.float64) if jnp.issubdtype(jnp.asarray(t).dtype, jnp.floating) else t
        jmodel = jax.tree.map(f64, case["jmodel"])
        d = jm.Data(**{k: f64(v[env]) for k, v in case["data"].items()})
        efc = jcon.EfcData(**{f.name: (f64(case["efc"][f.name][env]) if f.name in case["efc"] else None)
                              for f in dataclasses.fields(jcon.EfcData)})
        ell = jsolver._ell_const(jplan, jmodel, efc)
        x0 = d.qacc_smooth
        p = -jsolver.inertia.solve_m(d, jsolver._cost_grad(jplan, efc, ell, d, x0)[1])
        want = [float(jsolver._linesearch(jplan, efc, ell, d, x0, p, ls)) for ls in range(6)]
    ns, nc = jplan.nefc - 3 * jplan.ncon_ell, jplan.ncon_ell
    t = lambda a: torch.tensor(np.asarray(a))[None]
    j, aref, dd, qm, x, pp = t(efc.J), t(efc.aref), t(efc.D), t(d.qM), t(x0), t(p)
    fmin, fmax = (torch.tensor(np.asarray(a))[:ns] for a in (efc.fmin, efc.fmax))
    cones, split, d_s = tk._cones(dd, t(ell.mu_t), ns), tk._ell_split(ns, nc), dd[:, :ns]

    def scalar_terms(jar_s, jp_s):
        f, quad = tk.scalar_zone(jar_s, d_s, fmin, fmax)
        return (torch.where(quad, d_s * jar_s * jp_s, -f * jp_s).sum(-1),
                torch.where(quad, d_s * jp_s * jp_s, torch.zeros_like(jp_s)).sum(-1))

    def cost_rows(jar):
        jar_s, u = split(jar)
        return tk.scalar_cost(jar_s, d_s, fmin, fmax).sum(-1) + cones.cost(u)

    mv = lambda a, v: (a @ v[..., None])[..., 0]
    got = [float(tk._ell_linesearch(cones, split, mv(j, x) - aref, mv(j, pp), (pp * mv(qm, pp)).sum(-1),
                                    (pp * mv(qm, x - t(d.qacc_smooth))).sum(-1), scalar_terms, cost_rows, ls))
           for ls in range(6)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert len(set(np.round(want, 15))) > 3  # the bracket moved alpha at later steps


@pytest.mark.parametrize("name", ("dense", "general"))
def test_probe_objective_not_worse_than_c(name):
    """The port's solve, converged (50/20), scores no worse than MuJoCo C's
    converged solution (100/50) on C's own objective (mj_constraintUpdate),
    as tests/test_fly.py holds the JAX package: from C's state, condim-1
    and condim-3 contacts active (and in "general" the connect and the
    frictionloss rows)."""
    case = _probe_case(name)
    m = copy.deepcopy(case["m"])
    m.opt.iterations, m.opt.ls_iterations = 100, 50
    plan = dataclasses.replace(case["plan"], iterations=50, ls_iterations=20)
    qpos, qvel, _, _ = (a[1] for a in case["states"])
    md = mujoco.MjData(m)
    md.qpos[:], md.qvel[:] = qpos, qvel
    mujoco.mj_forward(m, md)
    assert md.ncon > 0 and set(md.contact.dim[: md.ncon].tolist()) == {1, 3}
    d = tm.make_data(plan, case["model"], 1).replace(qpos=torch.tensor(qpos[None]), qvel=torch.tensor(qvel[None]))
    ours = tf.forward(plan, case["model"], d).qacc[0].double().numpy()
    M = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, md, M)
    jc = md.efc_J.reshape(md.nefc, m.nv)

    def phi_c(x):
        jar = (jc @ x - md.efc_aref).reshape(-1, 1)
        cost = np.zeros((1, 1))
        mujoco.mj_constraintUpdate(m, md, jar, cost, 0)
        dx = x - md.qacc_smooth
        return 0.5 * dx @ M @ dx + cost[0, 0]

    assert phi_c(ours) <= phi_c(md.qacc) * (1 + 1e-4) + 1e-6, (phi_c(ours), phi_c(md.qacc))


# ---------------------------------------------------------------------------
# the fly on RK4 and implicitfast: the compact solve without Euler
# ---------------------------------------------------------------------------


def _jax_step(name, jplan, jmodel):
    """The JAX package's step of one env, batched over envs. implicitfast: one
    jit of jf.step. RK4: jf.rk4 over jf.forward, its four forwards one jit of
    the forward (jf.step's RK4 whole is a jit of four forwards' size)."""
    if name != "rk4":
        return jax.jit(jax.vmap(lambda d: jf.step(jplan, jmodel, d)))
    forward = jf.forward
    fwd = jax.jit(lambda d: forward(jplan, jmodel, d))

    def step(d):
        jf.forward = lambda plan, model, data: fwd(data)
        try:
            return jax.vmap(lambda d: jf.rk4(jplan, jmodel, fwd(d)))(d)
        finally:
            jf.forward = forward

    return step


@functools.lru_cache(maxsize=None)
def _integrator_case(name):
    """The JAX package's step from gentle fly starts, 2 "airborne" (no
    contact within a control step) and 2 in "contact" (legs 2-4 mm in the
    floor), run 10 times for a control step; the port's step and
    n_step(10)."""
    m, plan, model = _fly(name)
    jplan, jmodel = jm.put_model(m)
    rng = np.random.RandomState(11)
    starts = [_gentle_start(m, 2, rng, 0.05), _gentle_start(m, 2, rng, -rng.uniform(0.002, 0.004, (2,)))]
    start = {k: np.concatenate([s[k] for s in starts]) for k in starts[0]}
    step = _jax_step(name, jplan, jmodel)
    template = jm.make_data(jplan, jmodel)
    d = jax.tree.map(lambda x: jnp.broadcast_to(x, (4,) + jnp.shape(x)), template).replace(
        **{k: jnp.asarray(v) for k, v in start.items()})
    want = {}
    for n in range(1, 11):
        d = step(d)
        if n in (1, 10):
            want[n] = _np(d, DATA_FIELDS)
    data = tm.make_data(plan, model, 4).replace(**{k: torch.tensor(v) for k, v in start.items()})
    got = {1: tf.step(plan, model, data), 10: tf.n_step(plan, model, data, 10)}
    return dict(m=m, plan=plan, model=model, start=start, want=want, got=got, data=data)


@pytest.fixture(scope="module", params=("rk4", "implicitfast"))
def integrator_case(request):
    return _integrator_case(request.param)


def test_integrator_control_step_matches_jax(integrator_case):
    """The airborne flies over a control step (10 substeps) at the iterate
    level (STEP_BARS); the flies in contact over one substep: the stages
    before the solve at the iterate level, and the first forward's solve by
    its gap against a converged float64 solve of the port's rows (the state
    after the substep follows that solve, a knife edge in float32)."""
    c = integrator_case
    plan = c["plan"]
    assert tsolver.fused_elliptic_cg(plan) and not tsolver.fused_euler(plan)
    air, contact = slice(0, 2), slice(2, 4)
    for name in ("qpos", "qvel", "qacc", "qfrc_constraint", "sensordata"):
        assert_close(f"{name} after 10", getattr(c["got"][10], name)[air], c["want"][10][name][air], STEP_BARS[10])
    assert not (c["want"][10]["contact_dist"][air] < 0).any()
    one, got = c["want"][1], c["got"][1]
    assert (one["contact_dist"][contact] < 0).any(axis=1).all()
    for name in ("time", "qacc_smooth", "qfrc_passive", "xpos", "cvel"):
        assert_close(name, getattr(got, name)[contact], one[name][contact], STEP_BARS[1])
    # the first forward's solve, on the port's rows of that forward
    d, efc = tf.fwd_position(plan, c["model"], c["data"])
    d = tf.fwd_acceleration(plan, c["model"], tf.fwd_actuation(plan, c["model"], tf.fwd_velocity(plan, c["model"], d)))
    a = {k: v.double() for k, v in tsolver.ell_solve_inputs(plan, c["model"], d, efc).items()}
    star = tk.ell_cg_solve_plain(**a, iterations=60, ls_iterations=15, with_euler=False)
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    j = tk.build_j_ell(a["fq"], a["sw"], a["ll"], a["dm"], a["lim1h"])
    cost = lambda x: ell_objective_f64(qm[contact], j[contact], a["aref"][contact], a["D"][contact],
                                       a["mu"][contact], star.qacc_smooth[contact], np.asarray(x)[contact],
                                       plan.nlimit)
    cost_star = cost(star.qacc.numpy())
    gap_port, gap_jax = cost(got.qacc.numpy()) - cost_star, cost(one["qacc"]) - cost_star
    assert np.all(gap_port <= 2.0 * gap_jax + 1e-3 * np.abs(cost_star)), (gap_port, gap_jax)
    for name in ("qpos", "qvel"):
        assert np.isfinite(getattr(got, name).numpy()).all() and np.isfinite(getattr(c["got"][10], name).numpy()).all()


def test_rk4_holds_at_the_fly_timestep_in_mujoco():
    """Explicit RK4 holds on the fly at its 2e-4 timestep in MuJoCo C (the
    rodent needed an eighth of its own, PERF.md): 10 control steps of 10
    substeps from qpos0 with 1e-3 joint noise (chip_smoke.py's start),
    under fresh U(-1, 1) controls each control step, stay finite and within
    twice the largest |qvel| that the Euler integrator reaches under the
    same controls (the rodent at 0.002 reached 3.3e8 within 4 steps)."""
    rng = np.random.RandomState(0)
    for _ in range(2):
        noise = rng.uniform(-1e-3, 1e-3, _live().nq - 7)
        ctrls = rng.uniform(-1.0, 1.0, (10, _live().nu))
        top = {}
        for kind in (mujoco.mjtIntegrator.mjINT_EULER, mujoco.mjtIntegrator.mjINT_RK4):
            m = copy.deepcopy(_live())
            m.opt.integrator = kind
            assert m.opt.timestep == pytest.approx(2e-4)
            md = mujoco.MjData(m)
            md.qpos[7:] += noise
            top[kind], contacts = 0.0, 0
            for ctrl in ctrls:
                md.ctrl[:] = ctrl
                for _ in range(10):
                    mujoco.mj_step(m, md)
                    contacts = max(contacts, md.ncon)
                assert np.isfinite(md.qvel).all()
                top[kind] = max(top[kind], float(np.abs(md.qvel).max()))
            assert contacts > 0
        assert top[mujoco.mjtIntegrator.mjINT_RK4] < 2.0 * top[mujoco.mjtIntegrator.mjINT_EULER], top


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


WRAPPERS = ((tk, "cg_solve"), (tk, "cg_solve_dense"), (tk, "ell_cg_solve"), (tk, "ell_cg_solve_dense"),
            (bl, "cholesky"), (bl, "cho_solve"), (bl, "solve_spd"))


@pytest.mark.parametrize("name", ("condim1", "rk4", "implicitfast", "frictionloss", "probe"))
def test_routing(name, monkeypatch):
    """One step of each plan calls exactly its ops, each with the Euler flag
    its integrator needs: condim 1 the dense-J elliptic solve with Euler;
    RK4 four compact elliptic solves without; implicitfast one and the
    solve_spd of M - h qDeriv; frictionloss (and the general probe)
    factor_m, solve_m once for qacc_smooth and 1 + iterations times in the
    CG, and Euler's solve_spd."""
    calls = []

    def counted(op):
        def call(*args, **kwargs):
            calls.append((op.__name__, kwargs.get("with_euler")))
            return op(*args, **kwargs)
        return call

    for mod, op in WRAPPERS:
        monkeypatch.setattr(mod, op, counted(getattr(mod, op)))
    if name == "probe":
        case = _probe_case("general")
        plan, model, start = case["plan"], case["model"], case["states"]
    else:
        m, plan, model = _fly(name)
        start = torch_parity.contact_rich_fly_states(m, 2, seed=3)
    qpos, qvel, ctrl, warm = (torch.tensor(a[:2]) for a in start)
    d = tm.make_data(plan, model, 2).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    out = tf.step(plan, model, d)
    assert torch.isfinite(out.qpos).all()
    its = plan.iterations
    general = [("cholesky", None)] + [("cho_solve", None)] * (2 + its) + [("solve_spd", None)]
    want = {
        "condim1": [("ell_cg_solve_dense", True)],
        "rk4": [("ell_cg_solve", False)] * 4,
        "implicitfast": [("ell_cg_solve", False), ("solve_spd", None)],
        "frictionloss": general,
        "probe": general,
    }
    assert calls == want[name]
