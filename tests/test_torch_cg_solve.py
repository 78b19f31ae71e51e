"""The fused CG solve: the port's plain version against the JAX kernel run in
interpret mode (production configuration: qM from the CRB factors, J from the
compact operands, fused Euler solve) and against the unfused JAX path
`_smooth_scalar_cg_single`; the port's solve() against JAX's solve(); the
wrapper's argument checks; and, on a CUDA machine, the CUDA kernel against
the plain version."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import SOLVE_REL, assert_close, contact_rich_states
from track_mjx_tpu.ops import cg_solver_kernel as jk
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics.constraint import EfcData
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_ENVS = 4
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")


@pytest.fixture(scope="module")
def case():
    m = torch_parity.rodent_full_clips_model()
    jplan, jmodel = jm.put_model(m)
    assert jsolver.fused_euler(jplan)
    qpos, qvel, ctrl, warm = contact_rich_states(m.nq, m.nv, m.nu, m.qpos0, N_ENVS, seed=17)
    tol = jnp.asarray(m.opt.tolerance, jnp.float32)
    hd1 = jnp.asarray(m.opt.timestep * m.dof_damping, jnp.float32)
    its, ls = jplan.iterations, jplan.ls_iterations

    def run(qpos, qvel, ctrl, warm):
        with jax.default_matmul_precision("highest"):
            d = jm.make_data(jplan, jmodel).replace(
                qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm
            )
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_velocity(jplan, jmodel, d)
            d = jf.fwd_actuation(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, d)
            unfused = jsolver._smooth_scalar_cg_single(
                its, ls, True, d.qM, efc.J, efc.aref, efc.D, d.qfrc_smooth, warm, tol, hd1
            )
            solved = jsolver.solve(jplan, jmodel, d, efc)
        return d, efc, unfused, solved

    d, efc, unfused, solved = jax.jit(jax.vmap(run))(qpos, qvel, ctrl, warm)
    dm, lim1h = jsolver._jb_static(jplan)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    inputs = dict(
        buf=f32(d.crb_buf), cdof=f32(d.cdof), fq=f32(efc.jb_fq), sw=f32(efc.jb_sw),
        ll=f32(efc.jb_ll), mu=f32(efc.jb_mu), aref=f32(efc.aref), D=f32(efc.D),
        qfrc_smooth=f32(d.qfrc_smooth), warm=warm,
        hd=f32(np.broadcast_to(hd1, (N_ENVS, m.nv))),
        anc=f32(jplan.ancestry_mask), arm=f32(jmodel.dof_armature), dm=f32(dm), lim1h=f32(lim1h),
    )
    scale = np.maximum(
        (inputs["buf"].astype(np.float32) * inputs["cdof"]).sum((-2, -1)) + inputs["arm"].sum(), 1e-12
    )
    inputs["tolscale"] = f32(np.float32(m.opt.tolerance) * scale)
    interp = jk._cg_solve_tpu(
        d.qM, efc.J, efc.aref, efc.D, d.qfrc_smooth, warm, tol,
        hd=jnp.asarray(inputs["hd"]),
        crb=(d.crb_buf, d.cdof, jnp.asarray(inputs["anc"]), jmodel.dof_armature),
        jb=(efc.jb_fq, efc.jb_sw, efc.jb_ll, efc.jb_mu, inputs["dm"], inputs["lim1h"]),
        jb_dims=(jplan.nlimit, jplan.ncon),
        iterations=its, ls_iterations=ls, interpret=True,
    )
    data = {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
    return dict(
        plan_iters=(its, ls),
        inputs=inputs,
        interp=dict(zip(OUTS, (np.asarray(a) for a in interp))),
        unfused=dict(zip(OUTS, (np.asarray(a) for a in unfused))),
        solved={k: np.asarray(getattr(solved, k)) for k in OUTS},
        data=data,
        efc={k: np.asarray(getattr(efc, k)) for k in ("aref", "D", "jb_sw", "jb_fq", "jb_ll", "jb_mu")},
    )


def _plain(case):
    its, ls = case["plan_iters"]
    args = {k: torch.tensor(v) for k, v in case["inputs"].items()}
    before = tk.cg_solve.launches
    out = tk.cg_solve(**args, iterations=its, ls_iterations=ls)
    assert tk.cg_solve.launches == before, "a CPU call must not count a kernel launch"
    return out


@pytest.mark.parametrize("output", OUTS)
def test_plain_matches_jax_kernel_interpret(case, output):
    out = _plain(case)
    assert_close(output, getattr(out, output), case["interp"][output], SOLVE_REL[output])


@pytest.mark.parametrize("output", OUTS)
def test_plain_matches_unfused_jax(case, output):
    out = _plain(case)
    assert_close(output, getattr(out, output), case["unfused"][output], SOLVE_REL[output])
    if output == "efc_force":  # contact-rich: every env has active rows
        assert (np.abs(case["unfused"][output]).max(axis=1) > 0).all()


def test_solve_matches_jax_solve(case):
    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot(), device="cpu")
    data = tm.data_from_numpy(case["data"], device="cpu")
    e = case["efc"]
    t = lambda k: torch.tensor(e[k])
    efc = EfcData(
        aref=t("aref"), D=t("D"), pos=torch.zeros_like(t("aref")),
        active_row=torch.zeros_like(t("aref"), dtype=torch.bool),
        jb_sw=t("jb_sw"), jb_fq=t("jb_fq"), jb_ll=t("jb_ll"), jb_mu=t("jb_mu")[0],
    )
    got = tsolver.solve(plan, model, data, efc)
    for name in OUTS:
        assert_close(name, getattr(got, name), case["solved"][name], SOLVE_REL[name])


def test_wrapper_rejects_bad_arguments(case):
    its, ls = case["plan_iters"]
    good = {k: torch.tensor(v) for k, v in case["inputs"].items()}

    def call(**override):
        return tk.cg_solve(**dict(good, **override), iterations=its, ls_iterations=ls)

    with pytest.raises(TypeError, match="float32"):
        call(aref=good["aref"].double())
    with pytest.raises(ValueError, match="shape"):
        call(D=good["D"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        call(buf=good["buf"].transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="on meta"):
        call(hd=good["hd"].to("meta"))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    its, ls = case["plan_iters"]
    cpu = _plain(case)
    args = {k: torch.tensor(v).cuda() for k, v in case["inputs"].items()}
    before = tk.cg_solve.launches
    gpu = tk.cg_solve(**args, iterations=its, ls_iterations=ls)
    torch.cuda.synchronize()
    assert tk.cg_solve.launches == before + 1
    for name in OUTS:
        assert_close(name, getattr(gpu, name).cpu(), getattr(cpu, name), SOLVE_REL[name])
