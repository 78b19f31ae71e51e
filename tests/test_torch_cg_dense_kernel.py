"""The fused CG solve's dense-J mode (K2's `cg_solve_dense`, csrc/cg_solve.cu
built with kDense) and its no-Euler mode: the wrapper and the plain version
on the CPU, the kernel against its plain version on a CUDA machine. The
plain version is K2's schedule over a given J, as the compact plain version
is; tests/test_torch_condim.py holds it to the JAX package's dense-J TPU
kernel and to the reference's unfused CG. Inputs come from the port's own
forward stages on the rodent-full-clips snapshot, and on the same rodent
with mixed condims (chip_smoke.mixed_condim), with no jax: this file
imports none, so that `python -m pytest --noconftest
tests/test_torch_cg_dense_kernel.py -m cuda` runs the card's tests where
jax is not installed (README)."""

import pytest
import torch

import chip_smoke
from torch_parity import SOLVE_REL, contact_rich_states, rel_err
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk

torch.set_num_threads(1)
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")
# On the card: over 4096 contact-rich states two float32 CG solves that
# differ in summation order part by more than SOLVE_REL on some draws
# (tests/test_torch_cg_kernel.py, ROADMAP Queue 3), so on such draws the
# kernel's distance to its plain version run in float64 must stay within
# VS_F64 times the float32 plain version's, plus F64_FLOOR (that file's
# rule): over the batch, and per env (relative to max(1, max |float64|) of
# the env) on the worst and on the median env. On phase 2's states of
# chip_smoke.py, where the compact kernel holds SOLVE_REL, the no-Euler
# compact kernel is held to SOLVE_REL as well.
VS_F64 = 3.0
F64_FLOOR = 1e-6


def _rodent(device: str, n_envs: int, seed: int, mixed: bool):
    """(compact inputs or None, dense inputs, iterations, ls_iterations) of
    contact-rich rodent states from the port's forward stages; the dense J
    of the default rodent is built from its compact operands."""
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.physics import solver as ts

    tf.set_full_f32()
    snap = tm.load_snapshot("rodent-full-clips")
    if mixed:
        snap = chip_smoke.mixed_condim(snap)
    plan, model = tm.put_model(snap, device=device)
    qpos, qvel, ctrl, warm = (
        torch.tensor(a, device=device)
        for a in contact_rich_states(plan.nq, plan.nv, plan.nu, snap.qpos0, n_envs, seed)
    )
    d = tm.make_data(plan, model, n_envs).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    d, efc = tf.fwd_position(plan, model, d)
    d = tf.fwd_velocity(plan, model, d)
    d = tf.fwd_actuation(plan, model, d)
    d = tf.fwd_acceleration(plan, model, d)
    its = (plan.iterations, plan.ls_iterations)
    if mixed:
        return None, ts.dense_solve_inputs(plan, model, d, efc), *its
    a = ts.solve_inputs(plan, model, d, efc)
    j = tk.build_j(a["fq"], a["sw"], a["ll"], a["mu"], a["dm"], a["lim1h"]).contiguous()
    dense = {k: a[k] for k in tk._DENSE_ARG_NAMES if k != "J"}
    return a, dict(dense, J=j), *its


@pytest.fixture(scope="module")
def cpu_states():
    return _rodent("cpu", 4, 29, mixed=False)


# ---------------------------------------------------------------------------
# the CPU: wrapper and plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_euler", (True, False))
def test_dense_plain_matches_compact_plain(cpu_states, with_euler):
    """On the default rodent's rows, given the J that the compact plain
    version builds, the dense-J plain version is the compact one bit for
    bit: both are K2's schedule."""
    a, dense, its, ls = cpu_states
    got = tk.cg_solve_dense_plain(**dense, iterations=its, ls_iterations=ls, with_euler=with_euler)
    want = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls, with_euler=with_euler)
    for name in OUTS:
        if name == "qacc_eff" and not with_euler:
            assert got.qacc_eff is None and want.qacc_eff is None
            continue
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_without_euler_the_rest_is_unchanged(cpu_states):
    """with_euler only adds the (M + diag(hd)) solve: the other outputs are
    bitwise those of the run without it, in both modes."""
    a, dense, its, ls = cpu_states
    for op, args in ((tk.cg_solve, a), (tk.cg_solve_dense, dense)):
        full = op(**args, iterations=its, ls_iterations=ls, with_euler=True)
        bare = op(**args, iterations=its, ls_iterations=ls, with_euler=False)
        assert bare.qacc_eff is None and full.qacc_eff is not None
        for name in OUTS[:4]:
            assert torch.equal(getattr(full, name), getattr(bare, name)), name


def test_cpu_wrapper_runs_the_plain_version(cpu_states):
    _, dense, its, ls = cpu_states
    before = tk.cg_solve_dense.launches
    got = tk.cg_solve_dense(**dense, iterations=its, ls_iterations=ls, with_euler=True)
    want = tk.cg_solve_dense_plain(**dense, iterations=its, ls_iterations=ls, with_euler=True)
    for name in OUTS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert tk.cg_solve_dense.launches == before  # counts kernel launches only


@pytest.mark.parametrize("bad", ("J_rows", "J_cols", "dtype", "device_mix", "noncontiguous"))
def test_wrapper_checks_its_arguments(cpu_states, bad):
    _, dense, its, ls = cpu_states
    args = dict(dense)
    if bad == "J_rows":
        args["J"] = args["J"][:, 1:].contiguous()
    elif bad == "J_cols":
        args["J"] = args["J"][:, :, 1:].contiguous()
    elif bad == "dtype":
        args["aref"] = args["aref"].double()
    elif bad == "device_mix":
        args["arm"] = args["arm"].to("meta")
    else:
        args["J"] = args["J"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tk.cg_solve_dense(**args, iterations=its, ls_iterations=ls, with_euler=True)


def test_wrapper_raises_above_the_tiled_range():
    """The kernel's tiled factor takes n <= MAX_N; the check comes before
    the library is built or loaded."""
    n = bl.MAX_N + 1
    args = [torch.zeros(s) for s in ((1, n, 6), (1, n, 6), (1, 4, n), (1, 4), (1, 4), (1, n), (1, n),
                                     (1, n), (1,), (n, n), (n,))]
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        tk._launch("cg_solve_dense", args, 1, (n, 4), 4, 5, 5, True)


# ---------------------------------------------------------------------------
# the card: the kernel against plain
# ---------------------------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def card_states():
    _needs_cuda()
    return {"default": _rodent("cuda", 4096, 0, mixed=False), "mixed": _rodent("cuda", 4096, 0, mixed=True)}


def _per_env(got, want):
    return (got - want).abs().amax(1) / want.abs().amax(1).clamp(min=1.0)


def _as_close_to_float64_as_plain(op, plain, args, its, ls, with_euler, what):
    got = op(**args, iterations=its, ls_iterations=ls, with_euler=with_euler)
    torch.cuda.synchronize()
    want = plain(**args, iterations=its, ls_iterations=ls, with_euler=with_euler)
    exact = plain(**{k: v.double() for k, v in args.items()}, iterations=its, ls_iterations=ls,
                  with_euler=with_euler)
    for name in OUTS:
        if name == "qacc_eff" and not with_euler:
            assert got.qacc_eff is None
            continue
        assert torch.isfinite(getattr(got, name)).all(), name
        ref = getattr(exact, name).cpu()
        e_kernel = rel_err(getattr(got, name).cpu(), ref)
        e_plain = rel_err(getattr(want, name).cpu(), ref)
        env_kernel = _per_env(getattr(got, name).cpu().double(), ref)
        env_plain = _per_env(getattr(want, name).cpu().double(), ref)
        print(f"{what}, {name} against float64: kernel {e_kernel:.3e}, float32 plain {e_plain:.3e}, kernel "
              f"against float32 plain {rel_err(getattr(got, name).cpu(), getattr(want, name).cpu()):.3e}; per env, "
              f"kernel / float32 plain: worst {float(env_kernel.max()):.3e} / {float(env_plain.max()):.3e}, "
              f"median {float(env_kernel.median()):.3e} / {float(env_plain.median()):.3e}")
        assert e_kernel <= VS_F64 * e_plain + F64_FLOOR, f"{name}: {e_kernel:.3e} > {VS_F64} x {e_plain:.3e}"
        for stat in (torch.amax, torch.median):
            k, p = float(stat(env_kernel)), float(stat(env_plain))
            assert k <= VS_F64 * p + F64_FLOOR, f"{name}, {stat.__name__} env: {k:.3e} > {VS_F64} x {p:.3e}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("with_euler", (True, False))
@pytest.mark.parametrize("which", ("default", "mixed"))
def test_cuda_dense_kernel_matches_plain(card_states, which, with_euler):
    """cg_solve_dense against its plain version on 4096 contact-rich states
    of the rodent (J built from the compact operands: 187 rows) and of the
    rodent with mixed condims (228 rows), with and without the Euler solve,
    by the float64 rule."""
    _, dense, its, ls = card_states[which]
    before = tk.cg_solve_dense.launches
    _as_close_to_float64_as_plain(tk.cg_solve_dense, tk.cg_solve_dense_plain, dense, its, ls, with_euler,
                                  f"cg_solve_dense, {which}")
    assert tk.cg_solve_dense.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("states", ("default", "phase 2"))
def test_cuda_compact_kernel_without_euler(card_states, states):
    """The compact cg_solve with with_euler=False: its four outputs are those
    of its run with the Euler solve, bit for bit, and held to its plain
    version by the float64 rule; on chip_smoke.py's phase 2 states also
    within SOLVE_REL."""
    if states == "phase 2":
        from track_mjx_tpu_torch.physics import model as tm

        plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device="cuda")
        a = chip_smoke.Phases("", device="cuda").rodent_states(plan, model)
        its, ls = plan.iterations, plan.ls_iterations
    else:
        a, _, its, ls = card_states["default"]
    full = tk.cg_solve(**a, iterations=its, ls_iterations=ls, with_euler=True)
    bare = _as_close_to_float64_as_plain(tk.cg_solve, tk.cg_solve_plain, a, its, ls, False, "cg_solve")
    for name in OUTS[:4]:
        assert torch.equal(getattr(full, name), getattr(bare, name)), name
    if states == "phase 2":
        want = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls, with_euler=False)
        for name in OUTS[:4]:
            err = rel_err(getattr(bare, name).cpu(), getattr(want, name).cpu())
            assert err < SOLVE_REL[name], f"{name}: rel err {err:.3e} >= {SOLVE_REL[name]:.1e}"


@pytest.mark.cuda
def test_cuda_refuses_a_model_over_the_shared_memory():
    """J lives in shared memory: 600 rows at n = 128 need more than a CTA
    has, and the wrapper raises before it launches."""
    _needs_cuda()
    n, e = bl.MAX_N, 600
    args = dict(buf=(1, n, 6), cdof=(1, n, 6), J=(1, e, n), aref=(1, e), D=(1, e), qfrc_smooth=(1, n),
                warm=(1, n), hd=(1, n), tolscale=(1,), anc=(n, n), arm=(n,))
    before = tk.cg_solve_dense.launches
    with pytest.raises(ValueError, match="shared memory"):
        tk.cg_solve_dense(**{k: torch.zeros(s, device="cuda") for k, s in args.items()},
                          iterations=5, ls_iterations=5, with_euler=True)
    assert tk.cg_solve_dense.launches == before


@pytest.mark.cuda
def test_cuda_dense_kernel_info():
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.cg_solve_dense_kernel_info(73, 228, info) == 0
    assert info[0] > 0 and info[1] == lib.cg_solve_dense_smem_bytes(73, 228) and info[2] >= 1
    assert info[3] == 128
    assert lib.cg_solve_dense_kernel_info(bl.MAX_N + 1, 10, info) != 0
