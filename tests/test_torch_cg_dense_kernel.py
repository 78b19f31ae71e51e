"""The fused CG solve's dense-J mode (K2's `cg_solve_dense`, csrc/cg_solve.cu
built with kDense) and its no-Euler mode: the wrapper and the plain version
on the CPU, the kernel against its plain version on a CUDA machine. The
plain version is K2's schedule over a given J, as the compact plain version
is; tests/test_torch_condim.py holds it to the JAX package's dense-J TPU
kernel and to the reference's unfused CG. The kernel walks J in panels
(csrc/j_panels.cuh); `PanelJ` mirrors the walks in torch, held bit for bit
against the same sums over the whole J and, inside the plain solve, within
SOLVE_REL of it (tests/test_torch_ell_kernel.py does the same for K3's
panels of whole cone blocks). Inputs come from the port's own
forward stages on the rodent-full-clips snapshot, and on the same rodent
with mixed condims (chip_smoke.mixed_condim), with no jax: this file
imports none, so that `python -m pytest --noconftest
tests/test_torch_cg_dense_kernel.py -m cuda` runs the card's tests where
jax is not installed (README)."""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_cg_kernel import _seq_matv
from torch_parity import SOLVE_REL, assert_close, contact_rich_states, rel_err
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
# Products whose order the kernel keeps, against the plain version's
# matmuls, relative to max(1, max |plain|) (tests/test_torch_ell_kernel.py's
# bar, at sums of up to 73 terms here)
PRODUCT_REL = 5e-6


class PanelJ:
    """A dense J [B, e, n] walked as the dense kernels walk it (csrc/
    j_panels.cuh, panels of `tk.j_panels(op, n, e, ns)`): J x panel by
    panel, each row summed one term at a time in increasing d; J^T f
    column by column over the panels' rows in order, the partial sums
    carried from panel to panel. Under `@` it stands in for J in the plain
    versions (`j @ x[..., None]`, `f[:, None, :] @ j`)."""

    def __init__(self, op: str | None, j: torch.Tensor, ns: int | None = None):
        """op None: J whole, one panel (the same sums over the whole J)."""
        self.j, self.shape = j, j.shape
        cuts = (0, j.shape[1]) if op is None else tk.j_panels(op, j.shape[2], j.shape[1], ns).cuts
        self.spans = list(zip(cuts[:-1], cuts[1:]))

    def matv(self, x: torch.Tensor) -> torch.Tensor:
        parts = []
        for r0, r1 in self.spans:
            s = torch.zeros(x.shape[0], r1 - r0, dtype=x.dtype)
            for d in range(self.shape[2]):
                s = s + self.j[:, r0:r1, d] * x[:, d, None]
            parts.append(s)
        return torch.cat(parts, dim=1)

    def matv_t(self, f: torch.Tensor) -> torch.Tensor:
        s = torch.zeros(f.shape[0], self.shape[2], dtype=f.dtype)
        for r0, r1 in self.spans:
            for r in range(r0, r1):
                s = s + self.j[:, r] * f[:, r, None]
        return s

    def __matmul__(self, x):
        return self.matv(x[..., 0])[..., None]

    def __rmatmul__(self, f):
        return self.matv_t(f[:, 0])[:, None]


def assert_panels_cut(p: tk.JPanels, e: int, ns: int, n: int, ring_floats: int):
    """Panels cover rows 0 .. e - 1 in order, at most p.rows each (a
    multiple of 3 where there are cone blocks), no boundary inside a cone
    block; J is copied once where it fits the slots, and the ring within its
    floats."""
    cuts = p.cuts
    assert cuts[0] == 0 and cuts[-1] == e and len(cuts) - 1 == -(-e // p.rows)
    assert all(0 < b - a <= p.rows for a, b in zip(cuts[:-1], cuts[1:])), cuts
    assert all(c <= ns or (c - ns) % 3 == 0 for c in cuts), cuts
    if ns < e:
        assert p.rows % 3 == 0
    assert p.resident == (len(cuts) - 1 <= tk.J_SLOTS)
    assert tk.J_SLOTS * (p.rows * n + 4) <= ring_floats or p.rows == (3 if ns < e else 1)


def assert_walks_equal_whole_j(op: str, j: torch.Tensor, x: torch.Tensor, f: torch.Tensor, ns: int | None = None):
    """The panel walks against the same sums over the whole J, one term at a
    time (bit for bit), and against the plain matmuls (PRODUCT_REL)."""
    walk = PanelJ(op, j, ns)
    got, got_t = walk.matv(x), walk.matv_t(f)
    assert torch.equal(got, _seq_matv(j, x))
    assert torch.equal(got_t, _seq_matv(j.transpose(1, 2), f))
    assert_close("J x", got, (j @ x[..., None])[..., 0], PRODUCT_REL * max(1.0, float(x.abs().max())))
    assert_close("J^T f", got_t, (f[:, None, :] @ j)[:, 0], PRODUCT_REL * max(1.0, float(f.abs().max())))
    return walk


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


# (n, e): the mixed-condim rodent's 228 rows, the default rodent's 187 (not a
# multiple of the panel), fewer rows than one panel, J copied once in 2
# panels, one row more, and the widest n
PANEL_SIZES = ((73, 228), (73, 187), (73, 20), (73, 140), (73, 141), (128, 300))


@pytest.mark.parametrize("n, e", PANEL_SIZES)
def test_panels_cut_the_rows(n, e):
    p = tk.j_panels("cg_solve_dense", n, e)
    assert_panels_cut(p, e, e, n, tk.J_RING_FLOATS["cg_solve_dense"])
    if n == 73:
        assert p.rows == 70 and p.resident == (e <= 140)


@pytest.mark.parametrize("n, e", PANEL_SIZES)
def test_panel_walks_equal_whole_j_sums(n, e):
    rng = np.random.RandomState(n + e)
    j, x, f = (torch.tensor(rng.normal(size=s).astype(np.float32)) for s in ((2, e, n), (2, n), (2, e)))
    assert_walks_equal_whole_j("cg_solve_dense", j, x, f)


@pytest.mark.parametrize("rows", (None, 20, 141))
def test_panel_walks_in_the_plain_solve(cpu_states, rows):
    """The plain solve with J's products taken as the kernel's walks take
    them: bit for bit the solve with the same sums over the whole J, and
    within SOLVE_REL of the plain version; on the default rodent's 187 rows
    (3 panels), and its first 20 (one panel) and 141 (3 panels, the last of
    one row)."""
    _, dense, its, ls = cpu_states
    if rows is not None:
        dense = dict(dense, **{k: dense[k][:, :rows].contiguous() for k in ("J", "aref", "D")})
    want = tk.cg_solve_dense_plain(**dense, iterations=its, ls_iterations=ls, with_euler=True)
    qm = tk.assemble_qm(dense["buf"], dense["cdof"], dense["anc"], dense["arm"])
    got, whole = (tk._pyramidal_plain(qm, PanelJ(op, dense["J"]), dense["aref"], dense["D"], dense["qfrc_smooth"],
                                      dense["warm"], dense["hd"], dense["tolscale"], its, ls, True)
                  for op in ("cg_solve_dense", None))
    for name in OUTS:
        assert torch.equal(getattr(got, name), getattr(whole, name)), name
        assert_close(name, getattr(got, name), getattr(want, name), SOLVE_REL[name])


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
    """J is walked in panels, but each row's vectors live in shared memory:
    6,000 rows at n = 128 need more than a CTA has (5,700 fit), and the
    wrapper raises before it launches."""
    _needs_cuda()
    n, e = bl.MAX_N, 6000
    args = dict(buf=(1, n, 6), cdof=(1, n, 6), J=(1, e, n), aref=(1, e), D=(1, e), qfrc_smooth=(1, n),
                warm=(1, n), hd=(1, n), tolscale=(1,), anc=(n, n), arm=(n,))
    before = tk.cg_solve_dense.launches
    with pytest.raises(ValueError, match="shared memory"):
        tk.cg_solve_dense(**{k: torch.zeros(s, device="cuda") for k, s in args.items()},
                          iterations=5, ls_iterations=5, with_euler=True)
    assert tk.cg_solve_dense.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n, e", PANEL_SIZES)
def test_cuda_dense_panels_match_the_mirror(n, e):
    """The kernel's panels (cg_solve_dense_panels) are `tk.j_panels`'."""
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    out = (ctypes.c_int * 3)()
    assert kernel_lib.load_library().cg_solve_dense_panels(n, e, out) == 0
    p = tk.j_panels("cg_solve_dense", n, e)
    assert (out[0], out[1], bool(out[2])) == (p.rows, len(p.cuts) - 1, p.resident)


@pytest.mark.cuda
def test_cuda_dense_kernel_info():
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.cg_solve_dense_kernel_info(73, 228, info) == 0
    assert info[0] > 0 and info[1] == lib.cg_solve_dense_smem_bytes(73, 228) and info[2] >= 3
    assert info[0] <= 168 and info[3] == 128
    assert lib.cg_solve_dense_kernel_info(bl.MAX_N + 1, 10, info) != 0
