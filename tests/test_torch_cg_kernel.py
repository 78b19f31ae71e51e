"""The fused CG solve's CUDA kernel (K2, csrc/cg_solve.cu): its schedule
mirrored in torch on the CPU, and the kernel itself on a CUDA machine.

The kernel keeps qM and its factors in lower-triangle tiles, keeps J compact
(each limit row one dof, each contact its three frame rows, the pyramid rows
formed inside the products) and runs the (L L^T)^-1 applies on one warp.
The CPU tests mirror each of these pieces in float32 torch, sums taken one
term at a time in the kernel's order, and hold them against
`cg_solve_plain`'s pieces: bit for bit where the kernel keeps the dense
arithmetic, else to a stated tolerance; then the whole schedule against
`cg_solve_plain`, on the rodent's dims and on edge dims (n not a multiple
of 4 or 8, a multiple of 4 but not of 8, a single panel, no limit rows, no
contacts, no iterations), and on envs with a non-finite input. Inputs come from the port's own forward stages on the
rodent-full-clips snapshot, with no jax: this file imports none, so that
`python -m pytest --noconftest tests/test_torch_cg_kernel.py -m cuda` runs
the card's tests where jax is not installed (README)."""

import pytest
import torch

from torch_parity import SOLVE_REL, assert_close, contact_rich_states, rel_err
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk

torch.set_num_threads(1)
N_ENVS = 4
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")
THREADS = 128  # csrc/cg_solve.cu's threads per env (kThreads)
PANEL = 8
# Products whose order the kernel keeps, against the plain version's
# matmuls, relative to max(1, max |plain|): float32 roundoff of a 73-term
# sum (measured up to 3e-7 on these states, on an x86 CPU).
PRODUCT_REL = 5e-6
# The kernel against the plain version run in float64, on the card: its
# error must stay within VS_F64 times the float32 plain version's, plus
# F64_FLOOR, per output (chip_smoke.py's rule for the fly, FLY_VS_F64). Two
# float32 solves that differ only in summation order are equally far from
# the exact one; five CG iterations at cond(M) about 6e5 spread them.
VS_F64 = 3.0
F64_FLOOR = 1e-6


def _states(n_envs: int, device: str, seed: int) -> dict:
    """cg_solve's keyword arguments for contact-rich rodent states (feet
    dropped into the floor, joints perturbed, random qvel, ctrl and
    warmstart), from the port's forward stages on `device`."""
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.physics import solver as ts

    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device=device)
    qpos, qvel, ctrl, warm = (
        torch.tensor(a, device=device)
        for a in contact_rich_states(plan.nq, plan.nv, plan.nu, model.qpos0.cpu().numpy(), n_envs, seed)
    )
    d = tm.make_data(plan, model, n_envs).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm)
    d, efc = tf.fwd_position(plan, model, d)
    d = tf.fwd_velocity(plan, model, d)
    d = tf.fwd_actuation(plan, model, d)
    d = tf.fwd_acceleration(plan, model, d)
    return dict(ts.solve_inputs(plan, model, d, efc), its=(plan.iterations, plan.ls_iterations))


def _cut(inputs: dict, n: int | None = None, nl: int | None = None, nc: int | None = None) -> dict:
    """The same states with the first n dofs (dofs come parent first, so
    any prefix holds every ancestor of its dofs and qM's leading block is
    the cut model's; limit rows of cut dofs go), the first nl limit rows and
    the first nc contacts."""
    a = {k: v for k, v in inputs.items() if k != "its"}
    n0, nl0 = a["qfrc_smooth"].shape[1], a["lim1h"].shape[0]
    n = n0 if n is None else n
    keep = torch.nonzero(a["lim1h"][:, :n].sum(1) > 0)[:, 0]
    keep = keep[: len(keep) if nl is None else nl]
    nc = a["fq"].shape[1] if nc is None else nc
    rows = torch.cat([keep, nl0 + torch.arange(4 * nc, device=keep.device)])
    out = dict(
        buf=a["buf"][:, :n], cdof=a["cdof"][:, :n], sw=a["sw"][:, :n], fq=a["fq"][:, :nc],
        ll=a["ll"][:, keep], mu=a["mu"][:, :nc], aref=a["aref"][:, rows], D=a["D"][:, rows],
        qfrc_smooth=a["qfrc_smooth"][:, :n], warm=a["warm"][:, :n], hd=a["hd"][:, :n],
        tolscale=a["tolscale"], anc=a["anc"][:n, :n], arm=a["arm"][:n], dm=a["dm"][:nc, :n],
        lim1h=a["lim1h"][keep][:, :n],
    )
    return {k: v.contiguous() for k, v in out.items()}


@pytest.fixture(scope="module")
def rodent():
    return _states(N_ENVS, "cpu", seed=23)


CASES = {  # name: (_cut arguments, iterations or None for the plan's)
    "rodent": ({}, None),
    "n42": (dict(n=42), None),
    "n13": (dict(n=13), None),
    "n12": (dict(n=12), None),
    "n8": (dict(n=8), None),
    "nl0": (dict(nl=0), None),
    "nc0": (dict(nc=0), None),
    "its0": ({}, 0),
    "its1": ({}, 1),
}


def _case(states, name):
    cut, its = CASES[name]
    plan_its, ls = states["its"]
    return _cut(states, **cut), (plan_its if its is None else its), ls


# ---------------------------------------------------------------------------
# mirrors of the kernel's pieces
# ---------------------------------------------------------------------------


def _tri(c: int) -> int:
    return c * (c + 1) // 2


def _slots(n: int) -> tuple[torch.Tensor, int]:
    """Tiles' (tiled_cholesky.cuh) slot of entry (i, k), tile(i) >= tile(k),
    as an (n, n) index tensor (-1 above the diagonal tiles), and the
    layout's size in floats: row_part(i) + col_part(k)."""
    nt = (n + 3) // 4
    p = 4 * _tri(nt)
    plane = p + ((8 - p) & 31)
    slot = torch.full((n, n), -1, dtype=torch.long)
    for i in range(n):
        for k in range(n):
            if i // 4 >= k // 4:
                slot[i, k] = (i & 3) * plane + 4 * (nt - 1 - i // 4) + 4 * _tri(nt - 1 - k // 4) + (k & 3)
    return slot, 4 * plane


def _to_tiles(a: torch.Tensor) -> torch.Tensor:
    """[B, n, n] -> the tile layout's floats [B, size], as the kernel
    assembles qM: every entry of the lower tiles, diagonal tiles whole."""
    slot, size = _slots(a.shape[-1])
    flat = torch.zeros(a.shape[0], size, dtype=a.dtype)
    lower = slot >= 0
    flat[:, slot[lower]] = a[:, lower]
    return flat


def _read_m(flat: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n, n]: entry (i, j) as m_row reads it, row i's slot where tile(i)
    >= tile(j) (left of the diagonal and the diagonal tile), else (j, i)."""
    slot, _ = _slots(n)
    sym = torch.where(slot >= 0, slot, slot.t())
    return flat[:, sym]


def _seq_matv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(a v)[i] summed one term at a time in increasing j."""
    s = torch.zeros(a.shape[:2], dtype=a.dtype)
    for j in range(a.shape[-1]):
        s = s + a[:, :, j] * v[:, j, None]
    return s


class _CompactJ:
    """The kernel's J: each limit row's dof (its first nonzero) and value
    lim1h ll (NaN if the row has two nonzeros); each contact's frame rows
    jfr; the pyramid row q of contact c is j0 + m jk with (m, k) = (mu0, 1),
    (-mu0, 1), (mu1, 2), (-mu1, 2)."""

    def __init__(self, a: dict):
        lim1h, ll = a["lim1h"], a["ll"]
        nz = lim1h != 0
        self.dof = torch.argmax(nz.int(), dim=1) if lim1h.shape[0] else torch.zeros(0, dtype=torch.long)
        val = lim1h[torch.arange(lim1h.shape[0]), self.dof][None] * ll
        self.lval = torch.where((nz.sum(1) > 1)[None], torch.full_like(val, float("nan")), val)
        jfr = tk._jfr(a["fq"], a["sw"], a["dm"])  # [B, nc, 3, n]
        mu = a["mu"]
        m = torch.stack([mu[..., 0], -mu[..., 0], mu[..., 1], -mu[..., 1]], dim=-1)  # [B, nc, 4]
        jk = torch.stack([jfr[:, :, 1], jfr[:, :, 1], jfr[:, :, 2], jfr[:, :, 2]], dim=2)
        self.rows = jfr[:, :, 0, None] + m[..., None] * jk  # [B, nc, 4, n]
        self.nl, self.nc, self.n = lim1h.shape[0], jfr.shape[1], a["sw"].shape[1]

    def matv(self, x: torch.Tensor) -> torch.Tensor:
        """J x, each row summed one term at a time in increasing d."""
        lim = 0.0 + self.lval * x[:, self.dof]
        s = torch.zeros(self.rows.shape[:3], dtype=x.dtype)
        for d in range(x.shape[1]):
            s = s + self.rows[..., d] * x[:, None, None, d]
        return torch.cat([lim, s.reshape(x.shape[0], -1)], dim=1)

    def matv_t(self, f: torch.Tensor, base: torch.Tensor | None = None) -> torch.Tensor:
        """base - J^T f (or J^T f): each dof's limit rows in row order, then
        the contacts' rows in order."""
        s = torch.zeros(f.shape[0], self.n, dtype=f.dtype)
        for r in range(self.nl):
            d = int(self.dof[r])
            s[:, d] = s[:, d] + self.lval[:, r] * f[:, r]
        for c in range(self.nc):
            for q in range(4):
                s = s + self.rows[:, c, q] * f[:, self.nl + 4 * c + q, None]
        return s if base is None else base - s


def _seq_dinv(l: torch.Tensor) -> torch.Tensor:
    """invert_diag_blocks' arithmetic, one term at a time: lane c solves
    column c of each 8x8 panel by forward substitution."""
    bsz, n, _ = l.shape
    dinv = torch.zeros(bsz, n, PANEL, dtype=l.dtype)
    for p0 in range(0, n, PANEL):
        m = min(PANEL, n - p0)
        for c in range(m):
            x = []
            for r in range(m):
                s = torch.zeros(bsz, dtype=l.dtype)
                for k in range(r):
                    s = s + l[:, p0 + r, p0 + k] * x[k]
                x.append(((1.0 if r == c else 0.0) - s) / l[:, p0 + r, p0 + r])
                dinv[:, p0 + r, c] = x[r]
    return dinv


def _pinv_solve(l: torch.Tensor, dinv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """warp_pinv_solve's arithmetic: L L^T x = b through the panel inverses,
    every sum one term at a time in the kernel's order."""
    n = l.shape[-1]
    out, y = b.clone(), torch.zeros_like(b)
    for p0 in range(0, n, PANEL):
        m = min(PANEL, n - p0)
        for r in range(m):
            s = torch.zeros_like(b[:, 0])
            for c in range(m):
                s = s + dinv[:, p0 + r, c] * out[:, p0 + c]
            y[:, p0 + r] = s
        if p0 + m < n:
            t = torch.zeros_like(out[:, p0 + m :])
            for c in range(m):
                t = t + l[:, p0 + m :, p0 + c] * y[:, p0 + c, None]
            out[:, p0 + m :] = out[:, p0 + m :] - t
    for p0 in reversed(range(0, n, PANEL)):
        m = min(PANEL, n - p0)
        for c in range(m):
            s = torch.zeros_like(b[:, 0])
            for r in range(m):
                s = s + dinv[:, p0 + r, c] * y[:, p0 + r]
            out[:, p0 + c] = s
        if p0 > 0:
            t = torch.zeros_like(y[:, :p0])
            for r in range(m):
                t = t + l[:, p0 + r, None, :p0][:, 0] * out[:, p0 + r, None]
            y[:, :p0] = y[:, :p0] - t
    return out


def _kernel_mirror(a: dict, iterations: int, ls_iterations: int) -> tk.CGOut:
    """cg_solve.cu's schedule in torch: M v from the tile layout, the
    compact J and J^T products, the panel-inverse applies, the warm-start
    choice and the CG iterations with their linesearch as the kernel orders
    them. Dot products over dofs and rows are torch sums: the kernel's
    reduction order is not mirrored (tools/compare_torch_kernels.py holds
    the kernel's outputs against its first design's bit for bit, on the
    card)."""
    n = a["qfrc_smooth"].shape[1]
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    mm = _read_m(_to_tiles(qm), n)
    l = bl.factor(qm)
    dinv = _seq_dinv(l)
    j = _CompactJ(a)
    D, aref = a["D"], a["aref"]

    def solve(b):
        return _pinv_solve(l, dinv, b)

    def force_of(jar):
        return torch.where(jar < 0, -D * jar, torch.zeros_like(jar))

    smooth = solve(a["qfrc_smooth"])
    x = a["warm"]
    jar = j.matv(x) - aref
    mdx = _seq_matv(mm, x - smooth)
    jar_sm = j.matv(smooth) - aref
    s0 = ((x - smooth) * mdx).sum(1)
    s1 = torch.where(jar < 0, D * jar * jar, torch.zeros_like(jar)).sum(1)
    s2 = torch.where(jar_sm < 0, D * jar_sm * jar_sm, torch.zeros_like(jar)).sum(1)
    take = (0.5 * s0 + 0.5 * s1 < 0.5 * s2)[:, None]
    x = torch.where(take, x, smooth)
    mdx = torch.where(take, mdx, torch.zeros_like(mdx))
    jar = torch.where(take, jar, jar_sm)
    f = force_of(jar)
    grad = j.matv_t(f, mdx)
    mgrad = solve(grad)
    p = -mgrad
    imp = torch.ones_like(a["tolscale"])
    for _ in range(iterations):
        mp = _seq_matv(mm, p)
        jp = j.matv(p)
        pmp, dmx = (p * mp).sum(1), (mp * (x - smooth)).sum(1)
        alpha = torch.zeros_like(pmp)
        for _ in range(ls_iterations + 1):
            jr = jar + alpha[:, None] * jp
            act = jr < 0
            zero = torch.zeros_like(jr)
            d1 = alpha * pmp + dmx + torch.where(act, D * jr * jp, zero).sum(1)
            d2 = torch.clamp(pmp + torch.where(act, D * jp * jp, zero).sum(1), min=tk._EPS)
            alpha = alpha - d1 / d2
        alpha = alpha * imp
        x = x + alpha[:, None] * p
        mdx = mdx + alpha[:, None] * mp
        jar = jar + alpha[:, None] * jp
        f = force_of(jar)
        v0 = j.matv_t(f, mdx)
        v1 = solve(v0)
        beta = torch.clamp(
            (v0 * (v1 - mgrad)).sum(1) / torch.clamp((grad * mgrad).sum(1), min=tk._EPS), min=0.0
        )
        p = -v1 + beta[:, None] * p
        imp = imp * (torch.sqrt((v0 * v0).sum(1)) > a["tolscale"]).to(imp.dtype)
        grad, mgrad = v0, v1
    qfrc = j.matv_t(f)
    l2 = bl.factor(qm + torch.diag_embed(a["hd"]))
    eff = _pinv_solve(l2, _seq_dinv(l2), a["qfrc_smooth"] + qfrc)
    return tk.CGOut(smooth, x, f, qfrc, eff)


# ---------------------------------------------------------------------------
# CPU: the pieces, bit for bit or to a tolerance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", (73, 42, 13, 8, 5, 1))
def test_tile_slots_are_distinct_and_in_range(n):
    """Every entry of the lower tiles (the diagonal tiles whole) has its own
    slot inside the layout."""
    slot, size = _slots(n)
    used = slot[slot >= 0]
    assert len(used) == len(set(used.tolist()))
    assert int(used.min()) >= 0 and int(used.max()) < size
    assert len(used) == sum(1 for i in range(n) for k in range(n) if i // 4 >= k // 4)


@pytest.mark.parametrize("name", ("rodent", "n42", "n13", "n12", "n8"))
def test_matv_m_from_tiles_equals_row_major_read(rodent, name):
    """M v from the tiles (M(max(i, j), min(i, j)), increasing j) equals the
    dense row-major read term for term: qM is mirrored exactly, so the
    values and their order are the same; against the plain matmul to
    roundoff."""
    a, _, _ = _case(rodent, name)
    n = a["qfrc_smooth"].shape[1]
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    assert torch.equal(qm, qm.transpose(1, 2))
    v = a["warm"]
    got = _seq_matv(_read_m(_to_tiles(qm), n), v)
    assert torch.equal(got, _seq_matv(qm, v))
    assert_close("M v", got, (qm @ v[..., None])[..., 0], PRODUCT_REL)


@pytest.mark.parametrize("name", ("rodent", "n42", "nl0", "nc0"))
def test_compact_j_equals_dense_j(rodent, name):
    """The compact J's rows equal build_j's dense rows value for value, and
    J x summed over them equals the dense row sums bit for bit (a limit
    row's zeros add exactly nothing)."""
    a, _, _ = _case(rodent, name)
    j = _CompactJ(a)
    dense = tk.build_j(a["fq"], a["sw"], a["ll"], a["mu"], a["dm"], a["lim1h"])
    x = a["warm"]
    got = j.matv(x)
    assert torch.equal(got, _seq_matv(dense, x))
    assert_close("J x", got, (dense @ x[..., None])[..., 0], PRODUCT_REL)


@pytest.mark.parametrize("name", ("rodent", "n42", "nl0", "nc0"))
def test_compact_jt_equals_dense_jt(rodent, name):
    """J^T f over the compact J equals the dense column sums in row order
    bit for bit (the limit rows at other dofs add exact zeros), and the
    plain matmul to roundoff."""
    a, _, _ = _case(rodent, name)
    j = _CompactJ(a)
    dense = tk.build_j(a["fq"], a["sw"], a["ll"], a["mu"], a["dm"], a["lim1h"])
    jar = j.matv(a["warm"]) - a["aref"]
    f = torch.where(jar < 0, -a["D"] * jar, torch.zeros_like(jar))  # the forces of the warm start
    base = a["warm"]
    got = j.matv_t(f, base)
    assert torch.equal(got, base - _seq_matv(dense.transpose(1, 2), f))
    scale = max(1.0, float(f.abs().max())) if f.numel() else 1.0
    assert_close("J^T f", got, base - (f[:, None, :] @ dense)[:, 0], PRODUCT_REL * scale)


@pytest.mark.parametrize("name", ("rodent", "n42", "n13", "n12", "n8"))
def test_panel_inverse_solve_matches_plain(rodent, name):
    """The warp's panel-inverse apply, sums one term at a time, against
    blocked_substitution_pinv on the same factor (torch's sums there); its
    panel inverses equal invert_diag_blocks' to roundoff."""
    a, _, _ = _case(rodent, name)
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    l = bl.factor(qm)
    dinv = _seq_dinv(l)
    assert_close("dinv", dinv, bl.invert_diag_blocks(l), PRODUCT_REL)
    b = a["qfrc_smooth"]
    got = _pinv_solve(l, dinv, b)
    assert_close("panel solve", got, bl.blocked_substitution_pinv(l, bl.invert_diag_blocks(l), b), SOLVE_REL["qacc_smooth"])


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_schedule_matches_plain(rodent, name):
    """The kernel's whole schedule against cg_solve_plain at the kernel
    parity bars (tests/test_cg_kernel_parity.py)."""
    a, its, ls = _case(rodent, name)
    got = _kernel_mirror(a, its, ls)
    want = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls)
    for out in OUTS:
        assert_close(out, getattr(got, out), getattr(want, out), SOLVE_REL[out])


def _poisoned(a: dict) -> dict:
    """The envs with a non-finite input each: env 0 qfrc_smooth (NaN), env
    1 one entry of warm (inf), env 2 one limit row's D (NaN), env 3 one dof
    of sw (NaN); the rest as given."""
    a = {k: v.clone() for k, v in a.items()}
    a["qfrc_smooth"][0, 3] = float("nan")
    a["warm"][1, 5] = float("inf")
    a["D"][2, 0] = float("nan")
    a["sw"][3, 7, 2] = float("nan")
    return a


def _nonfinite_envs(out: tk.CGOut) -> dict:
    return {name: (~torch.isfinite(getattr(out, name))).any(1).cpu() for name in OUTS}


@pytest.mark.parametrize("its", (0, 5))
def test_nonfinite_env_stays_nonfinite(rodent, its):
    """With compact rows a NaN reaches fewer products than through the
    dense J, but every output of an env is non-finite in the kernel's
    schedule exactly where the plain version's is; the other envs are
    finite."""
    a, _, ls = _case(rodent, "rodent")
    a = _poisoned(a)
    got = _nonfinite_envs(_kernel_mirror(a, its, ls))
    want = _nonfinite_envs(tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls))
    assert want["qacc_eff"].any()
    for name in OUTS:
        assert torch.equal(got[name], want[name]), name


def test_wrapper_raises_above_the_tiled_range():
    """The kernel's tiled factor takes n <= MAX_N; the check comes before
    the library is built or loaded, for any device."""
    n = bl.MAX_N + 1
    args = [torch.zeros(s) for s in ((1, n, 6), (1, n, 6), (1, 0, 3, 6), (1, n, 6), (1, 0), (1, 0, 2),
                                     (1, 0), (1, 0), (1, n), (1, n), (1, n), (1,), (n, n), (n,), (0, n), (0, n))]
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        tk._launch("cg_solve", args, 1, (n, 0, 0), 0, 5, 5)


# ---------------------------------------------------------------------------
# the card: the kernel against plain
# ---------------------------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def card_states():
    """The 4096 contact-rich rodent states chip_smoke.py holds the kernel to
    (its generator, seed 0)."""
    _needs_cuda()
    import chip_smoke
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm

    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device="cuda")
    a = chip_smoke.Phases("", device="cuda").rodent_states(plan, model)
    return dict(a, its=(plan.iterations, plan.ls_iterations))


def _against_plain(a: dict, its: int, ls: int, what: str) -> tk.CGOut:
    before = tk.cg_solve.launches
    got = tk.cg_solve(**a, iterations=its, ls_iterations=ls)
    torch.cuda.synchronize()
    assert tk.cg_solve.launches == before + 1
    want = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls)
    errs = {out: rel_err(getattr(got, out).cpu(), getattr(want, out).cpu()) for out in OUTS}
    print(f"cg_solve vs plain, {what}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for out in OUTS:
        assert errs[out] < SOLVE_REL[out], f"{out}: rel err {errs[out]:.3e} >= {SOLVE_REL[out]:.1e}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", (4096, 4095))
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain(card_states, name, bsz):
    """The kernel against its plain version on the card, on 4096
    contact-rich rodent states and a ragged 4095, at the rodent's dims and
    the edge dims."""
    a, its, ls = _case(card_states, name)
    a = {k: (v[:bsz].contiguous() if v.dim() and v.shape[0] == 4096 else v) for k, v in a.items()}
    got = _against_plain(a, its, ls, f"{name}, {bsz} envs")
    for out in OUTS:
        assert torch.isfinite(getattr(got, out)).all(), out


@pytest.mark.cuda
def test_cuda_nonfinite_env_stays_nonfinite(card_states):
    _needs_cuda()
    a, its, ls = _case(card_states, "rodent")
    a = _poisoned(a)
    got = _nonfinite_envs(tk.cg_solve(**a, iterations=its, ls_iterations=ls))
    want = _nonfinite_envs(tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls))
    for name in OUTS:
        assert torch.equal(got[name], want[name]), name
        assert not got[name][4:].any(), name


@pytest.mark.cuda
def test_cuda_raises_above_the_tiled_range():
    _needs_cuda()
    n = bl.MAX_N + 1
    a = {k: torch.zeros(s, device="cuda") for k, s in dict(
        buf=(1, n, 6), cdof=(1, n, 6), fq=(1, 0, 3, 6), sw=(1, n, 6), ll=(1, 0), mu=(1, 0, 2),
        aref=(1, 0), D=(1, 0), qfrc_smooth=(1, n), warm=(1, n), hd=(1, n), tolscale=(1,),
        anc=(n, n), arm=(n,), dm=(0, n), lim1h=(0, n)).items()}
    before = tk.cg_solve.launches
    with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
        tk.cg_solve(**a, iterations=5, ls_iterations=5)
    assert tk.cg_solve.launches == before


@pytest.mark.cuda
def test_cuda_kernel_info():
    """Registers, shared memory, CTAs per SM and threads of the kernel as
    built, at the rodent's sizes."""
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.cg_solve_kernel_info(73, 67, 30, info) == 0
    assert info[0] > 0 and info[1] == lib.cg_solve_smem_bytes(73, 67, 30) and info[2] >= 1
    assert info[3] == THREADS
    assert lib.cg_solve_kernel_info(bl.MAX_N + 1, 0, 0, info) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (0, 29))
def test_cuda_kernel_as_close_to_float64_as_plain(card_states, seed):
    """On 4096 contact-rich rodent states (seed 0: chip_smoke.py's; seed 29:
    contact_rich_states', where the kernel and its first design alike read
    qacc_eff about 6e-4 against the float32 plain version, over its 5e-4
    bar): per output, the kernel is as close to the plain version run in
    float64 as the float32 plain version is, within VS_F64 and F64_FLOOR."""
    if seed == 0:
        a = dict(card_states)
    else:
        a = _states(4096, "cuda", seed)
    its, ls = a.pop("its")
    got = tk.cg_solve(**a, iterations=its, ls_iterations=ls)
    plain = tk.cg_solve_plain(**a, iterations=its, ls_iterations=ls)
    exact = tk.cg_solve_plain(**{k: v.double() for k, v in a.items()}, iterations=its, ls_iterations=ls)
    for out in OUTS:
        want = getattr(exact, out).cpu()
        e_kernel = rel_err(getattr(got, out).cpu(), want)
        e_plain = rel_err(getattr(plain, out).cpu(), want)
        print(f"seed {seed}, {out} against float64: kernel {e_kernel:.3e}, float32 plain {e_plain:.3e}")
        assert e_kernel <= VS_F64 * e_plain + F64_FLOOR, f"{out}: {e_kernel:.3e} > {VS_F64} x {e_plain:.3e}"
