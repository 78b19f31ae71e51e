"""The one-warp exact substitution (csrc/tiled_cholesky.cuh's
warp_exact_solve), the elliptic CG solve's CUDA kernel (K3,
csrc/ell_cg_solve.cu) and the standalone cho_solve kernel (K4b,
csrc/batched_linalg.cu), on the CPU through mirrors of their schedules in
torch and on a CUDA machine through the kernels themselves.

The substitution reads its factor from the lower-triangle tiles, solves each
8-row panel's chain on every lane alike and gives the rows below or above
the panel one lane each; its mirror takes the same float32 operations in
the same order, one term at a time, reading the factor through the tile
layout's slots, and is held bit for bit at every n from 1 to 128 against
`_seq_blocked_substitution`, the plain `blocked_substitution` with every sum
taken one term at a time in the device routine's order (the plain version
itself sums vectorized, and is held to it at cho_solve's roundoff bar).
K3's compact J (each limit
row its dof, each contact its three frame rows, J^T through a per-dof list
of limit rows) is held bit for bit against the dense J's sums at the fly's
sizes and with no contacts. The dense-J mode's walks over J in panels of
whole cone blocks (csrc/j_panels.cuh) are mirrored by
tests/test_torch_cg_dense_kernel.py's PanelJ: held bit for bit against the
same sums over the whole J, and inside the plain solve within SOLVE_REL of
it. Inputs come from the port's own forward stages
on the fly-mc-intention snapshot. This file imports no jax, so that
`python -m pytest --noconftest tests/test_torch_ell_kernel.py -m cuda` runs
the card's tests where jax is not installed (README)."""

import numpy as np
import pytest
import torch

from test_torch_cg_dense_kernel import PanelJ, assert_panels_cut, assert_walks_equal_whole_j
from test_torch_cg_kernel import _seq_matv, _slots, _tri
from torch_parity import SOLVE_REL, assert_close, rel_err
from track_mjx_tpu_torch.ops import batched_linalg as bl
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk

torch.set_num_threads(1)
N_ENVS = 4
PANEL = 8
LANES = 32
OUTS = ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint", "qacc_eff")
# Products whose order the kernel keeps, against the plain version's
# matmuls, relative to max(1, max |plain|): float32 roundoff of a 42-term
# sum (tests/test_torch_cg_kernel.py's bar).
PRODUCT_REL = 5e-6
# The plain substitution's vectorized sums against the same sums one term
# at a time (tests/test_torch_linalg.py's cho_solve bar).
SUBSTITUTION_REL = 2e-6


def _spd(bsz: int, n: int, seed: int):
    """[bsz, n, n] SPD matrices X X^T / n + I / 2 and [bsz, n] right-hand
    sides, float32 torch."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(bsz, n, n)).astype(np.float32)
    a = x @ x.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=np.float32)
    return torch.tensor(a), torch.tensor(rng.uniform(-1.0, 1.0, (bsz, n)).astype(np.float32))


def _tiles_of_factor(l: torch.Tensor) -> torch.Tensor:
    """The factor as the kernels hold it: its lower triangle in the tile
    layout, the diagonal tiles' entries above the diagonal NaN (never
    read) and the padding NaN."""
    n = l.shape[-1]
    slot, size = _slots(n)
    flat = torch.full((l.shape[0], size), float("nan"))
    lower = torch.ones(n, n, dtype=torch.bool).tril()
    flat[:, slot[lower]] = l[:, lower]
    return flat


def _seq_blocked_substitution(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bl.blocked_substitution with every sum taken one term at a time in
    the device routines' order (csrc/cholesky.cuh's lower_substitution and
    csrc/tiled_cholesky.cuh's warp_exact_solve): forward, a panel row's
    terms in increasing k and the update's in increasing column; backward,
    a panel row's terms from the panel's last row down and the update's in
    increasing row."""
    n = l.shape[-1]
    out, y = b.clone(), torch.zeros_like(b)
    for p0 in range(0, n, PANEL):
        m = min(PANEL, n - p0)
        for j in range(m):
            s = torch.zeros_like(b[:, 0])
            for k in range(j):
                s = s + l[:, p0 + j, p0 + k] * y[:, p0 + k]
            y[:, p0 + j] = (out[:, p0 + j] - s) / l[:, p0 + j, p0 + j]
        if p0 + m < n:
            t = torch.zeros_like(out[:, p0 + m :])
            for c in range(m):
                t = t + l[:, p0 + m :, p0 + c] * y[:, p0 + c, None]
            out[:, p0 + m :] -= t
    for p0 in reversed(range(0, n, PANEL)):
        m = min(PANEL, n - p0)
        for j in range(m - 1, -1, -1):
            s = torch.zeros_like(b[:, 0])
            for k in range(m - 1, j, -1):
                s = s + l[:, p0 + k, p0 + j] * out[:, p0 + k]
            out[:, p0 + j] = (y[:, p0 + j] - s) / l[:, p0 + j, p0 + j]
        if p0 > 0:
            t = torch.zeros_like(y[:, :p0])
            for r in range(m):
                t = t + l[:, p0 + r, :p0] * out[:, p0 + r, None]
            y[:, :p0] -= t
    return out


def _exact_solve_mirror(flat: torch.Tensor, n: int, b: torch.Tensor) -> torch.Tensor:
    """warp_exact_solve's schedule: per panel, the chain solved alike on
    every lane (v_j = (r_j - s) / L_jj, s one multiply-add at a time in the
    kernel's order), lanes j < m storing v_j; the rows below (forward) or
    above (backward) the panel one per lane, i = first + lane + 32 q, each
    summing the panel's columns or rows in increasing order. L is read
    through the tile layout's slots."""
    slot, _ = _slots(n)
    bsz = b.shape[0]
    out, y = b.clone(), torch.zeros_like(b)

    def lanes_rows(first: int, end: int) -> torch.Tensor:
        rows = [i for lane in range(LANES) for i in range(first + lane, end, LANES)]
        assert sorted(rows) == list(range(first, end))  # each row on one lane, once
        return torch.tensor(rows, dtype=torch.long)

    for p0 in range(0, n, PANEL):  # forward
        m = min(PANEL, n - p0)
        v = []
        for j in range(m):
            s = torch.zeros(bsz)
            for k in range(j):
                s = s + flat[:, slot[p0 + j, p0 + k]] * v[k]
            v.append((out[:, p0 + j] - s) / flat[:, slot[p0 + j, p0 + j]])
        for lane in range(m):
            y[:, p0 + lane] = v[lane]
        if p0 + m < n:
            rows = lanes_rows(p0 + m, n)
            t = torch.zeros(bsz, len(rows))
            for c in range(m):
                t = t + flat[:, slot[rows, p0 + c]] * v[c][:, None]
            out[:, rows] = out[:, rows] - t
    for p0 in reversed(range(0, n, PANEL)):  # backward
        m = min(PANEL, n - p0)
        v = [None] * m
        for j in range(m - 1, -1, -1):
            s = torch.zeros(bsz)
            for k in range(m - 1, j, -1):
                s = s + flat[:, slot[p0 + k, p0 + j]] * v[k]
            v[j] = (y[:, p0 + j] - s) / flat[:, slot[p0 + j, p0 + j]]
        for lane in range(m):
            out[:, p0 + lane] = v[lane]
        if p0 > 0:
            rows = lanes_rows(0, p0)
            t = torch.zeros(bsz, len(rows))
            for r in range(m):
                t = t + flat[:, slot[p0 + r, rows]] * v[r][:, None]
            y[:, rows] = y[:, rows] - t
    return out


def _row_part(i: int, n: int) -> int:
    nt = (n + 3) // 4
    p = 4 * _tri(nt)
    plane = p + ((8 - p) & 31)
    return (i & 3) * plane + 4 * (nt - 1 - (i >> 2))


def _col_part(k: int, n: int) -> int:
    nt = (n + 3) // 4
    return 4 * _tri(nt - 1 - (k >> 2)) + (k & 3)


@pytest.mark.parametrize("n", (128, 73, 42, 13, 9, 8))
def test_exact_solve_addresses_are_the_slots(n):
    """The kernel's tile addresses, formed once per panel: forward, row i's
    columns p0 .. p0 + 3 at 4 tri(nt - 1 - p0 / 4) + row_part(i) + c, the
    next four at 4 tri(nt - 2 - p0 / 4) + row_part(i) + c - 4, and row_part
    falls by 32 from row i to row i + 32; backward, row p0 + r's column i at
    row_part(p0 + 4 (r >= 4)) + (r & 3) plane + col_part(i)."""
    slot, _ = _slots(n)
    nt = (n + 3) // 4
    plane = _row_part(1, n) - _row_part(0, n)
    for p0 in range(0, n - PANEL, PANEL):
        tp = p0 >> 2
        for i in range(p0 + PANEL, n):
            for c in range(PANEL):
                base = 4 * _tri(nt - 1 - tp) if c < 4 else 4 * _tri(nt - 2 - tp)
                assert base + _row_part(i, n) + (c & 3) == slot[i, p0 + c]
            if i + 32 < n:
                assert _row_part(i + 32, n) == _row_part(i, n) - 32
    for p0 in range(PANEL, n, PANEL):
        for r in range(min(PANEL, n - p0)):
            for i in range(p0):
                base = _row_part(p0 + (4 if r >= 4 else 0), n)
                assert base + (r & 3) * plane + _col_part(i, n) == slot[p0 + r, i]


@pytest.mark.parametrize("n", range(1, bl.MAX_N + 1))
def test_exact_solve_mirror_equals_blocked_substitution_bitwise(n):
    """The one-warp substitution's schedule on the tiles takes
    blocked_substitution's float32 operations in the device routines'
    order: bit for bit its one-term-at-a-time form, and nothing above the
    diagonal (NaN in the tiles) is read; the plain version, whose sums are
    vectorized, agrees to roundoff."""
    a, b = _spd(2, n, seed=n)
    l = bl.factor(a)
    got = _exact_solve_mirror(_tiles_of_factor(l), n, b)
    assert torch.isfinite(got).all()
    assert torch.equal(got, _seq_blocked_substitution(l, b))
    assert_close("blocked_substitution", bl.blocked_substitution(l, b), got, SUBSTITUTION_REL)


# ---------------------------------------------------------------------------
# K3's compact J, from fly states
# ---------------------------------------------------------------------------


def _fly_states(n_envs: int, device: str, seed: int) -> dict:
    """ell_cg_solve's keyword arguments for contact-rich fly states (legs
    dropped into the floor, joints perturbed, random qvel, ctrl and
    warmstart, as tests/test_cg_kernel_parity.py draws them), from the
    port's forward stages on `device`."""
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.physics import solver as ts

    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot("fly-mc-intention"), device=device)
    rng = np.random.RandomState(seed)
    qpos = np.tile(model.qpos0.cpu().numpy().astype(np.float64), (n_envs, 1))
    qpos[:, 2] -= rng.uniform(0.02, 0.12, n_envs)
    qpos[:, 7:] += rng.uniform(-0.10, 0.10, (n_envs, plan.nq - 7))
    qvel = rng.uniform(-2.0, 2.0, (n_envs, plan.nv))
    ctrl = rng.uniform(-0.3, 0.3, (n_envs, plan.nu))
    warm = rng.uniform(-5.0, 5.0, (n_envs, plan.nv))
    t = lambda x: torch.tensor(np.asarray(x, np.float32), device=device)
    d = tm.make_data(plan, model, n_envs).replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl), qacc_warmstart=t(warm))
    d, efc = tf.fwd_position(plan, model, d)
    d = tf.fwd_velocity(plan, model, d)
    d = tf.fwd_actuation(plan, model, d)
    d = tf.fwd_acceleration(plan, model, d)
    a = ts.ell_solve_inputs(plan, model, d, efc)
    return dict(a, its=(plan.iterations, plan.ls_iterations))


def _cut(inputs: dict, n: int | None = None, nl: int | None = None, nc: int | None = None) -> dict:
    """The same states with the first n dofs (dofs come parent first, so any
    prefix holds every ancestor of its dofs), the first nl of their limit
    rows and the first nc contacts."""
    a = {k: v for k, v in inputs.items() if k != "its"}
    n0, nl0 = a["qfrc_smooth"].shape[1], a["lim1h"].shape[0]
    n = n0 if n is None else n
    keep = torch.nonzero(a["lim1h"][:, :n].sum(1) > 0)[:, 0]
    keep = keep[: len(keep) if nl is None else nl]
    nc = a["fq"].shape[1] if nc is None else nc
    rows = torch.cat([keep, nl0 + torch.arange(3 * nc, device=keep.device)])
    out = dict(
        buf=a["buf"][:, :n], cdof=a["cdof"][:, :n], sw=a["sw"][:, :n], fq=a["fq"][:, :nc],
        ll=a["ll"][:, keep], mu=a["mu"][:, :nc], aref=a["aref"][:, rows], D=a["D"][:, rows],
        qfrc_smooth=a["qfrc_smooth"][:, :n], warm=a["warm"][:, :n], hd=a["hd"][:, :n],
        tolscale=a["tolscale"], anc=a["anc"][:n, :n], arm=a["arm"][:n], dm=a["dm"][:nc, :n],
        lim1h=a["lim1h"][keep][:, :n],
    )
    return {k: v.contiguous() for k, v in out.items()}


@pytest.fixture(scope="module")
def fly():
    return _fly_states(N_ENVS, "cpu", seed=3)


# the edge dims, on the fly's states: no contacts, no limit rows, n not a
# multiple of 4 or 8, a single panel
CUTS = {"fly": {}, "nc0": dict(nc=0), "nl0": dict(nl=0), "n13": dict(n=13), "n7": dict(n=7)}


class _CompactJ:
    """K3's J: each limit row's dof (its first nonzero) and value lim1h ll
    (NaN if the row has two nonzeros), each dof's limit rows as a list in
    row order; each contact's frame rows jfr, which are its cone block's
    rows (normal, t1, t2)."""

    def __init__(self, a: dict):
        lim1h, ll = a["lim1h"], a["ll"]
        nz = lim1h != 0
        self.dof = torch.argmax(nz.int(), dim=1) if lim1h.shape[0] else torch.zeros(0, dtype=torch.long)
        val = lim1h[torch.arange(lim1h.shape[0]), self.dof][None] * ll
        self.lval = torch.where((nz.sum(1) > 1)[None], torch.full_like(val, float("nan")), val)
        self.jfr = tk._jfr(a["fq"], a["sw"], a["dm"])  # [B, nc, 3, n]
        self.nl, self.nc, self.n = lim1h.shape[0], self.jfr.shape[1], a["sw"].shape[1]
        self.rows_of = [[r for r in range(self.nl) if int(self.dof[r]) == d] for d in range(self.n)]

    def matv(self, x: torch.Tensor) -> torch.Tensor:
        """J x: a limit row is its one term, a block's three rows are each
        summed one term at a time in increasing d."""
        lim = 0.0 + self.lval * x[:, self.dof]
        s = torch.zeros(self.jfr.shape[:3], dtype=x.dtype)
        for d in range(self.n):
            s = s + self.jfr[..., d] * x[:, None, None, d]
        return torch.cat([lim, s.reshape(x.shape[0], -1)], dim=1)

    def matv_t(self, f: torch.Tensor, base: torch.Tensor | None = None) -> torch.Tensor:
        """base - J^T f (or J^T f): each dof's limit rows from its list, then
        every contact's three rows in order."""
        s = torch.zeros(f.shape[0], self.n, dtype=f.dtype)
        for d, rows in enumerate(self.rows_of):
            for r in rows:
                s[:, d] = s[:, d] + self.lval[:, r] * f[:, r]
        for c in range(self.nc):
            for k in range(3):
                s = s + self.jfr[:, c, k] * f[:, self.nl + 3 * c + k, None]
        return s if base is None else base - s


@pytest.mark.parametrize("name", list(CUTS))
def test_compact_j_equals_dense_j(fly, name):
    """J x over the compact J equals build_j_ell's dense row sums bit for bit
    (a limit row's zeros add exactly nothing), and the plain matmul to
    roundoff."""
    a = _cut(fly, **CUTS[name])
    j = _CompactJ(a)
    dense = tk.build_j_ell(a["fq"], a["sw"], a["ll"], a["dm"], a["lim1h"])
    x = a["warm"]
    got = j.matv(x)
    assert torch.equal(got, _seq_matv(dense, x))
    assert_close("J x", got, (dense @ x[..., None])[..., 0], PRODUCT_REL * max(1.0, float(x.abs().max())))


@pytest.mark.parametrize("name", list(CUTS))
def test_compact_jt_equals_dense_jt(fly, name):
    """J^T f over the compact J, each dof's limit rows from its list in row
    order and then the contacts' rows, equals the dense column sums in row
    order bit for bit (the limit rows at other dofs add exact zeros), and
    the plain matmul to roundoff."""
    a = _cut(fly, **CUTS[name])
    j = _CompactJ(a)
    dense = tk.build_j_ell(a["fq"], a["sw"], a["ll"], a["dm"], a["lim1h"])
    jar = j.matv(a["warm"]) - a["aref"]
    f = torch.where(jar < 0, -a["D"] * jar, torch.zeros_like(jar))  # forces of the active rows
    base = a["warm"]
    got = j.matv_t(f, base)
    assert torch.equal(got, base - _seq_matv(dense.transpose(1, 2), f))
    scale = max(1.0, float(f.abs().max())) if f.numel() else 1.0
    assert_close("J^T f", got, base - (f[:, None, :] @ dense)[:, 0], PRODUCT_REL * scale)


def test_limit_lists_hold_each_limit_row_once(fly):
    j = _CompactJ(fly)
    assert sorted(r for rows in j.rows_of for r in rows) == list(range(j.nl))
    assert all(rows == sorted(rows) for rows in j.rows_of)


def test_dense_wrapper_checks_its_rows():
    """ell_cg_solve_dense takes J [B, ns + 3 nc, n] with nc from mu; a J of
    another row count, or no rows at all, is refused on any device; on the
    CPU it runs the plain version, with and without the Euler solve."""
    a = {k: torch.zeros(s) for k, s in dict(
        buf=(1, 4, 6), cdof=(1, 4, 6), J=(1, 2 + 3, 4), aref=(1, 5), D=(1, 5), mu=(1, 1), qfrc_smooth=(1, 4),
        warm=(1, 4), hd=(1, 4), tolscale=(1,), anc=(4, 4), arm=(4,)).items()}
    a["anc"] = torch.eye(4)
    a["arm"] = torch.ones(4)
    for we in (True, False):
        out = tk.ell_cg_solve_dense(**a, ns=2, with_euler=we, iterations=1, ls_iterations=0)
        assert (out.qacc_eff is None) != we and torch.isfinite(out.qacc).all()
    with pytest.raises(ValueError, match="J shape"):
        tk.ell_cg_solve_dense(**a, ns=3, with_euler=True, iterations=1, ls_iterations=0)
    with pytest.raises(ValueError, match="row counts"):
        tk.ell_cg_solve_dense(**dict(a, mu=torch.zeros(1, 0), J=torch.zeros(1, 0, 4), aref=torch.zeros(1, 0),
                                     D=torch.zeros(1, 0)), ns=0, with_euler=True, iterations=1, ls_iterations=0)


# (n, ns, nc): the fly with a condim-1 leg (113 rows: boundaries at 39 and
# 78 would part the cone blocks of rows 38-40 and 77-79), the fly's own rows, fewer rows
# than one panel, cone blocks alone, scalar rows alone (J copied once), and
# the widest n
ELL_PANEL_SIZES = ((42, 38, 25), (42, 36, 27), (42, 5, 5), (42, 0, 40), (42, 70, 0), (128, 20, 60))


@pytest.mark.parametrize("n, ns, nc", ELL_PANEL_SIZES)
def test_dense_panels_hold_whole_cone_blocks(n, ns, nc):
    e = ns + 3 * nc
    p = tk.j_panels("ell_cg_solve_dense", n, e, ns)
    assert_panels_cut(p, e, ns, n, tk.J_RING_FLOATS["ell_cg_solve_dense"])
    if (n, ns, nc) == (42, 38, 25):
        assert p.rows == 39 and p.cuts == (0, 38, 77, 113) and not p.resident


@pytest.mark.parametrize("n, ns, nc", ELL_PANEL_SIZES)
def test_dense_panel_walks_equal_whole_j_sums(n, ns, nc):
    e = ns + 3 * nc
    rng = np.random.RandomState(n + e)
    j, x, f = (torch.tensor(rng.normal(size=s).astype(np.float32)) for s in ((2, e, n), (2, n), (2, e)))
    assert_walks_equal_whole_j("ell_cg_solve_dense", j, x, f, ns)


@pytest.mark.parametrize("name, cut", [("fly", {}), ("nl34", dict(nl=34)), ("nc3", dict(nc=3))])
def test_dense_panel_walks_in_the_plain_solve(fly, name, cut):
    """The plain elliptic solve with J's products taken as the dense kernel's
    walks take them: at the fly's 4/4 bit for bit the solve with the same
    sums over the whole J, and at 1/0 within SOLVE_REL of the plain version
    (at 4/4 the linesearch's bracket decisions flip under reassociation:
    the plain version summed one term at a time parts from its matmuls by
    1.5e-2 in qacc on one of these 4 envs, in float64 too; chip_smoke.py
    holds the kernel at 1/0 the same way). The fly's rows as a dense J (36
    scalar rows, 3 panels), with 34 limit rows (a boundary at 39 would part
    a cone block) and with 3 contacts (J copied once)."""
    a = _cut(fly, **cut)
    j = tk.build_j_ell(a["fq"], a["sw"], a["ll"], a["dm"], a["lim1h"]).contiguous()
    ns = a["lim1h"].shape[0]
    qm = tk.assemble_qm(a["buf"], a["cdof"], a["anc"], a["arm"])
    dense = {k: a[k] for k in ("buf", "cdof", "aref", "D", "mu", "qfrc_smooth", "warm", "hd", "tolscale", "anc",
                               "arm")}

    def solve(op, its, ls):
        return tk._elliptic_plain(qm, PanelJ(op, j, ns), a["aref"], a["D"], a["mu"], a["qfrc_smooth"], a["warm"],
                                  a["hd"], a["tolscale"], ns, its, ls, True)

    got, whole = (solve(op, *fly["its"]) for op in ("ell_cg_solve_dense", None))
    for out in OUTS:
        assert torch.equal(getattr(got, out), getattr(whole, out)), out
    got = solve("ell_cg_solve_dense", 1, 0)
    want = tk.ell_cg_solve_dense_plain(**dense, J=j, ns=ns, with_euler=True, iterations=1, ls_iterations=0)
    for out in OUTS:
        assert_close(out, getattr(got, out), getattr(want, out), SOLVE_REL[out])


@pytest.mark.parametrize("op", ("ell_cg_solve", "cho_solve"))
def test_wrappers_raise_above_the_tiled_range(op):
    """Both kernels keep their factor in the tiles, n <= MAX_N; the check
    comes before the library is built or loaded, for any device."""
    n = bl.MAX_N + 1
    if op == "cho_solve":
        a = torch.zeros(1, n, n)
        with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
            bl._launch(op, torch.empty(1, n), a, torch.zeros(1, n))
    else:
        args = [torch.zeros(s) for s in ((1, n, 6), (1, n, 6), (1, 0, 3, 6), (1, n, 6), (1, 0), (1, 0),
                                         (1, 0), (1, 0), (1, n), (1, n), (1, n), (1,), (n, n), (n,), (0, n), (0, n))]
        with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
            tk._launch(op, args, 1, (n, 0, 0), 0, 4, 4)


# ---------------------------------------------------------------------------
# the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.fixture(scope="module")
def card_fly():
    """The 4096 contact-rich fly states chip_smoke.py holds the kernel to
    (its generator, seed 0)."""
    _needs_cuda()
    import chip_smoke
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm

    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot("fly-mc-intention"), device="cuda")
    a = chip_smoke.Phases("", device="cuda").fly_states(plan, model)
    return dict(a, its=(plan.iterations, plan.ls_iterations))


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", (4096, 4095))
@pytest.mark.parametrize("name", list(CUTS))
def test_cuda_ell_kernel_matches_plain(card_fly, name, bsz):
    """The kernel against its plain version on the card at one iteration
    with one Newton step (chip_smoke.py's bars: with more linesearch steps
    the float32 bracket is a knife edge between any two float32 solves),
    on the fly's dims and the edge dims, a full and a ragged batch; at the
    fly's 4/4 every output finite and qacc_smooth at its bar."""
    import chip_smoke

    a = _cut(card_fly, **CUTS[name])
    a = {k: (v[:bsz].contiguous() if v.dim() and v.shape[0] == 4096 else v) for k, v in a.items()}
    before = tk.ell_cg_solve.launches
    got = tk.ell_cg_solve(**a, iterations=1, ls_iterations=0)
    torch.cuda.synchronize()
    assert tk.ell_cg_solve.launches == before + 1
    want = tk.ell_cg_solve_plain(**a, iterations=1, ls_iterations=0)
    for out, bar in chip_smoke.FLY_KERNEL_REL.items():
        err = rel_err(getattr(got, out).cpu(), getattr(want, out).cpu())
        print(f"ell_cg_solve vs plain, {name}, {bsz} envs, 1/0, {out}: {err:.3e}")
        assert err < bar, f"{out}: rel err {err:.3e} >= {bar:.0e}"
    its, ls = card_fly["its"]
    got = tk.ell_cg_solve(**a, iterations=its, ls_iterations=ls)
    want = tk.ell_cg_solve_plain(**a, iterations=its, ls_iterations=ls)
    for out in OUTS:
        assert torch.isfinite(getattr(got, out)).all(), out
    assert rel_err(got.qacc_smooth.cpu(), want.qacc_smooth.cpu()) < chip_smoke.FLY_KERNEL_REL["qacc_smooth"]


@pytest.mark.cuda
def test_cuda_ell_kernel_info():
    """Registers, shared memory, CTAs per SM and threads of the kernel as
    built, at the fly's sizes; n > MAX_N refused."""
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.ell_cg_solve_kernel_info(42, 36, 27, info) == 0
    assert info[0] > 0 and info[1] == lib.ell_cg_solve_smem_bytes(42, 36, 27) and info[2] >= 1
    assert info[3] in (64, 128)
    assert lib.ell_cg_solve_kernel_info(bl.MAX_N + 1, 0, 0, info) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("fly", "nl0"))
def test_cuda_ell_kernel_without_euler_keeps_its_bits(card_fly, name):
    """Without the Euler solve (RK4 and implicit plans) the compact kernel
    writes no qacc_eff, and its other four outputs are the with-Euler
    launch's bit for bit, at 1/0 and at the fly's 4/4."""
    a = _cut(card_fly, **CUTS[name])
    for its, ls in ((1, 0), card_fly["its"]):
        bare = tk.ell_cg_solve(**a, iterations=its, ls_iterations=ls, with_euler=False)
        full = tk.ell_cg_solve(**a, iterations=its, ls_iterations=ls)
        torch.cuda.synchronize()
        assert bare.qacc_eff is None
        for out in OUTS[:4]:
            assert torch.equal(getattr(bare, out), getattr(full, out)), (out, its, ls)


@pytest.fixture(scope="module")
def card_fly_dense():
    """ell_cg_solve_dense's inputs on 4096 contact-rich states of the fly with
    a condim-1 leg (chip_smoke.py's generator and edit, seed 0)."""
    _needs_cuda()
    import chip_smoke
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.physics import model as tm

    tf.set_full_f32()
    plan, model = tm.put_model(chip_smoke.fly_condim1(tm.load_snapshot("fly-mc-intention")), device="cuda")
    a = chip_smoke.Phases("", device="cuda").fly_states(plan, model, dense=True)
    return dict(a, its=(plan.iterations, plan.ls_iterations))


def _cut_dense(a: dict, n: int | None = None, ns: int | None = None, nc: int | None = None) -> dict:
    """ell_cg_solve_dense's inputs with the first n dofs, the first ns scalar
    rows and the first nc cone blocks."""
    ns0 = a["ns"]
    nc0 = a["mu"].shape[1]
    n = a["qfrc_smooth"].shape[1] if n is None else n
    ns = ns0 if ns is None else ns
    nc = nc0 if nc is None else nc
    rows = torch.cat([torch.arange(ns), ns0 + torch.arange(3 * nc)]).to(a["J"].device)
    out = dict(
        buf=a["buf"][:, :n], cdof=a["cdof"][:, :n], J=a["J"][:, rows][:, :, :n], aref=a["aref"][:, rows],
        D=a["D"][:, rows], mu=a["mu"][:, :nc], qfrc_smooth=a["qfrc_smooth"][:, :n], warm=a["warm"][:, :n],
        hd=a["hd"][:, :n], tolscale=a["tolscale"], anc=a["anc"][:n, :n], arm=a["arm"][:n],
    )
    return dict({k: v.contiguous() for k, v in out.items()}, ns=ns)


DENSE_CUTS = {"fly": {}, "ns0": dict(ns=0), "nc0": dict(nc=0), "n13": dict(n=13)}


@pytest.mark.cuda
@pytest.mark.parametrize("with_euler", (True, False), ids=("euler", "no_euler"))
@pytest.mark.parametrize("bsz", (4096, 4095))
@pytest.mark.parametrize("name", list(DENSE_CUTS))
def test_cuda_ell_dense_kernel_matches_plain(card_fly_dense, name, bsz, with_euler):
    """The dense-J kernel against its plain version on the card at 1/0
    (chip_smoke.py's FLY_KERNEL_REL), with and without the Euler solve, on
    the fly condim-1 plan's dims and the edge dims (no scalar rows, no cone
    blocks, n = 13), a full and a ragged batch; at the fly's 4/4 every
    output finite and qacc_smooth at its bar; without Euler the four outputs
    are the with-Euler launch's bit for bit."""
    import chip_smoke

    a = _cut_dense(card_fly_dense, **DENSE_CUTS[name])
    a = {k: (v[:bsz].contiguous() if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == 4096 else v)
         for k, v in a.items()}
    before = tk.ell_cg_solve_dense.launches
    got = tk.ell_cg_solve_dense(**a, with_euler=with_euler, iterations=1, ls_iterations=0)
    torch.cuda.synchronize()
    assert tk.ell_cg_solve_dense.launches == before + 1
    want = tk.ell_cg_solve_dense_plain(**a, with_euler=with_euler, iterations=1, ls_iterations=0)
    for out, bar in chip_smoke.FLY_KERNEL_REL.items():
        if out == "qacc_eff" and not with_euler:
            assert got.qacc_eff is None and want.qacc_eff is None
            continue
        err = rel_err(getattr(got, out).cpu(), getattr(want, out).cpu())
        print(f"ell_cg_solve_dense vs plain, {name}, {bsz} envs, 1/0, with_euler={with_euler}, {out}: {err:.3e}")
        assert err < bar, f"{out}: rel err {err:.3e} >= {bar:.0e}"
    its, ls = card_fly_dense["its"]
    got = tk.ell_cg_solve_dense(**a, with_euler=with_euler, iterations=its, ls_iterations=ls)
    want = tk.ell_cg_solve_dense_plain(**a, with_euler=with_euler, iterations=its, ls_iterations=ls)
    for out in OUTS[: 5 if with_euler else 4]:
        assert torch.isfinite(getattr(got, out)).all(), out
    assert rel_err(got.qacc_smooth.cpu(), want.qacc_smooth.cpu()) < chip_smoke.FLY_KERNEL_REL["qacc_smooth"]
    if not with_euler:
        full = tk.ell_cg_solve_dense(**a, with_euler=True, iterations=its, ls_iterations=ls)
        for out in OUTS[:4]:
            assert torch.equal(getattr(got, out), getattr(full, out)), out


@pytest.mark.cuda
def test_cuda_ell_dense_kernel_on_the_compact_rows(card_fly):
    """The dense-J kernel given the compact plan's own J (build_j_ell, ns =
    the limit rows) solves as the compact kernel does, at 1/0 within
    FLY_KERNEL_REL."""
    import chip_smoke

    a = _cut(card_fly)
    j = tk.build_j_ell(a["fq"], a["sw"], a["ll"], a["dm"], a["lim1h"]).contiguous()
    dense = {k: a[k] for k in ("buf", "cdof", "aref", "D", "mu", "qfrc_smooth", "warm", "hd", "tolscale", "anc",
                               "arm")}
    got = tk.ell_cg_solve_dense(**dense, J=j, ns=a["lim1h"].shape[0], with_euler=True, iterations=1,
                                ls_iterations=0)
    want = tk.ell_cg_solve(**a, iterations=1, ls_iterations=0)
    torch.cuda.synchronize()
    for out, bar in chip_smoke.FLY_KERNEL_REL.items():
        err = rel_err(getattr(got, out).cpu(), getattr(want, out).cpu())
        assert err < bar, f"{out}: rel err {err:.3e} >= {bar:.0e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n, ns, nc", ELL_PANEL_SIZES)
def test_cuda_ell_dense_panels_match_the_mirror(n, ns, nc):
    """The kernel's panels (ell_cg_solve_dense_panels) are `tk.j_panels`'."""
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    out = (ctypes.c_int * 3)()
    assert kernel_lib.load_library().ell_cg_solve_dense_panels(n, ns, nc, out) == 0
    p = tk.j_panels("ell_cg_solve_dense", n, ns + 3 * nc, ns)
    assert (out[0], out[1], bool(out[2])) == (p.rows, len(p.cuts) - 1, p.resident)


@pytest.mark.cuda
def test_cuda_ell_dense_kernel_info():
    """Registers, shared memory, CTAs per SM and threads of the dense-J
    kernel as built, at the fly condim-1 plan's sizes (n 42, 38 scalar rows,
    25 cone blocks); n > MAX_N refused."""
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.ell_cg_solve_dense_kernel_info(42, 38, 25, info) == 0
    assert info[0] > 0 and info[1] == lib.ell_cg_solve_dense_smem_bytes(42, 38, 25) and info[2] >= 8
    assert info[3] == 64
    assert lib.ell_cg_solve_dense_kernel_info(bl.MAX_N + 1, 0, 1, info) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", (1, 3, 4097))
@pytest.mark.parametrize("n", (1, 9, 42, 73, 128))
def test_cuda_cho_solve_matches_plain(n, bsz):
    """cho_solve against its plain version on the card at ragged batch sizes
    and n up to MAX_N (tests/test_torch_linalg.py's bar, 2e-6), and bit for
    bit the same with the factor's strict upper triangle NaN."""
    _needs_cuda()
    a, b = _spd(bsz, n, seed=n + bsz)
    l = bl.factor(a).cuda()
    b = b.cuda()
    before = bl.cho_solve.launches
    got = bl.cho_solve(l, b)
    torch.cuda.synchronize()
    assert bl.cho_solve.launches == before + 1
    assert_close("cho_solve", got.cpu(), bl.cho_solve_plain(l, b).cpu(), 2e-6)
    nan_upper = l.masked_fill(torch.ones(n, n, dtype=torch.bool, device="cuda").triu(1), float("nan"))
    assert torch.equal(bl.cho_solve(nan_upper, b), got)


@pytest.mark.cuda
def test_cuda_cho_solve_kernel_info():
    _needs_cuda()
    import ctypes

    from track_mjx_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load_library()
    info = (ctypes.c_int * 4)()
    assert lib.cho_solve_kernel_info(73, info) == 0
    assert info[0] > 0 and info[1] == lib.cho_solve_smem_bytes(73) and info[2] >= 1
    assert info[3] == 32
    assert lib.cho_solve_kernel_info(bl.MAX_N + 1, info) != 0
