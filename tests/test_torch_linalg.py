"""The standalone linalg kernels (K4a-c: cholesky, cho_solve, solve_spd):
the port's plain versions against the JAX package's Pallas kernels run in
interpret mode and against numpy in float64, at the rodent's n = 73 and a
ragged n = 20; the wrappers' CPU dispatch and argument checks; the tiled
factor's schedule (csrc/batched_linalg.cu) mirrored in torch; and, on a
CUDA machine, each kernel against its plain version. The port needs no
jax, so a CUDA machine may have none: `python -m pytest --noconftest
tests/test_torch_linalg.py -m cuda` runs there (tests/conftest.py sets JAX
up)."""

import numpy as np
import pytest
import torch

from torch_parity import assert_close
from track_mjx_tpu_torch.ops import batched_linalg as bl

torch.set_num_threads(1)
N_ENVS = 4
SIZES = (73, 20)
KERNELS = ("cholesky", "cho_solve", "solve_spd")

# The plain versions and the TPU kernels run the same arithmetic step for
# step (right-looking factor with c = row * rsqrt(diag), panel-8 exact
# substitution); the order of the <= 8-term sums inside a panel and the
# rsqrt may differ by an ulp or two per operation. Errors are relative to
# max(1, max |reference|). Measured on these matrices (cond 1e3, on an
# x86 CPU): L 4.0e-7, cho_solve on the same L 2.9e-7, solve_spd 7.0e-6 (the
# factor's roundoff carried through cond(A)); the bars leave 5-7x.
INTERPRET_REL = {"cholesky": 2e-6, "cho_solve": 2e-6, "solve_spd": 5e-5}
# Against float64, f32 roundoff (6e-8) grows with the factor and, in the
# solutions, with cond(A): measured L 3.1e-7, cho_solve 6.3e-6, solve_spd
# 8.0e-6.
F64_REL = {"cholesky": 2e-6, "cho_solve": 5e-5, "solve_spd": 5e-5}


def _spd(n: int, seed: int):
    """[N_ENVS, n, n] SPD matrices Q diag(lam) Q^T, Q random orthogonal and
    lam log-spaced over [1e-3, 1] (cond 1e3), and [N_ENVS, n] right-hand
    sides, float32 numpy."""
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.normal(size=(N_ENVS, n, n)))[0]
    a = (q * np.logspace(-3.0, 0.0, n)[None, None, :]) @ q.transpose(0, 2, 1)
    b = rng.uniform(-1.0, 1.0, (N_ENVS, n))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.fixture(scope="module", params=SIZES, ids=lambda n: f"n{n}")
def case(request):
    # JAX is imported here and not at the top, so that the cuda-marked
    # tests run on a machine without jax (README)
    import jax.numpy as jnp
    from track_mjx_tpu.ops import batched_linalg as jbl

    n = request.param
    a, b = _spd(n, seed=n)
    l = np.asarray(jbl._cholesky_tpu(jnp.asarray(a), interpret=True))
    interp = {
        "cholesky": l,
        "cho_solve": np.asarray(jbl._cho_solve_tpu(jnp.asarray(l), jnp.asarray(b), interpret=True)),
        "solve_spd": np.asarray(jbl._solve_spd_tpu(jnp.asarray(a), jnp.asarray(b), interpret=True)),
    }
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    x64 = np.linalg.solve(a64, b64[..., None])[..., 0]
    f64 = {"cholesky": np.linalg.cholesky(a64), "cho_solve": x64, "solve_spd": x64}
    return dict(a=a, b=b, l=l, interp=interp, f64=f64)


def _plain(case, kernel: str):
    a, b, l = (torch.tensor(case[k]) for k in ("a", "b", "l"))
    if kernel == "cholesky":
        return bl.cholesky_plain(a)
    if kernel == "cho_solve":  # on the TPU kernel's factor, as the comparison's input
        return bl.cho_solve_plain(l, b)
    return bl.solve_spd_plain(a, b)


def _args(kernel: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The wrapper's arguments; cho_solve takes the plain factor of `a`."""
    return {"cholesky": (a,), "cho_solve": (bl.cholesky_plain(a), b), "solve_spd": (a, b)}[kernel]


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax_kernel_interpret(case, kernel):
    assert_close(kernel, _plain(case, kernel), case["interp"][kernel], INTERPRET_REL[kernel])


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_numpy_float64(case, kernel):
    assert_close(kernel, _plain(case, kernel), case["f64"][kernel], F64_REL[kernel])


def test_cholesky_upper_triangle_is_zero(case):
    l = bl.cholesky_plain(torch.tensor(case["a"]))
    assert not torch.triu(l, diagonal=1).any()
    assert not np.triu(case["interp"]["cholesky"], k=1).any()


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_on_cpu_runs_plain(case, kernel):
    """A CPU tensor runs the plain version and counts no launch; a float64
    CPU tensor runs it in float64 (a reference solve)."""
    a, b = torch.tensor(case["a"]), torch.tensor(case["b"])
    op = getattr(bl, kernel)
    args = _args(kernel, a, b)
    before = op.launches
    got = op(*args)
    assert op.launches == before, "a CPU call must not count a kernel launch"
    torch.testing.assert_close(got, getattr(bl, f"{kernel}_plain")(*args), rtol=0, atol=0)
    got64 = op(*_args(kernel, a.double(), b.double()))
    assert got64.dtype == torch.float64
    # float64 roundoff (1e-16) through cond(A) (about 1e3)
    assert_close(f"{kernel} float64", got64, case["f64"][kernel], 1e-10)


def test_wrapper_rejects_bad_arguments(case):
    a, b = torch.tensor(case["a"]), torch.tensor(case["b"])
    with pytest.raises(TypeError, match="float32"):
        bl.solve_spd(a, b.double())
    with pytest.raises(TypeError, match="float32"):
        bl.cholesky(a.half())
    with pytest.raises(ValueError, match="shape"):
        bl.cho_solve(a, b[:, :-1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        bl.cholesky(a[:, :, :-1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        bl.cholesky(a.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        bl.solve_spd(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="on meta"):
        bl.cho_solve(a, b.to("meta"))
    with pytest.raises(ValueError, match="empty"):
        bl.cholesky(a[:0])


def _nan_upper(a: torch.Tensor) -> torch.Tensor:
    """`a` with its strict upper triangle set to NaN."""
    return a.masked_fill(torch.ones_like(a[0], dtype=torch.bool).triu(1), float("nan"))


@pytest.mark.parametrize("kernel", bl.TILED)
def test_plain_ignores_the_upper_triangle(case, kernel):
    """The factor reads column j below the diagonal only, so a NaN-filled
    strict upper triangle gives the same output, bit for bit."""
    a, b = torch.tensor(case["a"]), torch.tensor(case["b"])
    plain = getattr(bl, f"{kernel}_plain")
    args = _args(kernel, a, b)
    got = plain(_nan_upper(a), *args[1:])
    assert torch.isfinite(got).all()
    assert torch.equal(got, plain(*args))


def test_tiled_kernels_raise_above_their_range():
    """The tiled factor takes n <= MAX_N; the check comes before the library
    is built or loaded."""
    a = torch.zeros(1, bl.MAX_N + 1, bl.MAX_N + 1)
    for op in bl.TILED:
        with pytest.raises(ValueError, match=f"n <= {bl.MAX_N}"):
            bl._launch(op, torch.empty_like(a), a)


# ---------------------------------------------------------------------------
# the tiled factor's schedule (csrc/batched_linalg.cu), mirrored in torch
# ---------------------------------------------------------------------------

TILED_PANEL = 8  # the tiled kernel's panel width (kTiledPanel)


def _untri(t: int) -> tuple[int, int]:
    """The kernel's `untri`: (c, t - tri(c)) for the largest c with tri(c) =
    c (c + 1) / 2 <= t, from a float32 square root and two corrections."""
    tri = lambda c: c * (c + 1) // 2
    c = int((np.sqrt(np.float32(8 * t + 1), dtype=np.float32) - np.float32(1)) * np.float32(0.5))
    if tri(c + 1) <= t:
        c += 1
    if tri(c) > t:
        c -= 1
    return c, t - tri(c)


def _trailing_tiles(nt: int, k0: int) -> list[tuple[int, int]]:
    """(tile row, tile column) of the tiles right of tile column k0, in the
    order the kernel's threads take them: t = 0, 1, ... -> untri(t),
    counted from the last tile column and row."""
    m = nt - k0
    tiles = []
    for t in range(m * (m + 1) // 2 if m > 0 else 0):
        c, r = _untri(t)
        tiles.append((nt - 1 - r, nt - 1 - c))
    return tiles


def _tiled_factor(a: torch.Tensor, panel: int) -> torch.Tensor:
    """The tiled kernel's schedule in float32 torch, from the lower triangle
    of `a` padded to whole 4x4 tiles. Warp 0 factors the first panel of
    `panel` columns (pivot rsqrt, column scaled, then the later panel
    columns updated). Then, for each panel, the tiles right of it, in the
    threads' order, take its update: warp 0's share (the next panel's
    tiles) first, then warp 0 factors the next panel, then the other warps'
    share. Each tile takes the panel's tile columns in order and, inside
    one, columns jj = 0..3 in order; its 16 entries are independent, so
    they are updated together."""
    bsz, n, _ = a.shape
    nt = (n + 3) // 4
    l = torch.zeros(bsz, 4 * nt, 4 * nt, dtype=a.dtype)
    l[:, :n, :n] = torch.tril(a)

    def factor_panel(p0):
        end = min(p0 + panel, n)
        for j in range(p0, end):
            l[:, j:n, j] = l[:, j:n, j] * torch.rsqrt(l[:, j, j])[:, None]
            for k in range(j + 1, end):
                l[:, k:n, k] -= l[:, k:n, j] * l[:, k, j][:, None]

    def update(p0, tiles):
        for ti, tk in tiles:
            rows, cols = slice(4 * ti, 4 * ti + 4), slice(4 * tk, 4 * tk + 4)
            acc = l[:, rows, cols].clone()
            for tc in range(p0 // 4, (p0 + panel) // 4):
                pan = slice(4 * tc, 4 * tc + 4)
                a_t, b_t = l[:, rows, pan], l[:, cols, pan]  # L[i][j], L[k][j]
                for jj in range(4):
                    acc -= a_t[:, :, jj, None] * b_t[:, None, :, jj]
            l[:, rows, cols] = acc

    factor_panel(0)
    for p0 in range(0, n, panel):
        m = nt - (p0 + panel) // 4
        if m <= 0:
            break
        tiles = _trailing_tiles(nt, (p0 + panel) // 4)
        split = max(m - panel // 4, 0) * (max(m - panel // 4, 0) + 1) // 2
        update(p0, tiles[split:])  # warp 0: the next panel's tiles
        factor_panel(p0 + panel)
        update(p0, tiles[:split])  # the other warps
    return torch.tril(l[:, :n, :n])


@pytest.mark.parametrize("nt", range(1, bl.MAX_N // 4 + 1))
def test_tile_order_covers_each_trailing_tile_once(nt):
    """For every panel start, the threads' tiles are the lower tiles right
    of the panel, each once; tile t is stored at index t."""
    for k0 in range(nt + 1):
        tiles = _trailing_tiles(nt, k0)
        want = {(ti, tk) for tk in range(k0, nt) for ti in range(tk, nt)}
        assert len(tiles) == len(want) and set(tiles) == want
        for t, (ti, tk) in enumerate(tiles):  # the kernel's tile_index
            c = nt - 1 - tk
            assert c * (c + 1) // 2 + (nt - 1 - ti) == t


@pytest.mark.parametrize("n", (128, 73, 42, 20, 9, 1))
def test_tiled_schedule_equals_factor_bitwise(n):
    """Every entry receives the same float32 operations in the same order
    as in `factor`, so the two agree bit for bit."""
    a, _ = _spd(n, seed=n + TILED_PANEL)
    a = torch.tensor(a)
    assert torch.equal(_tiled_factor(a, TILED_PANEL), bl.factor(a))


def _cuda_spd(bsz: int, n: int, seed: int):
    """[bsz, n, n] SPD matrices X X^T / n + I / 2 and [bsz, n] right-hand
    sides, float32, on the card."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(bsz, n, n)).astype(np.float32)
    a = x @ x.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=np.float32)
    b = rng.uniform(-1.0, 1.0, (bsz, n)).astype(np.float32)
    return torch.tensor(a).cuda(), torch.tensor(b).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", (1, 3, 4097))
@pytest.mark.parametrize("n", (9, 42, 73, 128))
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_kernel_matches_plain(kernel, n, bsz):
    """Each kernel against its plain version on the card, at ragged batch
    sizes and n up to MAX_N; the tiled kernels also read nothing above the
    diagonal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    a, b = _cuda_spd(bsz, n, seed=n + bsz)
    args = _args(kernel, a, b)
    op = getattr(bl, kernel)
    before = op.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = getattr(bl, f"{kernel}_plain")(*args)  # on the card
    assert_close(kernel, got.cpu(), want.cpu(), INTERPRET_REL[kernel])
    if kernel in bl.TILED:
        assert torch.equal(op(_nan_upper(a), *args[1:]), got)
