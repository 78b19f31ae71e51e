"""The standalone linalg kernels (K4a-c: cholesky, cho_solve, solve_spd):
the port's plain versions against the JAX package's Pallas kernels run in
interpret mode and against numpy in float64, at the rodent's n = 73 and a
ragged n = 20; the wrappers' CPU dispatch and argument checks; and, on a
CUDA machine, each kernel against its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from track_mjx_tpu.ops import batched_linalg as jbl
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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", KERNELS)
def test_cuda_kernel_matches_plain(case, kernel):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    args = _args(kernel, torch.tensor(case["a"]), torch.tensor(case["b"]))
    op = getattr(bl, kernel)
    before = op.launches
    got = op(*(t.cuda() for t in args))
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert_close(kernel, got.cpu(), getattr(bl, f"{kernel}_plain")(*args), INTERPRET_REL[kernel])
