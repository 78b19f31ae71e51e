"""Port ops against the JAX package (quaternion, spatial) and the port's
batched Cholesky routines against np.linalg."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_close
from track_mjx_tpu.ops import quaternion as jq
from track_mjx_tpu.ops import spatial as js
from track_mjx_tpu_torch.ops import batched_linalg as tl
from track_mjx_tpu_torch.ops import quaternion as tq
from track_mjx_tpu_torch.ops import spatial as ts

torch.set_num_threads(1)
N = 16
# same f32 formulas in both packages; only the order of 3- and 4-term sums
# may differ
OP_REL = 1e-6


def _inputs(seed):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f(N, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = f(N, 4)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    axis = f(N, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rot = np.stack([np.asarray(jq.to_mat(x)) for x in q])
    return dict(
        q=q, q2=q2, v=f(N, 3), axis=axis, angle=f(N), m6=f(N, 6), u6=f(N, 6),
        inert=f(N, 10), off=f(N, 3), rot=rot, mass=np.abs(f(N)) + 0.1,
        inertia=np.abs(f(N, 3)) + 0.1, xipos=f(N, 3), com=f(N, 3),
    )


QUAT_CASES = {
    "mul": (jq.mul, tq.mul, ("q", "q2")),
    "inv": (jq.inv, tq.inv, ("q",)),
    "rotate": (jq.rotate, tq.rotate, ("v", "q")),
    "rotate_inv": (jq.rotate_inv, tq.rotate_inv, ("v", "q")),
    "relative_quat": (jq.relative_quat, tq.relative_quat, ("q", "q2")),
    "normalize": (jq.normalize, tq.normalize, ("q2",)),
    "to_mat": (jq.to_mat, tq.to_mat, ("q",)),
    "from_axis_angle": (jq.from_axis_angle, tq.from_axis_angle, ("axis", "angle")),
    "integrate": (lambda q, v: jq.integrate(q, v, 0.002), lambda q, v: tq.integrate(q, v, 0.002), ("q", "v")),
    "subtract": (jq.subtract, tq.subtract, ("q", "q2")),
    "motion_cross": (js.motion_cross, ts.motion_cross, ("m6", "u6")),
    "force_cross": (js.force_cross, ts.force_cross, ("m6", "u6")),
    "inert_mul": (js.inert_mul, ts.inert_mul, ("inert", "m6")),
    "transform_motion": (js.transform_motion, ts.transform_motion, ("m6", "off", "rot")),
    "transform_force": (js.transform_force, ts.transform_force, ("m6", "off")),
    "inertia_in_com_frame": (
        js.inertia_in_com_frame, ts.inertia_in_com_frame, ("mass", "inertia", "rot", "xipos", "com"),
    ),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_op_matches_jax(name):
    jfn, tfn, keys = QUAT_CASES[name]
    x = _inputs(0)
    want = jax.vmap(jfn)(*(x[k] for k in keys))
    got = tfn(*(torch.tensor(x[k]) for k in keys))
    assert_close(name, got, want, OP_REL)


def _spd(n, bsz, seed):
    rng = np.random.RandomState(seed)
    a = rng.standard_normal((bsz, n, n))
    return a @ a.transpose(0, 2, 1) / n + np.eye(n)


# f32 factor/solve of matrices with cond ~ 10 against float64 np.linalg
LINALG_REL = 1e-5


@pytest.mark.parametrize("n", [23, 73])
def test_factor_matches_numpy(n):
    a = _spd(n, 3, n)
    got = tl.factor(torch.tensor(a, dtype=torch.float32))
    assert_close("L", got, np.linalg.cholesky(a), LINALG_REL)
    assert torch.equal(got, torch.tril(got))


@pytest.mark.parametrize("n", [23, 73])
def test_invert_diag_blocks_matches_numpy(n):
    l = np.linalg.cholesky(_spd(n, 3, n + 1))
    got = tl.invert_diag_blocks(torch.tensor(l, dtype=torch.float32)).numpy()
    for p0 in range(0, n, tl.PANEL):
        m = min(tl.PANEL, n - p0)
        want = np.linalg.inv(l[:, p0 : p0 + m, p0 : p0 + m])
        assert_close(f"panel {p0}", got[:, p0 : p0 + m, :m], want, LINALG_REL)
        assert not got[:, p0 : p0 + m, m:].any()


@pytest.mark.parametrize("n", [23, 73])
def test_blocked_substitution_pinv_matches_numpy(n):
    a = _spd(n, 3, n + 2)
    b = np.random.RandomState(n).standard_normal((3, n))
    l = tl.factor(torch.tensor(a, dtype=torch.float32))
    x = tl.blocked_substitution_pinv(l, tl.invert_diag_blocks(l), torch.tensor(b, dtype=torch.float32))
    assert_close("x", x, np.linalg.solve(a, b[..., None])[..., 0], LINALG_REL)
