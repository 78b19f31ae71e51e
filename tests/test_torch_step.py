"""One physics step and one control step (n_step, 10 substeps) of the port
against the JAX package from identical states and controls.

The rodent under contact is chaotic at f32 roundoff: from the dropped,
perturbed states of the other parity tests, a 1e-6 relative change of qvel
alone moves the JAX package's own state by order 1 within 10 substeps. So
this test starts from a gentle state (feet just touching, small joint
offsets, velocities and controls) where JAX's own sensitivity stays near
1e-5 over 10 substeps, and contacts still become active in every env."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import assert_close
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
N_ENVS = 4
N_SUB = 10


@pytest.fixture(scope="module")
def ref():
    m = torch_parity.rodent_full_clips_model()
    jplan, jmodel = jm.put_model(m)
    rng = np.random.RandomState(11)
    qpos = np.tile(m.qpos0, (N_ENVS, 1))
    qpos[:, 2] -= rng.uniform(0.0015, 0.003, N_ENVS)
    qpos[:, 7:] += rng.uniform(-0.01, 0.01, (N_ENVS, m.nq - 7))
    qvel = rng.uniform(-0.05, 0.05, (N_ENVS, m.nv))
    ctrl = rng.uniform(-0.005, 0.005, (N_ENVS, m.nu))
    act = rng.uniform(-0.005, 0.005, (N_ENVS, m.na))
    start = {
        k: np.asarray(v, np.float32)
        for k, v in dict(
            qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=np.zeros((N_ENVS, m.nv))
        ).items()
    }

    def run(qpos, qvel, ctrl, act, warm):
        d = jm.make_data(jplan, jmodel).replace(
            qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=warm
        )
        return jf.step(jplan, jmodel, d), jf.n_step(jplan, jmodel, d, N_SUB)

    one, many = jax.jit(jax.vmap(run))(*(start[k] for k in ("qpos", "qvel", "ctrl", "act", "qacc_warmstart")))
    as_np = lambda d: {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
    return start, as_np(one), as_np(many)


def _port_run(start, n):
    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot(), device="cpu")
    data = tm.make_data(plan, model, N_ENVS).replace(
        **{k: torch.tensor(v) for k, v in start.items()}
    )
    return tf.step(plan, model, data) if n == 1 else tf.n_step(plan, model, data, n)


# Measured on these states (rel. to max(1, max |ref|)): largest error 6e-6
# after one substep (qacc) and 5e-5 after ten (qvel), the same size as the
# JAX package's own response to a 1e-6 change of qvel. Bars leave 15x.
STATE = ("qpos", "qvel", "act", "time", "qacc_warmstart")
DERIVED = ("qacc", "qacc_smooth", "qfrc_constraint", "efc_force", "sensordata", "xpos", "cvel")
BARS = {1: 1e-4, N_SUB: 1e-3}


@pytest.mark.parametrize("n", [1, N_SUB])
def test_step_matches_jax(ref, n):
    start, one, many = ref
    want = one if n == 1 else many
    got = _port_run(start, n)
    for name in STATE + DERIVED:
        assert_close(f"{name} after {n}", getattr(got, name), want[name], BARS[n])
    assert np.isfinite(want["qpos"]).all()
    if n == N_SUB:  # contacts and constraint forces act in every env
        assert (want["contact_dist"] < 0).any(axis=1).all()
        assert (want["efc_force"] != 0).any(axis=1).all()


def test_slim_round_trip():
    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot(), device="cpu")
    data = tm.make_data(plan, model, 2)
    data = data.replace(qvel=torch.ones_like(data.qvel), qM=torch.ones_like(data.qM))
    full = tf.expand_slim(plan, model, tf.slim_data(data))
    for name in tf._CARRY_FIELDS:
        assert torch.equal(getattr(full, name), getattr(data, name)), name
    assert not full.qM.any()  # derived stages start zeroed
