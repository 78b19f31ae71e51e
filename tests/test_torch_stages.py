"""Each forward stage of the port (kinematics, com, tendon/actuation, crb,
collision, constraint, passive, rne, sensors) against the JAX package on
contact-rich rodent states. Every port stage reads the JAX forward's own
intermediate state, so each comparison isolates one stage."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import STAGE_REL, assert_close, contact_rich_states
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import sensors as jsens
from track_mjx_tpu.physics import solver as jsolver
from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
from track_mjx_tpu_torch.physics import actuation, collision, com, constraint, inertia
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import kinematics, passive, rne, sensors
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import solver as tsolver

torch.set_num_threads(1)
N_ENVS = 4


@pytest.fixture(scope="module")
def rodent_full_clips_model():
    return torch_parity.rodent_full_clips_model()


@pytest.fixture(scope="module")
def ref(rodent_full_clips_model):
    """JAX forward on 4 contact-rich states (one jit): final Data and efc."""
    m = rodent_full_clips_model
    jplan, jmodel = jm.put_model(m)
    qpos, qvel, ctrl, warm = contact_rich_states(m.nq, m.nv, m.nu, m.qpos0, N_ENVS, seed=3)
    act = np.random.RandomState(4).uniform(-0.5, 0.5, (N_ENVS, m.na)).astype(np.float32)

    def run(qpos, qvel, ctrl, act, warm):
        with jax.default_matmul_precision("highest"):
            d = jm.make_data(jplan, jmodel).replace(
                qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=warm
            )
            d, efc = jf.fwd_position(jplan, jmodel, d)
            d = jf.fwd_velocity(jplan, jmodel, d)
            d = jf.fwd_actuation(jplan, jmodel, d)
            d = jf.fwd_acceleration(jplan, jmodel, d)
            d = jsolver.solve(jplan, jmodel, d, efc)
            d = jsens.sensor(jplan, jmodel, d)
        return d, efc

    d, efc = jax.jit(jax.vmap(run))(qpos, qvel, ctrl, act, warm)
    data = {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(jm.Data)}
    efc = {
        k: np.asarray(getattr(efc, k))
        for k in ("J", "aref", "D", "pos", "active_row", "jb_sw", "jb_fq", "jb_ll", "jb_mu")
    }
    tf.set_full_f32()
    plan, model = tm.put_model(tm.load_snapshot(), device="cpu")
    return plan, model, data, efc


def _port_data(data):
    return tm.data_from_numpy(data, device="cpu")


def _check(name_fields, got, data):
    for f in name_fields:
        assert_close(f, getattr(got, f), data[f], STAGE_REL)


STAGES = {
    "kinematics": (
        kinematics.kinematics,
        ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
         "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"),
    ),
    "com_pos": (com.com_pos, ("subtree_com", "cinert", "cdof")),
    "tendon": (actuation.tendon, ("ten_length", "ten_velocity")),
    "crb": (inertia.crb, ("qM", "crb_buf")),
    "com_vel": (com.com_vel, ("cvel", "cdof_dot")),
    "passive": (passive.passive, ("qfrc_spring", "qfrc_damper", "qfrc_passive")),
    "rne": (rne.rne, ("qfrc_bias",)),
    "actuation": (
        actuation.actuation,
        ("actuator_length", "actuator_velocity", "actuator_force", "act_dot", "qfrc_actuator"),
    ),
    "sensors": (sensors.sensor, ("sensordata",)),
}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_stage_matches_jax(ref, stage):
    plan, model, data, _ = ref
    fn, fields = STAGES[stage]
    _check(fields, fn(plan, model, _port_data(data)), data)


def test_collision_matches_jax(ref):
    plan, model, data, _ = ref
    got, contact = collision.collide(plan, model, _port_data(data))
    _check(("contact_dist", "contact_pos", "contact_frame"), got, data)
    assert torch.equal(contact.dist, got.contact_dist)
    # the states are contact-rich: some contacts are active in every env
    assert (data["contact_dist"] < 0).any(axis=1).all()


def test_constraint_rows_match_jax(ref):
    plan, model, data, efc = ref
    d = _port_data(data)
    _, contact = collision.collide(plan, model, d)
    got = constraint.make_constraint(plan, model, d, contact)
    for name in ("aref", "D", "pos", "jb_sw", "jb_fq", "jb_ll"):
        assert_close(name, getattr(got, name), efc[name], STAGE_REL)
    np.testing.assert_array_equal(got.active_row.numpy(), efc["active_row"])
    np.testing.assert_array_equal(got.jb_mu.numpy(), efc["jb_mu"][0])
    # the dense J rebuilt from the compact operands equals JAX's dense rows
    dm, lim1h = (torch.tensor(t, dtype=torch.float32) for t in tsolver._jb_static(plan))
    j = tk.build_j(got.jb_fq, got.jb_sw, got.jb_ll, got.jb_mu, dm, lim1h)
    assert_close("J", j, efc["J"], STAGE_REL)
    assert np.abs(efc["J"][:, plan.nlimit:]).max() > 0  # active pyramid rows


def test_fwd_acceleration_matches_jax(ref):
    plan, model, data, _ = ref
    got = tf.fwd_acceleration(plan, model, _port_data(data))
    assert_close("qfrc_smooth", got.qfrc_smooth, data["qfrc_smooth"], STAGE_REL)
