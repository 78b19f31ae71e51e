"""The port's per-body contact wrenches (physics/postconstraint.cfrc_ext)
against the JAX package's and MuJoCo C's.

cfrc_ext is a pure function of a Data (contact distances, positions and
frames, efc_force, subtree_com), so the port and the JAX package are held
on the same Data: the port's forward on the CPU from seeded numpy states,
its outputs fed to both functions. Bar: 1e-5 of the largest wrench (float32
roundoff of a few products and sums; the two packages sum a body's contacts
in different orders). Against MuJoCo C (float64, its own forward) the bars
are the JAX package's own: rel 2e-3 on the pyramidal rodent
(tests/test_physics_parity.py:177-197), 2e-2 on the elliptic fly
(tests/test_fly.py:130-156), 5e-3 x scale on the condim-4/6 probe
(tests/test_physics_parity.py:483-503).
"""

import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import torch_parity
from test_physics_parity import CONDIM_XML
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import postconstraint as jpost
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.physics import postconstraint as tpost

PORT_VS_JAX = 1e-5
FIELDS = ("contact_dist", "contact_pos", "contact_frame", "efc_force", "subtree_com")


def _port_forward(m, qpos, qvel, ctrl):
    """The port's plan, model and forward Data of the states [B, ...] (CPU)."""
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    data = tm.make_data(plan, model, qpos.shape[0])
    data = data.replace(**{k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
                           (("qpos", qpos), ("qvel", qvel), ("ctrl", ctrl))})
    return plan, model, tf.forward(plan, model, data)


def _jax_cfrc(m, data):
    """The JAX package's cfrc_ext of the port's Data, vmapped over envs."""
    plan, model = jm.put_model(m)
    base = jm.make_data(plan, model)

    def one(qpos, dist, pos, frame, force, com):
        d = base.replace(qpos=qpos, contact_dist=dist, contact_pos=pos, contact_frame=frame, efc_force=force,
                         subtree_com=com)
        return jpost.cfrc_ext(plan, model, d)

    args = [jnp.asarray(data.qpos.numpy())] + [jnp.asarray(getattr(data, f).numpy()) for f in FIELDS]
    return np.asarray(jax.vmap(one)(*args))


def _c_cfrc(m, qpos, qvel, ctrl):
    """MuJoCo C's cfrc_ext (float64) and contact count per state."""
    out, ncon = [], []
    d = mujoco.MjData(m)
    for q, v, c in zip(qpos, qvel, ctrl):
        d.qpos[:], d.qvel[:] = q, v
        if m.nu:
            d.ctrl[:] = c
        mujoco.mj_forward(m, d)
        mujoco.mj_rnePostConstraint(m, d)
        out.append(d.cfrc_ext.copy())
        ncon.append(d.ncon)
    return np.stack(out), np.array(ncon)


def _random_state(m, seed, drop, joint_scale):
    """tests/test_physics_parity.py's contact-rich rodent state."""
    rng = np.random.RandomState(seed)
    qpos = m.qpos0.copy()
    qpos[2] -= drop
    qpos[7:] += rng.uniform(-joint_scale, joint_scale, m.nq - 7)
    return qpos, rng.uniform(-0.5, 0.5, m.nv), rng.uniform(-0.5, 0.5, m.nu)


@pytest.fixture(scope="module")
def rodent():
    """rodent.xml as tests/test_physics_parity.py compiles it (its own
    solver options: the comparison with C needs a converged solve)."""
    from track_mjx_tpu.envs.walker.base import DEFAULT_ASSET_ROOT

    m = mujoco.MjModel.from_xml_path(os.path.join(DEFAULT_ASSET_ROOT, "rodent", "rodent.xml"))
    states = [_random_state(m, seed, 0.012, 0.05) for seed in (1, 2, 3)]
    qpos, qvel, ctrl = (np.stack(x) for x in zip(*states))
    return m, qpos, qvel, ctrl


def _check(m, qpos, qvel, ctrl, c_bar, c_scaled=False):
    plan, model, data = _port_forward(m, qpos, qvel, ctrl)
    got = tpost.cfrc_ext(plan, model, data).numpy()
    assert got.shape == (qpos.shape[0], m.nbody, 6)
    want = _jax_cfrc(m, data)
    assert np.abs(want).max() > 0, "the states must carry contact wrenches"
    torch_parity.assert_close("cfrc_ext, port against JAX on the same Data", got, want, PORT_VS_JAX)
    assert not got[:, 0].any(), "the world body must stay zero"
    c, ncon = _c_cfrc(m, qpos, qvel, ctrl)
    assert (ncon > 0).all()
    for k in range(qpos.shape[0]):
        if c_scaled:
            scale = max(1.0, np.abs(c[k]).max())
            np.testing.assert_allclose(got[k], c[k], atol=c_bar * scale, err_msg=f"cfrc_ext env {k}")
        else:
            torch_parity.assert_close(f"cfrc_ext env {k} against MuJoCo C", got[k], c[k], c_bar)
    return got


def test_cfrc_ext_rodent_pyramidal(rodent):
    m, qpos, qvel, ctrl = rodent
    got = _check(m, qpos, qvel, ctrl, 2e-3)
    # the feet push on the floor: upward force on the bodies in contact
    assert (got[..., 5] > 0).any()


def test_cfrc_ext_fly_elliptic():
    """tests/test_fly.py's fly (fruitfly_force_fast.xml, CG 30/15) at its
    state, seed 0. The fly's elliptic solve is a knife edge in float32
    (PERF.md): on other draws the port's forward, like the JAX one, can part
    from C's by more than the bar, while its cfrc_ext stays within
    PORT_VS_JAX of the JAX function's on the same Data."""
    from test_fly import _rand_state
    from track_mjx_tpu.envs.walker.base import DEFAULT_ASSET_ROOT
    from track_mjx_tpu.envs.walker.fly import ensure_fly_assets

    m = mujoco.MjModel.from_xml_path(ensure_fly_assets(DEFAULT_ASSET_ROOT) + "/fruitfly_force_fast.xml")
    m.opt.solver, m.opt.iterations, m.opt.ls_iterations, m.opt.jacobian = 1, 30, 15, 0
    qpos, qvel, ctrl = (x[None] for x in _rand_state(m, 0, qvel_scale=10.0))
    _check(m, qpos, qvel, ctrl, 2e-2)


def test_cfrc_ext_condim_4_6_torsion():
    """Torsional and rolling moments of condim-4/6 contacts (the balls of
    test_physics_parity's probe spinning and rolling on the plane)."""
    m = mujoco.MjModel.from_xml_string(CONDIM_XML)
    rng = np.random.RandomState(4)
    qpos = np.tile(m.qpos0, (3, 1))
    qvel = np.zeros((3, m.nv))
    qvel[0, 3:6] = [0.0, 0.0, 6.0]
    qvel[1, 3:6], qvel[1, 0], qvel[1, 9:12] = [1.0, 0.0, 6.0], 0.5, [0.0, 0.0, 8.0]
    qvel[2] = rng.uniform(-3.0, 3.0, m.nv)
    got = _check(m, qpos, qvel, np.zeros((3, 0)), 5e-3, c_scaled=True)
    # a spin about the normal shows as a torque about z beyond the force's moment
    assert np.abs(got[0, :, 2]).max() > 0


def test_cfrc_ext_without_contacts_is_zero():
    m = mujoco.MjModel.from_xml_string(CONDIM_XML.replace('contype="1"', 'contype="0"'))
    tf.set_full_f32()
    plan, model = tm.put_model(m, device="cpu")
    data = tf.forward(plan, model, tm.make_data(plan, model, 2))
    out = tpost.cfrc_ext(plan, model, data)
    assert out.shape == (2, m.nbody, 6) and not out.any()
