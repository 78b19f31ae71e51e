"""The walker's observation helpers and the tracking reward of the port
against the JAX package's under jax.vmap, with no physics: the same random
qpos, qvel, xpos, qfrc_actuator, reference frames and windows, actions and
action ring buffers (buffer_index 0, mid-window and W-1) go into both.

Walkers: the rodent (the port's from the snapshot's index tables, the JAX
package's resolved by name with MuJoCo) and the toy walker of
track_mjx_tpu.testing, whose last body id runs past the end of xpos[1:]
(jnp clamps that index; the port must read the same entry)."""

import collections

import jax
import jax.numpy as jp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import near_threshold, per_env_rel, port_reward_config, port_walker
from track_mjx_tpu.envs.task import reward as jr
from track_mjx_tpu.io.load import ReferenceClip as JClip
from track_mjx_tpu.testing import ToyWalker, toy_reward_config
from track_mjx_tpu.utils.config import load_config
from track_mjx_tpu_torch.envs.task import reward as tr
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.io.load import ReferenceClip
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
B = 12
L = 5  # traj_length
# The helpers and the reward are the same float32 formulas in both
# packages; only the order of sums differs. Measured up to 6.6e-7 (per env,
# relative to max(1, max |JAX|)).
REL = 1e-5
FLAGS = {"too_far": "too_far_dist", "bad_pose": "bad_pose_dist", "bad_quat": "bad_quat_dist"}

Data = collections.namedtuple("Data", "qpos qvel xpos qfrc_actuator")


@pytest.fixture(scope="module")
def walkers():
    rodent = torch_parity.load_export_tool().workload_walker("rodent-full-clips")
    toy = ToyWalker()
    rw = dict(load_config("rodent-full-clips").env_config.reward_weights)
    return {
        "rodent": (rodent, Rodent.from_snapshot(tm.load_snapshot("rodent-full-clips")), jr.RewardConfig(**rw)),
        "toy": (toy, port_walker(toy), toy_reward_config()),
    }


def _inputs(m, seed: int, window: int):
    """Random states near random reference frames, with per-env distance
    scales spread over two decades so that every flag takes both values."""
    rng = np.random.RandomState(seed)
    nq, nv, nb, nu = m.nq, m.nv, m.nbody, m.nu
    scale = np.logspace(-3, 0, B)[:, None]
    qpos = np.tile(m.qpos0, (B, 1)) + 0.3 * rng.uniform(-1, 1, (B, nq))
    qpos[:, 3:7] = rng.normal(size=(B, 4))
    qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=1, keepdims=True)
    # the last env's reference is the root quaternion turned by pi about x:
    # the largest bounded distance, over every walker's bad_quat threshold
    quat = qpos[:, 3:7] + 3 * scale * rng.normal(size=(B, 4))
    quat[-1] = [-qpos[-1, 4], qpos[-1, 3], qpos[-1, 6], -qpos[-1, 5]]
    ref = {
        "position": qpos[:, :3] + scale * rng.normal(size=(B, 3)),
        "quaternion": quat / np.linalg.norm(quat, axis=1, keepdims=True),
        "joints": qpos[:, 7:] + 5 * scale * rng.normal(size=(B, nq - 7)),
        "body_positions": rng.uniform(-0.3, 0.3, (B, nb - 1, 3)),
        "velocity": rng.normal(size=(B, 3)),
        "angular_velocity": rng.normal(size=(B, 3)),
        "joints_velocity": rng.normal(size=(B, nv - 6)),
        "body_quaternions": rng.normal(size=(B, nb - 1, 4)),
    }
    xpos = rng.uniform(-0.3, 0.3, (B, nb, 3))
    xpos[:, 1:] = ref["body_positions"] + 0.05 * scale[:, :, None] * rng.normal(size=(B, nb - 1, 3))
    xpos[:, :, 2] += rng.uniform(-0.05, 0.6, (B, 1))  # torso heights in and out of range
    data = Data(qpos, rng.normal(size=(B, nv)), xpos, 5 * rng.normal(size=(B, nv)))
    traj = {
        "position": qpos[:, None, :3] + 0.1 * rng.normal(size=(B, L, 3)),
        "quaternion": rng.normal(size=(B, L, 4)),
        "joints": rng.normal(size=(B, L, nq - 7)),
        "body_positions": rng.uniform(-0.3, 0.3, (B, L, nb - 1, 3)),
    }
    info = {
        "action_buffer": rng.uniform(-1, 1, (B, window, nu)),
        "buffer_index": np.array([0, window // 2, window - 1] * (B // 3)),
        "prev_ctrl": rng.uniform(-1, 1, (B, nu)),
    }
    action = rng.uniform(-1, 1, (B, nu))
    f32 = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}
    return (
        Data(*(np.asarray(a, np.float32) for a in data)),
        f32(ref),
        f32(traj),
        {**f32(info), "buffer_index": info["buffer_index"].astype(np.int32)},
        np.asarray(action, np.float32),
    )


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_t(v) for v in tree))
    a = np.asarray(tree)
    return torch.as_tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("name", ["rodent", "toy"])
def test_obs_helpers_match_jax(walkers, name, quirk):
    jw, tw, _ = walkers[name]
    jw.reproduce_joint_index_quirk = tw.reproduce_joint_index_quirk = quirk
    try:
        data, _, traj, _, _ = _inputs(jw._mj_model, seed=1, window=10)
        cases = {
            "track_positions": (
                jax.vmap(jw.compute_local_track_positions)(traj["position"], data.qpos),
                tw.compute_local_track_positions(_t(traj["position"]), _t(data.qpos)),
            ),
            "quat_distances": (
                jax.vmap(jw.compute_quat_distances)(traj["quaternion"], data.qpos),
                tw.compute_quat_distances(_t(traj["quaternion"]), _t(data.qpos)),
            ),
            "joint_distances": (
                jax.vmap(jw.compute_local_joint_distances)(traj["joints"], data.qpos),
                tw.compute_local_joint_distances(_t(traj["joints"]), _t(data.qpos)),
            ),
            "body_positions": (
                jax.vmap(jw.compute_local_body_positions)(
                    traj["body_positions"], data.xpos[:, 1:], data.qpos
                ),
                tw.compute_local_body_positions(
                    _t(traj["body_positions"]), _t(data.xpos[:, 1:]), _t(data.qpos)
                ),
            ),
        }
    finally:
        jw.reproduce_joint_index_quirk = tw.reproduce_joint_index_quirk = True
    for what, (want, got) in cases.items():
        assert got.shape == want.shape, what
        err = per_env_rel(got, want).max()
        assert err < REL, f"{name} {what}: {err:.3e}"
    # the quirk moves the joint distances; the last body id runs past xpos[1:]
    assert int(tw.body_idxs.max()) == jw._mj_model.nbody - 1


@pytest.mark.parametrize("name", ["rodent", "toy"])
def test_tracking_rewards_match_jax(walkers, name):
    jw, tw, jrc = walkers[name]
    data, ref, _, info, action = _inputs(jw._mj_model, seed=2, window=jrc.var_window_size)
    frame = JClip(**{k: jp.asarray(v) for k, v in ref.items()})

    def jax_rewards(d, f, a, i):
        return jr.compute_tracking_rewards(d, f, jw, a, i, jrc)

    want = jax.vmap(jax_rewards)(data, frame, action, info)
    got = tr.compute_tracking_rewards(
        _t(data), ReferenceClip(**_t(ref)), tw, _t(action), _t(info), port_reward_config(jrc)
    )
    names = [
        "pos_reward", "quat_reward", "joint_reward", "angvel_reward", "bodypos_reward",
        "endeff_reward", "ctrl_cost", "ctrl_diff_cost", "energy_cost", "too_far", "bad_pose",
        "bad_quat", "fall", "joint_distance", "summed_pos_distance", "quat_distance",
        "var_cost", "jerk_cost",
    ]
    assert len(got) == len(want) == 18
    out = dict(zip(names, got))
    ref_out = {k: np.asarray(v) for k, v in zip(names, want)}
    for k in names:
        assert out[k].shape == (B,), k
    # flags equal except where the distance sits within FLAG_MARGIN of the
    # threshold; on these inputs that exempts no env
    dist = {"too_far": "summed_pos_distance", "bad_pose": "joint_distance", "bad_quat": "quat_distance"}
    for flag, thr in FLAGS.items():
        exempt = near_threshold(ref_out[dist[flag]], getattr(jrc, thr))
        assert exempt.sum() == 0, flag
        np.testing.assert_array_equal(out[flag].numpy()[~exempt], ref_out[flag][~exempt], err_msg=flag)
        assert 0 < ref_out[flag].sum() < B, f"{flag} takes one value on every env"
    np.testing.assert_array_equal(out["fall"].numpy(), ref_out["fall"])
    assert 0 < ref_out["fall"].sum() < B
    for k in names:
        if k in FLAGS or k == "fall":
            continue
        err = per_env_rel(out[k], ref_out[k]).max()
        assert err < REL, f"{name} {k}: {err:.3e}"
    # the reward terms are not all saturated at 0 or at their weight
    for k in ("pos_reward", "quat_reward", "joint_reward", "endeff_reward"):
        assert np.ptp(ref_out[k]) > 1e-3, k


def test_bounded_quat_dist_leaves_its_inputs():
    """The reference's `source /= norm` makes a new array in JAX; the port
    must not divide the caller's qpos slice in place."""
    q = torch.tensor([[2.0, 0.0, 0.0, 0.0], [0.0, 3.0, 0.0, 0.0]])
    qpos = torch.cat([torch.zeros(2, 3), q, torch.zeros(2, 2)], dim=1)
    before = qpos.clone()
    d = tr.bounded_quat_dist(qpos[:, 3:7], torch.tensor([[1.0, 0.0, 0.0, 0.0]] * 2))
    assert torch.equal(qpos, before)
    want = jr.bounded_quat_dist(jp.asarray(before[:, 3:7].numpy()), jp.asarray([[1.0, 0, 0, 0]] * 2))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-6)
