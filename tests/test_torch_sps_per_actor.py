"""The port on the repo's third workload, rodent-sps-per-actor: the rodent
with position actuators at scale 0.8, CG 4/4, 5 substeps a control step,
held against the JAX package and MuJoCo C, and its tiny CPU CLI run.

- the snapshot and its config equal a fresh export;
- the position servos (gain FIXED, bias AFFINE, FILTER dynamics of tau
  0.04 on act, na 38): actuator force, qfrc_actuator and act_dot against
  the JAX package's actuation and against MuJoCo C's mj_forward, and the
  activations after a control step against MuJoCo C's Euler integration;
- one control step (n_step, 5 substeps, CG 4/4) against the JAX package from
  gentle states, as tests/test_torch_step.py does for rodent-full-clips;
- one env step under this config's reward weights against the JAX env, on
  the JAX physics output (the port's step and the JAX step are both handed
  the JAX n_step of the reset state, as tests/test_torch_rodent_env.py
  holds the env layer). Both resets run on the port's forward of the same
  reset pose, so that one JAX jit of n_step serves both physics tests;
- the repairs: a walker_config that the snapshot was not exported with
  raises, and a reward config without energy_cost_weight gets 0.0 (where
  the JAX CLI raises a TypeError);
- `python -m track_mjx_tpu_torch.train --config-name rodent-sps-per-actor
  device=cpu` at a tiny size, with eval_every // reset_every = 0.
"""

import dataclasses
import json
import os

import jax
import mujoco
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (
    STAGE_REL,
    assert_close,
    assert_state_close,
    jax_reset_draws,
    port_clip,
    port_reward_config,
    to_torch,
)
from track_mjx_tpu.envs.task.reward import RewardConfig as JaxRewardConfig
from track_mjx_tpu.envs.task.tracking import MultiClipTracking as JaxMultiClip
from track_mjx_tpu.io.synthetic import synthesize_clips
from track_mjx_tpu.physics import actuation as ja
from track_mjx_tpu.physics import forward as jf
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.utils.config import load_config as jax_load_config
from track_mjx_tpu_torch import train, workload
from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.physics import actuation as ta
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
NAME = "rodent-sps-per-actor"
B = 4
N_SUB = 5
CLIP = dict(clip_length=60, random_init_range=5, traj_length=5)
# The control step from gentle states: test_torch_step.py's bar for 10
# substeps; measured here up to 3.0e-5 (qfrc_constraint) after five.
STEP_REL = 1e-3
# Against MuJoCo C (float64): the port's float32 products of lengths and
# velocities with the gains; measured up to 7.0e-8 (qfrc_actuator), against
# the JAX package up to 7.6e-8 (act_dot, bar STAGE_REL), and the activations
# after a control step 7.7e-9 from MuJoCo C's (bar 1e-6).
C_REL = 1e-5
# The env layer on identical physics (test_torch_rodent_env.py's bars).
RESET_REL = 1e-6
LAYER_REL = 1e-5


@pytest.fixture(scope="module")
def export_tool():
    return torch_parity.load_export_tool()


@pytest.fixture(scope="module")
def jwalker(export_tool):
    return export_tool.workload_walker(NAME)


@pytest.fixture(scope="module")
def jenv(jwalker):
    """The JAX package's env of this config: its env_args, and its reward
    weights with the backfilled energy_cost_weight."""
    cfg = jax_load_config(NAME)
    clips = synthesize_clips(jwalker._mj_model, n_clips=2, n_frames=CLIP["clip_length"], mocap_hz=50)
    weights = {"energy_cost_weight": 0.0, **dict(cfg.env_config.reward_weights)}
    return JaxMultiClip(clips, jwalker, JaxRewardConfig(**weights), **dict(cfg.env_config.env_args), **CLIP)


@pytest.fixture(scope="module")
def jax_n_step(jenv):
    """One jitted control step of the JAX package, [B] envs from their carry
    fields."""

    def run(qpos, qvel, ctrl, act, warm):
        d = jm.make_data(jenv.plan, jenv.model).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=warm)
        return jf.n_step(jenv.plan, jenv.model, d, N_SUB)

    return jax.jit(jax.vmap(run))


def _as_np(d) -> dict:
    return {f.name: np.asarray(getattr(d, f.name)) for f in dataclasses.fields(d)}


def _port_system():
    tf.set_full_f32()
    return tm.put_model(tm.load_snapshot(NAME), device="cpu")


def test_snapshot_equals_fresh_export(export_tool, jwalker):
    fresh = {**export_tool.snapshot_arrays(jwalker._mj_model), **export_tool.walker_arrays(jwalker)}
    with np.load(tm.SNAPSHOTS[NAME]) as z:
        assert sorted(z.files) == sorted(fresh)
        for name, arr in fresh.items():
            assert z[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(z[name], arr, err_msg=name)
    with open(os.path.splitext(tm.SNAPSHOTS[NAME])[0] + ".json") as f:
        exported = json.load(f)
    assert exported == export_tool.config_sections(NAME)
    assert exported["walker_config"]["torque_actuators"] is False
    assert exported["walker_config"]["rescale_factor"] == 0.8
    plan, model = _port_system()
    assert (plan.nq, plan.nv, plan.nu, plan.na, plan.ngeom) == (74, 73, 38, 38, 101)
    assert (plan.ncon, plan.nlimit, plan.nefc) == (30, 67, 187)
    assert (plan.solver, plan.integrator, plan.cone) == (tm.SOLVER_CG, tm.INT_EULER, tm.CONE_PYRAMIDAL)
    assert (plan.iterations, plan.ls_iterations) == (4, 4)
    # position servos: fixed gain kp, affine bias (b0, -kp, 0), filter dynamics tau 0.04
    assert (plan.actuator_gaintype == tm.GAIN_FIXED).all() and (plan.actuator_biastype == tm.BIAS_AFFINE).all()
    assert (plan.actuator_dyntype == tm.DYN_FILTER).all()
    assert (model.actuator_gainprm[:, 0] > 0).all() and (model.actuator_biasprm[:, 1] < 0).all()
    np.testing.assert_allclose(model.actuator_dynprm[:, 0].numpy(), 0.04)
    assert not (model.actuator_forcelimited > 0).any()


def _servo_states(m, seed: int = 3):
    """Random joint poses and velocities, controls past the [-1, 1] range
    (the clamp) and activations: float32 numpy arrays [B, ...]."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0, (B, 1))
    qpos[:, 7:] += rng.uniform(-0.3, 0.3, (B, m.nq - 7))
    qvel = rng.uniform(-0.5, 0.5, (B, m.nv))
    ctrl = rng.uniform(-1.2, 1.2, (B, m.nu))
    act = rng.uniform(-1.0, 1.0, (B, m.na))
    return tuple(np.asarray(a, np.float32) for a in (qpos, qvel, ctrl, act))


def test_position_servos_match_jax_and_mujoco(jwalker, jenv):
    m = jwalker._mj_model
    qpos, qvel, ctrl, act = _servo_states(m)
    plan, model = _port_system()
    data = tm.make_data(plan, model, B).replace(
        **{k: torch.tensor(v) for k, v in dict(qpos=qpos, qvel=qvel, ctrl=ctrl, act=act).items()}
    )
    got = ta.actuation(plan, model, ta.tendon(plan, model, data))

    def run(qpos, qvel, ctrl, act):
        d = jm.make_data(jenv.plan, jenv.model).replace(qpos=qpos, qvel=qvel, ctrl=ctrl, act=act)
        return ja.actuation(jenv.plan, jenv.model, ja.tendon(jenv.plan, jenv.model, d))

    want = _as_np(jax.jit(jax.vmap(run))(qpos, qvel, ctrl, act))
    fields = ("actuator_length", "actuator_velocity", "actuator_force", "act_dot", "qfrc_actuator")
    for name in fields:
        assert_close(f"{name} against JAX", getattr(got, name), want[name], STAGE_REL)

    c = {name: [] for name in fields}
    for i in range(B):
        d = mujoco.MjData(m)
        d.qpos[:], d.qvel[:], d.ctrl[:], d.act[:] = qpos[i], qvel[i], ctrl[i], act[i]
        mujoco.mj_forward(m, d)
        for name in fields:
            c[name].append(np.array(getattr(d, name)))
    for name in fields:
        assert_close(f"{name} against MuJoCo C", getattr(got, name), np.stack(c[name]), C_REL)
    # the affine bias acts: the force is not gain x act alone
    gain = model.actuator_gainprm[:, 0]
    assert (got.actuator_force - gain * got.act).abs().max() > 1.0


def _gentle_start(m, seed: int = 11):
    """Feet just touching, small joint offsets, velocities, controls and
    activations (test_torch_step.py's states), float32 [B, ...]."""
    rng = np.random.RandomState(seed)
    qpos = np.tile(m.qpos0, (B, 1))
    qpos[:, 2] -= rng.uniform(0.0015, 0.003, B)
    qpos[:, 7:] += rng.uniform(-0.01, 0.01, (B, m.nq - 7))
    qvel = rng.uniform(-0.05, 0.05, (B, m.nv))
    ctrl = rng.uniform(-0.3, 0.3, (B, m.nu))
    act = rng.uniform(-0.005, 0.005, (B, m.na))
    return {
        k: np.asarray(v, np.float32)
        for k, v in dict(qpos=qpos, qvel=qvel, ctrl=ctrl, act=act, qacc_warmstart=np.zeros((B, m.nv))).items()
    }


STATE = ("qpos", "qvel", "act", "time", "qacc_warmstart")
DERIVED = ("qacc", "qacc_smooth", "qfrc_constraint", "efc_force", "actuator_force", "qfrc_actuator", "xpos", "cvel")


def test_control_step_matches_jax_and_mujoco_act(jwalker, jax_n_step):
    m = jwalker._mj_model
    start = _gentle_start(m)
    want = _as_np(jax_n_step(*(start[k] for k in ("qpos", "qvel", "ctrl", "act", "qacc_warmstart"))))
    plan, model = _port_system()
    data = tm.make_data(plan, model, B).replace(**{k: torch.tensor(v) for k, v in start.items()})
    got = tf.n_step(plan, model, data, N_SUB)
    for name in STATE + DERIVED:
        assert_close(f"{name} after {N_SUB}", getattr(got, name), want[name], STEP_REL)
    assert np.isfinite(want["qpos"]).all()
    assert (want["contact_dist"] < 0).any(axis=1).all()  # contacts act in every env
    assert (want["efc_force"] != 0).any(axis=1).all()
    # the activations: MuJoCo C's Euler, act += dt (ctrl - act) / tau, 5 times
    for i in range(B):
        d = mujoco.MjData(m)
        d.qpos[:], d.qvel[:], d.ctrl[:], d.act[:] = (start[k][i] for k in ("qpos", "qvel", "ctrl", "act"))
        for _ in range(N_SUB):
            mujoco.mj_step(m, d)
        assert_close(f"act of env {i} against MuJoCo C", got.act[i], d.act, 1e-6)
    assert (got.act - torch.tensor(start["act"])).abs().max() > 1e-3  # the filter moved them


def test_env_step_on_jax_physics(jenv, jax_n_step):
    """Reset and one env step of the port's env (workload.make_env on this
    config) against the JAX env, both on the same physics: the port's
    forward of the reset pose, then the JAX n_step of it."""
    cfg = tconfig.load_config(NAME, [f"reference_config.{k}={v}" for k, v in CLIP.items()])
    tenv = workload.make_env(cfg, port_clip(jenv._reference_clips), device="cpu")
    _assert_same_rewards(tenv._reward_config, jenv._reward_config)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    draws = jax_reset_draws(jenv, keys, cfg.env_config.env_args.reset_noise_scale)
    start, clip, qn, vn = (torch.as_tensor(np.array(d)) for d in draws)
    treset = tenv.reset_from_clip(start.long(), qn, vn, clip_idx=clip.long())
    jdata0 = jm.Data(**{k: np.asarray(v.numpy()) for k, v in _as_np_torch(treset.pipeline_state).items()})

    def reset_on(key, data):
        # the JAX reset's own pose on the port's forward of it
        jenv.pipeline_init = lambda qpos, qvel: data.replace(qpos=qpos, qvel=qvel)
        try:
            return jenv.reset(key)
        finally:
            del jenv.pipeline_init

    jreset = jax.jit(jax.vmap(reset_on))(keys, jdata0)
    for name in ("qpos", "qvel"):
        assert_close(f"reset {name}", getattr(treset.pipeline_state, name), np.asarray(getattr(jreset.pipeline_state,
                     name)), RESET_REL)
    assert_state_close(treset, jreset, RESET_REL, "reset", frame_rel=RESET_REL)

    action = np.asarray(0.2 * np.random.RandomState(5).uniform(-1, 1, (B, 38)), np.float32)
    d0 = jreset.pipeline_state
    jdata1 = jax_n_step(d0.qpos, d0.qvel, action, d0.act, d0.qacc_warmstart)

    def step_on(state, a, data):
        jenv.pipeline_step = lambda data0, ctrl: data
        try:
            return jenv.step(state, a)
        finally:
            del jenv.pipeline_step

    jstep = jax.jit(jax.vmap(step_on))(jreset, action, jdata1)
    tenv.pipeline_step = lambda data, ctrl: to_torch(jdata1)
    try:
        tstep = tenv.step(treset, torch.tensor(action))
    finally:
        del tenv.pipeline_step
    assert_state_close(tstep, jstep, LAYER_REL, "step", reward_config=jenv._reward_config)
    assert np.isfinite(np.asarray(jstep.reward)).all()
    # this config's terms: the end effectors weigh in, the energy term does not
    assert (np.asarray(jstep.metrics["endeff_reward"]) > 0).all()
    np.testing.assert_array_equal(tstep.metrics["energy_cost"].numpy(), 0.0)


def _assert_same_rewards(got, jax_config):
    """The port's RewardConfig holds the JAX one's values (the JAX one keeps
    penalty_pos_distance_scale as a float32 array)."""
    want = dataclasses.asdict(port_reward_config(jax_config))
    got = dataclasses.asdict(got)
    np.testing.assert_allclose(got.pop("penalty_pos_distance_scale"), want.pop("penalty_pos_distance_scale"), rtol=1e-7)
    assert got == want


def _as_np_torch(data) -> dict:
    return {f.name: getattr(data, f.name) for f in dataclasses.fields(data)}


def test_walker_config_override_raises(tmp_path):
    """The repair: the snapshot follows the config's name, and a
    walker_config it was not exported with raises before anything trains."""
    torque_off = tconfig.load_config("rodent-full-clips", ["walker_config.torque_actuators=false", "device=cpu"])
    with pytest.raises(ValueError, match="torque_actuators"):
        workload.make_walker(torque_off)
    with pytest.raises(ValueError, match="torque_actuators"):
        train.main(torque_off)
    nameless = tconfig.load_config(NAME)
    del nameless[tconfig.CONFIG_NAME]
    with pytest.raises(ValueError, match=tconfig.CONFIG_NAME):
        workload.make_walker(nameless)
    servo = workload.make_walker(tconfig.load_config(NAME))._mj_model
    torque = workload.make_walker(tconfig.load_config("rodent-full-clips"))._mj_model
    assert (servo.actuator_biastype == tm.BIAS_AFFINE).all() and (torque.actuator_biastype == tm.BIAS_NONE).all()
    assert not np.array_equal(servo.body_pos, torque.body_pos)  # 0.8 and 0.9 scale


def test_reward_backfill():
    cfg = tconfig.load_config(NAME)
    weights = dict(cfg.env_config.reward_weights)
    assert "energy_cost_weight" not in weights
    with pytest.raises(TypeError, match="energy_cost_weight"):  # the JAX CLI's fault (ROADMAP Queue 3)
        JaxRewardConfig(**weights)
    got = workload.reward_config(cfg)
    want = JaxRewardConfig(**{"energy_cost_weight": 0.0, **weights})  # the reference's own backfill
    _assert_same_rewards(got, want)
    assert got.energy_cost_weight == 0.0 and got.penalty_pos_distance_scale == (1.0, 1.0, 0.2)
    assert got.endeff_reward_weight == 1.0
    assert (got.var_window_size, got.var_coeff, got.jerk_coeff) == (want.var_window_size, want.var_coeff,
                                                                   want.jerk_coeff)
    # a config that sets it keeps its own
    assert workload.reward_config(tconfig.load_config("rodent-full-clips")).energy_cost_weight == 0.01


TINY = [
    "device=cpu",
    "reference_config.clip_length=20",
    "reference_config.random_init_range=10",
    "train_setup.eval_every=16",  # reset_every stays 50,000,000: no reset between evals
    "train_setup.train_config.num_envs=4",
    "train_setup.train_config.num_timesteps=32",
    "train_setup.train_config.batch_size=4",
    "train_setup.train_config.num_eval_envs=4",
    "train_setup.train_config.num_minibatches=2",
    "train_setup.train_config.num_updates_per_batch=2",
    "train_setup.train_config.unroll_length=2",
    "network_config.encoder_layer_sizes=[16]",
    "network_config.decoder_layer_sizes=[16]",
    "network_config.critic_layer_sizes=[16]",
    "network_config.intention_size=4",
]


def test_cli_trains_and_checkpoints(tmp_path, monkeypatch):
    clips = synthesize_clips_port(tmp_path)
    resets = []
    on_reset = wrappers.AutoResetWrapperTracking.on_reset
    monkeypatch.setattr(wrappers.AutoResetWrapperTracking, "on_reset",
                        lambda self, state: resets.append(state.obs.shape[0]) or on_reset(self, state))
    train.cli(["--config-name", NAME, f"data_path={clips}", f"logging_config.model_path={tmp_path / 'ckpts'}", *TINY])
    (run_dir,) = [p for p in (tmp_path / "ckpts").iterdir() if p.name != "wandb_local"]
    assert sorted(p.name for p in run_dir.iterdir() if p.is_dir()) == ["PPONetwork_0", "PPONetwork_1"]
    store = checkpointing.CheckpointStore(str(run_dir))
    cfg = store.config()
    assert cfg[tconfig.CONFIG_NAME] == NAME and cfg["walker_config"]["torque_actuators"] is False
    assert cfg["train_setup"]["eval_every"] // cfg["train_setup"]["reset_every"] == 0
    state = store.training_state()
    # one epoch of ceil(32 / (1 x 16 x max(0, 1))) = 2 training steps, 2 passes of 2 minibatches
    assert int(state["optimizer_state"]["state"][0]["step"]) == 2 * 2 * 2
    assert state["env_steps"] == 0  # thousands, int32: 2 x 0.016 truncates to 0 as in the JAX package
    for v in state["params"]["policy"].values():
        assert torch.isfinite(v).all()
    # the training envs reset once (no reset between evals), each eval once
    assert resets == [4, 4, 4]


def synthesize_clips_port(root):
    from track_mjx_tpu_torch.io.synthetic import synthesize_clips as port_synthesize

    clips = port_synthesize(tm.load_snapshot(NAME), n_clips=2, n_frames=20, mocap_hz=50, seed=0, device="cpu")
    path = root / "clips.npz"
    load.save_npz(clips, path)
    return path
