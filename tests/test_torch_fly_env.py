"""The port's fly tracking env (fly_multi_clip) on the fly-mc-intention
snapshot against the JAX package's fly (its env_args and reward weights,
synthetic clips at 500 Hz), 4 envs, from the JAX reset's draws; the fly
walker's index tables; the frame index over a whole episode of float32
time; and the fly's synthetic clips.

The fly's elliptic linesearch is a knife edge in float32 (PERF.md): two
float32 solves of the same system part by O(1) on single envs, so no fly
step is held per env on its own physics. The env layer (obs, reward, the
20 metrics among them the 18 reward outputs, done, info) is held tight on
one physics state, the JAX package's n_step output, which the port's step
is handed in place of its own; the whole step, the port's physics
included, is held as chip_smoke.py holds the fly's control step on the
card: its time bit for bit, every state finite, and its obs and reward as
close to a float64 run of the port's step as the JAX package's float32
step is (on the median env)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (
    CLIP_FIELDS,
    assert_state_close,
    jax_reset_draws,
    per_env_rel,
    port_clip,
    port_reward_config,
    state_to_torch,
    to_torch,
)
from track_mjx_tpu.envs.task.reward import RewardConfig
from track_mjx_tpu.envs.task.tracking import MultiClipTracking as JaxMultiClip
from track_mjx_tpu.io.synthetic import synthesize_clips as jax_synthesize
from track_mjx_tpu.utils.config import load_config
from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.envs import base as tenvs
from track_mjx_tpu_torch.envs.base import map_tensors
from track_mjx_tpu_torch.envs.walker.fly import Fly
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
CONFIG = "fly-mc-intention"
B = 4
CLIP = dict(clip_length=60, random_init_range=5, traj_length=5)
# Reset and the env layer on identical physics: the same float32 formulas,
# per env relative to max(1, max |JAX|).
RESET_REL = 1e-6
LAYER_REL = 1e-5
# The whole step on the port's own physics, against the port's step in
# float64 from the same state: the median env's error within VS_F64 times
# the JAX float32 step's, plus F64_FLOOR (chip_smoke.py's FLY_VS_F64 and
# FLY_F64_FLOOR). Within one control step the knife edge parts float32 from
# float64 by O(1e-2-1) on single envs, with one contact or none: measured
# on these inputs, obs per env 2.7e-4, 3.2e-4, 0.23, 1.5e-2 (port) against
# 1.8e-2, 4.4e-2, 6.5e-2, 0.17 (JAX).
VS_F64 = 3.0
F64_FLOOR = 1e-6
ACTION = 0.5  # action scale (the fly's ctrlrange is +-10; a policy's actions lie in [-1, 1])
# Synthetic clips' bodies: the port's float64 kinematics on the float32
# snapshot against MuJoCo C (tests/test_torch_clips.py's bar).
BODY_ABS = 1e-5
EPISODE = 600 - 50 - 5  # the fly's episode at the config's clip_length: 545 control steps


@pytest.fixture(scope="module")
def fly():
    tf.set_full_f32()
    cfg = load_config(CONFIG)
    env_args = dict(cfg.env_config.env_args)
    jwalker = torch_parity.load_export_tool().workload_walker(CONFIG)
    clips = jax_synthesize(jwalker._mj_model, n_clips=2, n_frames=CLIP["clip_length"], mocap_hz=500, seed=0)
    jenv = JaxMultiClip(clips, jwalker, RewardConfig(**dict(cfg.env_config.reward_weights)), **env_args, **CLIP)
    tenv = tenvs.get_environment(
        "fly_multi_clip",
        reference_clip=port_clip(clips),
        walker=Fly.from_snapshot(),
        reward_config=port_reward_config(jenv._reward_config),
        **env_args,
        **CLIP,
        device="cpu",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    draws = jax_reset_draws(jenv, keys, env_args["reset_noise_scale"])
    jreset = jax.jit(jax.vmap(jenv.reset))(keys)
    return jwalker, jenv, tenv, draws, jreset, jax.jit(jax.vmap(jenv.step))


def _port_reset(tenv, draws):
    start, clip, qn, vn = (torch.as_tensor(np.array(d)) for d in draws)
    return tenv.reset_from_clip(start.long(), qn, vn, clip_idx=clip.long())


@pytest.fixture
def port_env(fly):
    tenv = fly[2]
    yield tenv
    tenv.__dict__.pop("pipeline_step", None)


def test_fly_walker_index_tables_match_jax(fly):
    jwalker = fly[0]
    walker = Fly.from_snapshot()
    for name in ("joint_idxs", "body_idxs", "endeff_idxs"):
        np.testing.assert_array_equal(getattr(walker, name), np.asarray(getattr(jwalker, f"_{name}")), err_msg=name)
    assert walker.torso_idx == int(jwalker._torso_idx) == 2  # "thorax"
    assert walker.reproduce_joint_index_quirk == jwalker.reproduce_joint_index_quirk
    assert workload.WALKERS["fly"] is Fly and Fly.SNAPSHOT == CONFIG


def test_fly_reward_config_takes_the_fly_defaults(fly):
    """The fly's YAML gives no var_coeff (the default, 5e-2, where the
    rodent's gives 0.005) and a healthy_z_range of [-0.03, 0.1]."""
    tenv = fly[2]
    rc = tenv._reward_config
    assert rc.var_coeff == fly[1]._reward_config.var_coeff == 5e-2
    assert rc.healthy_z_range == (-0.03, 0.1)


def test_fly_reset_matches_jax(fly):
    _, jenv, tenv, draws, jreset, _ = fly
    got = _port_reset(tenv, draws)
    assert got.obs.shape == jreset.obs.shape and tenv.observation_size == jreset.obs.shape[1]
    assert tenv.reference_obs_size == int(jreset.info["reference_obs_size"][0])
    assert_state_close(got, jreset, RESET_REL, "reset", frame_rel=RESET_REL)
    for f in ("qpos", "qvel", "xpos"):
        assert per_env_rel(getattr(got.pipeline_state, f), np.asarray(getattr(jreset.pipeline_state, f))).max() < 1e-5, f


def test_fly_env_layer_matches_jax(fly, port_env):
    """One step from the JAX reset, on the JAX physics output."""
    _, jenv, _, draws, jstate, jstep = fly
    action = (ACTION * np.random.RandomState(1).uniform(-1, 1, (B, jenv.plan.nu))).astype(np.float32)
    jnext = jstep(jstate, action)
    port_env.pipeline_step = lambda state, ctrl: to_torch(jnext.pipeline_state)
    tnext = port_env.step(state_to_torch(jstate), torch.as_tensor(action))
    exempt = assert_state_close(tnext, jnext, LAYER_REL, "step", jenv._reward_config, LAYER_REL)
    assert exempt == 0  # no env has a flag's distance within FLAG_MARGIN of its threshold
    np.testing.assert_array_equal(tnext.info["reference_frame"].position.numpy(),
                                  np.asarray(jnext.info["reference_frame"].position))


def test_fly_step_with_port_physics_matches_jax(fly):
    """One whole control step (10 substeps of the elliptic CG), the port's
    physics included, from the JAX reset."""
    _, jenv, tenv, _, jstate, jstep = fly
    action = (ACTION * np.random.RandomState(2).uniform(-1, 1, (B, jenv.plan.nu))).astype(np.float32)
    want = jstep(jstate, action)
    start = state_to_torch(jstate)
    got = tenv.step(start, torch.as_tensor(action))
    np.testing.assert_array_equal(got.pipeline_state.time.numpy(), np.asarray(want.pipeline_state.time))
    for f in ("qpos", "qvel", "qacc", "efc_force"):
        assert torch.isfinite(getattr(got.pipeline_state, f)).all(), f
    model32, pack32 = tenv.model, tenv._pack
    try:
        tenv.model = tm.Model(**{f: getattr(model32, f).double() for f in tm.Model.__dataclass_fields__})
        tenv._pack = pack32.double()
        f64 = tenv.step(map_tensors(lambda t: t.double() if t.is_floating_point() else t, start),
                        torch.as_tensor(action).double())
    finally:
        tenv.model, tenv._pack = model32, pack32
    for name in ("obs", "reward"):
        ref = getattr(f64, name).numpy().reshape(B, -1)
        port = np.median(per_env_rel(getattr(got, name).numpy().reshape(B, -1), ref))
        jax_f32 = np.median(per_env_rel(np.asarray(getattr(want, name)).reshape(B, -1), ref))
        assert port <= VS_F64 * jax_f32 + F64_FLOOR, f"{name}: {port:.3e} against the JAX step's {jax_f32:.3e}"
    assert (np.asarray(want.pipeline_state.contact_dist) < 0).any()  # a contact acts


def test_fly_frame_index_matches_jax_over_an_episode(fly):
    """The frame index of every control step of a 545-step episode, from
    the float32 time that the physics sums substep by substep (time += dt,
    10 substeps of 2e-4 per control step: time * 500 lands on an integer at
    each control step, so float32 roundoff decides the floor), bit for bit."""
    _, jenv, tenv, *_ = fly
    starts = np.arange(44, dtype=np.int32)  # every start frame the multi-clip reset draws
    dt_jax, dt_port = jenv._mj_model.opt.timestep, tenv.model.opt_timestep
    jdt = jnp.float32(dt_jax)

    @jax.jit
    def jax_frames(start):
        def control_step(t, _):
            t = jax.lax.fori_loop(0, 10, lambda i, x: x + jdt, t)
            return t, jenv._get_cur_frame({"start_frame": start}, types.SimpleNamespace(time=t))

        return jax.lax.scan(control_step, jnp.zeros_like(start, jnp.float32), (), length=EPISODE)[1]

    want = np.asarray(jax.vmap(jax_frames)(jnp.asarray(starts))).T  # [steps, starts]
    t = torch.zeros(len(starts))
    info = {"start_frame": torch.as_tensor(starts, dtype=torch.int64)}
    got = []
    for _ in range(EPISODE):
        for _ in range(10):
            t = t + dt_port
        got.append(tenv._get_cur_frame(info, types.SimpleNamespace(time=t)).numpy())
    got = np.stack(got)
    assert float(dt_port) == np.float32(dt_jax)
    np.testing.assert_array_equal(got, want)
    exact = starts[None, :] + np.arange(1, EPISODE + 1)[:, None]
    assert (got <= exact).all() and (got >= exact - 1).all()


def test_fly_synthetic_clips_match_jax(fly):
    """Fly clips at 500 Hz: the numpy draws (qpos and its finite
    differences) bit for bit, the bodies from the port's kinematics on the
    snapshot within BODY_ABS of MuJoCo C's."""
    jwalker = fly[0]
    kw = dict(n_clips=2, n_frames=30, mocap_hz=500, seed=1)
    want = jax_synthesize(jwalker._mj_model, **kw)
    got = synthesize_clips(tm.load_snapshot(CONFIG), device="cpu", **kw)
    for k in CLIP_FIELDS:
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, k
        if k in ("body_positions", "body_quaternions"):
            err = float(np.abs(a.numpy() - b).max())
            assert err < BODY_ABS, f"{k}: {err:.3e}"
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def test_fly_rollout_runs_the_workload():
    """`rollout.make_rollout` builds the fly-mc-intention workload (its
    clips' length, the Episode and AutoReset wrappers, the networks at the
    config's widths) and unrolls it with the stochastic policy."""
    from track_mjx_tpu_torch.agent import acting
    from track_mjx_tpu_torch.rollout import make_rollout

    ro = make_rollout("fly-mc-intention", n_clips=1, device="cpu")
    assert ro.episode_length == EPISODE and isinstance(ro.tracking.walker, Fly)
    assert ro.tracking._clip_frames == 600 and ro.networks.parametric_action_distribution.param_size == 2 * 36
    assert [m.out_features for m in ro.networks.value_network.mlp.layers] == [256, 256, 1]
    state = ro.env.reset(torch.Generator().manual_seed(0), 2)
    state, data = acting.generate_unroll(ro.env, state, ro.policy(), torch.Generator().manual_seed(1), 2)
    assert data.observation.shape == (2, 2, ro.tracking.observation_size)
    assert torch.isfinite(data.reward).all() and torch.isfinite(data.observation).all()
