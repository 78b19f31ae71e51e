"""The port's tracking env, wrappers and rollout on the toy walker (with
floor contacts) against the JAX package's, from the same inputs: the JAX
reset's draws (start frame, clip, both noises) fed to reset_from_clip, the
same actions, the JAX policy's weights carried by params_from_flax and its
noise fed to the port's policy.

The toy walker is small enough to run free: the port and the JAX package
step side by side for several control steps from the same reset."""


import jax
import jax.numpy as jp
import numpy as np
import pytest
import torch

from torch_parity import (
    assert_state_close,
    jax_policy_noise,
    jax_reset_draws,
    per_env_rel,
    port_clip,
    port_reward_config,
    port_walker,
)
from track_mjx_tpu.agent import acting as jacting
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu.testing import make_toy_env
from track_mjx_tpu_torch.agent import acting, types
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.physics import forward as tf

torch.set_num_threads(1)
B = 8
STEPS = 3
NOISE = 1e-3  # make_toy_env's reset_noise_scale
# Per env, relative to max(1, max |JAX|). Reset: the same float32
# formulas (measured 1.5e-8). Steps: contacts amplify roundoff from step to
# step; reward terms and info are computed from the stepped state and carry
# its error. Measured on these inputs up to 1.7e-5 (obs over 3 steps),
# 2.1e-6 (reward terms), 1.5e-5 (the wrapped SlimData) and 3.0e-5 (the
# unroll's policy extras); the bar leaves 10x.
RESET_REL = 1e-6
STEP_REL = 3e-4


@pytest.fixture(scope="module")
def envs():
    tf.set_full_f32()
    jenv = make_toy_env()
    tenv = tt.MultiClipTracking(
        port_clip(jenv._reference_clips),
        port_walker(jenv.walker),
        port_reward_config(jenv._reward_config),
        physics_steps_per_control_step=jenv._n_frames,
        reset_noise_scale=NOISE,
        solver="cg",
        iterations=4,
        ls_iterations=4,
        mj_model_timestep=0.005,
        mocap_hz=50,
        clip_length=60,
        random_init_range=10,
        traj_length=5,
        device="cpu",
    )
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    return jenv, tenv, keys, jax_reset_draws(jenv, keys, NOISE)


def _port_reset(env, draws, wrapped=None):
    start, clip, qn, vn = (torch.as_tensor(np.array(d)) for d in draws)
    return (wrapped or env).reset_from_clip(start.long(), qn, vn, clip_idx=clip.long())


def test_reset_matches_jax(envs):
    jenv, tenv, keys, draws = envs
    want = jax.jit(jax.vmap(jenv.reset))(keys)
    got = _port_reset(tenv, draws)
    assert got.obs.shape == want.obs.shape == (B, tenv.observation_size)
    assert tenv.observation_size == jenv.observation_size
    assert got.info["reference_obs_size"] == int(want.info["reference_obs_size"][0]) == tenv.reference_obs_size
    assert_state_close(got, want, RESET_REL, "reset", frame_rel=RESET_REL)
    assert not got.info["action_buffer"].any() and not got.reward.any()
    # the fed draws are the JAX reset's: its qpos is reference + noise
    np.testing.assert_allclose(got.pipeline_state.qpos.numpy(), np.asarray(want.pipeline_state.qpos), atol=1e-7)
    assert len(set(draws[0].tolist())) > 1 and len(set(draws[1].tolist())) > 1


def test_steps_match_jax(envs):
    """Free-running control steps from the same reset and actions."""
    jenv, tenv, keys, draws = envs
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = _port_reset(tenv, draws)
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(0)
    exempt = 0
    for t in range(STEPS):
        action = rng.uniform(-1, 1, (B, jenv.plan.nu)).astype(np.float32)
        jstate = jstep(jstate, action)
        tstate = tenv.step(tstate, torch.as_tensor(action))
        exempt += assert_state_close(tstate, jstate, STEP_REL, f"step {t}", jenv._reward_config, RESET_REL)
    # flags within FLAG_MARGIN of a threshold on these inputs: none
    assert exempt == 0
    assert (np.asarray(jstate.info["buffer_index"]) == STEPS).all()


def test_nan_guard_matches_jax(envs):
    """A NaN in one env's qpos: that env reports nan = 1 and done = 1 with
    finite obs and reward; the others step as in the JAX package."""
    jenv, tenv, keys, draws = envs
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = _port_reset(tenv, draws)
    bad = 2
    jq = jstate.pipeline_state.qpos.at[bad, 8].set(jp.nan)
    jstate = jstate.replace(pipeline_state=jstate.pipeline_state.replace(qpos=jq))
    tq = tstate.pipeline_state.qpos.clone()
    tq[bad, 8] = float("nan")
    tstate = tstate.replace(pipeline_state=tstate.pipeline_state.replace(qpos=tq))
    action = np.random.RandomState(1).uniform(-1, 1, (B, jenv.plan.nu)).astype(np.float32)
    jnext = jax.jit(jax.vmap(jenv.step))(jstate, action)
    tnext = tenv.step(tstate, torch.as_tensor(action))
    assert float(jnext.metrics["nan"][bad]) == 1.0
    assert float(tnext.metrics["nan"][bad]) == 1.0 and float(tnext.done[bad]) == 1.0
    assert torch.isfinite(tnext.obs).all() and torch.isfinite(tnext.reward).all()
    assert int((tenv.nan_count(tnext.pipeline_state) > 0).sum()) == 1
    ok = np.arange(B) != bad
    np.testing.assert_array_equal(tnext.metrics["nan"].numpy(), np.asarray(jnext.metrics["nan"]))
    np.testing.assert_array_equal(tnext.done.numpy(), np.asarray(jnext.done))
    for name, g, w in (("obs", tnext.obs, jnext.obs), ("reward", tnext.reward, jnext.reward)):
        assert per_env_rel(g[ok], np.asarray(w)[ok]).max() < STEP_REL, name
    # nan_to_num of the bad env's obs and reward, as in JAX
    np.testing.assert_allclose(tnext.obs[bad].numpy(), np.asarray(jnext.obs[bad]), rtol=1e-3, atol=1e-3)


def _wrapped(jenv, tenv, episode_length):
    return (
        jwrappers.wrap(jenv, episode_length=episode_length, action_repeat=1, use_lstm=False),
        wrappers.wrap(tenv, episode_length=episode_length, action_repeat=1, use_lstm=False),
    )


def _slim_close(got, want, rel):
    for f in tf._CARRY_FIELDS:
        assert per_env_rel(getattr(got, f), np.asarray(getattr(want, f))).max() < rel, f


def test_wrappers_truncate_and_auto_reset_like_jax(envs):
    """Episodes of 2 steps: truncation at step 2, then the auto-reset swap
    back to each env's cached first state, obs and prev_ctrl."""
    jenv, tenv, keys, draws = envs
    jw, tw = _wrapped(jenv, tenv, episode_length=2)
    jstate = jax.jit(jw.reset)(keys)
    tstate = _port_reset(tenv, draws, wrapped=tw)
    assert isinstance(tstate.pipeline_state, tf.SlimData)
    _slim_close(tstate.info["first_pipeline_state"], jstate.info["first_pipeline_state"], RESET_REL)
    jstep = jax.jit(jw.step)
    rng = np.random.RandomState(2)
    for t in range(3):
        action = rng.uniform(-1, 1, (B, jenv.plan.nu)).astype(np.float32)
        jstate = jstep(jstate, action)
        tstate = tw.step(tstate, torch.as_tensor(action))
        for k in ("steps", "truncation"):
            np.testing.assert_array_equal(tstate.info[k].numpy(), np.asarray(jstate.info[k]), err_msg=f"{k} {t}")
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        assert per_env_rel(tstate.obs, np.asarray(jstate.obs)).max() < STEP_REL
        assert per_env_rel(tstate.info["prev_ctrl"], np.asarray(jstate.info["prev_ctrl"])).max() < STEP_REL
        _slim_close(tstate.pipeline_state, jstate.pipeline_state, STEP_REL)
        if t == 1:  # every episode ends here: each env is back at its first state
            assert (np.asarray(jstate.info["truncation"]) + np.asarray(jstate.metrics["done"]) > 0).all()
            first = tstate.info["first_pipeline_state"]
            for f in tf._CARRY_FIELDS:
                assert torch.equal(getattr(tstate.pipeline_state, f), getattr(first, f)), f
            assert torch.equal(tstate.obs, tstate.info["first_obs"])
            assert not tstate.info["prev_ctrl"].any()


def test_generate_unroll_matches_jax(envs):
    """The slice as a whole on the toy walker: 3 steps of the stochastic
    intention policy (narrow widths, flax weights carried across, the
    normalizer at a non-trivial mean and std) in the wrapped env, episodes
    of 2 steps, every Transition field against the JAX unroll."""
    jenv, tenv, keys, draws = envs
    jw, tw = _wrapped(jenv, tenv, episode_length=2)
    obs_size, ref_size, nu = jenv.observation_size, tenv.reference_obs_size, jenv.plan.nu
    kw = dict(
        intention_latent_size=4,
        encoder_hidden_layer_sizes=[16, 16],
        decoder_hidden_layer_sizes=[16, 16],
        value_hidden_layer_sizes=[16],
    )
    jnet = jpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=jrs.normalize, **kw)
    pp = jnet.policy_network.init(jax.random.PRNGKey(0))
    vp = jnet.value_network.init(jax.random.PRNGKey(1))
    rng = np.random.RandomState(3)
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs_size,), jp.float32)).replace(
        mean=jp.asarray(0.1 * rng.normal(size=obs_size), jp.float32),
        std=jp.asarray(rng.uniform(0.5, 2.0, obs_size), jp.float32),
    )
    tnet = tpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=trs.normalize,
                                           device="cpu", **kw)
    params = tpn.params_from_flax(jax.tree.map(np.asarray, pp), jax.tree.map(np.asarray, vp),
                                  jax.tree.map(np.asarray, norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    key = jax.random.PRNGKey(9)

    def unroll(state, key):
        policy = jpn.make_inference_fn(jnet)((norm, pp))
        return jacting.generate_unroll(jw, state, policy, key, STEPS, extra_fields=("truncation",))

    jfinal, jdata = jax.jit(unroll)(jax.jit(jw.reset)(keys), key)
    step_keys, k = [], key
    for _ in range(STEPS):  # generate_unroll's split per step (acting.py:108)
        cur, k = jax.random.split(k)
        step_keys.append(types.PolicyNoise(*(torch.as_tensor(n) for n in jax_policy_noise(cur, B, 4, nu))))
    policy = tpn.make_inference_fn(tnet)(params.normalizer)
    tfinal, tdata = acting.generate_unroll(tw, _port_reset(tenv, draws, wrapped=tw), policy, step_keys, STEPS,
                                           extra_fields=("truncation",))
    for f in ("observation", "action", "reward", "discount", "next_observation"):
        g, w = getattr(tdata, f), np.asarray(getattr(jdata, f))
        assert tuple(g.shape) == w.shape, f
        assert per_env_rel(g.reshape(STEPS * B, -1), w.reshape(STEPS * B, -1)).max() < STEP_REL, f
    np.testing.assert_array_equal(tdata.discount.numpy(), np.asarray(jdata.discount))
    pe, jpe = tdata.extras["policy_extras"], jdata.extras["policy_extras"]
    assert set(pe) == {k for k, v in jpe.items() if v is not None}
    for k in pe:
        w = np.asarray(jpe[k])
        assert per_env_rel(pe[k].reshape(STEPS * B, -1), w.reshape(STEPS * B, -1)).max() < STEP_REL, k
    np.testing.assert_array_equal(tdata.extras["state_extras"]["truncation"].numpy(),
                                  np.asarray(jdata.extras["state_extras"]["truncation"]))
    assert (np.asarray(jdata.discount) == 0).any()  # the unroll crossed an episode end
    assert per_env_rel(tfinal.obs, np.asarray(jfinal.obs)).max() < STEP_REL


def test_single_clip_env_matches_jax():
    """SingleClipTracking (one clip, frames first): reset from the JAX
    single-clip reset's draws and one step."""
    tf.set_full_f32()
    jenv = make_toy_env(multi_clip=False)
    tenv = tt.SingleClipTracking(
        port_clip(jenv._reference_clip),
        port_walker(jenv.walker),
        port_reward_config(jenv._reward_config),
        physics_steps_per_control_step=jenv._n_frames,
        reset_noise_scale=NOISE,
        solver="cg",
        iterations=4,
        ls_iterations=4,
        mj_model_timestep=0.005,
        mocap_hz=50,
        clip_length=60,
        random_init_range=10,
        traj_length=5,
        device="cpu",
    )
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    frame_range = 60 - 10 - 5

    def draws(rng):  # SingleClipTracking.reset (tracking.py:213-222, :228-250)
        _, start_rng, rng = jax.random.split(rng, 3)
        _, rng1, _ = jax.random.split(rng, 3)
        return (
            jax.random.randint(start_rng, (), 0, frame_range),
            jax.random.uniform(rng1, (jenv.plan.nq,), minval=-NOISE, maxval=NOISE),
            jax.random.uniform(rng1, (jenv.plan.nv,), minval=-NOISE, maxval=NOISE),
        )

    start, qn, vn = (torch.as_tensor(np.array(d)) for d in jax.vmap(draws)(keys))
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    tstate = tenv.reset_from_clip(start.long(), qn, vn)
    assert per_env_rel(tstate.obs, np.asarray(jstate.obs)).max() < RESET_REL
    action = np.random.RandomState(5).uniform(-1, 1, (B, jenv.plan.nu)).astype(np.float32)
    jnext = jax.jit(jax.vmap(jenv.step))(jstate, action)
    tnext = tenv.step(tstate, torch.as_tensor(action))
    for name in ("obs", "reward"):
        assert per_env_rel(getattr(tnext, name).reshape(B, -1), np.asarray(getattr(jnext, name)).reshape(B, -1)).max() < STEP_REL, name
    np.testing.assert_array_equal(tnext.done.numpy(), np.asarray(jnext.done))
    assert len(set(start.tolist())) > 1


def test_reset_draws_from_a_generator(envs):
    """reset(generator, batch_size) draws the start frame in the reference's
    hard-coded [0, 44), a clip, then the qpos and qvel noise in the reset
    noise range, in that order: the same seed gives the same state."""
    _, tenv, _, _ = envs
    a = tenv.reset(torch.Generator().manual_seed(0), 64)
    b = tenv.reset(torch.Generator().manual_seed(0), 64)
    assert torch.equal(a.obs, b.obs) and torch.equal(a.pipeline_state.qpos, b.pipeline_state.qpos)
    start, clip = a.info["start_frame"], a.info["clip_idx"]
    assert 0 <= int(start.min()) and int(start.max()) < 44 and len(set(start.tolist())) > 10
    assert set(clip.tolist()) == set(range(tenv._n_clips))
    ref = a.info["reference_frame"]
    qpos_ref = torch.cat([ref.position, ref.quaternion, ref.joints], dim=1)
    assert float((a.pipeline_state.qpos - qpos_ref).abs().max()) <= NOISE * (1 + 1e-5)
    assert 0 < float(a.pipeline_state.qvel.abs().max()) <= NOISE
