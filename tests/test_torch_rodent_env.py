"""The port's rodent tracking env and rollout on the rodent-full-clips
snapshot against the JAX package's rodent (rodent-full-clips env_args and
reward weights, synthetic clips), 4 envs, from the JAX reset's draws.

The rodent is chaotic in float32 under contact: from these resets, a
control step with actions of 0.2 x U(-1, 1) moves the JAX package's own qvel
by orders of magnitude more than a 1e-6 change of its start qvel, and the
port's as much. So no step runs free here. Each step starts from the JAX package's
state carried across, and
- the env layer (obs, reward, the 20 metrics, done, info) is held tight on
  the JAX package's own physics output, which the port's step is handed in
  place of its n_step;
- the whole step, the port's physics included, is held within 10 times the
  JAX package's own response to a 1e-6 relative change of qvel (plus 1e-4),
  with gentle actions;
- the rollout runs the stochastic intention policy (JAX weights and noise)
  one teacher-forced step per transition, on the JAX physics output."""


import jax
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import (
    assert_state_close,
    jax_policy_noise,
    jax_reset_draws,
    per_env_rel,
    port_clip,
    port_reward_config,
    state_to_torch,
    to_torch,
)
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs.task.reward import RewardConfig
from track_mjx_tpu.envs.task.tracking import MultiClipTracking as JaxMultiClip
from track_mjx_tpu.io.synthetic import synthesize_clips
from track_mjx_tpu.utils.config import load_config
from track_mjx_tpu_torch.agent import acting, types
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
B = 4
CLIP = dict(clip_length=60, random_init_range=5, traj_length=5)
# Reset and the env layer on identical physics: the same float32 formulas
# (measured up to 1.7e-8 and 1.2e-7 per env, relative to max(1, max |JAX|)).
RESET_REL = 1e-6
LAYER_REL = 1e-5
# The whole step: per env, 10 x the JAX package's own response to a 1e-6
# relative change of qvel, plus SELF_FLOOR for the roundoff of every other
# input (test_torch_step.py holds 10 substeps from gentle states to 1e-3).
# Measured on these inputs: obs 1.2e-5, 1.7e-5, 8.2e-6 and 5.0e-4 against
# bars of 9.2e-4, 1.6e-4, 1.1e-4 and 2.7e-3.
SELF_FACTOR = 10.0
SELF_FLOOR = 1e-4
# A transition on the JAX physics output: the policy's products and tanh
# (test_torch_policy.py's bars); measured up to 3.7e-6.
ROLLOUT_REL = 5e-5
GENTLE = 0.005  # action scale of the whole-step test
ACTION = 0.2  # action scale of the env-layer test


@pytest.fixture(scope="module")
def rodent():
    tf.set_full_f32()
    cfg = load_config("rodent-full-clips")
    env_args = dict(cfg.env_config.env_args)
    jwalker = torch_parity.load_export_tool().workload_walker("rodent-full-clips")
    clips = synthesize_clips(jwalker._mj_model, n_clips=2, n_frames=CLIP["clip_length"], mocap_hz=50)
    jenv = JaxMultiClip(clips, jwalker, RewardConfig(**dict(cfg.env_config.reward_weights)), **env_args, **CLIP)
    tenv = tt.MultiClipTracking(
        port_clip(clips),
        Rodent.from_snapshot(tm.load_snapshot("rodent-full-clips")),
        port_reward_config(jenv._reward_config),
        **env_args,
        **CLIP,
        device="cpu",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    draws = jax_reset_draws(jenv, keys, env_args["reset_noise_scale"])
    jreset = jax.jit(jax.vmap(jenv.reset))(keys)
    return jenv, tenv, draws, jreset, jax.jit(jax.vmap(jenv.step))


def _port_reset(tenv, draws):
    start, clip, qn, vn = (torch.as_tensor(np.array(d)) for d in draws)
    return tenv.reset_from_clip(start.long(), qn, vn, clip_idx=clip.long())


def _with_physics(tenv, data):
    """The port's env, its physics step replaced by `data` (the JAX
    package's n_step output carried across)."""
    tenv.pipeline_step = lambda state, ctrl: to_torch(data)
    return tenv


@pytest.fixture
def port_env(rodent):
    tenv = rodent[1]
    yield tenv
    tenv.__dict__.pop("pipeline_step", None)


def test_reset_matches_jax(rodent):
    jenv, tenv, draws, jreset, _ = rodent
    got = _port_reset(tenv, draws)
    assert got.obs.shape == jreset.obs.shape == (B, 696) and tenv.observation_size == 696
    assert tenv.reference_obs_size == int(jreset.info["reference_obs_size"][0]) == 470
    assert_state_close(got, jreset, RESET_REL, "reset", frame_rel=RESET_REL)
    for f in ("qpos", "qvel", "xpos", "qacc", "efc_force"):
        assert per_env_rel(getattr(got.pipeline_state, f), np.asarray(getattr(jreset.pipeline_state, f))).max() < 1e-3, f


def test_env_layer_matches_jax(rodent, port_env):
    """Two steps; each from the JAX state, on the JAX physics output."""
    jenv, _, draws, jstate, jstep = rodent
    rng = np.random.RandomState(1)
    exempt = 0
    for t in range(2):
        action = (ACTION * rng.uniform(-1, 1, (B, jenv.plan.nu))).astype(np.float32)
        jnext = jstep(jstate, action)
        tnext = _with_physics(port_env, jnext.pipeline_state).step(state_to_torch(jstate), torch.as_tensor(action))
        exempt += assert_state_close(tnext, jnext, LAYER_REL, f"step {t}", jenv._reward_config, LAYER_REL)
        jstate = jnext
    # envs with a flag's distance within FLAG_MARGIN of its threshold: none
    assert exempt == 0


def test_step_with_port_physics_matches_jax(rodent):
    """One whole control step, the port's CG physics included, from the JAX
    reset, against the JAX package's own sensitivity to roundoff."""
    jenv, tenv, draws, jstate, jstep = rodent
    action = (GENTLE * np.random.RandomState(2).uniform(-1, 1, (B, jenv.plan.nu))).astype(np.float32)
    want = jstep(jstate, action)
    qvel = jstate.pipeline_state.qvel
    nudged = jstep(jstate.replace(pipeline_state=jstate.pipeline_state.replace(qvel=qvel * (1 + 1e-6))), action)
    sensitivity = np.maximum.reduce([
        per_env_rel(nudged.obs, np.asarray(want.obs)),
        per_env_rel(np.asarray(nudged.reward)[:, None], np.asarray(want.reward)[:, None]),
    ])
    got = tenv.step(state_to_torch(jstate), torch.as_tensor(action))
    exempt = assert_state_close(got, want, SELF_FACTOR * sensitivity + SELF_FLOOR, "whole step",
                                jenv._reward_config, LAYER_REL)
    assert exempt == 0
    assert (np.asarray(want.pipeline_state.contact_dist) < 0).any(axis=1).all()  # contacts act in every env


def test_rollout_teacher_forced_matches_jax(rodent, port_env):
    """Three transitions of the stochastic intention policy (narrow widths,
    the JAX weights and normalizer carried across, the JAX noise fed in):
    each from the JAX state, on the JAX physics output; every field of each
    Transition against the JAX package's actor step."""
    jenv, _, draws, jstate, jstep = rodent
    obs_size, ref_size, nu = jenv.observation_size, 470, jenv.plan.nu
    kw = dict(intention_latent_size=8, encoder_hidden_layer_sizes=[32, 16],
              decoder_hidden_layer_sizes=[16, 16], value_hidden_layer_sizes=[16])
    jnet = jpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=jrs.normalize, **kw)
    pp = jnet.policy_network.init(jax.random.PRNGKey(2))
    vp = jnet.value_network.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(4)
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs_size,), np.float32)).replace(
        mean=np.asarray(0.1 * rng.normal(size=obs_size), np.float32),
        std=np.asarray(rng.uniform(0.5, 2.0, obs_size), np.float32),
    )
    jpolicy = jax.jit(jpn.make_inference_fn(jnet)((norm, pp)))
    tnet = tpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=trs.normalize,
                                           device="cpu", **kw)
    params = tpn.params_from_flax(*(jax.tree.map(np.asarray, t) for t in (pp, vp, norm)), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    tpolicy = tpn.make_inference_fn(tnet)(params.normalizer)
    key = jax.random.PRNGKey(5)
    for t in range(3):
        cur, key = jax.random.split(key)
        jaction, jextras = jpolicy(jstate.obs, cur)
        jnext = jstep(jstate, jaction)
        noise = types.PolicyNoise(*(torch.as_tensor(n) for n in jax_policy_noise(cur, B, 8, nu)))
        tnext, tr = acting.actor_step(_with_physics(port_env, jnext.pipeline_state), state_to_torch(jstate),
                                      tpolicy, noise)
        want = {
            "observation": jstate.obs, "action": jaction, "reward": np.asarray(jnext.reward)[:, None],
            "discount": 1 - np.asarray(jnext.done)[:, None], "next_observation": jnext.obs,
        }
        for f, w in want.items():
            g = getattr(tr, f)
            g = g[:, None] if g.dim() == 1 else g
            assert per_env_rel(g, np.asarray(w)).max() < ROLLOUT_REL, f"transition {t} {f}"
        pe = tr.extras["policy_extras"]
        for k in pe:
            assert per_env_rel(pe[k].reshape(B, -1), np.asarray(jextras[k]).reshape(B, -1)).max() < ROLLOUT_REL, k
        np.testing.assert_array_equal(tnext.done.numpy(), np.asarray(jnext.done))
        jstate = jnext
    assert np.abs(np.asarray(jaction)).max() > 0.5  # the policy's actions are not small
