"""The trainer options of the port against the JAX package, on the CPU:
domain randomization, the bf16 rollout policy, foreign envs and the
profiler trace.

- `DomainRandomizationVmapWrapper` on the toy walker against the JAX one
  (tests/test_env.py's case: the floor's friction per env; here with
  dof_damping per env too), each env against the port's own run on that
  env's model for every group of leaves (tests/test_torch_domain_
  randomization.py holds every group against the JAX package), and the
  wrapper's errors: a name that is no Model field, leaves that disagree on
  the env count, a wrong shape;
- the bf16 policy forward (`compute_dtype`) against the JAX package's
  `compute_dtype=bfloat16`, feed-forward and recurrent, with float32 master
  parameters; both trainers with `rollout_bf16` and with `randomization_fn`;
- `wrap_external` on the point mass against the JAX package's, and the MLP
  trainer on it;
- the reference's two faults of the foreign-env path (ADVICE.md), each
  shown repaired: dict observations raise a ValueError, and a step after an
  auto-reset sees the reset's obs;
- `profile_dir` writes a trace that holds the rollout, normalizer_update
  and sgd scopes, in both trainers.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

import torch_parity
from test_external_env import _PointMassEnv as JaxPointMass
from torch_parity import fed_reset, jax_policy_noise, jax_reset_draws, per_env_rel
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jlstm_networks
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu_torch.agent import running_statistics, types
from track_mjx_tpu_torch.agent.lstm_ppo import ppo as lstm_ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tlstm_networks
from track_mjx_tpu_torch.agent.mlp_ppo import ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.testing import PointMassEnv, PointMassState

torch.set_num_threads(1)
N_ENVS = 3


@pytest.fixture(scope="module")
def toy():
    return torch_parity.toy_envs()


def _randomize_jax(model):
    """tests/test_env.py's randomization, the floor's friction per env, at
    1 + 0.5 i in env i (a contact takes the larger of its geoms' frictions,
    and test_env.py's 0.5 + 0.1 i stays under the body geoms' 1.0), and every
    hinge's damping 0.1 + 0.2 i; JAX's (model, in_axes)."""
    frictions = jnp.stack([model.geom_friction.at[0, 0].set(1.0 + 0.5 * i) for i in range(N_ENVS)])
    dampings = jnp.stack([jnp.where(model.dof_damping > 0, 0.1 + 0.2 * i, 0.0) for i in range(N_ENVS)])
    in_axes = jax.tree.map(lambda _: None, model).replace(geom_friction=0, dof_damping=0)
    return model.replace(geom_friction=frictions, dof_damping=dampings), in_axes


def _randomize_port(model, generator=None, num_envs=N_ENVS):
    """The same leaves in the port's idiom: (model, names)."""
    frictions = model.geom_friction.repeat(num_envs, 1, 1)
    frictions[:, 0, 0] = 1.0 + 0.5 * torch.arange(num_envs, dtype=torch.float32)
    i = torch.arange(num_envs, dtype=torch.float32)[:, None]
    dampings = torch.where(model.dof_damping > 0, 0.1 + 0.2 * i, 0.0)
    return dataclasses.replace(model, geom_friction=frictions, dof_damping=dampings), ("geom_friction", "dof_damping")


# The toy walker's step on per-env leaves, the JAX package against the port
# (the same float32 formulas; tests/test_torch_env.py holds the unrandomized
# toy step to 1e-5): measured up to 8.5e-8 per env.
DR_REL = 1e-5


def test_domain_randomization_matches_jax(toy):
    jenv, tenv = toy
    keys = jax.random.split(jax.random.PRNGKey(0), N_ENVS)
    draws = jax_reset_draws(jenv, keys, tenv._reset_noise_scale)
    base = jenv.model
    try:
        jwrapped = jwrappers.DomainRandomizationVmapWrapper(
            jwrappers.EpisodeWrapper(jenv, episode_length=5, action_repeat=1), _randomize_jax
        )
        action = np.asarray(0.3 * np.random.RandomState(1).uniform(-1, 1, (N_ENVS, tenv.action_size)), np.float32)
        jstate = jax.jit(jwrapped.reset)(keys)
        jstate = jax.jit(jwrapped.step)(jstate, action)
    finally:
        jenv.model = base  # the JAX wrapper leaves its last model in the env
    twrapped = wrappers.DomainRandomizationVmapWrapper(
        wrappers.EpisodeWrapper(fed_reset(tenv, draws), episode_length=5, action_repeat=1), _randomize_port
    )
    assert twrapped.randomized == ("geom_friction", "dof_damping") and twrapped.num_envs == N_ENVS
    shared = tenv.model
    tstate = twrapped.step(twrapped.reset(None, N_ENVS), torch.as_tensor(action))
    assert tenv.model is shared  # the randomized model is swapped in per call only
    for name in ("obs", "reward"):
        err = per_env_rel(getattr(tstate, name), np.asarray(getattr(jstate, name)))
        assert (err < DR_REL).all(), f"{name}: {err}"
    np.testing.assert_array_equal(tstate.info["truncation"].numpy(), np.asarray(jstate.info["truncation"]))
    # the friction reached the solve: contact forces differ between envs
    qacc = tstate.pipeline_state.qacc
    assert (qacc[0] - qacc[1]).abs().max() > 1e-3


def test_each_randomized_env_is_its_own_model(toy):
    """Env i of a randomized batch steps bit for bit as a batch of env i's
    state does on env i's model, unrandomized (the same batch size: torch's
    float32 reductions change order with it): for friction and damping, and
    for each group of leaves (torch_parity.DR_GROUPS, every Model field);
    and two envs that differ only in friction differ in qacc."""
    _, tenv = toy
    tf.set_full_f32()
    plan, shared = tenv.plan, tenv.model
    rng = np.random.RandomState(4)
    qpos = np.tile(tenv._mj_model.qpos0, (N_ENVS, 1)).astype(np.float32)
    qpos[:, 2] -= 0.01  # in contact with the floor
    start = dict(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(rng.uniform(-0.3, 0.3, (N_ENVS, plan.nv)).astype(np.float32)),
        ctrl=torch.as_tensor(rng.uniform(-0.5, 0.5, (N_ENVS, plan.nu)).astype(np.float32)),
    )
    leaves = {f.name: getattr(shared, f.name).numpy() for f in dataclasses.fields(shared)}
    cases = {"friction and damping": _randomize_port(shared)}
    for group, names in torch_parity.DR_GROUPS.items():
        per_env = torch_parity.randomized_leaves(leaves, names, N_ENVS, 6, torch_parity.scalar_qpos_ids(plan))
        cases[group] = dataclasses.replace(shared, **{k: torch.as_tensor(v) for k, v in per_env.items()}), names
    for case, (model_v, names) in cases.items():
        batched = tf.n_step(plan, model_v, tm.make_data(plan, model_v, N_ENVS).replace(**start), 2)
        for i in range(N_ENVS):
            one = dataclasses.replace(shared, **{n: getattr(model_v, n)[i] for n in names})
            alone = tf.n_step(plan, one, tm.make_data(plan, one, N_ENVS).replace(
                **{k: v[[i] * N_ENVS] for k, v in start.items()}), 2)
            for name in ("qpos", "qvel", "qacc", "efc_force"):
                assert torch.equal(getattr(batched, name)[i], getattr(alone, name)[i]), (case, i, name)
    # friction alone, from one state: a contact takes the larger of its two
    # geoms' frictions, so the floor's goes past the body geoms' 1.0 here
    frictions = shared.geom_friction.repeat(N_ENVS, 1, 1)
    frictions[:, 0, 0] = 1.0 + 0.5 * torch.arange(N_ENVS, dtype=torch.float32)
    friction_only = dataclasses.replace(shared, geom_friction=frictions)
    out = tf.n_step(plan, friction_only, tm.make_data(plan, friction_only, N_ENVS).replace(
        **{k: v[[0] * N_ENVS] for k, v in start.items()}), 1)
    assert (out.qacc[0] - out.qacc[2]).abs().max() > 1e-3


def test_unsupported_leaf_raises(toy):
    """Every Model field may be randomized; a name that is no Model field
    raises ValueError, as do leaves that disagree on the number of envs and a
    batch of another size than the randomized one."""
    _, tenv = toy
    every = tuple(tm.LEAF_RANK)

    def randomize(model):
        return dataclasses.replace(model, **{
            n: getattr(model, n).expand((N_ENVS,) + getattr(model, n).shape).clone() for n in every}), every

    wrapped = wrappers.DomainRandomizationVmapWrapper(tenv, randomize)
    assert wrapped.randomized == every and len(every) == 71 and wrapped.num_envs == N_ENVS

    def unknown(model):
        return dataclasses.replace(model, body_mass=model.body_mass.repeat(N_ENVS, 1)), ("body_mass", "body_masses")

    with pytest.raises(ValueError, match="body_masses"):
        wrappers.DomainRandomizationVmapWrapper(tenv, unknown)

    def disagree(model):
        return dataclasses.replace(model, body_mass=model.body_mass.repeat(N_ENVS, 1),
                                   dof_armature=model.dof_armature.repeat(N_ENVS + 1, 1)), ("body_mass", "dof_armature")

    with pytest.raises(ValueError, match="disagree"):
        wrappers.DomainRandomizationVmapWrapper(tenv, disagree)

    def wrong_shape(model):
        return dataclasses.replace(model, body_mass=model.body_mass.repeat(N_ENVS, 2)), ("body_mass",)

    with pytest.raises(ValueError, match="body_mass"):
        wrappers.DomainRandomizationVmapWrapper(tenv, wrong_shape)
    with pytest.raises(ValueError, match="envs"):
        wrappers.DomainRandomizationVmapWrapper(tenv, _randomize_port).reset(torch.Generator().manual_seed(0), 2)


# ---------------------------------------------------------------------------
# the bf16 rollout policy
# ---------------------------------------------------------------------------

OBS, REF, NU, LAT, B = 40, 24, 6, 8, 16
# bf16 bodies in both packages (8 significant bits; eps 2^-8 = 3.9e-3),
# products and LayerNorm statistics rounded in other places: per env,
# relative to max(1, max |JAX|). Measured up to 1.4e-2, feed-forward and
# recurrent.
BF16_REL = 3e-2


def _carried(recurrent: bool, seed: int = 3):
    rng = np.random.RandomState(seed)
    norm = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jnp.float32)).replace(
        mean=jnp.asarray(rng.normal(size=OBS), jnp.float32), std=jnp.asarray(rng.uniform(0.5, 2.0, OBS), jnp.float32)
    )
    widths = dict(intention_latent_size=LAT, encoder_hidden_layer_sizes=(32, 32), decoder_hidden_layer_sizes=(32,),
                  value_hidden_layer_sizes=(16,))
    kp, kv = jax.random.split(jax.random.PRNGKey(seed))
    if recurrent:
        jnet = jlstm_networks.make_intention_ppo_networks(OBS, REF, NU, preprocess_observations_fn=jrs.normalize,
                                                          hidden_state_size=16, hidden_layer_num=2, **widths)
        zero = jnp.zeros((1, 2, 16))
        pp = jnet.policy_network.init(kp, hidden_state=(zero, zero))
        tnet = tlstm_networks.make_intention_ppo_networks(
            OBS, REF, NU, preprocess_observations_fn=running_statistics.normalize, hidden_state_size=16,
            hidden_layer_num=2, device="cpu", **widths)
    else:
        jnet = jpn.make_intention_ppo_networks(OBS, REF, NU, preprocess_observations_fn=jrs.normalize, **widths)
        pp = jnet.policy_network.init(kp)
        tnet = tpn.make_intention_ppo_networks(OBS, REF, NU, preprocess_observations_fn=running_statistics.normalize,
                                               device="cpu", **widths)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    params = tpn.params_from_flax(as_np(pp), as_np(jnet.value_network.init(kv)), as_np(norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    obs = rng.normal(scale=2.0, size=(B, OBS)).astype(np.float32)
    return jnet, (norm, pp), tnet, params.normalizer, obs


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "deterministic"])
def test_bf16_policy_matches_jax(deterministic):
    jnet, (norm, pp), tnet, tnorm, obs = _carried(recurrent=False)
    key = jax.random.PRNGKey(11)
    jpolicy = jax.jit(jpn.make_inference_fn(jnet)((norm, pp), deterministic=deterministic,
                                                  compute_dtype=jnp.bfloat16))
    jaction, jextras = jpolicy(obs, key)
    f32 = tpn.make_inference_fn(tnet)(tnorm, deterministic=deterministic)
    bf16 = tpn.make_inference_fn(tnet)(tnorm, deterministic=deterministic, compute_dtype=torch.bfloat16)
    noise = None if deterministic else types.PolicyNoise(*(torch.as_tensor(n) for n in jax_policy_noise(key, B, LAT, NU)))
    action, extras = bf16(torch.as_tensor(obs), noise)
    action32, extras32 = f32(torch.as_tensor(obs), noise)
    assert action.dtype == torch.float32 and all(v.dtype == torch.float32 for v in extras.values())
    assert all(p.dtype == torch.float32 for p in tnet.policy_network.parameters())  # master parameters
    assert per_env_rel(action, np.asarray(jaction)).max() < BF16_REL
    for k in ("latent_mean", "latent_logvar") + (() if deterministic else ("logits", "raw_action")):
        want = np.asarray(jextras[k])
        assert per_env_rel(extras[k], want).max() < BF16_REL, k
    # bf16 is not float32: the outputs move by its roundoff
    assert (extras["latent_mean"] - extras32["latent_mean"]).abs().max() > 1e-4


def test_bf16_recurrent_policy_matches_jax():
    jnet, (norm, pp), tnet, tnorm, obs = _carried(recurrent=True)
    rng = np.random.RandomState(5)
    carry = tuple((rng.randn(B, 2, 16) * 0.5).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    jpolicy = jax.jit(jlstm_networks.make_inference_fn(jnet)((norm, pp), deterministic=False,
                                                             compute_dtype=jnp.bfloat16))
    jaction, jextras, jnext = jpolicy(obs, key, carry)
    policy = tlstm_networks.make_inference_fn(tnet)(tnorm, deterministic=False, compute_dtype=torch.bfloat16)
    noise = types.PolicyNoise(*(torch.as_tensor(n) for n in jax_policy_noise(key, B, LAT, NU)))
    action, extras, nxt = policy(torch.as_tensor(obs), noise, tuple(torch.as_tensor(c) for c in carry))
    assert per_env_rel(action, np.asarray(jaction)).max() < BF16_REL
    for k in ("latent_mean", "logits"):
        assert per_env_rel(extras[k], np.asarray(jextras[k])).max() < BF16_REL, k
    for g, w in zip(nxt, jnext):
        assert g.dtype == torch.float32
        assert per_env_rel(g, np.asarray(w)).max() < BF16_REL


def _tiny_factory(*args, **kwargs):
    kwargs.update(intention_latent_size=4, encoder_hidden_layer_sizes=(16,), decoder_hidden_layer_sizes=(16,),
                  value_hidden_layer_sizes=(16,))
    return tpn.make_intention_ppo_networks(*args, **kwargs)


def _tiny_lstm_factory(*args, **kwargs):
    kwargs.update(intention_latent_size=4, encoder_hidden_layer_sizes=(16,), decoder_hidden_layer_sizes=(16,),
                  value_hidden_layer_sizes=(16,), hidden_state_size=8, hidden_layer_num=2)
    return tlstm_networks.make_intention_ppo_networks(*args, **kwargs)


COMMON = dict(num_timesteps=64, episode_length=8, num_envs=N_ENVS, num_eval_envs=2, seed=0, unroll_length=4,
              batch_size=N_ENVS, num_minibatches=2, num_updates_per_batch=1, num_evals=2,
              normalize_observations=True, device="cpu")
TRAINERS = {
    "mlp": (ppo.train, dict(network_factory=_tiny_factory)),
    "lstm": (lstm_ppo.train, dict(network_factory=_tiny_lstm_factory, config_dict={
        "network_config": {"hidden_state_size": 8, "hidden_layer_num": 2}, "env_config": {"render_interval": 1}})),
}


@pytest.mark.parametrize("pipeline", sorted(TRAINERS))
def test_trainers_with_bf16_rollout_and_randomization(toy, pipeline):
    """Both trainers with `rollout_bf16` and `randomization_fn`: the rollout
    acts in bf16 (its logits are not the float32 policy's, but near them),
    the master parameters stay float32 and finite, and the randomization
    gets one generator for the training envs and another for the eval
    envs."""
    _, tenv = toy
    train, kw = TRAINERS[pipeline]
    calls, gaps = [], []
    shared = tenv.model

    def randomize(model, generator, num_envs):
        calls.append((generator, num_envs))
        frictions = model.geom_friction.repeat(num_envs, 1, 1)
        frictions[:, 0, 0] = 0.5 + torch.rand(num_envs, generator=generator, device=frictions.device)
        return dataclasses.replace(model, geom_friction=frictions), ("geom_friction",)

    def check_batch(state, data, make_learner):
        """The rollout's latent means against the float32 encoder's on the
        same observations and normalizer."""
        module = state.networks.policy_network.module
        with torch.no_grad():
            obs = running_statistics.normalize(data.observation, state.normalizer_params)
            mean32 = module.encoder(obs[..., : module.reference_obs_size])[0]
        gaps.append(float((data.extras["policy_extras"]["latent_mean"] - mean32).abs().max()))

    _, (normalizer, policy), metrics = train(environment=tenv, rollout_bf16=True, randomization_fn=randomize,
                                             batch_callback=check_batch, **COMMON, **kw)
    assert tenv.model is shared
    assert [n for _, n in calls] == [N_ENVS, 2] and calls[0][0] is not calls[1][0]
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in policy.values())
    assert np.isfinite(metrics["training/total_loss"])
    assert gaps and all(1e-5 < gap < BF16_REL for gap in gaps), gaps  # bf16 roundoff, not float32's


# ---------------------------------------------------------------------------
# foreign envs
# ---------------------------------------------------------------------------


class FedPointMass(PointMassEnv):
    """The port's point mass reset at given positions (the JAX reset's)."""

    def __init__(self, pos):
        super().__init__("cpu")
        self.pos = torch.as_tensor(np.asarray(pos))

    def reset(self, rng, batch_size):
        return self.reset_at(self.pos[:batch_size])


# The same float32 formulas; measured up to 3.7e-8.
POINT_REL = 1e-6


def test_wrap_external_matches_jax():
    env = jwrappers.wrap_external(JaxPointMass(), episode_length=8)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jstate = jax.jit(env.reset)(keys)
    jstep = jax.jit(env.step)
    tenv = wrappers.wrap_external(FedPointMass(np.asarray(jstate.obs)[:, :2]), episode_length=8)
    tstate = tenv.reset(None, 4)
    actions = np.asarray(np.random.RandomState(2).uniform(-3, 3, (10, 4, 2)), np.float32)
    for t in range(10):  # past the episode boundary: an auto-reset
        jstate = jstep(jstate, actions[t])
        tstate = tenv.step(tstate, torch.as_tensor(actions[t]))
        for name in ("obs", "reward", "done"):
            assert per_env_rel(getattr(tstate, name), np.asarray(getattr(jstate, name))).max() < POINT_REL, (t, name)
        for name in ("truncation", "steps"):
            np.testing.assert_array_equal(tstate.info[name].numpy(), np.asarray(jstate.info[name]), err_msg=name)
        np.testing.assert_allclose(tstate.metrics["dist"].numpy(), np.asarray(jstate.metrics["dist"]), rtol=1e-6)
    assert np.asarray(jstate.info["truncation"]).any() or t >= 8


def test_mlp_trainer_on_foreign_env():
    """tests/test_external_env.py's trainer run: the whole observation feeds
    the encoder, no proprioceptive slice."""
    cfg = {"network_config": {}, "env_config": {"render_interval": 10}}
    _, (normalizer, policy), metrics = ppo.train(
        environment=PointMassEnv("cpu"), config_dict=cfg, network_factory=_tiny_factory,
        **{**COMMON, "num_envs": 8, "batch_size": 8, "num_eval_envs": 4},
    )
    assert "training/sps" in metrics and np.isfinite(metrics["eval/episode_reward"])
    assert cfg["network_config"]["reference_obs_size"] == 4 and cfg["network_config"]["proprioceptive_obs_size"] == 0
    assert all(torch.isfinite(v).all() for v in policy.values()) and torch.isfinite(normalizer.mean).all()


class DictObsPointMass(PointMassEnv):
    def reset(self, rng, batch_size):
        s = super().reset(rng, batch_size)
        return s.replace(obs={"pos": s.obs[:, :2], "vel": s.obs[:, 2:]})


def test_dict_observations_raise_a_clear_error():
    """ADVICE.md, mlp_ppo/ppo.py:208: the reference's fallback calls
    np.asarray on dict observations; the port names the problem."""
    with pytest.raises(ValueError, match="dict observations"):
        wrappers.wrap_external(DictObsPointMass("cpu"), episode_length=4).reset(torch.Generator().manual_seed(0), 2)
    with pytest.raises(ValueError, match="dict observations"):
        ppo.train(environment=DictObsPointMass("cpu"), network_factory=_tiny_factory, **COMMON)


@struct.dataclass
class _JaxCounterState:
    pipeline_state: jax.Array
    obs: jax.Array
    reward: jax.Array
    done: jax.Array
    metrics: dict
    info: dict


class _JaxCounter:
    """A JAX foreign env whose step reads its observation: obs' = obs + 1,
    done where obs' is 3 (an episode of 3 steps)."""

    action_size = 1

    def reset(self, rng):
        zero = jnp.zeros(())
        return _JaxCounterState(jnp.zeros(1), jnp.zeros(1), zero, zero, {}, {})

    def step(self, state, action):
        obs = state.obs + 1
        return state.replace(pipeline_state=obs, obs=obs, done=jnp.where(obs[0] == 3, 1.0, 0.0))


@dataclasses.dataclass(frozen=True)
class _CounterState(PointMassState):
    pass


class Counter:
    """The same counter in the port's foreign-env contract."""

    action_size = 1

    def reset(self, rng, batch_size):
        zero = torch.zeros(batch_size)
        return _CounterState(torch.zeros(batch_size, 1), torch.zeros(batch_size, 1), zero, zero, {}, {})

    def step(self, state, action):
        obs = state.obs + 1
        return state.replace(pipeline_state=obs, obs=obs, done=(obs[:, 0] == 3).float())


def test_auto_reset_obs_reaches_the_next_step():
    """ADVICE.md, wrappers.py:270-274: after an auto-reset the reference's
    adapter keeps the pre-reset obs in the foreign state, so the next step
    counts on from it (1 + 3); the port writes the reset's obs back (0 + 1)."""
    jenv = jwrappers.wrap_external(_JaxCounter(), episode_length=100)
    jstate = jenv.reset(jax.random.split(jax.random.PRNGKey(0), 2))
    tenv = wrappers.wrap_external(Counter(), episode_length=100)
    tstate = tenv.reset(None, 2)
    jobs, tobs = [], []
    for _ in range(4):
        jstate = jenv.step(jstate, jnp.zeros((2, 1)))
        tstate = tenv.step(tstate, torch.zeros(2, 1))
        jobs.append(float(jstate.obs[0, 0]))
        tobs.append(float(tstate.obs[0, 0]))
    assert tobs == [1.0, 2.0, 0.0, 1.0]  # the third step ends the episode: the reset's obs, then one step on
    assert jobs == [1.0, 2.0, 0.0, 4.0]  # the reference's stale obs


# ---------------------------------------------------------------------------
# profile_dir
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pipeline", sorted(TRAINERS))
def test_profile_dir_writes_a_trace_of_the_phases(toy, pipeline, tmp_path):
    """Two epochs (num_evals 3): the second, the first after the warm-up,
    runs under torch.profiler."""
    _, tenv = toy
    train, kw = TRAINERS[pipeline]
    train(environment=tenv, profile_dir=str(tmp_path), **{**COMMON, "num_evals": 3}, **kw)
    (name,) = os.listdir(tmp_path)
    assert name == "epoch_1.pt.trace.json"
    with open(tmp_path / name) as f:
        events = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"rollout", "normalizer_update", "sgd"} <= events
