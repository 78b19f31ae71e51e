"""The port's offline rollout generator (analysis/rollout.py) on the rodent
against the JAX package's, step by step, for the MLP and the LSTM
pipelines: rodent-full-clips' env (synthetic clips), the policies at narrow
widths with the JAX weights carried across, two clips in one batch.

The rodent is chaotic in float32 under contact (tests/test_torch_rodent_env.py),
so the two packages' rollouts are not run free against each other. The
port's generator runs from the JAX render reset's draws with its own
physics, and the JAX package replays it step by step: its render wrapper's
reset and step, with its own policy on its own observations, but handed
the port's Data where its pipeline_init and n_step would run (the physics
is held against the JAX package's in tests/test_torch_rodent_env.py, whose
jit of the rodent's n_step takes minutes on the CPU; here only the JAX env
layer is compiled). Every channel the generator logs (qpos, actions,
rewards and metrics, the activation taps, cfrc_ext and sensordata) is then
held per step against the JAX package's on the same Data:
- REL 5e-5: the policy's products and tanh on observations that differ by
  the env layer's float32 roundoff (test_torch_rodent_env.py's
  ROLLOUT_REL); the reset's forward, obs and the env layer are held there
  at 1e-6 and 1e-5;
- WRENCH 1e-5: cfrc_ext, a pure function of the same Data
  (test_torch_postconstraint.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from torch_parity import per_env_rel, port_clip, port_reward_config
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jlpn
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jw
from track_mjx_tpu.envs.task.reward import RewardConfig
from track_mjx_tpu.envs.task.tracking import MultiClipTracking as JaxMultiClip
from track_mjx_tpu.io.synthetic import synthesize_clips
from track_mjx_tpu.physics import model as jm
from track_mjx_tpu.physics import postconstraint as jpost
from track_mjx_tpu.utils.config import load_config
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tlpn
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.analysis import rollout as troll
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.envs.walker.rodent import Rodent
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm

torch.set_num_threads(1)
REL = 5e-5
WRENCH = 1e-5
CLIPS = [1, 0]
STEPS = 3  # a clip of 4 frames: 4 x 1 - 1 control steps
CLIP = dict(clip_length=12, random_init_range=5, traj_length=5)
KW = dict(intention_latent_size=8, encoder_hidden_layer_sizes=[32, 16], decoder_hidden_layer_sizes=[16, 16],
          value_hidden_layer_sizes=[16])
LSTM = dict(hidden_state_size=16, hidden_layer_num=2)


def _cfg(lstm: bool) -> dict:
    return {
        "reference_config": {"clip_length": STEPS + 1},
        "train_setup": {"train_config": {"use_lstm": lstm}},
        "network_config": dict(LSTM),
        "logging_config": {"rollout_metrics": ["pos_reward", "joint_distance", "fall"]},
    }


@pytest.fixture(scope="module")
def rodent():
    """The JAX rodent env and its render wrapper's reset (2 clips) and step,
    jitted with the physics handed in, the port's env on the same clips,
    and the reset's draws."""
    tf.set_full_f32()
    cfg = load_config("rodent-full-clips")
    env_args = dict(cfg.env_config.env_args)
    jwalker = torch_parity.load_export_tool().workload_walker("rodent-full-clips")
    clips = synthesize_clips(jwalker._mj_model, n_clips=2, n_frames=CLIP["clip_length"], mocap_hz=50)
    jenv = JaxMultiClip(clips, jwalker, RewardConfig(**dict(cfg.env_config.reward_weights)), **env_args, **CLIP)
    tenv = tt.MultiClipTracking(port_clip(clips), Rodent.from_snapshot(tm.load_snapshot("rodent-full-clips")),
                                port_reward_config(jenv._reward_config), **env_args, **CLIP, device="cpu")
    jr = jw.RenderRolloutWrapperMulticlipTracking(jenv)
    keys = jax.random.split(jax.random.PRNGKey(3), len(CLIPS))

    def handed(name, fn):
        """`fn` with the env's physics entry `name` returning the Data given last."""

        def run(*args):
            *args, data = args
            setattr(jenv, name, lambda *_: data)
            try:
                return fn(*args)
            finally:
                delattr(jenv, name)

        return jax.jit(jax.vmap(run))

    jreset = handed("pipeline_init", lambda key, clip: jr.reset(key, clip_idx=clip))
    jstep = handed("pipeline_step", jr.step)

    def noise(key):  # RenderRolloutWrapperMulticlipTracking.reset, then reset_from_clip's rng1
        _, _, rng = jax.random.split(key, 3)
        _, rng1, _ = jax.random.split(rng, 3)
        s = jenv._reset_noise_scale
        return (jax.random.uniform(rng1, (jenv.plan.nq,), minval=-s, maxval=s),
                jax.random.uniform(rng1, (jenv.plan.nv,), minval=-s, maxval=s))

    draws = [np.asarray(x) for x in jax.vmap(noise)(keys)]
    cfrc = jax.jit(jax.vmap(lambda d: jpost.cfrc_ext(jenv.plan, jenv.model, d)))
    return jenv, tenv, (keys, jreset), jstep, cfrc, draws


def _networks(jenv, tenv, lstm: bool):
    obs, ref, nu = tenv.observation_size, tenv.reference_obs_size, tenv.action_size
    rng = np.random.RandomState(4)
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs,), np.float32)).replace(
        mean=np.asarray(0.1 * rng.normal(size=obs), np.float32),
        std=np.asarray(rng.uniform(0.5, 2.0, obs), np.float32),
    )
    kw = dict(KW, **LSTM) if lstm else KW
    jp, tp = (jlpn, tlpn) if lstm else (jpn, tpn)
    jnet = jp.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=jrs.normalize, **kw)
    zero = jnp.zeros((1, LSTM["hidden_layer_num"], LSTM["hidden_state_size"]))
    pp = jnet.policy_network.init(jax.random.PRNGKey(2), **({"hidden_state": (zero, zero)} if lstm else {}))
    vp = jnet.value_network.init(jax.random.PRNGKey(3))
    tnet = tp.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=trs.normalize, device="cpu", **kw)
    params = tp.params_from_flax(*(jax.tree.map(np.asarray, t) for t in (pp, vp, norm)), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    jpolicy = jax.jit(jp.make_inference_fn(jnet)((norm, pp), deterministic=True, get_activation=True))
    tpolicy = tp.make_inference_fn(tnet)(params.normalizer, deterministic=True, get_activation=True)
    return jpolicy, tpolicy


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("lstm", [False, True], ids=["mlp", "lstm"])
def test_rollout_generator_step_by_step_matches_jax(rodent, lstm, monkeypatch):
    jenv, tenv, reset, jstep, jcfrc, draws = rodent
    jpolicy, tpolicy = _networks(jenv, tenv, lstm)
    names = _cfg(lstm)["logging_config"]["rollout_metrics"]

    # the port's generator from the JAX reset's draws, its physics recorded
    queue = [torch.as_tensor(d.astype(np.float32)) for d in draws]
    monkeypatch.setattr(tenv, "_uniform", lambda rng, shape: queue.pop(0).reshape(shape))
    physics = []
    for name in ("pipeline_init", "pipeline_step"):
        run = getattr(tenv, name)
        monkeypatch.setattr(tenv, name, lambda *a, run=run: physics.append(run(*a)) or physics[-1])
    gen = troll.create_rollout_generator(_cfg(lstm), tenv, tpolicy, model="lstm" if lstm else "mlp",
                                         log_activations=True, log_metrics=True, log_sensor_data=True)
    got = gen(torch.tensor(CLIPS))
    assert len(physics) == STEPS + 1

    # the JAX package's rollout on the port's physics, recorded per step
    def jdata(d):
        return jm.Data(**{f.name: jnp.asarray(getattr(d, f.name).numpy()) for f in dataclasses.fields(jm.Data)})

    keys, jreset = reset
    jstate = jreset(keys, jnp.array(CLIPS), jdata(physics[0]))
    want = {"ctrl": [], "reward": [], "taps": [], "wrench": [], "metrics": []}
    hidden = tuple(jnp.zeros((len(CLIPS), LSTM["hidden_layer_num"], LSTM["hidden_state_size"])) for _ in range(2))
    for t in range(STEPS):
        if lstm:
            action, extras, hidden = jpolicy(jstate.obs, jax.random.PRNGKey(0), hidden)
        else:
            action, extras = jpolicy(jstate.obs, jax.random.PRNGKey(0))
        jstate = jstep(jstate, action, jdata(physics[t + 1]))
        for k, v in (("ctrl", action), ("reward", jstate.reward), ("taps", extras["activations"]),
                     ("wrench", jcfrc(jstate.pipeline_state)), ("metrics", {n: jstate.metrics[n] for n in names})):
            want[k].append(jax.tree.map(np.asarray, v))

    n = len(CLIPS)
    assert got["qposes_rollout"].shape == (n, STEPS + 1, tenv.plan.nq) and got["ctrl"].shape == (n, STEPS, 38)
    assert got["joint_forces"].shape == (n, STEPS, tenv.plan.nbody, 6)
    assert got["sensor_readings"].shape == (n, STEPS, tenv.plan.nsensordata)
    for t in range(STEPS + 1):
        assert torch.equal(got["qposes_rollout"][:, t], physics[t].qpos)
    for t in range(STEPS):
        assert torch.equal(got["sensor_readings"][:, t], physics[t + 1].sensordata)
        assert per_env_rel(got["ctrl"][:, t], want["ctrl"][t]).max() < REL, f"ctrl {t}"
        assert per_env_rel(got["state_rewards"][:, t + 1, None], want["reward"][t][:, None]).max() < REL, f"reward {t}"
        for k in names:
            g = got["rollout_metrics"][f"{k}s"][:, t + 1, None]
            assert per_env_rel(g, want["metrics"][t][k][:, None]).max() < REL, f"{k} {t}"
        w = want["wrench"][t]
        assert torch_parity.rel_err(got["joint_forces"][:, t], w) < WRENCH, f"cfrc_ext {t}"
        g, w = _flat(jax.tree.map(lambda x: x[:, t], got["activations"])), _flat(want["taps"][t])
        assert sorted(g) == sorted(w), (sorted(g), sorted(w))
        for k in w:
            assert g[k].shape == w[k].shape, k
            assert per_env_rel(g[k].reshape(n, -1), w[k].reshape(n, -1)).max() < REL, f"{k} {t}"
    assert np.abs(np.stack(want["wrench"])).max() > 0, "the rodent's feet must touch the floor"
    # the reset: the reference's frame 0 of each clip plus the JAX reset's qpos draw
    ref = tenv._reference_clips
    frame0 = torch.cat([ref.position, ref.quaternion, ref.joints], -1)[CLIPS, 0]
    assert torch.equal(got["qposes_rollout"][:, 0], frame0 + torch.as_tensor(draws[0]))
    torch.testing.assert_close(got["qposes_ref"][:, :STEPS + 1],
                               torch.cat([ref.position, ref.quaternion, ref.joints], -1)[CLIPS, :STEPS + 1],
                               rtol=0, atol=0)


@pytest.mark.parametrize("lstm", [False, True], ids=["mlp", "lstm"])
def test_trainers_honour_get_activation(tmp_path, lstm):
    """train_config.get_activation reaches the trainers' policies, as in the
    JAX trainers (ppo_factory.py:162-190): the MLP trainer's logging policy
    (handed to policy_params_fn) carries the taps in its extras, the LSTM
    trainer's rollout policy does (so its transitions hold them, [T, B, ...])."""
    from test_torch_train_cli import TINY
    from track_mjx_tpu_torch import train
    from track_mjx_tpu_torch.io import load
    from track_mjx_tpu_torch.io.synthetic import synthesize_clips
    from track_mjx_tpu_torch.utils import config as tconfig

    tf.set_full_f32()
    clips = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=20, seed=0, device="cpu")
    load.save_npz(clips, tmp_path / "clips.npz")
    extra = ["train_setup.train_config.use_lstm=true", "network_config.hidden_state_size=16",
             "network_config.hidden_layer_num=2"] if lstm else []
    cfg = tconfig.load_config("rodent-full-clips", [
        f"data_path={tmp_path / 'clips.npz'}", f"logging_config.model_path={tmp_path / 'ckpts'}", *TINY, *extra,
        "train_setup.train_config.get_activation=true"])
    logged, batches = [], []

    def policy_params_fn(current_step, jit_logging_inference_fn, params, policy_params_fn_key, **_):
        obs = torch.zeros(3, params[0].mean.shape[0])
        carry = (torch.zeros(3, 2, 16),) * 2
        logged.append(jit_logging_inference_fn(obs, None, carry) if lstm else jit_logging_inference_fn(obs))

    train.main(cfg, policy_params_fn=policy_params_fn, batch_callback=lambda s, data, _: batches.append(data))
    extras = logged[-1][1]
    taps = batches[-1].extras["policy_extras"].get("activations")
    if lstm:  # the JAX LSTM trainer's logging policy records none
        assert "activations" not in extras
        assert sorted(taps) == ["decoder", "encoder", "hidden_state", "intention"]
        assert taps["encoder"]["layer_0"].shape == batches[-1].observation.shape[:2] + (16,)
    else:
        assert sorted(extras["activations"]) == ["decoder", "egocentric_obs", "encoder", "intention", "traj_obs"]
        assert taps is None
