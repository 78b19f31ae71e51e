"""The port's analysis-from-a-checkpoint path against the JAX package's:
the activation taps, the decoder-only policy of a checkpoint, the eval and
auto-align wrappers, the stick walker's name tables, the clip metadata and
subsample helpers, HDF5 files across the two packages, create_environment
and the offline rollout generator on the toy walker (the rodent's, step by
step, is tests/test_torch_analysis_rodent.py).

Inputs are made with numpy from seeds and fed to both packages; the JAX
networks' flax weights are carried across by params_from_flax and the JAX
resets' draws fed to the port's resets.

Tolerances, relative to max(1, max |JAX|) per env unless said otherwise:
- TAPS 1e-5: the same float32 layers, sums over at most 16 terms in
  another order (test_torch_policy.py holds the policy's outputs at 1e-5);
- RESET 1e-6: the same float32 formulas on identical inputs (the reset's
  forward and obs; test_torch_rodent_env.py's RESET_REL);
- TOY_FLOOR 1e-5 beside 10 times the JAX package's own sensitivity: the
  toy walker's whole offline rollout, chaotic in float32 once it lands
  (the test's docstring);
- a batch of 2 clips equals the same clips run alone bit for bit, on a
  batch-invariant path (the test's docstring);
- AUTO_ALIGN 1e-5: one toy control step from identical states (the
  realigned envs' qpos and qvel are the reference's, exactly).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from test_io_stac import stac_file  # noqa: F401  (fixture)
from torch_parity import per_env_rel, port_clip, port_reward_config, port_walker, state_to_torch
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jlpn
from track_mjx_tpu.agent.mlp_ppo import intention_network as jin
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.analysis import rollout as jroll
from track_mjx_tpu.analysis import utils as jh5
from track_mjx_tpu.envs import wrappers as jw
from track_mjx_tpu.io import load as jload
from track_mjx_tpu.testing import make_toy_env
from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent import types as ttypes
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tlpn
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.analysis import rollout as troll
from track_mjx_tpu_torch.analysis import utils as th5
from track_mjx_tpu_torch.envs import wrappers as tw
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.io import load as tload
from track_mjx_tpu_torch.physics import forward as tf

torch.set_num_threads(1)
TAPS = 1e-5
RESET = 1e-6
AUTO_ALIGN = 1e-5
TOY_FLOOR = 1e-5
CLIP_LEN = 30
# Four substeps a control step, one control step a 50 Hz frame at the
# toy's 0.005 s. At two (the toy's default) XLA folds a control step's two
# time increments into one add, t + 2 dt, where the port (as MuJoCo C) adds
# dt substep by substep; the float32 times part by an ulp, and at a frame
# boundary floor(time x mocap_hz) then reads another frame (ROADMAP,
# standing divergences). A scan of three substeps and a last one adds dt
# one at a time in both packages, so their times agree bit for bit.
SUBSTEPS = 4
LATENT = 4
WIDTHS = dict(
    intention_latent_size=LATENT,
    encoder_hidden_layer_sizes=(16,),
    decoder_hidden_layer_sizes=(16,),
    value_hidden_layer_sizes=(16,),
)
TOY_CFG = {
    "reference_config": {"clip_length": CLIP_LEN},
    "train_setup": {"train_config": {"use_lstm": False}},
    "logging_config": {"rollout_metrics": ["pos_reward", "fall"]},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _flat(tree, prefix=""):
    """{path: array} of a nest of dicts, tuples and arrays."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _assert_trees(got, want, rel, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), f"{what}: keys {sorted(g)} against {sorted(w)}"
    for k in w:
        assert g[k].shape == w[k].shape, f"{what} {k}: {g[k].shape} against {w[k].shape}"
        err = per_env_rel(g[k].reshape(g[k].shape[0], -1), w[k].reshape(w[k].shape[0], -1)).max() if w[k].size else 0
        assert err < rel, f"{what} {k}: {err:.3e}"


@pytest.fixture(scope="module")
def toy():
    """The toy walker's JAX env (clips of 30 frames, SUBSTEPS a control
    step), the port's env on its clips, walker and reward config, and the
    intention networks at widths 16 with the JAX weights carried across (a
    non-trivial normalizer)."""
    tf.set_full_f32()
    jenv = make_toy_env(clip_length=CLIP_LEN, physics_steps_per_control_step=SUBSTEPS)
    tenv = _port_toy(jenv)
    return (jenv, tenv, *_toy_networks(tenv))


def _port_toy(jenv):
    return tt.MultiClipTracking(
        port_clip(jenv._reference_clips), port_walker(jenv.walker), port_reward_config(jenv._reward_config),
        physics_steps_per_control_step=jenv._n_frames, reset_noise_scale=1e-3, solver="cg", iterations=4,
        ls_iterations=4, mj_model_timestep=0.005, mocap_hz=50, clip_length=CLIP_LEN, random_init_range=10,
        traj_length=5, device="cpu",
    )


def _toy_networks(tenv):
    obs, ref, nu = tenv.observation_size, tenv.reference_obs_size, tenv.action_size
    jnet = jpn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=jrs.normalize, **WIDTHS)
    pp, vp = jnet.policy_network.init(jax.random.PRNGKey(1)), jnet.value_network.init(jax.random.PRNGKey(2))
    rng = np.random.RandomState(3)
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs,), jnp.float32)).replace(
        mean=jnp.asarray(rng.normal(scale=0.1, size=obs), jnp.float32),
        std=jnp.asarray(rng.uniform(0.5, 2.0, obs), jnp.float32),
    )
    tnet = tpn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=trs.normalize, device="cpu",
                                           **WIDTHS)
    params = tpn.params_from_flax(_np(pp), _np(vp), _np(norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    tnet.value_network.load_state_dict(params.value)
    return jnet, (norm, pp, vp), tnet, params


def _fed(env, monkeypatch, draws):
    """`env._uniform` hands out `draws` in turn (the JAX reset's noises)."""
    queue = [torch.as_tensor(np.asarray(d, np.float32)) for d in draws]
    monkeypatch.setattr(env, "_uniform", lambda rng, shape: queue.pop(0).reshape(shape))
    return queue


def _jax_render_reset_draws(env, seed):
    """The qpos and qvel noise that the JAX generate_rollout(clip, seed)'s
    reset draws (analysis/rollout.py, wrappers.py, tracking.py)."""
    _, reset_rng, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    _, _, rng = jax.random.split(reset_rng, 3)
    _, rng1, _ = jax.random.split(rng, 3)
    s = env._reset_noise_scale
    return [np.asarray(jax.random.uniform(rng1, (n,), minval=-s, maxval=s)) for n in (env.plan.nq, env.plan.nv)]


# ---------------------------------------------------------------------------
# activation taps and the decoder-only policy
# ---------------------------------------------------------------------------


def test_activation_taps_mlp_match_jax(toy):
    _, tenv, jnet, (norm, pp, _), tnet, params = toy
    rng = np.random.RandomState(5)
    obs = rng.normal(size=(6, tenv.observation_size)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    for deterministic in (True, False):
        jpolicy = jpn.make_inference_fn(jnet)((norm, pp), deterministic=deterministic, get_activation=True)
        jaction, jextras = jpolicy(obs, key)
        tpolicy = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=deterministic, get_activation=True)
        noise = ttypes.PolicyNoise(*(_t(x) for x in torch_parity.jax_policy_noise(key, 6, LATENT, tenv.action_size)))
        taction, textras = tpolicy(_t(obs), noise)
        assert sorted(jextras["activations"]) == ["decoder", "egocentric_obs", "encoder", "intention", "traj_obs"]
        _assert_trees(textras["activations"], jextras["activations"], TAPS, f"MLP taps, deterministic {deterministic}")
        assert sorted(jextras["activations"]["encoder"]) == ["layer_0", "logvar", "mean"]
        assert per_env_rel(taction, jaction).max() < TAPS
    # without get_activation the extras carry no taps; in bf16 the same tree, float32
    plain = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=True)(_t(obs))[1]
    assert "activations" not in plain
    half = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=True, get_activation=True,
                                       compute_dtype=torch.bfloat16)(_t(obs))[1]["activations"]
    assert sorted(_flat(half)) == sorted(_flat(jextras["activations"]))
    assert all(v.dtype == np.float32 for v in _flat(half).values())


def test_activation_taps_lstm_match_jax(toy):
    _, tenv, _, _, _, _ = toy
    obs_size, ref, nu = tenv.observation_size, tenv.reference_obs_size, tenv.action_size
    kw = dict(WIDTHS, hidden_state_size=8, hidden_layer_num=2)
    jnet = jlpn.make_intention_ppo_networks(obs_size, ref, nu, preprocess_observations_fn=jrs.normalize, **kw)
    zero = jnp.zeros((1, 2, 8))
    pp = jnet.policy_network.init(jax.random.PRNGKey(4), hidden_state=(zero, zero))
    vp = jnet.value_network.init(jax.random.PRNGKey(5))
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs_size,), jnp.float32))
    tnet = tlpn.make_intention_ppo_networks(obs_size, ref, nu, preprocess_observations_fn=trs.normalize,
                                            device="cpu", **kw)
    params = tlpn.params_from_flax(_np(pp), _np(vp), _np(norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    rng = np.random.RandomState(6)
    obs = rng.normal(size=(5, obs_size)).astype(np.float32)
    carry = tuple(rng.normal(scale=0.5, size=(5, 2, 8)).astype(np.float32) for _ in range(2))
    jaction, jextras, jcarry = jlpn.make_inference_fn(jnet)((norm, pp), deterministic=True, get_activation=True)(
        obs, jax.random.PRNGKey(0), carry)
    taction, textras, tcarry = tlpn.make_inference_fn(tnet)(params.normalizer, deterministic=True,
                                                            get_activation=True)(_t(obs), None, tuple(map(_t, carry)))
    assert sorted(jextras["activations"]) == ["decoder", "encoder", "hidden_state", "intention"]
    assert sorted(jextras["activations"]["decoder"]) == ["lstm_projection"]
    _assert_trees(textras["activations"], jextras["activations"], TAPS, "LSTM taps")
    _assert_trees(tcarry, jcarry, TAPS, "LSTM carry")
    assert per_env_rel(taction, jaction).max() < TAPS


def test_decoder_policy_fn_from_a_port_checkpoint_matches_jax(toy, tmp_path):
    """make_decoder_policy_fn of a port checkpoint (the JAX weights) against
    the JAX decoder-only policy on the same [latent, egocentric] inputs, and
    against the full policy's decoder fed its own latent means."""
    _, tenv, jnet, (norm, pp, _), tnet, params = toy
    obs_size, ref, nu = tenv.observation_size, tenv.reference_obs_size, tenv.action_size
    cfg = {
        "network_config": {"observation_size": obs_size, "reference_obs_size": ref, "action_size": nu,
                           "intention_size": LATENT, "decoder_layer_sizes": [16]},
        "train_setup": {"train_config": {"use_lstm": False}},
    }
    checkpointing.CheckpointManager(str(tmp_path)).save(3, (params.normalizer, params.policy), {}, cfg)
    tpolicy = tpn.make_decoder_policy_fn(str(tmp_path), device="cpu")

    jdec = jin.make_decoder_policy(2 * nu, decoder_obs_size=obs_size - ref + LATENT,
                                   preprocess_observations_fn=jrs.normalize, decoder_hidden_layer_sizes=[16])
    jnorm = jrs.RunningStatisticsState(count=jnp.zeros(()), mean=norm.mean[ref:],
                                       summed_variance=norm.summed_variance[ref:], std=norm.std[ref:])
    rng = np.random.RandomState(7)
    x = rng.normal(size=(6, obs_size - ref + LATENT)).astype(np.float32)
    jlogits, _ = jdec.apply(jnorm, {"params": pp["params"]["decoder"]}, x)
    jaction = jnet.parametric_action_distribution.mode(jlogits)
    taction, extras = tpolicy(_t(x))
    assert extras == {} and per_env_rel(taction, jaction).max() < TAPS

    # fed the full deterministic policy's own latent means, it acts as that policy
    obs = _t(rng.normal(size=(6, obs_size)).astype(np.float32))
    full_action, full_extras = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=True)(obs)
    action, _ = tpolicy(torch.cat([full_extras["latent_mean"], obs[:, ref:]], dim=-1))
    torch.testing.assert_close(action, full_action, rtol=0, atol=1e-6)

    lstm_cfg = dict(cfg, train_setup={"train_config": {"use_lstm": True}})
    checkpointing.CheckpointManager(str(tmp_path / "lstm")).save(0, (params.normalizer, params.policy), {}, lstm_cfg)
    with pytest.raises(NotImplementedError, match="LSTM"):
        tpn.make_decoder_policy_fn(str(tmp_path / "lstm"), device="cpu")
    # load_policy and load_checkpoint_for_eval read the same step
    normalizer, policy_params = checkpointing.load_policy(str(tmp_path), device="cpu")
    assert torch.equal(normalizer.std, params.normalizer.std) and policy_params.keys() == params.policy.keys()
    bundle = checkpointing.load_checkpoint_for_eval(str(tmp_path), step=3, device="cpu")
    assert bundle["cfg"] == cfg and all(torch.equal(bundle["policy"][1][k], v) for k, v in params.policy.items())


# ---------------------------------------------------------------------------
# the eval and auto-align wrappers
# ---------------------------------------------------------------------------


def test_eval_clip_wrapper_matches_jax(toy):
    jenv, tenv, *_ = toy
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    clips = jnp.array([1, 0])
    jstate = jax.jit(jax.vmap(jw.EvalClipWrapperTracking(jenv).reset))(keys, clips)

    def qpos_noise(key):  # EvalClipWrapperTracking.reset, then reset_from_clip's rng1
        _, rng = jax.random.split(key)
        _, rng1, _ = jax.random.split(rng, 3)
        s = jenv._reset_noise_scale
        return jax.random.uniform(rng1, (jenv.plan.nq,), minval=-s, maxval=s)

    draws = np.asarray(jax.vmap(qpos_noise)(keys))
    tstate = tw.EvalClipWrapperTracking(tenv).reset_from_draws(_t(np.asarray(clips)), _t(draws))
    for name in ("qpos", "qvel", "xpos"):
        got, want = getattr(tstate.pipeline_state, name), getattr(jstate.pipeline_state, name)
        assert per_env_rel(got, want).max() < RESET, name
    assert not tstate.pipeline_state.qvel.any()
    assert per_env_rel(tstate.obs, jstate.obs).max() < RESET
    frame = tstate.info["reference_frame"]
    assert torch.equal(tstate.info["start_frame"], torch.zeros(2, dtype=torch.int64))
    assert torch.equal(frame.position, tenv._reference_clips.position[[1, 0], 0])
    assert torch.equal(tstate.pipeline_state.qpos,
                       torch.cat([frame.position, frame.quaternion, frame.joints], -1) + _t(draws))
    # from a generator: one clip for every env, its qpos draw on frame 0
    g = tw.EvalClipWrapperTracking(tenv).reset(torch.Generator().manual_seed(0), clip_idx=1, batch_size=3)
    assert torch.equal(g.info["clip_idx"], torch.ones(3, dtype=torch.int64)) and not g.pipeline_state.qvel.any()


def test_auto_align_wrapper_matches_jax(toy):
    """One control step from a reset in which env 0 stands 1 m off its
    reference (so it ends done): env 0 is realigned to the reference frame
    with kinematics run on it, the other envs keep the step's result."""
    jenv, tenv, *_ = toy
    keys = jax.random.split(jax.random.PRNGKey(12), 3)
    jstate = jax.jit(jax.vmap(jw.EvalClipWrapperTracking(jenv).reset))(keys, jnp.array([0, 1, 0]))
    ps = jstate.pipeline_state
    jstate = jstate.replace(pipeline_state=ps.replace(qpos=ps.qpos.at[0, 0].add(1.0)))
    action = np.random.RandomState(13).uniform(-0.2, 0.2, (3, jenv.plan.nu)).astype(np.float32)
    jout = jax.jit(jw.AutoAlignWrapperTracking(jw.VmapWrapper(jenv)).step)(jstate, jnp.asarray(action))
    assert np.asarray(jout.done).tolist()[0] == 1.0 and not np.asarray(jout.done)[1:].any()

    tstate = state_to_torch(jstate)
    kept = {}

    class Keep(tw.Wrapper):
        def step(self, state, a):
            kept["out"] = self.env.step(state, a)
            return kept["out"]

    tout = tw.AutoAlignWrapperTracking(Keep(tenv)).step(tstate, _t(action))
    assert torch.equal(tout.done, torch.tensor([1.0, 0.0, 0.0]))
    ref = tout.info["reference_frame"]
    d = tout.pipeline_state
    assert torch.equal(d.qpos[0], torch.cat([ref.position, ref.quaternion, ref.joints], -1)[0])
    assert torch.equal(d.qvel[0], torch.cat([ref.velocity, ref.angular_velocity, ref.joints_velocity], -1)[0])
    for f in dataclasses.fields(d):  # the envs that are not done keep the step's output bit for bit
        assert torch.equal(getattr(d, f.name)[1:], getattr(kept["out"].pipeline_state, f.name)[1:]), f.name
    for name in ("qpos", "qvel", "xpos", "xquat", "geom_xpos", "site_xpos"):
        got, want = getattr(d, name), getattr(jout.pipeline_state, name)
        assert per_env_rel(got, want).max() < AUTO_ALIGN, name
    assert per_env_rel(tout.obs, jout.obs).max() < AUTO_ALIGN
    # a done env's step count restarts on the next step
    nxt = tw.AutoAlignWrapperTracking(tenv).step(tout.replace(info=dict(tout.info, steps=torch.tensor([4., 4., 4.]))),
                                                 _t(action))
    assert nxt.info["steps"].tolist() == [0.0, 4.0, 4.0]


# ---------------------------------------------------------------------------
# the stick walker
# ---------------------------------------------------------------------------


STICK_NAMES = {
    "test_misc": ([], ["reference_base"], []),
    "real": (
        ["07-a2-l", "27-h-l-femur-l", "39-m-r-tibia-l", "nonexistent"],
        ["reference_base", "04-t1-l", "22-m-l-femur-l", "46-h-r-claws-l"],
        ["30-h-l-claws-l", "46-h-r-claws-l", "25-m-l-claws-l", "41-m-r-claws-l", "20-f-l-claws-l", "36-f-r-claws-l"],
    ),
}


@pytest.mark.parametrize("names", sorted(STICK_NAMES))
def test_stick_index_tables_match_jax(names):
    from track_mjx_tpu.envs.walker.stick import Stick as JStick
    from track_mjx_tpu_torch.envs.walker.stick import Stick

    joints, bodies, endeffs = STICK_NAMES[names]
    jwalker, twalker = JStick(joints, bodies, endeffs), Stick(joints, bodies, endeffs)
    for table in ("_joint_idxs", "_body_idxs", "_endeff_idxs"):
        want = np.asarray(getattr(jwalker, table)).astype(np.int64)
        np.testing.assert_array_equal(getattr(twalker, table), want, err_msg=table)
    assert twalker.torso_idx == int(jwalker._torso_idx) == 2
    assert (twalker._mj_model.nq, twalker._mj_model.nv, twalker._mj_model.nu) == (45, 44, 38)


def test_stick_raises_and_its_snapshot_is_a_fresh_export():
    from track_mjx_tpu_torch.envs.walker.stick import Stick
    from track_mjx_tpu_torch.physics import model as tm

    with pytest.raises(ValueError, match="not supported"):
        Stick([], [], [], torque_actuators=True)
    with pytest.raises(ValueError, match="export_torch_model.py --stick"):
        Stick([], [], [], rescale_factor=0.9)
    # the JAX Stick builds no other scale either (dm_scale_spec finds no root body "walker")
    from track_mjx_tpu.envs.walker.stick import Stick as JStick

    with pytest.raises(AttributeError):
        JStick([], [], [], rescale_factor=0.9)
    fresh = torch_parity.load_export_tool().stick_arrays()
    with np.load(tm.WALKER_SNAPSHOTS["stick"]) as z:
        assert sorted(z.files) == sorted(fresh)
        for k in fresh:
            np.testing.assert_array_equal(z[k], fresh[k], err_msg=k)


# ---------------------------------------------------------------------------
# clips and HDF5
# ---------------------------------------------------------------------------


def test_clip_metadata_and_subsample_match_jax(stac_file):  # noqa: F811
    assert tload.load_clips_metadata(stac_file) == jload.load_clips_metadata(stac_file) == [
        ("walk", 3), ("groom", 12), ("rear", 0)]
    idx = np.arange(3, 40)
    for seed in (0, 1, 7):
        np.testing.assert_array_equal(tload.sub_sample_training_set(idx, 0.3, seed=seed),
                                      jload.sub_sample_training_set(idx, 0.3, seed=seed))


def test_h5_files_cross_between_the_packages(tmp_path):
    rng = np.random.RandomState(8)
    data = {
        "qposes_rollout": rng.normal(size=(4, 5)).astype(np.float32),
        "activations": {"encoder": {"layer_0": rng.normal(size=(3, 2))}, "intention": rng.normal(size=(3,))},
        "clips": [np.arange(3), np.arange(2.0)],
        "step": 7, "scale": 0.5, "name": "rodent", "missing": None,
    }

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if a is None:
            return b is None
        return np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype

    jh5.save_to_h5py(str(tmp_path / "jax.h5"), data)
    th5.save_to_h5py(str(tmp_path / "port.h5"), data)
    j_of_port, t_of_jax = jh5.load_from_h5py(str(tmp_path / "port.h5")), th5.load_from_h5py(str(tmp_path / "jax.h5"))
    assert same(j_of_port, jh5.load_from_h5py(str(tmp_path / "jax.h5"))) and same(t_of_jax, j_of_port)
    # tensors are written as their arrays
    th5.save_to_h5py(str(tmp_path / "tensors.h5"), {"x": torch.arange(6.0).reshape(2, 3)})
    np.testing.assert_array_equal(jh5.load_from_h5py(str(tmp_path / "tensors.h5"))["x"],
                                  np.arange(6.0, dtype=np.float32).reshape(2, 3))


def test_h5_helpers_name_h5py_where_it_is_missing(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    for call in (lambda: th5.save_to_h5py(str(tmp_path / "x.h5"), {"a": np.zeros(2)}),
                 lambda: th5.load_from_h5py(str(tmp_path / "x.h5")),
                 lambda: tload.load_clips_metadata(str(tmp_path / "x.h5")),
                 lambda: troll.create_environment({"data_path": str(tmp_path / "x.h5"),
                                                   "reference_config": {"clip_length": 5}}, device="cpu")):
        with pytest.raises(ImportError, match="h5py"):
            call()


# ---------------------------------------------------------------------------
# create_environment and the rollout generator
# ---------------------------------------------------------------------------


def test_create_environment_from_a_checkpoint_config(tmp_path):
    """The rodent-full-clips config pointing at synthetic clips (.npz and the
    grouped HDF5 layout), and a legacy config without energy_cost_weight."""
    from track_mjx_tpu_torch.io.synthetic import synthesize_clips
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.utils.config import load_config

    clips = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=12, seed=0, device="cpu")
    tload.save_npz(clips, tmp_path / "clips.npz")
    tload.save_reference_clip_data(clips, tmp_path / "clips.h5")
    for path in ("clips.npz", "clips.h5"):
        cfg = load_config("rodent-full-clips", [f"data_path={tmp_path / path}", "reference_config.clip_length=12"]).to_dict()
        del cfg["env_config"]["reward_weights"]["energy_cost_weight"]
        env = troll.create_environment(cfg, device="cpu")
        assert isinstance(env, tt.MultiClipTracking) and env.plan.nu == 38 and env._n_clips == 2
        assert env._reward_config.energy_cost_weight == 0.0
        assert torch.equal(env._reference_clips.joints, clips.joints)


@pytest.fixture(scope="module")
def toy_rollouts(toy):
    """The JAX generator's offline rollout of clip 1 (seed 42) with every
    channel logged, and the same with the env's reset noise scale changed
    by 1e-6 of itself (the JAX package's own sensitivity)."""
    jenv, _, jnet, (norm, pp, _), _, _ = toy
    jpolicy = jpn.make_inference_fn(jnet)((norm, pp), deterministic=True, get_activation=True)
    flags = dict(model="mlp", log_activations=True, log_metrics=True, log_sensor_data=True)
    want = _np(jroll.create_rollout_generator(TOY_CFG, jenv, jpolicy, **flags)(1))
    scale = jenv._reset_noise_scale
    try:
        jenv._reset_noise_scale = scale * (1 + 1e-6)
        perturbed = _np(jroll.create_rollout_generator(TOY_CFG, jenv, jpolicy, **flags)(1))
    finally:
        jenv._reset_noise_scale = scale
    return want, perturbed


def test_rollout_generator_toy_matches_jax(toy, toy_rollouts, monkeypatch):
    """The whole offline rollout (29 control steps) of the deterministic
    policy with every channel logged, the JAX generator's reset draws fed.
    The toy walker is chaotic in float32 under contact (it lands in the
    first control step): a 1e-6 relative change of the JAX reset's noise
    moves the JAX package's own outputs by up to 1e-6 of their scale in the
    first steps and by O(1) by the end (qpos 1.1). So every channel is held,
    step by step, within 10 times the JAX package's own response (its
    largest so far) plus TOY_FLOOR, the float32 roundoff of the same
    formulas. Measured on these inputs: each channel's error at most 0.34
    of that bound at every step (the egocentric obs at step 12); in the
    first step, before chaos, qpos 2.3e-7, ctrl 7.5e-7, taps 6.9e-7."""
    _, tenv, _, _, tnet, params = toy
    want, perturbed = toy_rollouts
    tpolicy = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=True, get_activation=True)
    tgen = troll.create_rollout_generator(TOY_CFG, tenv, tpolicy, log_activations=True, log_metrics=True,
                                          log_sensor_data=True)
    _fed(tenv, monkeypatch, _jax_render_reset_draws(tenv, 42))
    got = tgen(1)
    n = int(CLIP_LEN * tenv._steps_for_cur_frame)
    assert got["qposes_rollout"].shape == (n, tenv.plan.nq) and got["ctrl"].shape == (n - 1, tenv.plan.nu)
    assert got["joint_forces"].shape == (n - 1, tenv.plan.nbody, 6)
    assert got["state_rewards"].shape == (n,) and got["rollout_metrics"]["falls"].shape == (n,)
    assert torch.equal(got["qposes_ref"], _t(want["qposes_ref"]))
    contact = np.abs(want["joint_forces"]).reshape(n - 1, -1).max(1) > 0
    assert contact.any() and not contact[0], "the toy must start in the air and land"
    g, w, p = _flat({k: got[k] for k in want}), _flat(want), _flat(perturbed)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        if k == "/qposes_ref" or not w[k].size:  # the toy has no sensors
            continue
        scale = max(1.0, np.abs(w[k]).max())
        err = np.abs(g[k] - w[k]).reshape(w[k].shape[0], -1).max(1) / scale
        sens = np.abs(p[k] - w[k]).reshape(w[k].shape[0], -1).max(1) / scale
        bound = 10 * np.maximum.accumulate(sens) + TOY_FLOOR
        assert (np.maximum.accumulate(err) <= bound).all(), (
            f"{k}: step {int(np.argmax(np.maximum.accumulate(err) > bound))}, err {err.max():.3e}")


def test_rollout_generator_batch_equals_single_clips(monkeypatch):
    """One batch of 2 clips against each clip alone, on the same draws, bit
    for bit. What the generator does to a batch (resets per clip, the
    [N, T, ...] stacks, the reference rows) has to be batch-invariant, but
    the plain CG solve on the CPU and a matmul at one row are not (they part
    from their batch-of-2 results at float32 roundoff, which the rollout
    amplifies), so this runs the contact-free toy (limit rows only) under a
    policy of elementwise operations, whose every step is batch-invariant."""
    tf.set_full_f32()
    jenv = make_toy_env(clip_length=CLIP_LEN, physics_steps_per_control_step=SUBSTEPS, contact=False)
    tenv = _port_toy(jenv)
    nu = tenv.action_size

    def policy(obs, key):
        action = 0.5 * torch.tanh(3.0 * obs[:, -nu:])
        return action, {"activations": {"head": obs[:, :nu], "pair": (action, -action)}}

    tgen = troll.create_rollout_generator(TOY_CFG, tenv, policy, log_activations=True, log_metrics=True,
                                          log_sensor_data=True)
    rng = np.random.RandomState(10)
    s = tenv._reset_noise_scale
    noise = [rng.uniform(-s, s, (2, n)) for n in (tenv.plan.nq, tenv.plan.nv)]
    _fed(tenv, monkeypatch, noise)
    batch = _flat(tgen(torch.tensor([1, 0])))
    assert batch["/qposes_rollout"].shape == (2, int(CLIP_LEN * tenv._steps_for_cur_frame), tenv.plan.nq)
    for i, clip in enumerate((1, 0)):
        _fed(tenv, monkeypatch, [noise[0][i], noise[1][i]])
        single = _flat(tgen(clip))
        assert sorted(single) == sorted(batch)
        for k, v in batch.items():
            assert np.array_equal(v[i], single[k]), k
    assert np.abs(batch["/qposes_rollout"][:, -1] - batch["/qposes_rollout"][:, 0]).max() > 1e-2


def test_stick_environment_steps(tmp_path):
    """A stick config (the names of its snapshot's tables, rodent-full-clips'
    env args) through create_environment and one rollout step of 2 clips."""
    from track_mjx_tpu_torch.agent import running_statistics
    from track_mjx_tpu_torch.io.synthetic import synthesize_clips
    from track_mjx_tpu_torch.physics import model as tm
    from track_mjx_tpu_torch.utils.config import load_config

    tf.set_full_f32()
    snap = tm.load_snapshot("stick")
    clips = synthesize_clips(snap, n_clips=2, n_frames=2, seed=0, device="cpu")
    tload.save_npz(clips, tmp_path / "stick.npz")
    cfg = load_config("rodent-full-clips", [f"data_path={tmp_path / 'stick.npz'}", "reference_config.clip_length=2",
                                            "network_config.encoder_layer_sizes=[16]",
                                            "network_config.decoder_layer_sizes=[16]",
                                            "network_config.critic_layer_sizes=[16]"]).to_dict()
    cfg["env_config"]["walker_name"] = "stick"
    cfg["walker_config"] = {"joint_names": [str(n) for n in snap.names.joint[1:]],
                            "body_names": [str(n) for n in snap.names.body[2:]],
                            "end_eff_names": [str(n) for n in snap.names.body if "claws" in str(n)],
                            "torque_actuators": False, "rescale_factor": 1.0}
    env = troll.create_environment(cfg, device="cpu")
    assert env.plan.nefc == 38 and env.plan.ncon == 0 and env.plan.integrator == tm.INT_RK4
    net = tpn.network_factory(cfg["network_config"], torch.Generator().manual_seed(0))(
        env.observation_size, env.reference_obs_size, env.action_size,
        preprocess_observations_fn=running_statistics.normalize, device="cpu")
    policy = tpn.make_inference_fn(net)(running_statistics.init_state(env.observation_size, "cpu"), deterministic=True)
    out = troll.create_rollout_generator(cfg, env, policy, log_sensor_data=True)(torch.arange(2))
    assert out["qposes_rollout"].shape == (2, 2, 45) and torch.isfinite(out["qposes_rollout"]).all()
    assert not out["joint_forces"].any()  # no geom of the stick collides
