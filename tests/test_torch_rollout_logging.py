"""The per-eval logging rollout and its ghost video, against the JAX package.

- The render wrappers' resets (frame 0, prev_ctrl zero, the LSTM one's zero
  carry) against the JAX ones on the toy walker, fed the JAX reset's draws.
- `collect_rollout` over a few control steps of the toy walker, MLP and
  LSTM, against the JAX `collect_rollout` with the same weights
  (`params_from_flax`) and draws: the latent means and logvars, and the
  metric curves' tables.
- The latent statistics on frames with NaN latents, against the JAX
  `log_latent_statistics` (`_masked_stats`, `latents/nonfinite_frames`).
- The playback model's kinematics (geom_xpos, geom_xmat, site frames; the
  elements drawn, their sizes and rgba) and camera (eye, forward, up, fovy,
  near plane; the trackcom camera reads subtree_com) against MuJoCo on the
  JAX package's playback model, and a 120 x 160 frame's
  silhouette against the JAX `SoftwareRenderer`'s, for the rodent and the
  fly; frames after a blow-up; the video file or its frames.
"""

import jax
import jax.numpy as jp
import mujoco
import numpy as np
import pytest
import torch

from torch_parity import toy_envs
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent import wandb_logging as jlogging
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jlstm_pn
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jmlp_pn
from track_mjx_tpu.analysis import render as jrender
from track_mjx_tpu.analysis.software_render import SoftwareRenderer as JaxSoftwareRenderer
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent import wandb_logging
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tlstm_pn
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tmlp_pn
from track_mjx_tpu_torch.analysis import render
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.physics import forward as tf

torch.set_num_threads(1)
NOISE = 1e-3
LAT, HID, LAYERS = 4, 8, 2
WIDTHS = dict(intention_latent_size=LAT, encoder_hidden_layer_sizes=[16], decoder_hidden_layer_sizes=[16],
              value_hidden_layer_sizes=[16])
# Free-running toy-walker steps with the policy (tests/test_torch_lstm.py's
# UNROLL_REL): the env's roundoff and the policy's over a few steps.
ROLLOUT_REL = 5e-5
# The masked statistics: the same float32 sums in another order.
STATS_REL = 1e-6
# Kinematics and the camera in float32 against MuJoCo's float64: float32 roundoff of
# positions of order 1 m over the tree, with room to spare (measured 6e-7).
KIN_ABS = 1e-5
# A frame's non-background pixels against the JAX rasterizer's (matplotlib
# Agg): both draw the same shapes; they part on antialiased edge pixels
# (measured IoU 0.967 rodent, 0.973 fly).
MIN_IOU = 0.9
PLAYBACKS = {"rodent": (0.9, "close_profile"), "fly": (1.0, "track1")}


@pytest.fixture(scope="module")
def toy():
    tf.set_full_f32()
    return toy_envs(NOISE)


def jax_render_draws(env, key):
    """What the JAX multi-clip render wrapper's reset draws from `key`
    (wrappers.py: the clip from the second split; reset_from_clip's rng1,
    from the third, serves both noises): clip, qpos noise, qvel noise."""
    _, clip_rng, rng = jax.random.split(key, 3)
    clip = jax.random.randint(clip_rng, (), 0, env._n_clips)
    _, rng1, _ = jax.random.split(rng, 3)
    qn = jax.random.uniform(rng1, (env.plan.nq,), minval=-NOISE, maxval=NOISE)
    vn = jax.random.uniform(rng1, (env.plan.nv,), minval=-NOISE, maxval=NOISE)
    return tuple(torch.as_tensor(np.asarray(x))[None] for x in (clip, qn, vn))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def render_wrappers(jenv, tenv, lstm: bool):
    if lstm:
        return (jwrappers.RenderRolloutWrapperTrackingLSTM(jenv, lstm_features=HID, hidden_layer_num=LAYERS),
                wrappers.RenderRolloutWrapperTrackingLSTM(tenv, lstm_features=HID, hidden_layer_num=LAYERS))
    return jwrappers.RenderRolloutWrapperMulticlipTracking(jenv), wrappers.RenderRolloutWrapperMulticlipTracking(tenv)


@pytest.mark.parametrize("lstm", [False, True], ids=["mlp", "lstm"])
def test_render_reset_matches_jax(toy, lstm):
    jenv, tenv = toy
    jw, tw = render_wrappers(jenv, tenv, lstm)
    key = jax.random.PRNGKey(3)
    want = jax.jit(jw.reset)(key)
    got = tw.reset_from_draws(*jax_render_draws(jenv, key))
    assert _rel(got.obs[0], want.obs) < 1e-6
    assert _rel(got.pipeline_state.qpos[0], want.pipeline_state.qpos) < 1e-6
    assert _rel(got.pipeline_state.qvel[0], want.pipeline_state.qvel) < 1e-6
    assert int(got.info["start_frame"][0]) == int(want.info["start_frame"]) == 0
    assert int(got.info["clip_idx"][0]) == int(want.info["clip_idx"])
    assert not got.info["prev_ctrl"].any() and got.info["prev_ctrl"].shape == (1, tenv.plan.nu)
    if lstm:
        for g, w in zip(got.info["hidden_state"], want.info["hidden_state"]):
            assert g.shape == (1, LAYERS, HID) == tuple(np.shape(w)) and not g.any()
    # from a generator: a clip of the env, frame 0, any batch
    drawn = tw.reset(torch.Generator().manual_seed(0), batch_size=3)
    assert drawn.obs.shape == (3, jenv.observation_size) and not drawn.info["start_frame"].any()
    assert ((0 <= drawn.info["clip_idx"]) & (drawn.info["clip_idx"] < jenv._n_clips)).all()
    given = tw.reset(torch.Generator().manual_seed(0), clip_idx=1)
    assert int(given.info["clip_idx"][0]) == 1 and given.obs.shape[0] == 1


def test_render_vmap_wrapper_resets_each_clip(toy):
    _, tenv = toy
    vw = wrappers.RenderRolloutVmapWrapper(wrappers.RenderRolloutWrapperMulticlipTracking(tenv), batch_size=3)
    state = vw.reset(torch.Generator().manual_seed(1))
    assert state.info["clip_idx"].tolist() == [0, 0, 0] and not state.info["start_frame"].any()
    state = vw.reset(torch.Generator().manual_seed(1), torch.tensor([1, 0]))
    assert state.info["clip_idx"].tolist() == [1, 0]
    state = vw.step(state, torch.zeros((2, tenv.plan.nu)))
    assert torch.isfinite(state.obs).all() and state.obs.shape[0] == 2


class _Logged:
    """Records a wandb stand-in's log calls and tables."""

    def __init__(self, real):
        self.real, self.logs, self.tables = real, {}, []

    def log(self, metrics, commit=True, step=None):
        self.logs.update(metrics)

    def Table(self, data=None, columns=None):  # noqa: N802 - wandb's name
        self.tables.append((columns, data))
        return self.real.Table(data=data, columns=columns)

    def __getattr__(self, name):
        return getattr(self.real, name)


def _networks(jenv, tenv, lstm: bool):
    """JAX intention networks, their weights in the port's, and both
    deterministic logging policies."""
    obs, ref, nu = jenv.observation_size, tenv.reference_obs_size, jenv.plan.nu
    rng = np.random.RandomState(5)
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs,), jp.float32)).replace(
        mean=np.asarray(0.1 * rng.normal(size=obs), np.float32),
        std=np.asarray(rng.uniform(0.5, 2.0, obs), np.float32),
    )
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    if lstm:
        jnet = jlstm_pn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=jrs.normalize,
                                                    hidden_state_size=HID, hidden_layer_num=LAYERS, **WIDTHS)
        zero = jp.zeros((1, LAYERS, HID))
        pp = jnet.policy_network.init(k1, hidden_state=(zero, zero))
        tnet = tlstm_pn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=trs.normalize,
                                                    hidden_state_size=HID, hidden_layer_num=LAYERS, device="cpu",
                                                    **WIDTHS)
        pn, jmake = tlstm_pn, jlstm_pn.make_inference_fn(jnet)

        def jpolicy(params, obs_, key, hidden):
            return jmake(params, deterministic=True)(obs_, key, hidden)
    else:
        jnet = jmlp_pn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=jrs.normalize, **WIDTHS)
        pp = jnet.policy_network.init(k1)
        tnet = tmlp_pn.make_intention_ppo_networks(obs, ref, nu, preprocess_observations_fn=trs.normalize,
                                                   device="cpu", **WIDTHS)
        pn, jmake = tmlp_pn, jmlp_pn.make_inference_fn(jnet)

        def jpolicy(params, obs_, key):
            return jmake(params, deterministic=True)(obs_, key)
    vp = jnet.value_network.init(k2)
    carried = pn.params_from_flax(jax.tree.map(np.asarray, pp), jax.tree.map(np.asarray, vp),
                                  jax.tree.map(np.asarray, norm), device="cpu")
    tnet.policy_network.load_state_dict(carried.policy)
    return (norm, pp), jax.jit(jpolicy), pn.make_inference_fn(tnet)(carried.normalizer, deterministic=True)


@pytest.mark.parametrize("lstm", [False, True], ids=["mlp", "lstm"])
def test_collect_rollout_matches_jax(toy, monkeypatch, lstm):
    """Two frames (4 control steps) of the toy walker from the same reset
    draws and weights: latent means and logvars, and the metric curves."""
    jenv, tenv = toy
    jw, tw = render_wrappers(jenv, tenv, lstm)
    cfg = {"reference_config": {"clip_length": 2}, "train_setup": {"train_config": {"use_lstm": lstm}}}
    jparams, jpolicy, tpolicy = _networks(jenv, tenv, lstm)
    key = jax.random.PRNGKey(7)
    want = jlogging.collect_rollout(jw, jax.jit(jw.reset), jax.jit(jw.step), cfg, jpolicy, jparams, key)
    _, reset_key, _ = jax.random.split(key, 3)
    draws = jax_render_draws(jenv, reset_key)

    class Fed(type(tw)):
        def reset(self, rng, clip_idx=None, batch_size=1):
            return self.reset_from_draws(*draws)

    fed = Fed(tenv, HID, LAYERS) if lstm else Fed(tenv)
    got = wandb_logging.collect_rollout(fed, cfg, tpolicy, torch.Generator().manual_seed(0))
    assert got.latent_means.shape == (4, LAT) and got.qpos.shape == (5, tenv.plan.nq)
    assert _rel(got.latent_means, np.asarray(want.latent_means).reshape(4, LAT)) < ROLLOUT_REL
    assert _rel(got.latent_logvars, np.asarray(want.latent_logvars).reshape(4, LAT)) < ROLLOUT_REL
    assert _rel(got.qpos, np.stack([np.asarray(s.pipeline_state.qpos) for s in want.states])) < ROLLOUT_REL

    names = ["pos_reward", "joint_distance", "fall"]
    logged = _Logged(jlogging.wandb)
    monkeypatch.setattr(jlogging, "wandb", logged)
    jlogging.log_metric_curves(want, names)
    curves = wandb_logging.metric_curves(got, names)
    assert [cols for cols, _ in logged.tables] == [["frame", n] for n in names]
    # a state whose time sits on a frame boundary (every second control
    # step of the toy walker, after the first) reads the reward's reference
    # frame through floor(time * mocap_hz) of a float32 time, which the two
    # packages may round to either side: its values are not compared
    boundary = [float(s.pipeline_state.time) * jenv._mocap_hz for s in want.states]
    keep = [k for k, x in enumerate(boundary) if k == 0 or abs(x - round(x)) > 1e-3]
    assert keep == [0, 1, 3]
    for (_, rows), name in zip(logged.tables, names):
        frames, values = zip(*curves[name])
        assert list(frames) == [r[0] for r in rows] == list(range(5))
        assert _rel([values[k] for k in keep], [rows[k][1] for k in keep]) < ROLLOUT_REL, name


@pytest.mark.parametrize("nan_frames", [[], [3], [0, 2, 5], list(range(6))], ids=["none", "one", "three", "all"])
def test_latent_statistics_mask_nonfinite_frames_as_jax(monkeypatch, nan_frames):
    rng = np.random.RandomState(len(nan_frames))
    means = rng.normal(size=(6, LAT)).astype(np.float32)
    logvars = rng.normal(size=(6, LAT)).astype(np.float32)
    means[nan_frames[:1], 1] = np.nan
    logvars[nan_frames[1:], 0] = np.inf
    logged = _Logged(jlogging.wandb)
    monkeypatch.setattr(jlogging, "wandb", logged)
    jlogging.log_latent_statistics(jlogging.RolloutTrace([], jp.asarray(means), jp.asarray(logvars)))
    got = wandb_logging.latent_statistics(
        wandb_logging.RolloutTrace(None, {}, torch.as_tensor(means), torch.as_tensor(logvars), {}))
    assert set(got) == set(logged.logs)
    assert got["latents/nonfinite_frames"] == float(logged.logs["latents/nonfinite_frames"]) == len(nan_frames)
    for k, v in got.items():
        assert np.isfinite(v), k
        assert abs(v - float(logged.logs[k])) <= STATS_REL * max(1.0, abs(float(logged.logs[k]))), k


# ---- the playback model and the renderer ------------------------------------


@pytest.fixture(scope="module", params=list(PLAYBACKS))
def playback(request):
    """(walker, camera, the JAX playback MjModel, the port's renderer, a
    doubled qpos with both walkers posed)."""
    tf.set_full_f32()
    name = request.param
    scale, camera = PLAYBACKS[name]
    m = jrender.build_playback_model(name, scale)
    rng = np.random.RandomState(0)
    q = m.qpos0.copy()
    half = m.nq // 2
    q[half + 3:half + 7] = q[3:7]  # the ghost's free joint: a unit quaternion (its qpos0 holds zeros)
    q[7:half] += 0.1 * rng.normal(size=half - 7)
    q[half + 7:] += 0.1 * rng.normal(size=half - 7)
    q[half:half + 3] += [0.03, -0.02, 0.01]
    cfg = {"env_config": {"walker_name": name}, "walker_config": {"rescale_factor": scale}}
    renderer = render.make_rollout_renderer(cfg, "cpu", height=120, width=160)
    return name, camera, m, renderer, q


def test_playback_kinematics_match_mujoco(playback):
    _, _, m, renderer, q = playback
    d = mujoco.MjData(m)
    d.qpos[:] = q
    mujoco.mj_forward(m, d)
    pose = renderer.poses(torch.as_tensor(q[None]), None)
    ng = len(renderer.geoms)
    assert ng > 0 and len(renderer.sites) > 0
    np.testing.assert_allclose(pose["pos"][0, :ng], d.geom_xpos[renderer.geoms], atol=KIN_ABS)
    np.testing.assert_allclose(pose["mat"][0, :ng].reshape(ng, 9), d.geom_xmat[renderer.geoms], atol=KIN_ABS)
    np.testing.assert_allclose(pose["pos"][0, ng:], d.site_xpos[renderer.sites], atol=KIN_ABS)
    np.testing.assert_allclose(pose["mat"][0, ng:].reshape(-1, 9), d.site_xmat[renderer.sites], atol=KIN_ABS)
    # the elements drawn are the scene's: geoms of groups 0-2, sites of 0-4, alpha above 0
    opt = mujoco.MjvOption()
    opt.sitegroup[:] = render.SITEGROUP
    scn = mujoco.MjvScene(m, maxgeom=4 * (m.ngeom + m.nsite))
    mujoco.mjv_updateScene(m, d, opt, None, mujoco.MjvCamera(), mujoco.mjtCatBit.mjCAT_ALL.value, scn)
    seen = [(scn.geoms[i].objtype, scn.geoms[i].objid) for i in range(scn.ngeom)]
    assert sorted(seen) == sorted([(int(mujoco.mjtObj.mjOBJ_GEOM), int(g)) for g in renderer.geoms]
                                  + [(int(mujoco.mjtObj.mjOBJ_SITE), int(s)) for s in renderer.sites])
    for i in range(scn.ngeom):
        g = scn.geoms[i]
        k = (list(renderer.geoms).index(g.objid) if g.objtype == mujoco.mjtObj.mjOBJ_GEOM
             else ng + list(renderer.sites).index(g.objid))
        np.testing.assert_allclose(renderer.sizes[k], g.size, atol=1e-7)
        np.testing.assert_allclose(renderer.rgba[k], g.rgba, atol=1e-7)
        assert renderer.types[k] == g.type


@pytest.mark.parametrize("which", ["config", "fixed", "free"])
def test_playback_camera_matches_mjv_update_scene(playback, which):
    name, camera, m, renderer, q = playback
    if which == "fixed":
        camera = {"rodent": "egocentric", "fly": "eye_right"}[name]
        assert m.cam_mode[mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_CAMERA, camera)] == 0
    elif which == "free":
        camera = None
    d = mujoco.MjData(m)
    d.qpos[:] = q
    mujoco.mj_forward(m, d)
    jsr = JaxSoftwareRenderer(m, 120, 160)
    jsr.update_scene(d, camera=-1 if camera is None else camera)
    eye, _, up, fwd, (near, _, half_h, _, _) = jsr._mono_camera()
    pose = renderer.poses(torch.as_tensor(q[None]), camera)
    np.testing.assert_allclose(pose["eye"][0], eye, atol=KIN_ABS)
    np.testing.assert_allclose(pose["forward"][0], fwd, atol=KIN_ABS)
    np.testing.assert_allclose(pose["up"][0], up, atol=KIN_ABS)
    assert abs(np.rad2deg(2 * np.arctan(half_h / near)) - pose["fovy"]) < 1e-4
    assert abs(pose["znear"] - near) < 1e-9


def test_other_camera_modes_raise(playback):
    name, _, m, renderer, q = playback
    modes = {int(m.cam_mode[i]) for i in range(m.ncam)}
    other = [i for i in range(m.ncam) if m.cam_mode[i] not in (0, 2)]
    if not other:
        assert modes <= {0, 2}
        return
    with pytest.raises(NotImplementedError, match="'track'"):
        renderer.poses(torch.as_tensor(q[None]), int(other[0]))


def test_frame_silhouette_matches_the_jax_renderer(playback):
    _, camera, m, renderer, q = playback
    d = mujoco.MjData(m)
    d.qpos[:] = q
    mujoco.mj_forward(m, d)
    opt = mujoco.MjvOption()
    opt.sitegroup[:] = render.SITEGROUP
    jsr = JaxSoftwareRenderer(m, 120, 160)
    jsr.update_scene(d, camera=camera, scene_option=opt)
    want = (jsr.render() != 255).any(-1)
    jsr.close()
    frame = renderer.render(torch.as_tensor(q[None]), camera)[0]
    assert frame.shape == (120, 160, 3) and frame.dtype == np.uint8
    got = (frame != 255).any(-1)
    iou = (got & want).sum() / (got | want).sum()
    assert want.sum() > 200 and iou >= MIN_IOU, (iou, got.sum(), want.sum())


def test_frames_after_a_blow_up(playback):
    """The policy's walker goes NaN: its geoms are not drawn, the ghost is,
    from the last finite camera; a first frame with no finite camera is
    background."""
    _, camera, _, renderer, q = playback
    half = renderer.plan.nq // 2
    blown = q.copy()
    blown[:half] = np.nan
    frames = renderer.render(torch.as_tensor(np.stack([blown, q, blown])), camera)
    assert (frames[0] == 255).all()
    drawn = [(f != 255).any(-1).sum() for f in frames[1:]]
    assert drawn[0] > drawn[1] > 0


@pytest.mark.parametrize("have_imageio", [True, False])
def test_video_file_or_its_frames(tmp_path, monkeypatch, caplog, have_imageio):
    frames = np.full((3, 8, 10, 3), 255, np.uint8)
    frames[1, 2:4, 3:5] = [10, 20, 30]
    if not have_imageio:
        import builtins

        real_import = builtins.__import__

        def no_imageio(name, *args, **kwargs):
            if name.startswith("imageio"):
                raise ImportError(name)
            return real_import(name, *args, **kwargs)

        monkeypatch.setattr(builtins, "__import__", no_imageio)
    path = wandb_logging.write_video(frames, str(tmp_path / "7"), 50)
    if have_imageio:
        import imageio

        assert path.endswith((".mp4", ".gif"))
        back = imageio.mimread(path)
        assert np.asarray(back[0]).shape[:2] == (8, 10)
    else:
        assert path == str(tmp_path / "7.npz") and path in caplog.text
        with np.load(path) as z:
            np.testing.assert_array_equal(z["frames"], frames)
            assert float(z["fps"]) == 50


def test_reference_qpos_repeats_each_frame(toy):
    _, tenv = toy
    tw = wrappers.RenderRolloutWrapperMulticlipTracking(tenv)
    state = tw.reset(torch.Generator().manual_seed(0), clip_idx=1)
    qref = wandb_logging.reference_qpos(tw, state.info)
    clip = tenv._reference_clips
    want = torch.cat([clip.position[1], clip.quaternion[1], clip.joints[1]], dim=-1).repeat_interleave(2, 0)
    assert torch.equal(qref, want.float())
    assert qref.shape == (clip.position.shape[1] * 2, tenv.plan.nq)
