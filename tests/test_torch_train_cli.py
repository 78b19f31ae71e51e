"""The port's trainer end to end on the CPU, its config, and its evaluator.

- The entry point (`train.main`, then `train.cli` to resume) on the rodent
  at tiny widths and a few envs, as tests/test_entrypoint.py runs the JAX
  one: it trains, reports finite metrics, writes checkpoints, loads one
  back for eval (its policy acts as the trained one, bit for bit) and
  resumes from it (stored config authoritative, training state restored,
  stored steps left as they were). The same for the fly (fly-mc-intention)
  and for the rodent's LSTM pipeline (use_lstm, the carry in the
  checkpoint, a recurrent policy loaded back, a resume from the stored
  carry). The checkpoint manager writes and
  prunes the steps that Orbax's does; the CLI parses its arguments.
- `utils.config`: the exported JSON equals the JAX package's YAML config,
  and dotted overrides parse as the JAX package's do where JSON and YAML
  agree.
- `EvalWrapper` and `Evaluator` against the JAX package's on the toy walker,
  fed the JAX evaluator's reset draws and the same policy weights.
"""

import functools
import math

import jax
import jax.numpy as jp
import numpy as np
import pytest
import torch

from torch_parity import fed_reset, jax_reset_draws, toy_envs
from track_mjx_tpu.agent import acting as jacting
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu.utils import config as jconfig
from track_mjx_tpu_torch import train
from track_mjx_tpu_torch.agent import acting, checkpointing
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.base import Wrapper
from track_mjx_tpu_torch.envs.task import tracking as tt
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
N_ENVS = 4
# a training step of 2 unrolls of 2 steps (4 envs, batch 4, 2 minibatches),
# 2 training steps per epoch, 2 evals: an initial one and one after the epoch
TINY = [
    "device=cpu",
    "reference_config.clip_length=20",
    "reference_config.random_init_range=10",
    "train_setup.train_subset_ratio=null",
    "train_setup.eval_every=16",
    "train_setup.reset_every=16",
    f"train_setup.train_config.num_envs={N_ENVS}",
    "train_setup.train_config.num_timesteps=32",
    "train_setup.train_config.batch_size=4",
    f"train_setup.train_config.num_eval_envs={N_ENVS}",
    "train_setup.train_config.num_minibatches=2",
    "train_setup.train_config.num_updates_per_batch=2",
    "train_setup.train_config.unroll_length=2",
    "network_config.encoder_layer_sizes=[16]",
    "network_config.decoder_layer_sizes=[16]",
    "network_config.critic_layer_sizes=[16]",
    "network_config.intention_size=4",
]
ADAM_STEPS = 2 * 2 * 2  # training steps x passes x minibatches


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tf.set_full_f32()
    root = tmp_path_factory.mktemp("cli")
    clips = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=20, mocap_hz=50, seed=0,
                             device="cpu")
    load.save_npz(clips, root / "clips.npz")
    progress = []
    cfg = tconfig.load_config(
        "rodent-full-clips", [f"data_path={root / 'clips.npz'}", f"logging_config.model_path={root / 'ckpts'}", *TINY]
    )
    make_policy, params = train.main(cfg, progress_fn=lambda step, metrics: progress.append((step, metrics)))
    (run_dir,) = [p for p in (root / "ckpts").iterdir() if p.name != "wandb_local"]  # beside it: the log
    return root, run_dir, make_policy, params, progress


def test_cli_trains_and_reports_finite_metrics(trained):
    _, _, _, _, progress = trained
    assert [step for step, _ in progress] == [0, 0]  # the initial eval, then one epoch (env_steps in thousands)
    final = progress[-1][1]
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss", "sps", "walltime"):
        assert math.isfinite(final[f"training/{name}"]), name
    assert final["training/kl_weight"] == pytest.approx(0.1)  # ramp of int(2 * 0.25) = 0 evals: full weight
    for k in ("rollout_ms", "normalizer_update_ms", "sgd_ms"):
        assert final[f"training/{k}"] > 0
    for k in ("episode_reward", "episode_reward_std", "avg_episode_length", "sps"):
        assert np.isfinite(final[f"eval/{k}"]), k
    assert 1 <= final["eval/avg_episode_length"] <= 5  # episode of (20 - 10 - 5) steps
    assert "eval/episode_reward" in progress[0][1] and "training/sps" not in progress[0][1]


def test_checkpoints_load_for_eval_bit_for_bit(trained):
    _, run_dir, make_policy, params, _ = trained
    steps = sorted(p.name for p in run_dir.iterdir() if p.is_dir())
    assert steps == ["PPONetwork_0", "PPONetwork_1"]
    store = checkpointing.CheckpointStore(str(run_dir))
    bundle = store.for_eval(device="cpu")
    cfg = bundle["cfg"]
    assert cfg["network_config"]["observation_size"] == params[0].mean.shape[0]
    assert cfg["device"] == "cpu" and cfg["network_config"]["encoder_layer_sizes"] == [16]
    loaded = checkpointing.load_inference_fn(cfg, bundle["policy"], device="cpu")
    trained_policy = make_policy(params[0], deterministic=True)
    obs = torch.randn(6, cfg["network_config"]["observation_size"], generator=torch.Generator().manual_seed(1))
    assert torch.equal(loaded(obs)[0], trained_policy(obs)[0])
    state = store.training_state()
    assert int(state["optimizer_state"]["state"][0]["step"]) == ADAM_STEPS
    for k, v in params[1].items():
        assert torch.equal(state["params"]["policy"][k], v), k


def test_resume_restores_the_state_and_trains_on(trained):
    """The stored config wins, the first batch sees the stored training
    state, training goes on, and the run's stored steps stay as they were:
    the resumed run counts its steps from 0 again and, as Orbax's manager
    does, writes no step at or below the newest one in the directory."""
    _, run_dir, _, _, _ = trained
    stored = {str(f.relative_to(run_dir)): f.read_bytes() for f in sorted(run_dir.rglob("*")) if f.is_file()}
    before = checkpointing.load_training_state(str(run_dir))
    seen = []

    def on_batch(state, data, make_learner):
        seen.append((int(state.optimizer.state_dict()["state"][0]["step"]), state.env_steps, data.discount.shape))

    cfg = tconfig.load_config("rodent-full-clips", [
        f"train_setup.checkpoint_to_restore={run_dir}", "device=cpu",
        "train_setup.train_config.num_envs=999",  # the stored config wins
    ])
    _, params = train.main(cfg, batch_callback=on_batch)
    assert seen[0] == (ADAM_STEPS, before["env_steps"], (8, 2)) and len(seen) == 2
    assert params[0].count == 2 * before["normalizer_params"]["count"]
    moved = any(not torch.equal(params[1][k], v) for k, v in before["params"]["policy"].items())
    assert moved and all(torch.isfinite(v).all() for v in params[1].values())
    assert {str(f.relative_to(run_dir)): f.read_bytes() for f in sorted(run_dir.rglob("*")) if f.is_file()} == stored
    assert checkpointing.load_config_from_checkpoint(str(run_dir))["train_setup"]["train_config"]["num_envs"] == N_ENVS


def _tiny_run(root, name, extra=()):
    """train.main of workload `name` at TINY's sizes on 2 synthetic clips
    of 20 frames at the config's mocap rate; returns (run dir, make_policy,
    params, progress, the batches' (training state's carry, data))."""
    cfg = tconfig.load_config(name)
    clips = synthesize_clips(tm.load_snapshot(name), n_clips=2, n_frames=20,
                             mocap_hz=cfg.env_config.env_args.mocap_hz, seed=0, device="cpu")
    load.save_npz(clips, root / "clips.npz")
    cfg = tconfig.load_config(
        name, [f"data_path={root / 'clips.npz'}", f"logging_config.model_path={root / 'ckpts'}", *TINY, *extra]
    )
    progress, batches = [], []
    make_policy, params = train.main(
        cfg, progress_fn=lambda step, metrics: progress.append((step, metrics)),
        batch_callback=lambda state, data, _: batches.append((getattr(state, "hidden_state", None), data)),
    )
    (run_dir,) = [p for p in (root / "ckpts").iterdir() if p.name != "wandb_local"]
    return run_dir, make_policy, params, progress, batches


def test_fly_cli_trains_on_the_fly(tmp_path):
    """The fly-mc-intention workload through the entry point: the fly's env
    (one control step per 500 Hz frame), finite metrics, a checkpoint whose
    policy acts as the trained one."""
    run_dir, make_policy, params, progress, batches = _tiny_run(tmp_path, "fly-mc-intention")
    final = progress[-1][1]
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss", "sps"):
        assert math.isfinite(final[f"training/{name}"]), name
    assert np.isfinite(final["eval/episode_reward"]) and 1 <= final["eval/avg_episode_length"] <= 5
    bundle = checkpointing.CheckpointStore(str(run_dir)).for_eval(device="cpu")
    net = bundle["cfg"]["network_config"]
    assert bundle["cfg"]["env_config"]["walker_name"] == "fly" and net["action_size"] == 36
    assert batches[0][1].observation.shape == (8, 2, net["observation_size"])
    loaded = checkpointing.load_inference_fn(bundle["cfg"], bundle["policy"], device="cpu")
    obs = batches[-1][1].observation[:, 0]
    assert torch.equal(loaded(obs)[0], make_policy(params[0], deterministic=True)(obs)[0])


LSTM = ["train_setup.train_config.use_lstm=true", "network_config.hidden_state_size=16",
        "network_config.hidden_layer_num=2"]


def test_lstm_cli_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    """The LSTM pipeline through the entry point: it trains, its checkpoint
    holds the rollout carry and loads back as a recurrent policy that acts
    as the trained one from the same carry, and a resume through the CLI
    starts its first rollout from the stored carry and optimizer state."""
    run_dir, make_policy, params, progress, batches = _tiny_run(tmp_path, "rodent-full-clips", LSTM)
    final = progress[-1][1]
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss", "sps"):
        assert math.isfinite(final[f"training/{name}"]), name
    assert "training/kl_weight" not in final  # no KL schedule in the LSTM pipeline
    (h0, c0), first = batches[0]
    assert h0.shape == (N_ENVS, 2, 16) and not h0.any() and not c0.any()
    assert torch.equal(first.extras["hidden_state"][:N_ENVS, 0], h0)
    store = checkpointing.CheckpointStore(str(run_dir))
    state = store.training_state()
    h, c = state["hidden_state"]
    assert h.shape == c.shape == (N_ENVS, 2, 16) and h.any() and torch.isfinite(h).all()
    assert int(state["optimizer_state"]["state"][0]["step"]) == ADAM_STEPS
    bundle = store.for_eval(device="cpu")
    loaded = checkpointing.load_inference_fn(bundle["cfg"], bundle["policy"], device="cpu")
    trained_policy = make_policy(params[0], deterministic=True)
    obs = batches[-1][1].observation[:N_ENVS, 0]
    got, want = loaded(obs, None, (h, c)), trained_policy(obs, None, (h, c))
    assert torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[2], want[2]))

    seen = []
    main = train.main
    monkeypatch.setattr(train, "main", lambda cfg: main(cfg, batch_callback=lambda st, data, _: seen.append(
        (int(st.optimizer.state_dict()["state"][0]["step"]), st.hidden_state))))
    train.cli(["--config-name", "rodent-full-clips", f"train_setup.checkpoint_to_restore={run_dir}", "device=cpu"])
    assert seen[0][0] == ADAM_STEPS and len(seen) == 2
    assert torch.equal(seen[0][1][0], h) and torch.equal(seen[0][1][1], c)


@pytest.mark.parametrize(
    "max_to_keep, keep_period, runs",
    [
        (2, 3, [range(8)]),
        (1, None, [range(4)]),
        (None, None, [range(4), range(6)]),  # a resumed run counts from 0 again
        (2, 2, [range(5), range(7)]),
    ],
)
def test_checkpoint_manager_keeps_the_steps_orbax_keeps(tmp_path, max_to_keep, keep_period, runs):
    """The same saves through the port's CheckpointManager and Orbax's, one
    manager per run on the same directory: the same saves are written, the
    same steps are kept, and a step once written never changes."""
    import orbax.checkpoint as ocp

    policy = (trs.init_state(3, "cpu"), {"w": torch.zeros(2)})
    written = {}
    for run in runs:
        port = checkpointing.CheckpointManager(str(tmp_path / "port"), max_to_keep=max_to_keep, keep_period=keep_period)
        ref = ocp.CheckpointManager(
            str(tmp_path / "orbax"),
            options=ocp.CheckpointManagerOptions(
                create=True, step_prefix=checkpointing.STEP_PREFIX, max_to_keep=max_to_keep, keep_period=keep_period
            ),
        )
        for step in run:
            wrote = port.save(step, policy, {"env_steps": step, "run": len(written)}, {"step": step})
            assert wrote == ref.save(step, args=ocp.args.Composite(config=ocp.args.JsonSave({"step": step}))), step
            if wrote:
                written[step] = (tmp_path / "port" / f"PPONetwork_{step}" / "train_state.pt").read_bytes()
            ref.wait_until_finished()
            assert port.steps() == list(ref.all_steps()), step
        ref.close()
    for step in port.steps():
        assert (tmp_path / "port" / f"PPONetwork_{step}" / "train_state.pt").read_bytes() == written[step]
    assert not list((tmp_path / "port").glob("*.tmp"))


@pytest.mark.parametrize(
    "argv, name, overrides",
    [
        (["--config-name", "fly-mc-intention", "seed=3"], "fly-mc-intention", ["seed=3"]),
        (["--config-name=rodent-full-clips", "device=cpu", "a.b=1"], "rodent-full-clips", ["device=cpu", "a.b=1"]),
        (["-cn", "rodent-full-clips"], "rodent-full-clips", []),
    ],
)
def test_cli_reads_the_config_name_and_overrides(monkeypatch, argv, name, overrides):
    got = []
    monkeypatch.setattr(train, "main", got.append)
    train.cli(argv)
    assert got == [tconfig.load_config(name, overrides)]


@pytest.mark.parametrize(
    "overrides, error",
    [
        # the LSTM pipeline is ported; decoder freezing is not, in the LSTM pipeline
        pytest.param(["train_setup.train_config.use_lstm=true", "train_setup.freeze_decoder=true"],
                     NotImplementedError, id="train_setup.train_config.use_lstm=true"),
        # run states are ported: a record that is not there is refused by name
        pytest.param(["train_setup.restore_from_run_state=run.json"], FileNotFoundError,
                     id="train_setup.restore_from_run_state=run.json"),
        # data parallel is ported: without a launcher's variables (RANK, ...) it raises
        pytest.param(["distributed=true"], ValueError, id="distributed=true"),
    ],
)
def test_unported_options_are_refused(overrides, error, tmp_path):
    with pytest.raises(error):
        train.main(tconfig.load_config(
            "rodent-full-clips", [*overrides, "device=cpu", f"logging_config.model_path={tmp_path}"]))


@pytest.mark.parametrize("entry", ["clip_from_numpy", "load_data", "train.main"])
def test_default_device_is_the_card(entry, tmp_path):
    """Without a device, the readers and the trainer target the card; with
    no card they raise instead of running on the CPU."""
    arrays = {k: np.zeros((1, 2, 3), np.float32) for k in load.CLIP_KEYS}
    np.savez(tmp_path / "c.npz", **arrays)
    call = {
        "clip_from_numpy": lambda: load.clip_from_numpy(arrays).position,
        "load_data": lambda: load.load_data(tmp_path / "c.npz").position,
        "train.main": lambda: train.main(tconfig.load_config(
            "rodent-full-clips", [f"data_path={tmp_path / 'c.npz'}", f"logging_config.model_path={tmp_path}"])),
    }[entry]
    if torch.cuda.is_available():
        if entry != "train.main":
            assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_multirun_is_refused(monkeypatch):
    """-m runs each job of the sweep (tests/test_torch_run_management.py);
    an override without "=" is refused by name, where the JAX CLI writes
    it as "key=" (ROADMAP, Queue 3)."""
    monkeypatch.setattr(train, "main", lambda cfg: pytest.fail("a job ran"))
    with pytest.raises(ValueError, match="'seed'"):
        train.cli(["-m", "seed"])


@pytest.mark.parametrize("name", ["rodent-full-clips", "fly-mc-intention", "rodent-sps-per-actor"])
def test_exported_config_equals_the_jax_yaml(name):
    got = tconfig.load_config(name).to_dict()
    assert got.pop(tconfig.CONFIG_NAME) == name  # the workload's name, which names its snapshot
    assert got == jconfig.load_config(name).to_dict()


def test_dotted_overrides_match_jax_where_json_and_yaml_agree():
    overrides = [
        "train_setup.train_config.num_envs=128",
        "train_setup.train_subset_ratio=null",
        "train_setup.train_config.learning_rate=0.0003",
        "network_config.encoder_layer_sizes=[16, 16]",
        "network_config.kl_schedule=false",
        "data_path=data/clips.npz",
        "logging_config.exp_name=",
        "new_section.sub.key=3",
    ]
    got = tconfig.load_config("rodent-full-clips", overrides)
    want = jconfig.load_config("rodent-full-clips", overrides)
    assert {**want.to_dict(), tconfig.CONFIG_NAME: "rodent-full-clips"} == got.to_dict()
    assert got.train_setup.train_config.num_envs == 128 and got.new_section.sub.key == 3
    # where YAML and JSON differ, the port keeps the string (ROADMAP, standing divergences)
    assert [tconfig.parse_value(v) for v in ("~", "yes", "1e-4")] == ["~", "yes", 1e-4]
    with pytest.raises(ValueError):
        tconfig.apply_overrides(tconfig.ConfigDict(), ["no_equals_sign"])


# ---------------------------------------------------------------------------
# the evaluator against the JAX package's
# ---------------------------------------------------------------------------

B, EPISODE, NOISE = 6, 3, 1e-3
# Per-env episode sums after EPISODE free-running toy-walker steps, relative
# to max(1, max |JAX|): the env's step-to-step roundoff (tests/test_torch_env.py
# holds a step to 3e-4) summed over the episode; measured up to 2.9e-6.
EVAL_REL = 5e-5


def test_evaluator_matches_jax():
    """One eval of the JAX evaluator and of the port's on the same draws and
    weights (the test-set split's metric names too)."""
    jenv, tenv = toy_envs(NOISE)
    obs_size, ref_size, nu = jenv.observation_size, tenv.reference_obs_size, jenv.plan.nu
    kw = dict(intention_latent_size=4, encoder_hidden_layer_sizes=[16], decoder_hidden_layer_sizes=[16],
              value_hidden_layer_sizes=[16])
    jnet = jpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=jrs.normalize, **kw)
    pp, vp = jnet.policy_network.init(jax.random.PRNGKey(0)), jnet.value_network.init(jax.random.PRNGKey(1))
    norm = jrs.init_state(jax.ShapeDtypeStruct((obs_size,), jp.float32))
    key = jax.random.PRNGKey(11)
    jeval = jacting.Evaluator(
        jwrappers.wrap(jenv, episode_length=EPISODE, action_repeat=1, use_lstm=False),
        functools.partial(jpn.make_inference_fn(jnet), deterministic=True),
        num_eval_envs=B, episode_length=EPISODE, action_repeat=1, key=key,
    )
    want = jeval.run_evaluation((norm, pp), {"training/x": 1.0})
    # the JAX evaluator's reset keys: split(key) -> unroll key -> split(unroll key, B)
    _, unroll_key = jax.random.split(key)
    draws = jax_reset_draws(jenv, jax.random.split(unroll_key, B), NOISE)

    tnet = tpn.make_intention_ppo_networks(obs_size, ref_size, nu, preprocess_observations_fn=trs.normalize,
                                           device="cpu", **kw)
    params = tpn.params_from_flax(jax.tree.map(np.asarray, pp), jax.tree.map(np.asarray, vp),
                                  jax.tree.map(np.asarray, norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy)
    teval = acting.Evaluator(
        wrappers.wrap(fed_reset(tenv, draws), episode_length=EPISODE),
        functools.partial(tpn.make_inference_fn(tnet), deterministic=True),
        num_eval_envs=B, episode_length=EPISODE, action_repeat=1, key=torch.Generator().manual_seed(0),
    )
    got = teval.run_evaluation(params.normalizer, {"training/x": 1.0})
    assert set(got) == set(want)
    prefix = "eval/"
    assert got["training/x"] == 1.0 and got[f"{prefix}sps"] > 0 and got[f"{prefix}walltime"] > 0
    assert got[f"{prefix}avg_episode_length"] == float(want[f"{prefix}avg_episode_length"])
    for k in want:
        if k.startswith(f"{prefix}episode_"):
            g, w = float(got[k]), float(want[k])
            assert abs(g - w) / max(1.0, abs(w)) < EVAL_REL, f"{k}: {g} against {w}"
    assert 1 <= got[f"{prefix}avg_episode_length"] <= EPISODE
    test_set = teval.run_evaluation(params.normalizer, {}, data_split="test_set")
    assert {k.replace("eval/test_set/", "eval/") for k in test_set} == set(want) - {"training/x"}


class _Poison(Wrapper):
    """Writes NaN and inf into the first two envs' pos_reward on each step."""

    def step(self, state, action):
        state = self.env.step(state, action)
        bad = torch.tensor([float("nan"), float("inf"), 0.25])
        return state.replace(metrics=dict(state.metrics, pos_reward=bad))


def test_eval_wrapper_sums_the_first_episode_only():
    """An env whose episode ends at step 1 stops adding to its sums; NaN and
    inf term metrics add nothing."""
    _, tenv = toy_envs(NOISE)
    env = acting.EvalWrapper(_Poison(wrappers.wrap(tenv, episode_length=1)))
    state = env.reset(torch.Generator().manual_seed(0), 3)
    assert set(state.info["eval_metrics"].episode_metrics) == set(tt.METRIC_KEYS) | {"reward"}
    zero = torch.zeros(3, tenv.action_size)
    state = env.step(state, zero)
    first = {k: v.clone() for k, v in state.info["eval_metrics"].episode_metrics.items()}
    assert first["pos_reward"].tolist() == [0.0, 0.0, 0.25]
    assert (state.info["eval_metrics"].active_episodes == 0).all()  # episodes of 1 step
    state = env.step(state, zero)
    for k, v in state.info["eval_metrics"].episode_metrics.items():
        assert torch.equal(v, first[k]), k
    assert torch.equal(state.info["eval_metrics"].episode_steps, torch.ones(3))
