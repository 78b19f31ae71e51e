"""The CLI's run management in the port, against the JAX package's.

- `agent/preemption.py`: the run-state record's save, discover and cleanup
  over the port's checkpoint layout, the config-hash mismatch and the
  checkpoint callback, as tests/test_train.py holds the JAX one; the config
  hash equals the JAX package's digest of the same dict.
- `utils/wandb_compat.py`: the local stand-in writes the JAX stand-in's
  JSONL records, torch values as the JAX one writes numpy ones.
- `train.expand_multirun` equals the JAX one on tests/test_misc.py's cases;
  an override without "=" raises (the JAX one writes "key=").
- Both trainers call `checkpoint_callback` after every save that wrote a
  step and after no other.
- The tiny CPU CLI end to end, as tests/test_entrypoint.py runs the JAX
  one: the record exists during the run and is gone after it, metrics.jsonl
  holds the eval scalars, `latents/*` and the rollout curves, and the video
  (or its frames) is written; a run stopped after its first checkpoint is
  resumed by the next run of the same config, in the same run directory;
  `restore_from_run_state` restores from a record; `-m` runs every job.
"""

import json
import os

import numpy as np
import pytest
import torch

from track_mjx_tpu.agent import preemption as jpreemption
from track_mjx_tpu.train import expand_multirun as jax_expand_multirun
from track_mjx_tpu.utils import wandb_compat as jwandb_compat
from track_mjx_tpu_torch import train
from track_mjx_tpu_torch.agent import checkpointing, preemption
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.utils import config as tconfig
from track_mjx_tpu_torch.utils import wandb_compat

torch.set_num_threads(1)
JOB = "4242"
# train_cli's TINY at 2 envs: one training step of 2 unrolls of 2 steps, 2
# evals (an initial one and one after the epoch) of 5 steps, a logging
# rollout of 15 control steps, a video every eval
TINY = [
    "device=cpu",
    "reference_config.clip_length=15",
    "reference_config.random_init_range=5",
    "train_setup.train_subset_ratio=null",
    "train_setup.eval_every=4",
    "train_setup.reset_every=4",
    "train_setup.train_config.num_envs=2",
    "train_setup.train_config.num_timesteps=8",
    "train_setup.train_config.batch_size=2",
    "train_setup.train_config.num_eval_envs=2",
    "train_setup.train_config.num_minibatches=2",
    "train_setup.train_config.num_updates_per_batch=1",
    "train_setup.train_config.unroll_length=2",
    "network_config.encoder_layer_sizes=[8]",
    "network_config.decoder_layer_sizes=[8]",
    "network_config.critic_layer_sizes=[8]",
    "network_config.intention_size=4",
    "env_config.render_interval=1",
]
LSTM = ["train_setup.train_config.use_lstm=true", "network_config.hidden_state_size=8",
        "network_config.hidden_layer_num=2"]


def no_logging(**_):
    """A policy_params_fn that logs nothing (runs that test something else)."""


@pytest.fixture
def job(monkeypatch):
    monkeypatch.setenv("SLURM_JOB_ID", JOB)
    for k in ("SLURM_ARRAY_JOB_ID", "SLURM_ARRAY_TASK_ID", "PBS_JOBID", "JOB_ID", "SGE_TASK_ID"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tf.set_full_f32()
    root = tmp_path_factory.mktemp("clips")
    clip = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=20, mocap_hz=50, seed=0,
                            device="cpu")
    load.save_npz(clip, root / "clips.npz")
    return root / "clips.npz"


def tiny_cfg(clips, model_path, *extra):
    return tconfig.load_config(
        "rodent-full-clips", [f"data_path={clips}", f"logging_config.model_path={model_path}", *TINY, *extra]
    )


# ---- the run-state record ---------------------------------------------------


def _cfg(tmp_path, seed=0):
    return {"logging_config": {"model_path": str(tmp_path)}, "train_setup": {"train_config": {"seed": seed}}}


def _write_step(run_dir, step, files=checkpointing.STEP_FILES):
    d = run_dir / f"{checkpointing.STEP_PREFIX}_{step}"
    d.mkdir(parents=True)
    for f in files:
        (d / f).write_text("{}")


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_record_save_discover_cleanup(tmp_path, job, impl):
    """tests/test_train.py's test_save_discover_cleanup on both packages, each
    over its own checkpoint layout: no committed step, no resume."""
    mod = preemption if impl == "port" else jpreemption
    cfg = _cfg(tmp_path)
    run_dir = tmp_path / "run1"
    run_dir.mkdir()
    mod.save_run_state(cfg, "run1", run_dir, "wandb1")
    assert mod.discover_existing_run_state(cfg) is None
    if impl == "port":
        _write_step(run_dir, 5, files=checkpointing.STEP_FILES[:2])  # a step without its config: not committed
        assert preemption.discover_existing_run_state(cfg) is None
        _write_step(run_dir, 3)
    else:
        import orbax.checkpoint as ocp

        mgr = ocp.CheckpointManager(str(run_dir), options=ocp.CheckpointManagerOptions(create=True,
                                                                                       step_prefix="PPONetwork"))
        mgr.save(step=3, args=ocp.args.Composite(policy=ocp.args.StandardSave({"w": np.zeros(2)})))
        mgr.wait_until_finished()
    found = mod.discover_existing_run_state(cfg)
    assert found["run_id"] == "run1" and found["wandb_run_id"] == "wandb1"
    assert found["latest_checkpoint_step"] == 3
    assert found["checkpoint_path"] == str(run_dir.resolve())
    path = mod.RunStateStore(cfg).path
    assert path.name == f"run_state_slurm_{JOB}_{mod.config_hash(cfg)}.json"
    mod.cleanup_run_state(cfg)
    assert not path.exists() and mod.discover_existing_run_state(cfg) is None


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_record_config_hash_mismatch_is_ignored(tmp_path, job, impl):
    mod = preemption if impl == "port" else jpreemption
    run_dir = tmp_path / "run2"
    _write_step(run_dir, 0)
    cfg = _cfg(tmp_path)
    mod.save_run_state(cfg, "run2", run_dir, "wandb2")
    path = mod.RunStateStore(cfg).path
    path.rename(mod.RunStateStore(_cfg(tmp_path, seed=1)).path)  # the record of another config under this name
    assert mod.discover_existing_run_state(_cfg(tmp_path, seed=1)) is None


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_record_checkpoint_callback_updates_the_step(tmp_path, job, impl):
    mod = preemption if impl == "port" else jpreemption
    cfg = _cfg(tmp_path)
    cb = mod.create_checkpoint_callback(cfg, "run3", tmp_path / "run3", "wandb3")
    cb(7)
    record = mod.RunStateStore(cfg)._read_locked()
    assert record["latest_checkpoint_step"] == 7 and record["run_id"] == "run3"
    assert record["config_hash"] == mod.config_hash(cfg)


@pytest.mark.parametrize(
    "cfg",
    [
        _cfg("/tmp/x"),
        {"b": [1, 2.5, None, True], "a": {"z": "s", "y": 1e-4}},
        tconfig.load_config("rodent-full-clips").to_dict(),
        tconfig.load_config("fly-mc-intention", ["device=cpu", "train_setup.train_config.num_envs=8"]),
    ],
    ids=["minimal", "mixed", "rodent-full-clips", "fly-mc-intention-overridden"],
)
def test_config_hash_equals_the_jax_digest(cfg):
    assert preemption.config_hash(cfg) == jpreemption.config_hash(dict(cfg))
    assert len(preemption.config_hash(cfg)) == 12


def test_job_identifier_follows_the_jax_probes(monkeypatch):
    for env, want in (
        ({"SLURM_ARRAY_JOB_ID": "7", "SLURM_ARRAY_TASK_ID": "3", "SLURM_JOB_ID": "9"}, "slurm_7_3"),
        ({"SLURM_JOB_ID": "9"}, "slurm_9"),
        ({"PBS_JOBID": "12.host"}, "pbs_12.host"),
        ({"JOB_ID": "5"}, "sge_5"),
        ({"JOB_ID": "5", "SGE_TASK_ID": "2"}, "sge_5_2"),
    ):
        for k in ("SLURM_ARRAY_JOB_ID", "SLURM_ARRAY_TASK_ID", "SLURM_JOB_ID", "PBS_JOBID", "JOB_ID", "SGE_TASK_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert preemption.job_identifier() == jpreemption.job_identifier() == want


# ---- the local wandb stand-in -------------------------------------------------


@pytest.mark.skipif(jwandb_compat.USING_REAL_WANDB or wandb_compat.USING_REAL_WANDB, reason="wandb is installed")
def test_standin_writes_the_jax_records(tmp_path):
    """The same logs through both stand-ins (torch values in the port's,
    numpy ones in the JAX one's) give the same JSONL lines and config."""
    runs = {}
    for impl, stand_in, arr in (("port", wandb_compat.LocalWandb(), torch.tensor),
                                ("jax", jwandb_compat.wandb, np.asarray)):
        w = stand_in
        run = w.init(project="p", config={"a": 1, "b": [1, 2]}, id="r", resume="allow", group="g",
                     dir=str(tmp_path / impl))
        assert run.id == "r"
        table = w.Table(data=[[0, 1.0], [1, 2.0]], columns=["frame", "m"])
        w.log({"x": arr(1.5), "v": arr([1.0, 2.0]), "big": arr(np.zeros(65)), "n": 3}, commit=False)
        w.log({"plot": w.plot.line(table, "frame", "m", title="t"), "video": w.Video("/v/1.mp4", format="mp4")},
              commit=False)
        w.log({"y": arr(np.float32(2.0)), "flag": arr(True)}, step=4)
        w.log({"z": "s"})
        w.finish()
        out = tmp_path / impl / "p" / "r"
        lines = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        runs[impl] = ([{k: v for k, v in r.items() if k != "_timestamp"} for r in lines],
                      json.loads((out / "config.json").read_text()))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][0]["big"] == "<array (65,)>" and runs["port"][0][0]["_step"] == 4


@pytest.mark.parametrize("resume, lines", [("allow", 2), ("must", 2), ("never", 1)])
def test_standin_appends_on_resume(tmp_path, resume, lines):
    w = wandb_compat.LocalWandb()
    for r in ("allow", resume):
        w.init(project="p", id="r", resume=r, dir=str(tmp_path))
        w.log({"a": 1})
    w.finish()
    assert len((tmp_path / "p" / "r" / "metrics.jsonl").read_text().splitlines()) == lines


# ---- multirun --------------------------------------------------------------------


@pytest.mark.parametrize(
    "overrides",
    [["a.b=1,2", "c=x", "d=[1,2]"], ["a=5"], ["a=1,2", "b=3,4,5"], ["x=", "y=a,b"], []],
    ids=["sweep-and-list", "single", "product", "empty-value", "none"],
)
def test_expand_multirun_equals_the_jax_one(overrides):
    assert train.expand_multirun(overrides) == jax_expand_multirun(overrides)


def test_expand_multirun_refuses_an_override_without_equals():
    assert jax_expand_multirun(["foo"]) == [["foo="]]  # the reference's fault (ROADMAP, Queue 3)
    with pytest.raises(ValueError, match="'foo'"):
        train.expand_multirun(["a=1,2", "foo"])


def test_multirun_runs_each_job(monkeypatch):
    ran = []
    monkeypatch.setattr(train, "main", lambda cfg: ran.append(cfg) or len(ran))
    out = train.cli(["-m", "--config-name", "fly-mc-intention", "seed=1,2", "device=cpu"])
    assert out == [1, 2]
    assert [c["seed"] for c in ran] == [1, 2] and all(c["device"] == "cpu" for c in ran)
    assert all(c[tconfig.CONFIG_NAME] == "fly-mc-intention" for c in ran)


# ---- the trainers' checkpoint callback --------------------------------------------


def recording_callbacks(monkeypatch, fail: bool = False) -> list:
    """Every call of a run's checkpoint callback, appended to the list
    returned (the record is still written; with `fail` the callback raises
    instead)."""
    calls = []
    make = preemption.RunStateStore.checkpoint_callback

    def recorder(self, run_id, checkpoint_path, wandb_run_id):
        inner = make(self, run_id, checkpoint_path, wandb_run_id)

        def cb(step):
            calls.append(step)
            if fail:
                raise RuntimeError("a failing callback")
            inner(step)

        return cb

    monkeypatch.setattr(preemption.RunStateStore, "checkpoint_callback", recorder)
    return calls


def test_lstm_trainer_calls_the_callback_after_each_step_written(clips, tmp_path, job, monkeypatch):
    """The LSTM trainer calls it with 0 and 1, the steps it wrote; a callback
    that raises is logged and training goes on. (The MLP trainer's calls,
    and none after a skipped save: test_cli_resumes_a_preempted_run.)"""
    calls = recording_callbacks(monkeypatch, fail=True)
    train.main(tiny_cfg(clips, tmp_path, *LSTM), policy_params_fn=no_logging)
    assert calls == [0, 1]
    (run_dir,) = [p for p in tmp_path.iterdir() if p.name != "wandb_local"]
    assert sorted(checkpointing.committed_steps(str(run_dir))) == [0, 1]


def test_callback_is_skipped_with_its_save():
    calls = []
    for wrote in (True, False):
        mlp_ppo.call_checkpoint_callback(calls.append, 3, wrote)
    mlp_ppo.call_checkpoint_callback(None, 4, True)
    assert calls == [3]


# ---- the CLI end to end -------------------------------------------------------------


def _metrics(model_path):
    (path,) = list((model_path / "wandb_local").glob("*/*/metrics.jsonl"))
    return path, [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_manages_its_run_and_logs_each_eval(clips, tmp_path, job):
    cfg = tiny_cfg(clips, tmp_path)
    record = preemption.RunStateStore(cfg).path
    during = []
    train.main(cfg, progress_fn=lambda s, m: during.append(json.loads(record.read_text())))
    assert [r.get("latest_checkpoint_step") for r in during] == [None, 0]  # written, then each step's
    assert not record.exists()
    (run_dir,) = [p for p in tmp_path.iterdir() if p.name != "wandb_local"]
    assert during[0]["checkpoint_path"] == str(run_dir)
    assert sorted(checkpointing.committed_steps(str(run_dir))) == [0, 1]
    path, lines = _metrics(tmp_path)
    assert path.parent.name == f"jerk_cost_50hz_{run_dir.name}"
    assert len(lines) == 2 and [r["num_steps_thousands"] for r in lines] == [0, 0]
    last = lines[-1]
    assert np.isfinite(last["eval/episode_reward"])
    latents = {k for k in last if k.startswith("latents/")}
    assert latents == {"latents/nonfinite_frames"} | {f"latents/latent_{a}_{b}{i}" for a in ("means", "logvars")
                                                       for b in ("mean", "std") for i in range(4)}
    for name in cfg.logging_config.rollout_metrics:
        assert last[f"eval/rollout_{name}"] == {"_type": "line-plot", "x": "frame", "y": name,
                                                "title": f"{name} for each rollout frame"}
    video = last["videos/rollout"]["path"]
    assert os.path.dirname(video) == str(run_dir) and os.path.basename(video).split(".")[0] == "1"
    if video.endswith(".npz"):
        with np.load(video) as z:
            frames = z["frames"]
    else:
        import imageio

        frames = np.stack([f[..., :3] for f in imageio.mimread(video)])
        assert len(frames) >= 1
    assert frames.shape[1:] == (512, 512, 3) and frames.dtype == np.uint8 and frames.min() < 255
    assert json.loads((path.parent / "config.json").read_text())["train_setup"]["train_config"]["num_envs"] == 2


class Preempted(Exception):
    pass


def test_cli_resumes_a_preempted_run(clips, tmp_path, job, monkeypatch):
    """A run stopped after its first checkpoint leaves its record; the next
    run of the same config resumes that run directory and wandb run, writes
    a later step and removes the record. `restore_from_run_state` resumes
    from a copy of the record. The MLP trainer calls the checkpoint callback
    after each save that wrote a step (0, then in the resumed run 1) and
    after no other (the resumed run's step 0, and every step of the last
    run, are there already)."""
    callbacks = recording_callbacks(monkeypatch)
    cfg = tiny_cfg(clips, tmp_path)
    record = preemption.RunStateStore(cfg).path
    calls = []

    def preempt(step, metrics):
        calls.append(step)
        if len(calls) == 2:  # after the initial eval's checkpoint
            raise Preempted

    with pytest.raises(Preempted):
        train.main(cfg, progress_fn=preempt, policy_params_fn=no_logging)
    assert callbacks == [0]
    kept = json.loads(record.read_text())
    (run_dir,) = [p for p in tmp_path.iterdir() if p.name not in ("wandb_local", record.name)]
    assert kept["latest_checkpoint_step"] == 0 and kept["checkpoint_path"] == str(run_dir)
    assert sorted(checkpointing.committed_steps(str(run_dir))) == [0]
    (tmp_path / "by_hand.json").write_text(record.read_text())

    train.main(cfg, policy_params_fn=no_logging)
    assert callbacks == [0, 1]
    assert sorted(checkpointing.committed_steps(str(run_dir))) == [0, 1]
    assert not record.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([run_dir.name, "wandb_local", "by_hand.json"])
    path, lines = _metrics(tmp_path)  # one wandb run: its lines appended
    assert path.parent.name == kept["wandb_run_id"] and len(lines) >= 2

    train.main(tiny_cfg(clips, tmp_path, "train_setup.restore_from_run_state=by_hand.json"),
               policy_params_fn=no_logging)
    assert callbacks == [0, 1]
    assert sorted(checkpointing.committed_steps(str(run_dir))) == [0, 1]  # the run's steps, none rewritten
    assert [p.parent.name for p in (tmp_path / "wandb_local").glob("*/*/metrics.jsonl")] == [kept["wandb_run_id"]]
