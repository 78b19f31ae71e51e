"""Training entry point: config, data, env, trainer, checkpoints.

Port of track_mjx_tpu/train.py, both pipelines:

- the config is the port's exported JSON of a workload
  (`utils.config.load_config`) with dotted overrides; `device` (top level,
  default "cuda") names where the trainer runs;
- resume: with `train_setup.checkpoint_to_restore` set, the checkpoint's
  stored config is authoritative, its training state is restored and the
  eval iteration count starts again at 0;
- decoder transfer: with `train_setup.freeze_decoder` as well, the given
  config runs as a new run, and only the checkpoint's decoder (frozen) and
  the proprioceptive slice of its normalizer (pinned) carry over
  (agent/mlp_ppo/ppo.py). The JAX CLI replaces the config with the
  checkpoint's there too, so its freeze_decoder is the source run's and the
  run writes into the source's directory (ROADMAP, standing divergences);
- checkpoints go to <logging_config.model_path>/<run_id>, PPONetwork_<step>;
- the clips come from `data_path` (`.npz`, or `.h5` where h5py is
  installed) through `io.load.load_data`, split by `train_subset_ratio` or
  `train_test_split_info`, the test clips evaluated as `eval_env_test_set`;
- episode_length = (clip_length - random_init_range - traj_length) *
  steps per reference frame; num_evals = num_timesteps / eval_every;
  num_resets_per_eval = eval_every // reset_every;
- the walker is the config's (`env_config.walker_name`: rodent or fly,
  `workload.WALKERS`) on its workload's snapshot (`config_name`, set by
  `load_config`; a walker_config override that the snapshot was not
  exported with raises, `workload.make_walker`);
- the pipeline is the MLP one (agent/mlp_ppo), or with
  `train_setup.train_config.use_lstm` the LSTM one (agent/lstm_ppo), whose
  carry widths come from `network_config.hidden_state_size` and
  `hidden_layer_num` (no YAML sets them: give them as overrides, e.g. 128
  and 2, the JAX LSTM trainer's defaults);
- run management, as the JAX CLI: a preemption run-state record
  (agent/preemption.py, keyed by the scheduler's job id and the hash of the
  config as given) found at the start resumes its run (its checkpoint, run
  directory and wandb id); `train_setup.restore_from_run_state=<file under
  logging_config.model_path>` restores from a record by hand; a fresh run
  writes its record, each checkpoint written updates it, and a run that
  ends without an error removes it;
- logging: progress goes to `logging` and to `wandb` (utils/wandb_compat.py:
  the real one where installed and WANDB_API_KEY is set, else JSONL under
  <logging_config.model_path>/wandb_local/<project>/<run>/, where the JAX
  CLI writes wandb_local/ into the working directory), which gets the
  config, every progress report with `num_steps_thousands`, and after
  every eval the logging rollout's `latents/*` (agent/wandb_logging.py:
  one env over the whole clip through the render wrapper); every
  `env_config.render_interval` evals also its `eval/rollout_<metric>`
  curves and a ghost-pair video, `<run dir>/<it>.mp4` (or .gif, or .npz
  without imageio), drawn by analysis/render.py;
- `-m/--multirun` runs the cartesian product of comma-separated override
  values one job after another (`expand_multirun`: Hydra's order; a value
  that parses as a JSON list is no sweep; an override without "=" raises,
  where the JAX one writes "key=");
- `distributed=true`: data-parallel training, one process per device
  (parallel/mesh.py, where the JAX CLI calls jax.distributed.initialize()):
  the process group comes from torchrun's variables (RANK, WORLD_SIZE,
  LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else SLURM's,
  and a rank trains on cuda:LOCAL_RANK over NCCL (with `device=cpu`, on the
  CPU over gloo). Without them, or where the group's init fails, it
  raises: nothing trains alone instead. Every rank reads the same run-state
  records and checkpoint (a barrier follows the discovery, before rank 0
  writes a new record); rank 0 alone writes the run directory, the
  checkpoints, the records and the logs, and runs the evals and the
  logging rollout. The process group is left at the end.

`train_config`'s `rollout_bf16` and `profile_dir` reach the trainers as
they are. At the end every process logs its kernels' launch counts
(`kernel launches: {...}`, the wrappers' `.launches`).

Usage:
    python -m track_mjx_tpu_torch.train [--config-name NAME] [-m] [key.sub=value ...]
    torchrun --nproc_per_node=N -m track_mjx_tpu_torch.train distributed=true [key.sub=value ...]
"""

from __future__ import annotations

import copy
import functools
import itertools
import json
import logging
import os
import sys
from datetime import datetime
from pathlib import Path

import torch

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent import checkpointing, preemption, wandb_logging
from track_mjx_tpu_torch.agent.lstm_ppo import ppo as lstm_ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as lstm_ppo_networks
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as mlp_ppo_networks
from track_mjx_tpu_torch.analysis import render
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.ops import batched_linalg, cg_solver_kernel
from track_mjx_tpu_torch.parallel import mesh as mesh_lib
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.utils.config import CONFIG_NAME, ConfigDict, load_config
from track_mjx_tpu_torch.utils.wandb_compat import wandb


KERNELS = (
    cg_solver_kernel.cg_solve, cg_solver_kernel.cg_solve_dense, cg_solver_kernel.ell_cg_solve,
    cg_solver_kernel.ell_cg_solve_dense, batched_linalg.cholesky, batched_linalg.cho_solve, batched_linalg.solve_spd,
)


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count in this process."""
    return {fn.__name__: fn.launches for fn in KERNELS}


def _refuse_unported(cfg: ConfigDict) -> None:
    train_setup = cfg["train_setup"]
    if train_setup.get("freeze_decoder") and train_setup["train_config"].get("use_lstm"):
        raise NotImplementedError(
            "train_setup.freeze_decoder with the LSTM pipeline: its policy has no `decoder` module to freeze"
        )


def main(cfg: ConfigDict, progress_fn=None, batch_callback=None, policy_params_fn=None, mesh=None):
    """Runs training from a loaded config; returns (make_policy, (normalizer,
    policy state dict)). `progress_fn(num_steps_thousands, metrics)` is
    called beside the logging of progress; `batch_callback(training_state,
    data, make_learner)` goes to the trainer (`ppo.train`);
    `policy_params_fn`, where given, replaces the per-eval logging rollout
    (`wandb_logging.rollout_logging_fn`) as the trainer's hook. With
    `distributed` set the process group comes from the launcher's
    variables, unless `mesh` (a `parallel.mesh.Mesh` already joined) is
    given; `mesh` without `distributed` raises."""
    _refuse_unported(cfg)
    cfg = copy.deepcopy(cfg)
    device = cfg.get("device", "cuda")
    if mesh is not None and not cfg.get("distributed"):
        raise ValueError("a process group was given, but the config does not set distributed=true")
    joined = cfg.get("distributed") and mesh is None
    if joined:
        mesh = mesh_lib.init_from_env(device)
    try:
        return _main(cfg, device if mesh is None else str(mesh.device), mesh, progress_fn, batch_callback,
                     policy_params_fn)
    finally:
        logging.info("kernel launches%s: %s", "" if mesh is None else f" (rank {mesh.rank})",
                     json.dumps(kernel_launches()))
        if joined:
            mesh_lib.destroy(mesh)


def split_clips(all_clips: load.ReferenceClip, train_setup, mesh=None):
    """(train clips, test clips or None) as `train_setup` asks: the indices
    of a `train_test_split_info` file, a random split leaving
    `train_subset_ratio` of the clips for training, or every clip for
    training. The random split is the JAX CLI's numpy draw; under a mesh
    every rank draws and then takes rank 0's test clips, so that the ranks
    train on one set of clips and rank 0 evaluates on clips none of them
    trains on."""
    if train_setup.get("train_test_split_info") is not None:
        with open(train_setup["train_test_split_info"], "r") as f:
            split_info = json.load(f)
        if train_setup.get("train_subset_ratio") is None:
            train_idx = split_info["train"]
        else:
            train_idx = split_info["train_subset"][f"{train_setup['train_subset_ratio']:.2f}"]
        return load.select_clips(all_clips, train_idx), load.select_clips(all_clips, split_info["test"])
    if train_setup.get("train_subset_ratio") is None:
        return all_clips, None
    test_idx = load.draw_test_indices(all_clips.position.shape[0], test_ratio=1 - train_setup["train_subset_ratio"])
    if mesh is not None:
        drawn = torch.as_tensor(test_idx, dtype=torch.int64)
        mesh_lib.replicate([drawn], mesh)
        test_idx = drawn.numpy()
    return load.split_at(all_clips, test_idx)


def _main(cfg: ConfigDict, device: str, mesh, progress_fn, batch_callback, policy_params_fn):
    main_rank = mesh_lib.is_main(mesh)
    freeze_decoder = bool(cfg["train_setup"].get("freeze_decoder", False))
    store = preemption.RunStateStore(cfg)  # keyed by the config as given, for every record operation

    existing_run_state = store.discover()
    mesh_lib.synchronize_hosts(mesh)  # every rank reads the records before rank 0 writes a new one
    if existing_run_state:
        logging.info("Resuming from existing run: %s", existing_run_state["run_id"])
    elif cfg["train_setup"].get("restore_from_run_state") is not None:
        full_path = Path(cfg["logging_config"]["model_path"]).resolve() / cfg["train_setup"]["restore_from_run_state"]
        existing_run_state = preemption.read_locked(full_path)
        logging.info("Restoring from run state: %s", existing_run_state["run_id"])
    if existing_run_state:
        cfg["train_setup"]["checkpoint_to_restore"] = str(Path(existing_run_state["checkpoint_path"]).resolve())

    if existing_run_state or (cfg["train_setup"].get("checkpoint_to_restore") is not None and not freeze_decoder):
        checkpoint_to_restore = str(Path(cfg["train_setup"]["checkpoint_to_restore"]).resolve())
        # the checkpoint's stored config is authoritative on resume
        distributed = cfg.get("distributed")
        cfg = ConfigDict(checkpointing.load_config_from_checkpoint(checkpoint_to_restore))
        cfg["train_setup"]["checkpoint_to_restore"] = checkpoint_to_restore
        cfg["device"] = device
        cfg["distributed"] = distributed
        checkpoint_path = checkpoint_to_restore
        run_id = os.path.basename(checkpoint_path)
        _refuse_unported(cfg)
    else:
        if cfg["train_setup"].get("checkpoint_to_restore") is not None:  # the decoder's source run
            cfg["train_setup"]["checkpoint_to_restore"] = str(Path(cfg["train_setup"]["checkpoint_to_restore"]).resolve())
        run_id = datetime.now().strftime("%y%m%d_%H%M%S_%f")
        checkpoint_path = str(Path(cfg["logging_config"]["model_path"]).resolve() / run_id)

    workload.snapshot_name(cfg)  # before anything runs: a walker the snapshot does not hold raises
    cfg_dict = cfg.to_dict()
    logging.info("Configs: %s", cfg_dict)
    train_setup = cfg["train_setup"]
    ckpt_mgr = None
    if main_rank:  # rank 0 alone writes the run directory
        ckpt_mgr = checkpointing.CheckpointManager(
            checkpoint_path,
            max_to_keep=train_setup.get("checkpoint_max_to_keep"),
            keep_period=train_setup.get("checkpoint_keep_period"),
        )
    logging.info("run_id: %s", run_id)
    logging.info("Training checkpoint path: %s", checkpoint_path)

    phys_forward.set_full_f32()
    logging.info("Loading data: %s", cfg["data_path"])
    all_clips = load.load_data(cfg["data_path"], device=device)
    train_clips, test_clips = split_clips(all_clips, train_setup, mesh)
    env = workload.make_env(cfg, train_clips, device=device)
    test_env = None if test_clips is None else workload.make_env(cfg, test_clips, device=device)

    episode_length = workload.episode_length(cfg, env)
    logging.info("episode_length %s", episode_length)
    train_config = dict(train_setup["train_config"])
    network_config = cfg["network_config"]
    use_lstm = bool(train_config.get("use_lstm"))
    if use_lstm:
        logging.info("Using LSTM pipeline")
        ppo, ppo_networks = lstm_ppo, lstm_ppo_networks
    else:
        logging.info("Using MLP pipeline")
        ppo, ppo_networks = mlp_ppo, mlp_ppo_networks

    # ---- wandb and the run-state record (JAX train.py:227-256) ----------
    logging_config = cfg["logging_config"]
    # rodent-sps-per-actor's YAML has no exp_name (the JAX CLI raises a KeyError there)
    run_id = f"{logging_config.get('exp_name') or cfg.get(CONFIG_NAME, 'run')}_{run_id}"
    if existing_run_state:
        wandb_run_id, wandb_resume = existing_run_state["wandb_run_id"], "must"
    else:
        wandb_run_id, wandb_resume = run_id, "allow"
    checkpoint_callback = None
    if main_rank:  # rank 0 alone logs and keeps the run-state record
        wandb.init(
            project=logging_config["project_name"],
            config=cfg_dict,
            id=wandb_run_id,
            resume=wandb_resume,
            group=logging_config["group_name"],
            dir=str(Path(logging_config["model_path"]).resolve() / "wandb_local"),
        )
        if not existing_run_state:
            store.save(run_id, checkpoint_path, wandb.run.id)
        checkpoint_callback = store.checkpoint_callback(run_id, checkpoint_path, wandb.run.id)

    def progress(num_steps, metrics):
        logging.info("num_steps_thousands %s: %s", num_steps, metrics)
        wandb.log({**metrics, "num_steps_thousands": num_steps})
        if progress_fn is not None:
            progress_fn(num_steps, metrics)

    if policy_params_fn is None and main_rank:  # the trainers call it on rank 0 only
        if use_lstm:
            rollout_env = wrappers.RenderRolloutWrapperTrackingLSTM(
                env, lstm_features=network_config["hidden_state_size"],
                hidden_layer_num=network_config["hidden_layer_num"],
            )
        else:
            rollout_env = wrappers.RenderRolloutWrapperMulticlipTracking(env)
        policy_params_fn = functools.partial(
            wandb_logging.rollout_logging_fn, rollout_env, cfg, checkpoint_path,
            render.make_rollout_renderer(cfg, device),
        )

    make_inference_fn, params, _ = ppo.train(
        environment=env,
        **train_config,
        num_evals=int(train_config["num_timesteps"] / train_setup["eval_every"]),
        num_resets_per_eval=train_setup["eval_every"] // train_setup["reset_every"],
        episode_length=episode_length,
        kl_weight=network_config["kl_weight"],
        network_factory=ppo_networks.network_factory(network_config),
        ckpt_mgr=ckpt_mgr,
        checkpoint_to_restore=train_setup.get("checkpoint_to_restore"),
        config_dict=cfg_dict,
        use_kl_schedule=network_config["kl_schedule"],
        eval_env_test_set=test_env,
        freeze_decoder=freeze_decoder,
        checkpoint_callback=checkpoint_callback,
        progress_fn=progress,
        policy_params_fn=policy_params_fn,
        device=device,
        batch_callback=batch_callback,
        mesh=mesh,
    )
    if main_rank:
        wandb.finish()
        store.clear()
        logging.info("Training completed successfully, cleaned up run state")
    return make_inference_fn, params


def expand_multirun(overrides):
    """Hydra's multirun sweep: comma-separated values (`a.b=1,2 c=x,y`)
    expand to the cartesian product of single-value override sets, the
    first override varying slowest. A value that parses as a JSON list
    (`a=[1,2]`) is no sweep. An override without "=" raises a ValueError
    (the JAX package's writes it as `key=`)."""
    axes = []
    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} has no '=': write key=value")
        parts = raw.split(",") if raw else [raw]
        if len(parts) > 1:
            try:
                if isinstance(json.loads(raw), list):
                    parts = [raw]
            except json.JSONDecodeError:
                pass
        axes.append([f"{key}={p}" for p in parts])
    return [list(combo) for combo in itertools.product(*axes)]


def cli(argv=None):
    """python -m track_mjx_tpu_torch.train [--config-name NAME] [-m|--multirun]
    [a.b=c ...]; with -m, each job of `expand_multirun(overrides)` in turn."""
    logging.basicConfig(level=logging.INFO)
    args = sys.argv[1:] if argv is None else list(argv)
    config_name = "rodent-full-clips"
    multirun = False
    overrides = []
    i = 0
    while i < len(args):
        if args[i] in ("--config-name", "-cn"):
            config_name = args[i + 1]
            i += 2
        elif args[i].startswith("--config-name="):
            config_name = args[i].split("=", 1)[1]
            i += 1
        elif args[i] in ("-m", "--multirun"):
            multirun = True
            i += 1
        else:
            overrides.append(args[i])
            i += 1
    if multirun:
        jobs = expand_multirun(overrides)
        out = []
        for k, job in enumerate(jobs):
            logging.info("multirun job %d/%d: %s", k + 1, len(jobs), job)
            out.append(main(load_config(config_name, job)))
        return out
    return main(load_config(config_name, overrides))


if __name__ == "__main__":
    cli()
