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
- progress goes to `logging`.

`train_config`'s `rollout_bf16` and `profile_dir` reach the trainers as
they are. Not ported (ROADMAP 5d/5e), and refused rather than skipped:
multi-host `distributed`, preemption run-state files
(`restore_from_run_state`, and the trainers' `checkpoint_callback`) and
`-m` multirun. There is no wandb and no rendering.

Usage:
    python -m track_mjx_tpu_torch.train [--config-name NAME] [key.sub=value ...]
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime
from pathlib import Path

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.agent.lstm_ppo import ppo as lstm_ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as lstm_ppo_networks
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as mlp_ppo_networks
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.utils.config import ConfigDict, load_config


def _refuse_unported(cfg: ConfigDict) -> None:
    train_setup = cfg["train_setup"]
    refused = {
        "distributed": bool(cfg.get("distributed")),
        "train_setup.restore_from_run_state (preemption run states)": train_setup.get("restore_from_run_state")
        is not None,
    }
    for what, asked in refused.items():
        if asked:
            raise NotImplementedError(f"{what}: not ported (ROADMAP 5d/5e)")
    if train_setup.get("freeze_decoder") and train_setup["train_config"].get("use_lstm"):
        raise NotImplementedError(
            "train_setup.freeze_decoder with the LSTM pipeline: its policy has no `decoder` module to freeze"
        )


def main(cfg: ConfigDict, progress_fn=None, batch_callback=None):
    """Runs training from a loaded config; returns (make_policy, (normalizer,
    policy state dict)). `progress_fn(num_steps_thousands, metrics)` is
    called beside the logging of progress; `batch_callback(training_state,
    data, make_learner)` goes to the trainer (`ppo.train`)."""
    _refuse_unported(cfg)
    device = cfg.get("device", "cuda")
    freeze_decoder = bool(cfg["train_setup"].get("freeze_decoder", False))

    if cfg["train_setup"].get("checkpoint_to_restore") is not None and not freeze_decoder:
        checkpoint_to_restore = str(Path(cfg["train_setup"]["checkpoint_to_restore"]).resolve())
        # the checkpoint's stored config is authoritative on resume
        cfg = ConfigDict(checkpointing.load_config_from_checkpoint(checkpoint_to_restore))
        cfg["train_setup"]["checkpoint_to_restore"] = checkpoint_to_restore
        cfg["device"] = device
        checkpoint_path = checkpoint_to_restore
        run_id = os.path.basename(checkpoint_path)
        _refuse_unported(cfg)
    else:
        if cfg["train_setup"].get("checkpoint_to_restore") is not None:  # the decoder's source run
            cfg["train_setup"]["checkpoint_to_restore"] = str(Path(cfg["train_setup"]["checkpoint_to_restore"]).resolve())
        run_id = datetime.now().strftime("%y%m%d_%H%M%S_%f")
        model_path = Path(cfg["logging_config"]["model_path"])
        if not model_path.is_absolute():
            model_path = Path.cwd() / model_path
        checkpoint_path = str(model_path / run_id)

    workload.snapshot_name(cfg)  # before anything runs: a walker the snapshot does not hold raises
    cfg_dict = cfg.to_dict()
    logging.info("Configs: %s", cfg_dict)
    train_setup = cfg["train_setup"]
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
    test_clips = None
    if train_setup.get("train_test_split_info") is not None:
        with open(train_setup["train_test_split_info"], "r") as f:
            split_info = json.load(f)
        if train_setup.get("train_subset_ratio") is None:
            train_idx = split_info["train"]
        else:
            train_idx = split_info["train_subset"][f"{train_setup['train_subset_ratio']:.2f}"]
        test_clips = load.select_clips(all_clips, split_info["test"])
        train_clips = load.select_clips(all_clips, train_idx)
    elif train_setup.get("train_subset_ratio") is not None:
        train_clips, test_clips = load.generate_train_test_split(
            all_clips, test_ratio=1 - train_setup["train_subset_ratio"]
        )
    else:
        train_clips = all_clips
    env = workload.make_env(cfg, train_clips, device=device)
    test_env = None if test_clips is None else workload.make_env(cfg, test_clips, device=device)

    episode_length = workload.episode_length(cfg, env)
    logging.info("episode_length %s", episode_length)
    train_config = dict(train_setup["train_config"])
    network_config = cfg["network_config"]

    def progress(num_steps, metrics):
        logging.info("num_steps_thousands %s: %s", num_steps, metrics)
        if progress_fn is not None:
            progress_fn(num_steps, metrics)

    if train_config.get("use_lstm"):
        logging.info("Using LSTM pipeline")
        ppo, ppo_networks = lstm_ppo, lstm_ppo_networks
    else:
        logging.info("Using MLP pipeline")
        ppo, ppo_networks = mlp_ppo, mlp_ppo_networks

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
        progress_fn=progress,
        device=device,
        batch_callback=batch_callback,
    )
    return make_inference_fn, params


def cli(argv=None):
    """python -m track_mjx_tpu_torch.train [--config-name NAME] [a.b=c ...]"""
    logging.basicConfig(level=logging.INFO)
    args = sys.argv[1:] if argv is None else list(argv)
    config_name = "rodent-full-clips"
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
            raise NotImplementedError("-m/--multirun: not ported; run one job per call")
        else:
            overrides.append(args[i])
            i += 1
    return main(load_config(config_name, overrides))


if __name__ == "__main__":
    cli()
