"""Long PPO learning run of the torch port on synthetic clips: the learning
check of tools/long_run.py, through track_mjx_tpu_torch.

Runs the port's MLP intention-PPO trainer (`agent/mlp_ppo/ppo.train`) with
the keyword values tools/long_run.py passes the JAX trainer: the reference
minibatch structure (batch 1024 x 16 minibatches x 4 updates, unroll 20,
4096 envs, 128 deterministic eval envs), the config's learning rate,
entropy cost, KL weight (ramped over the first quarter of the evals),
discounting, clipping epsilon and seed, and the intention networks at the
config's widths, on `n_clips` synthetic clips of the config's clip length.
Each eval appends a record to `--out` (a JSON list) and prints it: wall_s,
env_steps_k, eval_reward, eval_reward_std, avg_episode_length,
training_sps, eval_sps (the JAX tool's keys) and kernel_launches (each
kernel wrapper's launches so far in this process).

Flags beyond the JAX tool's, each defaulting to its value there:
--device (cuda; the port raises without a card unless it is cpu),
--clip-length and --random-init-range (the config's), --unroll-length (the
config's), --num-eval-envs (128), --stop-after-evals (none: with N, the run
stops once its Nth eval is recorded and checkpointed, its schedule and KL
ramp still those of --num-evals) and --ckpt-dir (none: with a directory, a
checkpoint of every eval goes there as PPONetwork_<step>, beside clips.npz,
the clips of the run, and each step's config.json holds the config with
that data_path, so that `checkpointing.load_checkpoint_for_eval(DIR)` and
`analysis.rollout.create_environment` rebuild the run's policy and env, as
examples/torch/02_rollout_from_checkpoint.py does).

Each record after the first also carries step_sps, the env steps of one
training step over the host seconds between the trainer's batch hooks of
two consecutive training steps of the epoch (one learning half and one
rollout; on the card each phase ends in a synchronize), one value for each
training step of the epoch but its first.

Usage:
    python tools/long_run_torch.py [--walker fly] [--num-timesteps 50e6]
        [--num-envs 4096] [--num-evals 16] [--out $TMPDIR/long_run.json]
        [--ckpt-dir DIR] [--device cuda]

A tiny run on the CPU (about 15 s; episodes of one control step, full widths):
    python tools/long_run_torch.py --device cpu --num-timesteps 16 --num-envs 4 \
        --num-evals 2 --batch-size 2 --num-minibatches 2 --updates-per-batch 1 \
        --n-clips 2 --clip-length 8 --random-init-range 2 --unroll-length 2 --num-eval-envs 2
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from track_mjx_tpu_torch import train as ttrain
from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config

CONFIGS = {"rodent": "rodent-full-clips", "fly": "fly-mc-intention"}
CLIPS_FILE = "clips.npz"


class StopRun(Exception):
    """Raised once the run has recorded (and checkpointed) --stop-after-evals evals."""


class CheckpointThenStop(checkpointing.CheckpointManager):
    """A CheckpointManager that calls `stop()` after each save."""

    def __init__(self, checkpoint_path: str, stop):
        super().__init__(checkpoint_path)
        self.stop = stop

    def save(self, step: int, *args, **kwargs) -> bool:
        wrote = super().save(step, *args, **kwargs)
        self.stop()
        return wrote


def build_env(num_clips: int, clip_length: int | None = None, walker_type: str = "rodent",
              device: torch.device | str = "cuda", random_init_range: int | None = None):
    """(env, cfg, clips): the walker's workload config (its clip_length and
    random_init_range set where given), `num_clips` synthetic clips of that
    length at the config's mocap rate over the workload's snapshot, and the
    unwrapped tracking env over them, as bench.build_env builds the JAX one."""
    name = CONFIGS[walker_type]
    cfg = load_config(name)
    if clip_length is not None:
        cfg.reference_config.clip_length = int(clip_length)
    if random_init_range is not None:
        cfg.reference_config.random_init_range = int(random_init_range)
    clips = synthesize_clips(
        phys_model.load_snapshot(name),
        n_clips=num_clips,
        n_frames=int(cfg.reference_config.clip_length),
        mocap_hz=cfg.env_config.env_args.mocap_hz,
        device=device,
    )
    return workload.make_env(cfg, clips, device=device), cfg, clips


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--walker", choices=tuple(CONFIGS), default="rodent")
    ap.add_argument("--num-timesteps", type=float, default=50e6)
    ap.add_argument("--num-envs", type=int, default=4096)
    ap.add_argument("--num-evals", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--num-minibatches", type=int, default=16)
    ap.add_argument("--updates-per-batch", type=int, default=4)
    ap.add_argument("--epoch-steps-per-call", type=int, default=2)
    ap.add_argument("--n-clips", type=int, default=4)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", type=str, default=os.path.join(tempfile.gettempdir(), "long_run.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clip-length", type=int, default=None, help="default: the config's")
    ap.add_argument("--random-init-range", type=int, default=None, help="default: the config's")
    ap.add_argument("--unroll-length", type=int, default=None, help="default: the config's")
    ap.add_argument("--num-eval-envs", type=int, default=128)
    ap.add_argument("--stop-after-evals", type=int, default=None, help="default: run every eval")
    ap.add_argument("--ckpt-dir", default=None, help="write a checkpoint of every eval here (default: none)")
    return ap


def main(argv=None) -> list:
    """Runs the learning check; returns the records."""
    args = parser().parse_args(argv)
    phys_forward.set_full_f32()
    env, cfg, clips = build_env(args.n_clips, args.clip_length, walker_type=args.walker, device=args.device,
                                random_init_range=args.random_init_range)
    episode_length = workload.episode_length(cfg, env)
    print(f"episode_length={episode_length}", flush=True)

    net = cfg.network_config
    factory = functools.partial(
        ppo_networks.make_intention_ppo_networks,
        intention_latent_size=net.intention_size,
        encoder_hidden_layer_sizes=tuple(net.encoder_layer_sizes),
        decoder_hidden_layer_sizes=tuple(net.decoder_layer_sizes),
        value_hidden_layer_sizes=tuple(net.critic_layer_sizes),
    )

    tc = cfg.train_setup.train_config
    kwargs = dict(
        num_timesteps=int(args.num_timesteps),
        num_envs=args.num_envs,
        num_eval_envs=args.num_eval_envs,
        learning_rate=float(tc.learning_rate),
        entropy_cost=float(tc.entropy_cost),
        kl_weight=float(net.kl_weight),
        discounting=float(tc.discounting),
        seed=int(tc.seed if args.seed is None else args.seed),
        unroll_length=int(tc.unroll_length if args.unroll_length is None else args.unroll_length),
        batch_size=args.batch_size,
        num_minibatches=args.num_minibatches,
        num_updates_per_batch=args.updates_per_batch,
        num_evals=args.num_evals,
        normalize_observations=True,
        clipping_epsilon=float(tc.clipping_epsilon),
        use_lstm=False,
        deterministic_eval=True,
        epoch_steps_per_call=args.epoch_steps_per_call,
    )
    history, stamps = [], []

    def stop():
        if args.stop_after_evals is not None and len(history) >= args.stop_after_evals:
            raise StopRun(f"stopped after {len(history)} evals (--stop-after-evals)")

    ckpt_mgr = None
    config_dict = {"network_config": {}, "env_config": {"render_interval": 10_000}}
    if args.ckpt_dir is not None:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        cfg.data_path = os.path.abspath(os.path.join(args.ckpt_dir, CLIPS_FILE))
        load.save_npz(clips, cfg.data_path)
        # the stored config describes this run: its clips and the trainer's arguments
        tc.update({k: v for k, v in kwargs.items() if k in tc or k == "num_eval_envs"})
        net.kl_weight = kwargs["kl_weight"]
        config_dict = cfg.to_dict()
        ckpt_mgr = CheckpointThenStop(args.ckpt_dir, stop)

    per_step = kwargs["batch_size"] * kwargs["unroll_length"] * kwargs["num_minibatches"]
    t0 = time.time()

    def on_batch(*_):  # after each training step's rollout, before its learning half
        stamps.append(time.perf_counter())

    def progress(step, metrics):
        rec = {
            "wall_s": round(time.time() - t0, 1),
            "env_steps_k": int(step),
            "eval_reward": _f(metrics.get("eval/episode_reward")),
            "eval_reward_std": _f(metrics.get("eval/episode_reward_std")),
            "avg_episode_length": _f(metrics.get("eval/avg_episode_length")),
            "training_sps": _f(metrics.get("training/sps")),
            "eval_sps": _f(metrics.get("eval/sps")),
            "kernel_launches": ttrain.kernel_launches(),
        }
        if stamps:
            rec["step_sps"] = [per_step / (b - a) for a, b in zip(stamps, stamps[1:])]
            stamps.clear()
        history.append(rec)
        print(json.dumps(rec), flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(history, f, indent=1)
        if ckpt_mgr is None:
            stop()

    try:
        mlp_ppo.train(
            environment=env,
            episode_length=episode_length,
            ckpt_mgr=ckpt_mgr,
            config_dict=config_dict,
            network_factory=factory,
            progress_fn=progress,
            device=args.device,
            batch_callback=on_batch,
            **kwargs,
        )
    except StopRun as e:
        print(e, flush=True)
    rews = [h["eval_reward"] for h in history if h["eval_reward"] is not None]
    if rews:
        print(f"\nfirst={rews[0]:.2f} last={rews[-1]:.2f} max={max(rews):.2f}")
    return history


def _f(x):
    return float(x) if x is not None else None


if __name__ == "__main__":
    main()
