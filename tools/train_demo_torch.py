"""Short end-to-end PPO learning demo of the torch port on the rodent
tracking task: tools/train_demo.py through track_mjx_tpu_torch.

Trains the port's MLP intention-PPO trainer (`agent/mlp_ppo/ppo.train`) with
the keyword values tools/train_demo.py passes the JAX trainer (2 synthetic
clips of 250 frames, episodes of 195 control steps, batch 256 x 4
minibatches x 4 updates, unroll 20, KL weight 0.1, entropy cost 0.01, the
intention networks at rodent-full-clips' widths) and prints the eval-reward
progression. At 512 envs a control step is host-bound, so on a card this
takes far longer per env step than tools/long_run_torch.py at 4096.

Usage: python tools/train_demo_torch.py [num_timesteps] [num_envs] [num_evals] [--device cuda]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num_timesteps", type=int, nargs="?", default=4_000_000)
    ap.add_argument("num_envs", type=int, nargs="?", default=512)
    ap.add_argument("num_evals", type=int, nargs="?", default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    phys_forward.set_full_f32()
    cfg = load_config("rodent-full-clips")
    clips = synthesize_clips(phys_model.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=250,
                             device=args.device)
    env = workload.make_env(cfg, clips, device=args.device)

    net = cfg.network_config
    factory = functools.partial(
        ppo_networks.make_intention_ppo_networks,
        intention_latent_size=net.intention_size,
        encoder_hidden_layer_sizes=tuple(net.encoder_layer_sizes),
        decoder_hidden_layer_sizes=tuple(net.decoder_layer_sizes),
        value_hidden_layer_sizes=tuple(net.critic_layer_sizes),
    )

    history = []
    t0 = time.time()

    def progress(step, metrics):
        rew = metrics.get("eval/episode_reward")
        sps = metrics.get("training/sps", 0)
        history.append((step, float(rew) if rew is not None else None))
        print(
            f"[{time.time() - t0:7.1f}s] steps(k)={step} "
            f"eval/episode_reward={rew} training/sps={sps:,.0f}",
            flush=True,
        )

    make_policy, params, metrics = mlp_ppo.train(
        environment=env,
        num_timesteps=args.num_timesteps,
        episode_length=195,
        ckpt_mgr=None,
        config_dict={
            "network_config": {},
            "env_config": {"render_interval": 10_000},
        },
        num_envs=args.num_envs,
        num_eval_envs=128,
        learning_rate=1e-4,
        entropy_cost=1e-2,
        kl_weight=1e-1,
        discounting=0.98,
        seed=0,
        unroll_length=20,
        batch_size=256,
        num_minibatches=4,
        num_updates_per_batch=4,
        num_evals=args.num_evals,
        normalize_observations=True,
        clipping_epsilon=0.2,
        use_lstm=False,
        deterministic_eval=True,
        network_factory=factory,
        progress_fn=progress,
        device=args.device,
    )
    print("\nreward progression:")
    for step, rew in history:
        print(f"  steps(k)={step:>8} reward={rew}")
    first = next((r for _, r in history if r is not None), None)
    last = next((r for _, r in reversed(history) if r is not None), None)
    if first is not None:
        print(f"\nfirst={first:.2f} last={last:.2f} improvement={last - first:+.2f}")
    return history


if __name__ == "__main__":
    main()
