"""Decoder-only reuse in the torch port (the counterpart of
examples/03_decoder_playground.py): the frozen decoder of a checkpoint
(`make_decoder_policy_fn`) acting through `HighLevelWrapper`, whose actions
are latent intentions: random ones, N(0, 1), or with `--intentions policy`
the ones the checkpoint's whole policy records on the same states (its
`intention` activation), with which the decoder acts as the whole policy.

Usage: python examples/torch/03_decoder_playground.py <checkpoint_dir>
           [--steps 50] [--intentions random|policy] [--device cpu]
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.agent.mlp_ppo.ppo_networks import make_decoder_policy_fn
from track_mjx_tpu_torch.analysis import rollout as rollout_lib
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.physics import forward as phys_forward


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--intentions", choices=("random", "policy"), default="random")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    phys_forward.set_full_f32()
    cfg = checkpointing.load_config_from_checkpoint(args.checkpoint_dir)
    env = rollout_lib.create_environment(cfg, device=args.device)
    decoder_policy = make_decoder_policy_fn(args.checkpoint_dir, device=args.device)
    reference_obs_size = cfg["network_config"]["reference_obs_size"]
    intention_size = cfg["network_config"]["intention_size"]
    policy = None
    if args.intentions == "policy":
        policy = checkpointing.load_inference_fn(
            cfg, checkpointing.load_policy(args.checkpoint_dir, device=args.device), deterministic=True,
            get_activation=True, device=args.device,
        )

    hl_env = wrappers.HighLevelWrapper(
        wrappers.RenderRolloutWrapperMulticlipTracking(env), decoder_policy, reference_obs_size,
    )
    state = hl_env.reset(torch.Generator(device=args.device).manual_seed(0), 0)
    rng = torch.Generator(device=args.device).manual_seed(1)
    rewards = []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        if policy is None:
            z = torch.randn((1, intention_size), generator=rng, device=args.device)
        else:
            z = policy(state.obs, None)[1]["activations"]["intention"]
        state = hl_env.step(state, z)
        rewards.append(float(state.reward[0]))
    print(f"{args.steps} {args.intentions}-intention steps in {time.perf_counter() - t0:.1f} s; "
          f"mean reward: {np.mean(rewards):.4f}")


if __name__ == "__main__":
    main()
