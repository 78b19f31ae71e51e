"""Checkpoint round trip of the torch port (the counterpart of
examples/02_rollout_from_checkpoint.py): load a checkpoint, rebuild the env
and the policy from its stored config, roll out one clip whole with the
policy's activations and the config's rollout metrics, and round-trip the
rollout through the HDF5 helpers (h5py must be installed: without it the
save raises an ImportError that says so).

The port's rollout is batch-first: `generate_rollout(torch.arange(n))`
rolls n clips as one env batch, every output [n, T, ...].

Usage: python examples/torch/02_rollout_from_checkpoint.py <checkpoint_dir>
           [clip_idx] [--out rollout.h5] [--device cpu]

e.g. over the checkpoint of `tools/long_run_torch.py --ckpt-dir DIR`.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from track_mjx_tpu_torch.agent import checkpointing
from track_mjx_tpu_torch.analysis import rollout as rollout_lib
from track_mjx_tpu_torch.analysis import utils as h5utils
from track_mjx_tpu_torch.physics import forward as phys_forward


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint_dir")
    ap.add_argument("clip_idx", type=int, nargs="?", default=0)
    ap.add_argument("--out", default="rollout.h5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    phys_forward.set_full_f32()
    out = checkpointing.load_checkpoint_for_eval(args.checkpoint_dir, device=args.device)
    cfg, policy = out["cfg"], out["policy"]
    env = rollout_lib.create_environment(cfg, device=args.device)
    inference_fn = checkpointing.load_inference_fn(cfg, policy, deterministic=True, get_activation=True,
                                                   device=args.device)
    use_lstm = cfg["train_setup"]["train_config"].get("use_lstm", False)
    generate_rollout = rollout_lib.create_rollout_generator(
        cfg, env, inference_fn, model="lstm" if use_lstm else "mlp", log_activations=True, log_metrics=True,
    )

    t0 = time.perf_counter()
    result = generate_rollout(args.clip_idx)
    seconds = time.perf_counter() - t0
    steps = result["qposes_rollout"].shape[0] - 1
    print("rollout keys:", sorted(result.keys()))
    print(f"qposes_rollout: {tuple(result['qposes_rollout'].shape)} ({steps} control steps in {seconds:.1f} s)")
    rewards = result["state_rewards"][1:]
    print(f"reward per step: mean {float(rewards.mean()):.4f}, min {float(rewards.min()):.4f}, "
          f"max {float(rewards.max()):.4f}")
    for name, v in sorted(result.get("rollout_metrics", {}).items()):
        print(f"  {name}: mean {float(v.float().mean()):.4f}")
    print("finite qpos:", bool(torch.isfinite(result["qposes_rollout"]).all()))

    h5utils.save_to_h5py(args.out, result)
    loaded = h5utils.load_from_h5py(args.out)
    print(f"{args.out} round-trip OK:", sorted(loaded.keys()))


if __name__ == "__main__":
    main()
