"""Env check of the torch port (the counterpart of examples/01_env_rollout.py):
the rodent env from its config over synthetic clips, wrapped for training,
a batched rollout under uniform random actions, the termination counts
(fall, too_far, bad_pose, bad_quat, nan) and the reference frame index
from the reset to the last step.

Usage: python examples/torch/01_env_rollout.py [num_envs] [num_steps]
           [--device cpu] [--frames 250]
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config

TERMINATIONS = ("fall", "too_far", "bad_pose", "bad_quat", "nan")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("num_envs", type=int, nargs="?", default=8)
    ap.add_argument("num_steps", type=int, nargs="?", default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=250)
    args = ap.parse_args(argv)

    phys_forward.set_full_f32()
    cfg = load_config("rodent-full-clips")
    cfg.reference_config.clip_length = args.frames
    clips = synthesize_clips(phys_model.load_snapshot("rodent-full-clips"), n_clips=2,
                             n_frames=args.frames, mocap_hz=cfg.env_config.env_args.mocap_hz, device=args.device)
    env = workload.make_env(cfg, clips, device=args.device)
    wrapped = wrappers.wrap(env, episode_length=195)

    state = wrapped.reset(torch.Generator(device=args.device).manual_seed(0), args.num_envs)
    start = env._get_cur_frame(state.info, state.pipeline_state)
    print("reset qpos vs reference frame: max |err| =",
          float((state.pipeline_state.qpos[:, 2] - clips.position[0, 0, 2]).abs().max()))

    counts = dict.fromkeys(TERMINATIONS, 0.0)
    rng = torch.Generator(device=args.device).manual_seed(1)
    for _ in range(args.num_steps):
        action = 2 * torch.rand((args.num_envs, env.action_size), generator=rng, device=args.device) - 1
        state = wrapped.step(state, action)
        for key in counts:
            counts[key] += float(state.metrics[key].sum())
    print(f"after {args.num_steps} random steps x {args.num_envs} envs:")
    for key, v in counts.items():
        print(f"  {key}: {v:.0f} terminations")
    print("reference frame index at the reset:", start.tolist())
    print("reference frame index now:", env._get_cur_frame(state.info, state.pipeline_state).tolist())
    print("mean reward (final step):", float(state.reward.mean()))


if __name__ == "__main__":
    main()
