"""Stack smoke test of the torch port (the counterpart of
examples/00_smoke_test.py): torch and its CUDA devices, the kernel library
that ops/kernel_lib builds from csrc/ with nvcc, and one reset and one step
of the port's smallest tracking env, the stick walker on synthetic clips
(the JAX script's toy walker is compiled by MuJoCo, which the port does
without; nor does the port need GL: its renderer is numpy).

Usage: python examples/torch/00_smoke_test.py [--device cpu]

On the CPU nothing is built: every kernel wrapper runs its plain version
there.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from track_mjx_tpu_torch import workload
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.ops import cg_solver_kernel, kernel_lib
from track_mjx_tpu_torch.physics import forward as phys_forward
from track_mjx_tpu_torch.physics import model as phys_model
from track_mjx_tpu_torch.utils.config import load_config

CLIP_LENGTH = 60


def stick_config():
    """rodent-full-clips' env args and reward weights on the stick walker,
    its names from its snapshot (no workload config names the stick)."""
    snap = phys_model.load_snapshot("stick")
    cfg = load_config("rodent-full-clips")
    cfg.env_config.walker_name = "stick"
    cfg.walker_config = {
        "joint_names": [str(x) for x in snap.names.joint[1:]],
        "body_names": [str(x) for x in snap.names.body[2:]],
        "end_eff_names": [str(x) for x in snap.names.body if "claws" in str(x)],
        "torque_actuators": False,
        "rescale_factor": 1.0,
    }
    cfg.reference_config.clip_length = CLIP_LENGTH
    return cfg, snap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print("torch", torch.__version__, "cuda", torch.version.cuda)
    print("cuda devices:", [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())])
    if torch.device(args.device).type == "cuda":
        path, seconds, _ = kernel_lib.build_library()
        print(f"kernel library: {path} (built in {seconds:.1f} s; 0 when it was there)")
    else:
        print("kernel library: not built on the CPU (the wrappers run their plain versions)")

    phys_forward.set_full_f32()
    cfg, snap = stick_config()
    clips = synthesize_clips(snap, n_clips=2, n_frames=CLIP_LENGTH, mocap_hz=cfg.env_config.env_args.mocap_hz,
                             device=args.device)
    env = workload.make_env(cfg, clips, device=args.device)
    cg_solver_kernel.cg_solve.launches = 0
    state = env.reset(torch.Generator(device=args.device).manual_seed(0), 1)
    print("env reset OK; obs size:", state.obs.shape[-1])
    state = env.step(state, torch.zeros((1, env.action_size), device=args.device))
    print("env step OK; reward:", float(state.reward[0]))
    print("cg_solve launches (reset and one step):", cg_solver_kernel.cg_solve.launches)


if __name__ == "__main__":
    main()
