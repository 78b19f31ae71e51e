"""Smoke run of the torch port on one NVIDIA GPU: the physics control
steps, the rodent rollout, the trainer on the rodent (MLP and LSTM
pipelines) and on the fly, the rest of the physics (RK4 and implicit
integrators, condim-1/4/6 contacts, frictionloss and equality rows, on
pyramidal and on elliptic cones), the third workload config with the
trainer's options, the CLI's run management and per-eval logging, the
analysis of a trained checkpoint, data-parallel training over
torch.distributed, domain randomization of the Model's leaves, and the
learning-check tool (tools/long_run_torch.py).

Usage (from the repository root, on a machine with a CUDA device and nvcc):

    python3 chip_smoke.py

It imports nothing of JAX. Phases, each of which raises on failure:

1. Device: requires CUDA, prints the card's name and power limit as
   nvidia-smi reports them, builds csrc/cg_solve.cu, csrc/ell_cg_solve.cu
   and csrc/batched_linalg.cu for sm_90a, one nvcc call per source, all
   started together, then linked into one library.
2. Rodent kernel against plain: 4096 contact-rich rodent states (the main
   path's batch) made on the card with the port's forward stages go through
   the cg_solve kernel and its plain PyTorch version; each output's error is
   held to a bar. The kernel's registers, shared memory, resident CTAs per
   SM and waves at that batch are printed. Then both are timed on the same
   inputs with CUDA events.
3. Rodent main path: the rodent-full-clips snapshot, 4096 envs, 1 warm-up
   and 5 timed control steps of forward.n_step(..., 10). Every substep must
   launch cg_solve once (60 launches), the state must stay finite and
   contacts must be active. For 64 of those envs, the warm-up control step
   and one substep from the state after it are repeated on the CPU (plain
   version) from the same state and controls and compared.
4. Rodent rollout: the port's rollout of rodent-full-clips
   (track_mjx_tpu_torch/rollout.py): 8 synthetic clips of 250 frames made
   on the card, the tracking env with the exported config (CG 5/5, 10
   substeps, dt 0.002, mocap 50 Hz, traj_length 5, the reward weights),
   Episode (195 steps) and AutoReset wrappers, 4096 envs, and the
   intention policy and value networks at the config's widths (encoder
   [1024, 512 x 4], decoder [512 x 3, 256 x 2] + 2 x 38, critic
   [512 x 5, 256], intention 60) from seeded initializers behind the
   initial normalizer. Reset and one stochastic generate_unroll of
   unroll_length (20) steps must launch cg_solve exactly 1 + 20 x 10 times
   and the plain version never; every Transition field must be finite.
   Then ROLLOUT_TIMED more unrolls are timed (env-steps/s with the
   policy, median and spread, beside the physics-only figure of 3), the
   policy's forward at 4096 envs is timed with CUDA events, and for 64
   envs one env step from the state after the first unroll is repeated on
   the CPU: on the card's own physics output the env layer (obs, reward,
   the reward terms, flags) must agree with the CPU's to float32
   roundoff; the whole step, card and CPU float32, against a float64 CPU
   run. The policy's outputs on 64 observations are held against the CPU.
5. Fly kernel against plain: 4096 contact-rich fly states; at one
   iteration with one Newton step every output of ell_cg_solve is held to
   the JAX package's bars, at the workload's 4/4 the kernel is held by its
   optimality gap against a converged (60/15) plain solve. The kernel's
   registers, shared memory, resident CTAs per SM and waves are printed.
   Both are timed at 4/4.
6. Fly main path: the fly-mc-intention snapshot, 4096 envs, 1 warm-up and 3
   timed control steps; ell_cg_solve must launch once per substep (40
   launches), the state must stay finite and contacts must be active. For 64
   envs the warm-up control step and one substep after it are repeated on
   the CPU in float32 and in float64; the card must be as close to the
   float64 run as the CPU's float32 run is.
7. Rodent Newton main path: the rodent-full-clips snapshot with
   opt.solver = Newton, 4096 envs, 1 warm-up and 3 timed control steps;
   every substep must launch cholesky once, cho_solve once, solve_spd
   iterations + 1 times and cg_solve never, the state must stay finite and
   contacts active; 64 envs are compared with the CPU as in 3.
8. Rodent training: the port's trainer through its entry point,
   track_mjx_tpu_torch.train.main(load_config("rodent-full-clips", ...)),
   without its per-eval logging rollout (phase 13 runs that; so in 9-11c),
   at the config's widths and 4096 envs, cut in depth only (TRAIN_OVERRIDES:
   8 synthetic clips of 80 frames written to build/, episodes of 5 control
   steps (25 until phase 15 was added, 10 until phase 17), 4 minibatches of 1024 trajectories, one epoch of 2 training steps
   of one unroll each, 4 passes, one eval of 128 envs). cg_solve must launch
   exactly as often as the reset, the unrolls, the reset after the epoch and
   the eval need (the formula is printed), the plain version and the other
   kernels never; every loss metric and parameter must be finite, env_steps
   must follow the JAX package's formula, and the checkpoint, loaded back by
   CheckpointStore.for_eval and load_inference_fn, must act as the trained
   policy bit for bit. One learning half (the normalizer update and 4 passes
   over 4 minibatches) runs on the card and on the CPU from the state that
   the last training step's learning half started from, on 64 trajectories
   of its batch with the same permutations and noises; loss terms, the first
   minibatch's gradients and the parameters after it are held to bars. Training sps, eval sps and the
   host ms of rollout, normalizer update and SGD per training step come from
   the trainer's own metrics. Runs after phase 7, before phase 9.
9. Fly training: phase 8 on fly-mc-intention (the fly's tracking env, the
   intention networks at the config's widths: encoder [256, 256], decoder
   [256, 256] + 2 x 36, critic [256, 256], intention 60), with the same
   cuts (8 synthetic clips of 80 frames at 500 Hz, episodes of 10 control
   steps, one control step per frame); ell_cg_solve must launch exactly as
   the formula says and cg_solve, the plain version and the other kernels
   never; the same checks of losses, parameters, env_steps, checkpoint and
   learning half. Also, on N_CPU envs one env step from a reset: the env
   layer (obs, reward, the reward terms, flags) on the card's own physics
   output against the CPU's, as phase 4 holds the rodent's.
10. Rodent LSTM training: phase 8 with use_lstm (the LSTM pipeline:
   2 LSTM layers of 128, the JAX LSTM trainer's defaults, then a projection
   to 2 x 38; plain adam; the passes on the pre-update normalizer), the
   same cuts and checks; the stored rollout carry must be finite and
   [N_ENVS, 2, 128], the checkpoint's recurrent policy must act (and carry
   on) as the trained one from the same carry, and the learning half runs
   backpropagation through time over the unroll of 20.
11. The rest of the physics: the compact cg_solve without the Euler solve
   (with_euler=False, RK4 and implicit plans) against its plain version on
   phase 2's states (each output within KERNEL_REL, and bitwise phase 2's
   launch with the Euler solve) and on a second draw of 4096 contact-rich
   rodent states; cg_solve_dense (K2's dense-J mode) against its plain
   version, with and without the Euler solve, on 4096 contact-rich states
   of the rodent with mixed condims (mixed_condim: the floor at condim 1,
   the colliding body geoms at 1, 4 and 6 in turn), each output within
   KERNEL_REL; every one of them also against the plain version run in
   float64 (KERNEL_VS_F64, over the batch and per env). Both are timed by
   CUDA events beside the plain version and the bound, with
   cg_solve_dense's registers, shared memory, CTAs per SM, waves and the
   panels it walks J in. Then
   five rodent paths at 4096 envs, 1 warm-up and 1 timed control step each
   with exact launches per substep and no plain version run: RK4 (cg_solve
   without Euler, 4), implicitfast (cg_solve without Euler and solve_spd, 1
   each), implicit (cg_solve without Euler, 1), mixed condims
   (cg_solve_dense, 1; every condim active) and frictionloss on every hinge
   dof (cholesky 1, cho_solve 7, solve_spd 1; rows in both zones); and the
   equality probes exported by tools/export_torch_model.py --probes
   (connect, weld, joint, tendon, friction: cholesky 1, cho_solve 52,
   solve_spd 1 per substep) from test_equality's draws, one control step
   each. Each is held against the CPU on 64 envs as phase 3 is. The
   mixed-condim and frictionloss paths (F64_PATHS) are also held against
   float64 CPU runs on the worst and the median env, and the card's solve of
   its own rows against the CPU's solve of them within phase 3's substep
   bars, with the worst env taken apart; the frictionloss path's worst-env
   qpos after the control step is held by that float64 rule in place of
   phase 3's bar (QPOS_BY_F64). The env-steps/s of each is printed beside
   phase 3's.
11b. The fly's remainder (elliptic plans off the compact layout): the
   compact ell_cg_solve without the Euler solve on phase 5's states (at one
   iteration with one Newton step within FLY_KERNEL_REL and by the float64
   rule, its four outputs at 1/0 and 4/4 bitwise phase 5's launches with
   the Euler solve); ell_cg_solve_dense (K3's dense-J mode) on 4096
   contact-rich states of the fly with a condim-1 leg (fly_condim1: the
   floor and geom 79 at condim 1), with and without the Euler solve, at 1/0
   within FLY_KERNEL_REL and by the float64 rule, at 4/4 by the optimality
   gap; each timed beside its plain version and bound, with the dense
   mode's registers, shared memory, CTAs per SM, waves and the panels it
   walks J in. Then three fly paths at
   4096 envs, 1 warm-up and 1 timed control step each with exact launches
   per substep and no plain version run: condim 1 (ell_cg_solve_dense 1;
   condim-1 contacts active), RK4 (ell_cg_solve without Euler, 4) and
   frictionloss 0.01 on every hinge dof (the general elliptic CG: cholesky
   1, cho_solve 6, solve_spd 1; rows in both zones), each held against the
   CPU on 64 envs as phase 6 holds the fly, its env-steps/s printed beside
   phase 6's.
11c. rodent-sps-per-actor, the repo's third workload config (the rodent
   with position actuators at scale 0.8, CG 4/4, 5 substeps a control step,
   8192 envs, networks [512 x 3]): 8192 envs, 1 warm-up and 2 timed control
   steps with one cg_solve launch per substep and no plain version, 64 envs
   against the CPU as in 3 and env-steps/s beside phase 3's; cg_solve at
   B = 8192, 4/4 on the path's last states against its plain version
   within KERNEL_REL and by the float64 rule (on as many dropped states,
   phase 2's recipe, printed only), timed beside the plain version and the
   bound, with its registers, shared memory, CTAs per SM and waves; phase
   8's training through train.main at 8192 envs and full width (clips of
   80 frames, one epoch of 2 training steps, one eval of 10 control steps
   (20 until phase 16 was added); the learning half
   held against the CPU step by step); one epoch with freeze_decoder from
   its checkpoint (a new run, the decoder bitwise the checkpoint's, the
   encoder moved); one unroll of the rollout with the trained policy in
   bf16 (exact launches, float32 master parameters, actions within
   BF16_ACTION_MAX and BF16_ACTION_MEAN of the float32 policy's); one
   control step from the path's last state with geom_friction and
   dof_damping randomized per env (exact launches; one substep of 64 envs
   against the CPU on the same leaves within phase 3's substep bars; two
   envs that differ in friction only differ in qacc); the point-mass foreign
   env trained for one epoch through wrap_external. Its profile_dir check
   (a small train.main run whose trace must hold the rollout,
   normalizer_update and sgd scopes and the cg_solve kernel) runs after
   phase 12, when every rate has been taken.
12. Standalone linalg kernels against plain: from 4096 contact-rich states
   of the same model, made on the card with the port's stages, qM goes
   through cholesky, its factor and qfrc_smooth through cho_solve, the
   first Newton iteration's H (and Euler's M + h D) through solve_spd, each
   against its plain version, held to a bar, also on a ragged batch of
   4095 envs; each must give bitwise the same output when the strict upper
   triangle of its matrix (qM, or for cho_solve its factor) is NaN. The
   kernels' registers, shared memory and resident CTAs per SM are
   printed. Kernel, plain version and one library call are timed
   with CUDA events on the same inputs, beside the host's issue time per
   call and the kernel's device time from torch.profiler (the kernel's
   time where the host is the slower), its share of its bound and its
   ratio to the library call. This phase comes after every rate: it
   starts torch.profiler, which no host-clock rate should run after (only
   11c's profile_dir check follows it).
13. The CLI's run management and per-eval logging (runs after 11c, before
   12): train.main on rodent-full-clips at the config's widths, cut in
   depth (LOG_*: 4 synthetic clips of 15 frames, 256 envs, one training
   step of one unroll, 2 evals, a video every eval, SLURM_JOB_ID set). A
   first run stopped right after its first checkpoint (a BaseException
   raised once the checkpoint callback has updated the record, as a
   SIGTERM's SystemExit would) must leave its run-state record with
   latest_checkpoint_step 0; a second
   run of the same config must resume that run directory, keep the record
   while it runs, write step 1 and remove the record; cg_solve must launch
   exactly the trainer's count plus 1 + 20 x 10 for the logging rollout at
   B = 1; metrics.jsonl must hold eval/episode_reward, the latents/* keys
   and eval/rollout_pos_reward, and the video 20 non-constant frames of 512
   x 512 x 3 (clips of 15 frames: 30 before phase 14 was added, 20 before
   phase 16, cut to make room for them). Then the LSTM rodent's and the fly's logging rollouts, 5
   control steps each (10 until phase 16 was added) through collect_rollout (exact launches of cg_solve
   and ell_cg_solve at B = 1) and one frame rendered each; cg_solve and
   ell_cg_solve at B = 1 on those rollouts' last states against their plain
   versions (KERNEL_REL at the plan's 5/5, FLY_KERNEL_REL at 1/0, and the
   float64 rule), timed beside the plain version and the bound of one env.
   Prints ms per logging control step at B = 1 beside phase 4's rollout
   step, ms per rendered frame, and the phase's seconds.
14. Analysis from a checkpoint (runs after 13, before 12): phase 8's
   full-width rodent-full-clips checkpoint loaded by
   load_checkpoint_for_eval, its config pointed at ANALYSIS_CLIPS (256)
   synthetic clips of 20 frames (30 until phase 16 was added); create_environment, load_inference_fn
   with get_activation and create_rollout_generator's rollout of all 256
   clips as one batch (19 control steps) with every channel logged: the
   JAX tests' shapes, every channel finite on the envs that the NaN guard
   did not flag, a nonzero contact wrench wherever a contact penetrates,
   cg_solve launched exactly 1 + 19 x 10 times and no other kernel;
   cfrc_ext of the last step's Data on the card against the CPU's for 64
   envs within CFRC_REL. The LSTM rodent (phase 10's checkpoint) and the
   fly (phase 9's) the same way at 8 clips and 5 control steps (10 until
   phase 17 was added; cg_solve, ell_cg_solve, each exactly 1 + 5 x 10). On the rodent's analysis env:
   AutoAlignWrapperTracking for 10 control steps under 0.2 x U(-1, 1)
   controls (the envs that end done sit at their reference frame's qpos and
   qvel bit for bit, the others equal the unwrapped step bit for bit in
   every Data field and the obs; some must end done);
   EvalClipWrapperTracking's reset (frame 0 of each clip plus the qpos
   draw, qvel zero, bit for bit: the JAX wrapper's noise=False zeroes the
   qvel draw only); HighLevelWrapper driven by make_decoder_policy_fn(phase
   8's checkpoint) for 5 control steps, the latents the full policy's
   means, its action the full policy's bit for bit. Then the stick (its
   snapshot's names, rodent-full-clips' env args and widths, 64 clips of 10
   frames) for 5 control steps, the solve kernels' launches printed and
   held (RK4 from the stick's XML: cg_solve without its Euler solve, 4 a
   substep). Prints ms per analysis control step at B = 256 beside phase
   4's rollout step, cfrc_ext's ms a call and the phase's seconds.
15. Data-parallel training (runs after 14, before 12): train.main with
   distributed=true on rodent-full-clips at full width, cut in depth (DP_*:
   4 synthetic clips of 20 frames, 256 envs, one training step of one
   unroll of 2 steps at the config's 16 minibatches x 4 passes, one eval of
   1 control step). (a) One NCCL rank through the CLI, `python -m
   track_mjx_tpu_torch.train ... distributed=true` in a subprocess with
   RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, LOCAL_WORLD_SIZE=1, MASTER_ADDR
   127.0.0.1 and a free port: cg_solve's launches exact (its log's `kernel
   launches` line), its training sps and all-reduce ms per training step
   (metrics.jsonl) beside the same run in this process without
   distributed. (b) Two ranks on the one card over gloo (NCCL refuses two
   ranks on one device; gloo takes CUDA tensors for all_reduce and
   broadcast), 128 envs each, in subprocesses of this script (`--dp-rank`),
   against that one-process run of 256 envs on the same seed: each rank's
   first control step against the one-process run's slice (the state it
   started from, its actions, and the step redone from them within phase
   3's card bars; the states after it, which float32 chaos parts, printed);
   the ranks' learning half against one process's on the gathered batch
   and the same draws, with no env stepping between, step by step as
   phase 11c holds its own (loss terms and gradients at phase 8's bars, the
   parameters within what the gradients' difference moves them through one
   Adam step), the normalizer update within the float32 bound of two
   summation orders; the ranks' parameters bit for bit; each
   rank's cg_solve launches exact; a gradient-sized gloo all-reduce timed.
   Prints every run's training sps, the all-reduce ms per training step
   and the phase's seconds.
16. Domain randomization of the Model's leaves (runs after 15, before 12):
   a randomizer in the manner of MuJoCo Playground's locomotion randomizers
   (DR_SCALES: geom friction, dof frictionloss, armature and damping, body
   mass with inertia, body_ipos offsets, hinge qpos0 jitter, actuator gain),
   per env. The rodent at 4096 envs: cg_solve with its per-env armature
   against the plain version on contact-rich states of that model
   (KERNEL_REL and the float64 rule), how far each env's armature moves its
   qacc (the largest must pass the qacc bar), timed beside the plain
   version and the bound; then a reset (qpos at the shared qpos0 plus
   noise, as the env resets it from a clip) and 2 control steps with exact
   launches and no plain version, every state finite, and
   64 envs against the CPU on their own leaves at phase 3's bars. The fly
   (no offsets): ell_cg_solve with its per-env armature against the plain
   version at 1/0 (FLY_KERNEL_REL and the float64 rule), moved and timed
   alike, then one control step with exact launches and 64 envs against the
   CPU (the substep's solve outputs printed ungated, as in 11b). Then one
   MLP training step of the rodent at full width through ppo.train with the
   randomizer as its randomization_fn, cut in depth as phase 15's
   in-process run (256 envs, one unroll of 2, one eval of 1 control step):
   cg_solve's launches exact, every loss finite.
17. The learning-check tool (runs after 16, before 12):
   tools/long_run_torch.py's main, as a user runs it, at 4096 envs and full
   width with the JAX tool's settings, cut in depth only (LONG_RUN_*: one
   training step of one unroll of 20 steps, batch 256 x 16 minibatches, 1
   pass; 4 synthetic clips of 62 frames; 2 evals of 7 control steps,
   checkpointed with --ckpt-dir): one record per eval with the JAX tool's
   keys, every number finite; cg_solve's launches exact (reset + 20 x 10 +
   2 evals x (1 + 7 x 10), no other kernel, no plain version), the records'
   kernel_launches equal to the wrappers' counts; the last checkpoint loads
   for eval and its stored config rebuilds the run's env over its clips
   (analysis.rollout.create_environment). Prints the records and the
   phase's seconds.
18. Prints the seconds of each phase and the total, the kernels' JSON line
   (each kernel's launches on every path that runs it under
   "launches_by_path", phases 14's to 17's among them; cg_solve's
   and ell_cg_solve's B = 1 records under "b1", their per-env armature
   records under "per_env_armature") and, last, {"ok": true, "device":
   {...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
# train.main logs through the local stand-in of wandb: without a key the port
# does not import the real module, whose init would try to reach its servers
os.environ.pop("WANDB_API_KEY", None)
N_ENVS = 4096
N_CPU = 64
SUBSTEPS = 10
SEED = 0
# One NVIDIA H100 SXM (data sheet): HBM bytes/s and float32 (non-tensor-core)
# FLOP/s at the full 700 W; the least time a kernel could take is the larger
# of its bytes and its operations over these.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# --- rodent
RODENT_CONTROL_STEPS = 5  # timed, after one warm-up control step
# Controls are drawn from CTRL_SCALE * U(-1, 1). At full scale, U(-1, 1)
# drawn afresh each control step drives a share of rodents non-finite within
# a few control steps, in the JAX package as in the port (PERF.md): the
# torque actuators are strong for the light segments. This amplitude keeps
# every env finite over the run.
RODENT_CTRL_SCALE = 0.2
# Kernel against plain, relative to max(1, max |plain|): the bars of the
# JAX package's kernel parity test (tests/test_cg_kernel_parity.py).
KERNEL_REL = {
    "qacc_smooth": 5e-5,
    "qacc": 1e-4,
    "efc_force": 1e-3,
    "qfrc_constraint": 1e-3,
    "qacc_eff": 5e-4,
}
# Card against CPU over the warm-up control step (10 substeps from rest),
# per env relative to max(1, max |cpu|). The rodent under contact amplifies
# f32 roundoff across substeps, so the bar is on the median env for qvel
# and on the worst env for qpos (see PERF.md, "Open questions").
STEP_REL = {"qpos_max": 1e-2, "qvel_median": 1e-3}
# Card against CPU over one substep from the state after the warm-up control
# step, on the worst env, relative to max(1, max |cpu|) of that env. One
# substep is too short for the amplification above, so qacc and efc_force
# are held to the kernel's own bars. qacc_eff = (M + h D)^-1 (qfrc_smooth +
# qfrc_constraint) takes qfrc_constraint's roundoff through the inverse and
# carries its bar, 1e-3, as in the JAX package's fused Euler test; so does
# qvel = qvel + h qacc_eff.
SUBSTEP_REL = {"qacc": 1e-4, "qacc_eff": 1e-3, "efc_force": 1e-3, "qvel": 1e-3}

# --- fly
FLY_CONTROL_STEPS = 3  # timed, after one warm-up control step
# Actions go to the actuators as controls (ctrlrange +-10); a policy's
# actions lie in [-1, 1], and U(-1, 1) keeps every fly finite (PERF.md).
FLY_CTRL_SCALE = 1.0
# Kernel against plain at iterations=1, relative to max(1, max |plain|):
# the bars of the JAX package's elliptic one-iteration test
# (tests/test_cg_kernel_parity.py); qacc_eff carries qfrc_constraint's. The
# linesearch takes one Newton step (ls_iterations=0): with more, once Newton
# has converged to an ulp the sign of phi' is roundoff and the f32 bracket
# doubles, halves or refuses the step, on 5.5% of 512 envs between kernel
# and plain on an NVIDIA H100, and as often between the plain version in
# f32 and in f64 (PERF.md). The bracket is held at 4/4 by the optimality gap.
FLY_KERNEL_REL = {
    "qacc_smooth": 5e-5,
    "qacc": 2e-4,
    "efc_force": 1e-3,
    "qfrc_constraint": 1e-3,
    "qacc_eff": 1e-3,
}
# Card against CPU for the fly. The elliptic linesearch is a knife edge in
# f32: once Newton has converged to an ulp the sign of phi' is roundoff and
# the bracket doubles, halves or refuses the step, so f32 runs part by O(1)
# on single envs within a substep and on most envs within a control step
# (on the CPU, float32 against float64 over the warm-up control step of 64
# envs: median env qpos 3.5e-2, qvel 0.22; PERF.md). So the card and the
# CPU are both held against a float64 CPU run of the same envs, and the
# card's error must stay within FLY_VS_F64 times the CPU float32 run's (on
# the median env; on the worst env for qacc_smooth, which precedes the
# solve), plus FLY_F64_FLOOR.
FLY_VS_F64 = 3.0
FLY_F64_FLOOR = 1e-6
# The optimality-gap bound gap <= 2 gap_ref + 1e-3 |cost*| of the JAX
# package's objective test holds per env on its 6 states; over thousands of
# envs the same knife edge puts about 1% of the envs of either solve over
# the other's bound (on an NVIDIA H100 at 4/4 on 4096 states: 43 envs of the
# kernel over the plain version's bound, 28 the other way, summed gaps
# within 1.3%). The bound must hold on all but GAP_SHARE of the envs (at
# least one env may miss it), and the summed gap may exceed the reference's
# by at most GAP_SUM.
GAP_SHARE = 0.02
GAP_SUM = 1.1

# --- rodent rollout: the tracking env and the intention policy
ROLLOUT_CLIPS = 8
ROLLOUT_TIMED = 1  # timed unrolls after the first (counted) one (2 until phase 15 was added)
# The env layer on the card's own physics output, card against CPU, per env
# relative to max(1, max |cpu|): the same float32 formulas (gathers, sums
# in another order), about 1e-7 in the JAX package's parity tests.
ROLLOUT_LAYER_REL = 1e-5
# The whole env step from a rollout state. The untrained policy's actions
# are O(1), and a rodent driven so is chaotic in float32: one control step
# of float32 against float64 from the same state parts most envs' obs by
# tenths (this phase prints it), so the card is held against a float64 CPU
# run and must stay as close to it as the CPU's float32 run is: the card's
# median per-env error within ROLLOUT_VS_F64 times the CPU's, plus
# ROLLOUT_F64_FLOOR.
ROLLOUT_VS_F64 = 3.0
ROLLOUT_F64_FLOOR = 1e-6
# The policy and value networks, card against CPU on the same weights and
# observations, both in full float32 (TF32 off): sums of up to 1024 terms
# in another order; the port matched the JAX package to 2.0e-6 on the CPU.
POLICY_REL = 1e-5
REWARD_TERMS = ("pos_reward", "quat_reward", "joint_reward", "angvel_reward", "bodypos_reward",
                "endeff_reward", "ctrl_cost", "ctrl_diff_cost", "energy_cost", "var_cost", "jerk_cost")

# --- rodent training: the trainer through train.main, at full width
TRAIN_CLIPS = 8
TRAIN_CLIP_LENGTH = 80
# random_init_range 70 (the config's 50 until phase 15 was added, 65 until
# phase 17, cut to make room for them): episodes (and the eval's) of
# 80 - 70 - 5 = 5 control steps
TRAIN_RANDOM_INIT = 70
# The cuts are depth only: the config's widths and N_ENVS envs, batch_size
# 1024 (a minibatch is the reference's [1024, 20]); 4 minibatches (16 in the
# config) make one unroll per training step; num_timesteps = eval_every =
# reset_every = 163,840 make one epoch of 2 training steps and one eval.
TRAIN_OVERRIDES = [
    f"reference_config.clip_length={TRAIN_CLIP_LENGTH}",
    f"reference_config.random_init_range={TRAIN_RANDOM_INIT}",
    "train_setup.train_subset_ratio=null",
    "train_setup.eval_every=163840",
    "train_setup.reset_every=163840",
    "train_setup.train_config.num_timesteps=163840",
    f"train_setup.train_config.num_envs={N_ENVS}",
    "train_setup.train_config.num_minibatches=4",
]
# trajectories per minibatch of the last batch in the card-against-CPU
# learning half (64 at phases 8-10's 4 minibatches, 256 at phase 11c's 16)
TRAIN_CPU_MINIBATCH = 16
# each training path's config widths (encoder, decoder, critic, intention),
# asserted: the cuts are depth only
TRAIN_WIDTHS = {
    "rodent-full-clips": ([1024, 512, 512, 512, 512], [512, 512, 512, 256, 256], [512] * 5 + [256], 60),
    "fly-mc-intention": ([256, 256], [256, 256], [256, 256], 60),
    "rodent-sps-per-actor": ([512, 512, 512], [512, 512, 512], [512, 512, 512], 60),
}
# the rodent's LSTM pipeline at the JAX LSTM trainer's own carry widths
# (track_mjx_tpu/agent/lstm_ppo/ppo.py's defaults; no YAML sets them)
LSTM_CARRY = (2, 128)  # hidden_layer_num, hidden_state_size
LSTM_OVERRIDES = [
    "train_setup.train_config.use_lstm=true",
    f"network_config.hidden_layer_num={LSTM_CARRY[0]}",
    f"network_config.hidden_state_size={LSTM_CARRY[1]}",
]
# Card against CPU over one learning half (4 passes x 4 minibatches of 16
# trajectories x 20 steps), both in full float32 from the same state: the
# networks' sums (up to 1024 terms) and the loss's means run in another
# order. Loss terms relative to max(1, |cpu|); the first minibatch's
# gradients relative to each tensor's largest element; parameters in units
# of the learning rate, since Adam moves each parameter by about lr per
# step whatever the gradient's size; the normalizer's Welford sums.
# Measured on an NVIDIA H100: 1.2e-6, 1.1e-5, 1.2e-3 lr and 1.1e-9; the
# bars leave 8-90x.
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_PARAM_LR = 1e-2
TRAIN_NORM_REL = 1e-7

# --- rodent under the Newton solver: the standalone linalg kernels
NEWTON_CONTROL_STEPS = 3  # timed, after one warm-up control step
# Each standalone kernel against its plain version on the path's own
# matrices, relative to max(1, max |plain|). The arithmetic is the same
# (csrc/cholesky.cuh and ops/batched_linalg.py step for step); only FMA
# contraction and rsqrtf differ, about an ulp per operation. Measured on an
# NVIDIA H100 on these 4096 states: L 1.0e-8 (its entries are under 1),
# cho_solve 5.7e-7 and solve_spd 3.7e-7 on M + h D (cond(qM) about 6e5
# carries the factor's roundoff into the solution), solve_spd 6.7e-6 on the
# Newton H, whose J^T D J term adds the stiff active rows. The bars leave
# 7-10x.
LINALG_REL = {"cholesky": 1e-7, "cho_solve": 5e-6, "solve_spd": 5e-5}
RAGGED = N_ENVS - 1  # a batch that is no multiple of anything: the kernels take any
# Card against CPU on the Newton path, per env relative to max(1, max
# |cpu|). Unlike CG's five inexact iterations, exact-Hessian Newton
# converges within its 5 iterations, so each substep lands on the optimum up
# to f32 roundoff and that roundoff does not grow through the linesearch's
# choices: over the warm-up control step the worst env's qpos and the
# median env's qvel differed by 1.2e-7 and 2.6e-7 on an NVIDIA H100, about
# 1e4 times less than the CG path's bars allow. The bars leave about 40x.
NEWTON_STEP_REL = {"qpos_max": 5e-6, "qvel_median": 1e-5}
# One substep from the state after the warm-up control step, worst env:
# qacc_smooth (the cho_solve on qM's factor) up to 6.1e-6 and qacc up to
# 9.6e-6 take cond(qM)'s amplification, efc_force 1.2e-6 and qvel 1.0e-6
# (through the Euler solve_spd) less, in two runs on an NVIDIA H100; the
# bars leave 5-10x.
NEWTON_SUBSTEP_REL = {"qacc_smooth": 5e-5, "qacc": 5e-5, "efc_force": 1e-5, "qvel": 1e-5}
# --- the rest of the physics (phase 11): the rodent on RK4, implicitfast and
# implicit, with mixed condims and with frictionloss; the equality probes
REST_CONTROL_STEPS = 1  # timed, after one warm-up control step (held against the CPU)
# The RK4 path's timestep. RK4 is explicit: at the workload's 0.002 the
# rodent's lightly armatured, damped joints are past its stability limit,
# and MuJoCo C's RK4 diverges within 4 steps (qvel 4.2, 331, 2,170, 3.3e8 from
# qpos0 with 0.2 x U(-1, 1) controls; it then warns and resets). At 1e-3 it
# still diverges, at 5e-4 it holds (6 control steps, 2 seeds); the path runs
# at half that. Its 3 control steps then last 7.5 ms of simulated time, too
# short for the rodent at qpos0 to fall onto the floor, so it starts with
# the root RK4_DROP lower (the feet in contact).
RK4_TIMESTEP = 2.5e-4
RK4_DROP = 0.01
# dof_frictionloss on every hinge dof of the frictionloss variant, chosen so
# that the timed states hold rows in both zones (clamped at +-frictionloss,
# and quadratic); the phase prints both shares and requires both.
FRICTIONLOSS = 0.01
PROBES = ("connect", "weld", "joint", "tendon", "friction")
# The paths are held against the CPU as phase 3 holds the rodent (STEP_REL
# over the warm-up control step; SUBSTEP_REL over one substep after it, its
# qacc_eff only where the fused solve produces it: Euler plans). The paths
# with rows off the compact layout (F64_PATHS) are also held against float64
# CPU runs of the control step and of the substep, the card within
# FLY_VS_F64 times the float32 CPU's distance on the worst and on the median
# env, and the card's solve of its own rows against the CPU's solve of the
# same rows within SUBSTEP_REL, with the worst env taken apart (its rows'
# split, its solve's split on the same rows, the float64 solves of both row
# sets). One bar is replaced (QPOS_BY_F64): the frictionloss path's qpos on
# the worst env after the control step, which the float32 CPU run itself
# misses by its distance to float64 (on an NVIDIA H100: 9.4e-3 against the
# 1e-2 bar on its worst env, qvel 0.38; card and CPU after one substep from
# the same state at most 9.2e-6 apart in qacc; PERF.md §6). It is held by
# the float64 rule on the worst and the median env.
F64_PATHS = ("rodent mixed condims", "rodent frictionloss")
QPOS_BY_F64 = ("rodent frictionloss",)
REST_SUBSTEP_REL = {k: v for k, v in SUBSTEP_REL.items() if k != "qacc_eff"}
# cg_solve_dense and the no-Euler cg_solve against their plain versions:
# each output within KERNEL_REL (the no-Euler cg_solve on phase 2's states,
# where its four outputs must be bitwise those of phase 2's launch with the
# Euler solve; cg_solve_dense on states of the rodent with mixed condims).
# Also held, on those states and on a second draw of 4096 rodent states
# (where two float32 CG solves can part by more than KERNEL_REL: on an
# NVIDIA H100 the compact cg_solve's qacc sat 1.36e-4 from its plain
# version's on one such draw, bar 1e-4), against the plain version run in
# float64: per env, relative to max(1, max |float64|) of that env, the
# kernel's worst env within KERNEL_VS_F64 times the float32 plain version's
# worst env, plus KERNEL_F64_FLOOR, and so its median env.
KERNEL_VS_F64 = 3.0
KERNEL_F64_FLOOR = 1e-6

# --- rodent-sps-per-actor (phase 11c): the repo's third workload config, the
# rodent with position actuators at scale 0.8, CG 4/4, 5 substeps a control
# step, 8192 envs, networks [512 x 3] (its published widths and env count)
SPS_CONFIG = "rodent-sps-per-actor"
SPS_CONTROL_STEPS = 2  # timed, after one warm-up control step
# training cut in depth only, as phase 8: clips of 80 frames (episodes of
# 5 frames, 10 control steps: random_init_range 70, 65 until phase 16 was
# added, cut to make room for it), num_timesteps = eval_every = 655,360: one
# epoch of 2 training steps of 16 x 1024 / 8192 = 2 unrolls each (the
# learning half held against the CPU is the second's: the first, from a fresh
# Adam state, moves parameters by up to lr on roundoff), then one eval (the
# config's reset_every, 50M, leaves eval_every // reset_every = 0: no reset
# between evals); the decoder-transfer run, one training step and an eval of
# 10 control steps
SPS_CUTS = [
    f"reference_config.clip_length={TRAIN_CLIP_LENGTH}",
    "reference_config.random_init_range=70",
    "train_setup.eval_every=655360",
    "train_setup.train_config.num_timesteps=655360",
]
SPS_FREEZE_CUTS = [
    f"reference_config.clip_length={TRAIN_CLIP_LENGTH}",
    "reference_config.random_init_range=70",  # episodes of (80 - 70 - 5) x 2 = 10 control steps
    "train_setup.eval_every=327680",
    "train_setup.train_config.num_timesteps=327680",
]
# the bf16 rollout policy against the float32 one on the same observations
# and noise, in actions (tanh-squashed, in [-1, 1]): bf16 keeps 8
# significant bits; on the CPU at these widths, over 2048 envs x 38 actions,
# the worst differed by 0.034 and the mean by 0.0025
BF16_ACTION_MAX = 0.15
BF16_ACTION_MEAN = 0.01
# per-env randomization: every geom's friction and every dof's damping
# times U(0.5, 1.5) (a contact takes its higher-priority geom's friction,
# else the larger of the two: 16 of the rodent's geoms outrank the floor)
SPS_RANDOM_SCALE = (0.5, 1.5)
# the point-mass foreign env of phase 11c: one epoch of one training step
SPS_FOREIGN_ENVS = 1024

# --- phase 13: the CLI's run management and per-eval logging
# Clips of LOG_CLIP_LENGTH frames make a logging rollout of that many control
# steps (the rodent: one per frame) and evals of 15 - 5 - 5 = 5. LOG_ENVS
# envs, batch_size LOG_ENVS and 1 minibatch make a training step one unroll
# of 20; num_timesteps = 2 x eval_every = 20 x LOG_ENVS make 2 evals (the
# initial one and one after one training step), a logging rollout and a
# video after the second.
LOG_CLIP_LENGTH = 15  # 30 before phase 14 was added, 20 before phase 16, cut to make room for them
LOG_ENVS = 256
LOG_EVAL_ENVS = 128
LOG_CLIPS = 4
LOG_JOB = "chip_smoke_13"  # SLURM_JOB_ID: the second run finds the first one's record
LOG_OTHER_STEPS = 5  # the LSTM and fly logging rollouts' control steps (10 until phase 16 was added)
LOG_FRAME = (512, 512)  # the JAX make_rollout_renderer's


def log_overrides(device: str, root: str) -> list:
    return [
        f"device={device}",
        f"data_path={os.path.join(root, 'clips.npz')}",
        f"logging_config.model_path={os.path.join(root, 'ckpts')}",
        f"reference_config.clip_length={LOG_CLIP_LENGTH}",
        "reference_config.random_init_range=5",
        "train_setup.train_subset_ratio=null",
        f"train_setup.eval_every={10 * LOG_ENVS}",
        f"train_setup.reset_every={10 * LOG_ENVS}",
        f"train_setup.train_config.num_timesteps={20 * LOG_ENVS}",
        f"train_setup.train_config.num_envs={LOG_ENVS}",
        f"train_setup.train_config.batch_size={LOG_ENVS}",
        "train_setup.train_config.num_minibatches=1",
        f"train_setup.train_config.num_eval_envs={LOG_EVAL_ENVS}",
        "env_config.render_interval=1",
    ]


class Preempted(BaseException):
    """Stops phase 13's first run right after its first checkpoint and its
    record's update, as the SystemExit of a SIGTERM would: no `except
    Exception` of the trainer catches it."""


# --- phase 14: analysis from a checkpoint
# The analysis rollout: ANALYSIS_CLIPS synthetic clips of ANALYSIS_FRAMES
# frames, one env each, ANALYSIS_FRAMES - 1 control steps (the rodent: one
# per frame). The LSTM rodent's and the fly's at ANALYSIS_OTHER_CLIPS clips
# and ANALYSIS_OTHER_STEPS control steps, the wrappers on the rodent's
# analysis env, the stick at STICK_CLIPS clips of STICK_FRAMES frames.
ANALYSIS_CLIPS = 256
ANALYSIS_FRAMES = 20  # 30 until phase 16 was added, cut to make room for it
ANALYSIS_OTHER_CLIPS = 8
ANALYSIS_OTHER_STEPS = 5  # 10 until phase 17 was added, cut to make room for it
ANALYSIS_CPU = 64  # envs whose cfrc_ext is held against the CPU's
CFRC_REL = 1e-5  # cfrc_ext, card against CPU on the same Data: float32 roundoff of products and sums
ALIGN_STEPS = 10
HIGH_LEVEL_STEPS = 5
STICK_CLIPS = 64
STICK_FRAMES = 10
STICK_STEPS = 5

# --- phase 15: data-parallel training through train.main's distributed key
# rodent-full-clips at full width, DP_CLIPS synthetic clips of DP_CLIP_LENGTH
# frames, DP_ENVS envs, one training step of one unroll of DP_UNROLL steps at
# the config's 16 minibatches x 4 passes (batch_size DP_ENVS / 16), then one
# eval of 1 control step (random_init_range 14: 20 - 14 - 5) and a reset.
DP_ENVS = 256
DP_CLIPS = 4
DP_CLIP_LENGTH = 20
DP_RANDOM_INIT = 14
DP_UNROLL = 2
DP_RANKS = 2  # the gloo run's ranks, sharing the one card
DP_TIMEOUT_S = 300  # each subprocess's limit
# The learning half of the gloo ranks against one process's on the same
# global batch and draws, step by step (as phase 11c's): before each
# gradient step one process takes the ranks' parameters, Adam state and
# normalizer; the step's loss terms and clipped gradients are held to phase
# 8's card-against-CPU bars (TRAIN_LOSS_REL, TRAIN_GRAD_REL): the same
# float32 math, its sums in another order and its matmuls at other batch
# sizes (a rank's rows of a minibatch, its share of each mean, then the sum
# over the ranks). The parameters after a step are held to what the
# gradients' largest difference can move them through one Adam step from
# one state: where a gradient element is below Adam's eps its update is
# about lr g / eps, so a difference of 1e-9 in it moves the parameter by
# 0.1 lr (1.7e-1 lr measured, past phase 8's 1e-2 lr). The normalizer
# update is held within the float32 bound of its sums in two orders
# (`normalizer_order_bound`): its first update from zero subtracts nearly
# equal sums on observation dims that barely vary over the batch.
ADAM_B1, ADAM_EPS = 0.9, 1e-8  # agent/gradients.make_optimizer's
# A rank's first actions against the one-process run's, the same inputs:
# the full-width policy's float32 forward at 128 rows against 256 (cuBLAS
# picks its kernels by the batch size), relative to max(1, |a|); measured
# 9.6e-6 and 6.8e-6 on the two ranks (NVIDIA H100 80GB HBM3, 700.00 W).
DP_ACTION_REL = 1e-4
DP_EXTRA: list = []  # more overrides (none: the cuts above are depth only)
DP_ALLREDUCE_REPS = 5  # all-reduces of a gradient-sized buffer timed on the gloo ranks


# --- phase 16: domain randomization of the Model's leaves
# A randomizer in the manner of MuJoCo Playground's locomotion randomizers
# (its Go1 randomize.py), per env: every geom's friction x U(0.6, 1.4) (one
# factor an env), dof_frictionloss x U(0.9, 1.1), dof_armature x U(1.0,
# 1.05), body_mass x U(0.9, 1.1) with body_inertia scaled alike, body_ipos
# offsets up to DR_IPOS, hinge qpos0 jitter +-DR_QPOS0 rad, dof_damping x
# U(0.8, 1.2), actuator_gainprm[:, 0] x U(0.9, 1.1). The rodent's
# frictionloss is zero, so its plan has no frictionloss rows and the leaf
# stays zero. The fly (K3's path) takes the same scales without the ipos
# offsets and the qpos0 jitter (its lengths are in cm, its body 0.3 cm).
DR_SCALES = {"geom_friction": (0.6, 1.4), "dof_frictionloss": (0.9, 1.1), "dof_armature": (1.0, 1.05),
             "body_mass": (0.9, 1.1), "dof_damping": (0.8, 1.2), "actuator_gainprm": (0.9, 1.1)}
DR_IPOS = 1e-3  # m, the rodent's
DR_QPOS0 = 0.05
DR_CONTROL_STEPS = 1  # timed, after one warm-up control step from the reset

# --- phase 17: the learning-check tool, tools/long_run_torch.py, at
# N_ENVS envs and full width, cut in depth only: one training step of one
# unroll of the config's 20 steps (batch 256 x the reference's 16 minibatches
# = N_ENVS trajectories, 1 pass), 4 clips of LONG_RUN_CLIP_LENGTH frames,
# so evals of 62 - 50 - 5 = 7 control steps, and 2 evals (the initial one
# and one after the epoch), each checkpointed.
LONG_RUN_CLIP_LENGTH = 62
LONG_RUN_BATCH = 256
LONG_RUN_ARGS = ["--num-envs", str(N_ENVS), "--num-evals", "2", "--batch-size", str(LONG_RUN_BATCH),
                 "--num-minibatches", "16", "--updates-per-batch", "1",
                 "--clip-length", str(LONG_RUN_CLIP_LENGTH),
                 "--num-timesteps", str(LONG_RUN_BATCH * 20 * 16)]


def dp_overrides(device: str, root: str) -> list:
    step = DP_ENVS * DP_UNROLL  # env steps of one training step
    return [
        f"device={device}",
        f"data_path={os.path.join(os.path.dirname(root), 'clips.npz')}",
        f"logging_config.model_path={os.path.join(root, 'ckpts')}",
        f"reference_config.clip_length={DP_CLIP_LENGTH}",
        f"reference_config.random_init_range={DP_RANDOM_INIT}",
        "train_setup.train_subset_ratio=null",
        f"train_setup.eval_every={step}",
        f"train_setup.reset_every={step}",
        f"train_setup.train_config.num_timesteps={step}",
        f"train_setup.train_config.num_envs={DP_ENVS}",
        f"train_setup.train_config.batch_size={DP_ENVS // 16}",
        f"train_setup.train_config.unroll_length={DP_UNROLL}",
        "env_config.render_interval=2",  # no video at the one eval
        *DP_EXTRA,
    ]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_env(rank: int, world: int, local_world: int, port: int) -> dict:
    """The launcher's variables of a rank on this host (as torchrun sets them)."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                PYTHONPATH=REPO)


def first_step_recorder(recorded: dict, gate: str = None):
    """workload.make_env with the env wrapped to keep its first step (the
    training rollout's first control step: no initial eval runs at one
    eval): the state it started from and its actions, and the qpos and qvel
    after it, on the CPU, and the unwrapped env under "env". With `gate`
    the first step waits until that file exists: train.main has set up."""
    from track_mjx_tpu_torch import workload
    from track_mjx_tpu_torch.envs.base import Wrapper, map_tensors

    make_env = workload.make_env

    class FirstStep(Wrapper):
        def step(self, state, action):
            t0 = time.perf_counter()
            while gate is not None and "qpos" not in recorded and not os.path.exists(gate):
                time.sleep(0.05)
            recorded.setdefault("wait_s", time.perf_counter() - t0)
            nstate = self.env.step(state, action)
            if "qpos" not in recorded:
                recorded.update(state=map_tensors(lambda x: x.cpu(), state), action=action.cpu(),
                                qpos=nstate.pipeline_state.qpos.cpu(), qvel=nstate.pipeline_state.qvel.cpu())
            return nstate

    def recording(*args, **kwargs):
        recorded["env"] = make_env(*args, **kwargs)
        return FirstStep(recorded["env"])

    workload.make_env = recording
    return make_env


def normalizer_order_bound(batch: torch.Tensor, old, new) -> tuple:
    """Per observation dim, the largest difference that float32 sums of
    the Welford update (agent/running_statistics.update) in two orders can
    make from one state `old` over `batch` [..., dims], `new` being either
    result: each of two sums of n terms within (n - 1) u sum |terms| of the
    exact one (u = 2^-24), the mean's error carried into the summed
    variance's second factor. Returns (mean bound, summed variance bound)."""
    x = batch.reshape(-1, batch.shape[-1]).double()
    n, u = x.shape[0], 2.0**-24
    dev_old = (x - old.mean.double()).abs()
    mean = 2 * (n - 1) * u * dev_old.sum(0) / n + 2 * u * new.mean.double().abs()
    summed = 2 * (n - 1) * u * (dev_old * (x - new.mean.double()).abs()).sum(0) + dev_old.sum(0) * mean
    return mean, summed


def dp_learning_halves(mesh, state, data, make_learner, tc) -> dict:
    """Inside a data-parallel training step, before its learning half: the
    global batch gathered from the ranks; a gradient-sized all-reduce,
    timed; the ranks' normalizer update against one process's on the
    global batch (within `normalizer_order_bound`); then the ranks' learning
    half over copies of the networks with seeded global draws, step by step
    against one process's (rank 0), which before each gradient step takes
    the ranks' parameters and Adam state and the ranks' normalizer, as phase
    11c holds its learning half. Returns rank 0's worst distances
    (parameters in units of the learning rate of `tc`, the train_config)
    and the collectives this check ran."""
    import copy

    from track_mjx_tpu_torch.agent import running_statistics
    from track_mjx_tpu_torch.envs.base import map_tensors
    from track_mjx_tpu_torch.parallel import mesh as mesh_lib

    check_t0 = time.perf_counter()
    collectives = (mesh.collective_s, mesh.collective_calls, mesh.collective_bytes)
    num_envs = tc.num_envs
    assert data.observation.shape[0] == num_envs // mesh.world_size, "one unroll a step: a rank's rows are its envs"
    leaves = []
    map_tensors(lambda x: leaves.append(x) or x, data)
    gathered = iter(mesh_lib.gather_batch(leaves, mesh))
    global_data = map_tensors(lambda x: next(gathered), data)

    dev = data.observation.device
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    m, passes, t, lr = tc.num_minibatches, tc.num_updates_per_batch, data.observation.shape[1], tc.learning_rate
    per, lat = num_envs // m, data.extras["policy_extras"]["latent_mean"].shape[-1]
    perms = [torch.randperm(num_envs, generator=g, device=dev) for _ in range(passes)]
    noises = [[(torch.randn((t, per, lat), generator=g, device=dev),
                torch.randn((t, per, data.action.shape[-1]), generator=g, device=dev)) for _ in range(m)]
              for _ in range(passes)]

    n_params = sum(p.numel() for net in (state.networks.policy_network, state.networks.value_network)
                   for p in net.parameters())
    grads = torch.zeros(n_params, device=dev)
    mesh_lib.all_reduce_sum([grads], mesh)  # warm-up
    t0 = mesh.collective_s
    for _ in range(DP_ALLREDUCE_REPS):
        mesh_lib.all_reduce_sum([grads], mesh)
    grad_ms = 1e3 * (mesh.collective_s - t0) / DP_ALLREDUCE_REPS

    normalizer = running_statistics.update(state.normalizer_params, data.observation, group=mesh)
    sides = {"dp": copy.deepcopy(state.networks)}
    learners = {"dp": make_learner(sides["dp"])}
    worst = {"loss": 0.0, "grad": 0.0, "param": 0.0, "param_bound": 0.0, "mean": 0.0, "summed_variance": 0.0}
    if mesh.rank == 0:
        one = running_statistics.update(state.normalizer_params, global_data.observation)
        bounds = normalizer_order_bound(global_data.observation, state.normalizer_params, one)
        for name, bound in zip(("mean", "summed_variance"), bounds):
            diff = (getattr(normalizer, name).double() - getattr(one, name).double()).abs()
            worst[name] = float((diff / bound.clamp(min=1e-300)).max())
        sides["one"] = copy.deepcopy(state.networks)
        learners["one"] = make_learner(sides["one"], one_process=True)
    t0 = time.perf_counter()
    for u in range(passes):
        minibatches = {"dp": learners["dp"]._minibatches(data, perms[u], None, noises[u])}
        if mesh.rank == 0:
            minibatches["one"] = learners["one"]._minibatches(global_data, perms[u], None, noises[u])
        for _ in range(m):
            if mesh.rank == 0:  # one process starts from the ranks' parameters and Adam state
                for a, b in ((sides["one"].policy_network, sides["dp"].policy_network),
                             (sides["one"].value_network, sides["dp"].value_network)):
                    a.load_state_dict(b.state_dict())
                learners["one"].optimizer.load_state_dict(copy.deepcopy(learners["dp"].optimizer.state_dict()))
            step = {}
            for k, learner in learners.items():
                mb, latent, entropy, kwargs = next(minibatches[k])
                _, aux = learner.update_fn(normalizer, mb, latent, entropy, 1, **kwargs)
                nets = sides[k]
                params = [p for net in (nets.policy_network, nets.value_network) for p in net.parameters()]
                step[k] = ({name: float(aux[name]) for name in ("total_loss", "policy_loss", "v_loss",
                                                                  "kl_latent_loss", "entropy_loss")},
                           [p.grad.detach().clone() for p in params], [p.detach().clone() for p in params])
            if mesh.rank == 0:
                (a_m, a_g, a_p), (b_m, b_g, b_p) = step["dp"], step["one"]
                worst["loss"] = max(worst["loss"], max(abs(a_m[k] - b_m[k]) / max(1.0, abs(b_m[k])) for k in b_m))
                worst["grad"] = max(worst["grad"], max(float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                                                       for x, y in zip(a_g, b_g)))
                moved = max(float((x - y).abs().max()) for x, y in zip(a_p, b_p))
                worst["param"] = max(worst["param"], moved / lr)
                # Adam from one state: d(update)/dg <= lr (1 - b1) / ((1 - b1^k) eps), once through m and
                # once through v, so the gradients' largest difference bounds the parameters'
                k = float(next(iter(learners["dp"].optimizer.state.values()))["step"])
                grad_diff = max(float((x - y).abs().max()) for x, y in zip(a_g, b_g))
                bound = 2 * lr * (1 - ADAM_B1) / (1 - ADAM_B1**k) * grad_diff / ADAM_EPS
                worst["param_bound"] = max(worst["param_bound"], moved / max(bound, 1e-30))
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    dp_s = time.perf_counter() - t0
    params = [p for net in (sides["dp"].policy_network, sides["dp"].value_network) for p in net.parameters()]
    normalizer_fields = [getattr(normalizer, f) for f in ("count", "mean", "summed_variance", "std")]
    mesh_lib.assert_is_replicated(params + normalizer_fields, mesh, debug="the ranks' learning-half copies")
    return {**worst, "dp_s": dp_s, "grad_allreduce_ms": grad_ms, "n_params": n_params, "steps": passes * m,
            "check_s": time.perf_counter() - check_t0,
            "ms": 1e3 * (mesh.collective_s - collectives[0]), "calls": mesh.collective_calls - collectives[1],
            "mb": 1e-6 * (mesh.collective_bytes - collectives[2])}  # this check's collectives


def dp_rank_main(rank: int, root: str, device: str) -> None:
    """One gloo rank of phase 15(b) (`python3 chip_smoke.py --dp-rank RANK
    ROOT DEVICE`, the launcher's variables set by the parent, at the lowest
    CPU priority: it sets up while the parent's runs are timed): joins the
    group, runs train.main with distributed=true (the overrides in
    ROOT/gloo.json) on its slice of the envs, its first control step
    waiting for ROOT/go, and saves what the parent checks to
    ROOT/rank<RANK>.pt."""
    sys.path.insert(0, REPO)
    from track_mjx_tpu_torch import train as ttrain
    from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
    from track_mjx_tpu_torch.parallel import mesh as mesh_lib
    from track_mjx_tpu_torch.physics import forward as tf
    from track_mjx_tpu_torch.utils.config import load_config

    os.nice(19)
    tf.set_full_f32()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // DP_RANKS))  # the ranks share the host's cores
    mesh = mesh_lib.init_from_env(device, backend="gloo")
    with open(os.path.join(root, "gloo.json")) as f:
        cfg = load_config("rodent-full-clips", json.load(f))
    recorded, captured, progress = {}, {}, []
    first_step_recorder(recorded, gate=os.path.join(root, "go"))
    tc = cfg.train_setup.train_config
    tk.cg_solve.launches = 0
    _, (normalizer, policy) = ttrain.main(
        cfg, mesh=mesh, policy_params_fn=no_logging, progress_fn=lambda s, m: progress.append(m),
        batch_callback=lambda st, d, ml: captured.update(dp_learning_halves(mesh, st, d, ml, tc)),
    )
    torch.cuda.synchronize() if device == "cuda" else None
    seconds = time.time() - os.path.getmtime(os.path.join(root, "go"))  # since go
    recorded.pop("env")
    torch.save({"first_step": recorded, "captured": captured, "progress": progress, "policy": policy,
                "normalizer": normalizer, "launches": ttrain.kernel_launches(), "seconds": seconds,
                "device": str(mesh.device), "collectives": (mesh.collective_s, mesh.collective_calls,
                                                           mesh.collective_bytes)},
               os.path.join(root, f"rank{rank}.pt"))
    mesh_lib.destroy(mesh)


REPLACES = {  # the TPU kernel bodies, track_mjx_tpu/ops/batched_linalg.py
    "cholesky": "track_mjx_tpu/ops/batched_linalg.py:86",
    "cho_solve": "track_mjx_tpu/ops/batched_linalg.py:248",
    "solve_spd": "track_mjx_tpu/ops/batched_linalg.py:263",
}


def mixed_condim(snap):
    """The rodent snapshot `snap` (load_snapshot) with the floor at condim 1
    and the colliding body geoms at condim 1, 4 and 6 in turn by geom id:
    its contact slots mix all three (a contact takes the larger condim of
    its two geoms), and its rows leave the compact layout for the dense J.
    Edits and returns `snap`."""
    from track_mjx_tpu_torch.physics import model as tm

    plan, _ = tm.put_model(snap, device="cpu")
    geoms = sorted({int(g) for _, _, g1, g2 in plan.pair_groups for g in (*g1, *g2)})
    condim = np.array(snap.geom_condim).copy()
    body = [g for g in geoms if snap.geom_type[g] != tm.GEOM_PLANE]
    condim[[g for g in geoms if snap.geom_type[g] == tm.GEOM_PLANE]] = 1
    for i, g in enumerate(body):
        condim[g] = (1, 4, 6)[i % 3]
    snap.geom_condim = condim
    return snap


def fly_condim1(snap):
    """The fly snapshot `snap` with the floor and geom 79 (a leg capsule, body
    28) at condim 1: that leg's floor contacts are condim-1 rows beside the
    other contacts' cone blocks (a contact takes the larger condim of its two
    geoms), and its rows leave the compact layout for the dense J. Edits and
    returns `snap`."""
    condim = np.array(snap.geom_condim).copy()
    condim[[0, 79]] = 1
    snap.geom_condim = condim
    return snap


def with_frictionloss(snap, value: float):
    """`snap` with dof_frictionloss = `value` on every hinge dof (one
    frictionloss row each). Edits and returns `snap`."""
    from track_mjx_tpu_torch.physics import model as tm

    floss = np.array(snap.dof_frictionloss).copy()
    floss[np.asarray(snap.jnt_type)[np.asarray(snap.dof_jntid)] == tm.JNT_HINGE] = value
    snap.dof_frictionloss = floss
    return snap


def _rel(a, b) -> float:
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def _per_env(a, b):
    return (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1.0)


def _on_cpu(obj, dtype=None):
    """The dataclass of tensors `obj` (Data, EfcData) with every tensor on
    the CPU and, given `dtype`, every floating one in it."""
    def move(t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.cpu()
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return dataclasses.replace(obj, **{f.name: move(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _f64_stats(card_e, cpu_e, stats, factor: float, floor: float) -> dict:
    """For each of `stats` ("median", "max") of two float32 runs' per-env
    distances to float64: (the card's, the reference float32 run's, the bar
    factor x the reference's + floor)."""
    out = {}
    for stat in stats:
        pick = (lambda e: float(e.median())) if stat == "median" else (lambda e: float(e.max()))
        out[stat] = (pick(card_e), pick(cpu_e), factor * pick(cpu_e) + floor)
    return out


def _times(fn, reps: int) -> tuple[float, float]:
    """(ms per call between CUDA events, ms per call to issue on the host
    clock) over the same `reps` calls, after one warm-up call. Where the
    host takes longer to issue a call than the card to run it, the event
    time is the host's rate, not the kernel's."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, host_s * 1e3 / reps


def _time_ms(fn, reps: int) -> float:
    return _times(fn, reps)[0]


def _profiled_ms(fn, reps: int, kernel: str) -> float:
    """Device ms per launch of the CUDA kernels whose name contains
    `kernel`, from torch.profiler over `reps` calls of fn: the mean over
    the launches it recorded (it may miss one of a run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in rows)
    assert 0 < count <= reps, f"the profiler saw {count} launches of {kernel} in {reps} calls"
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def solve_flops(n: int, nl: int, nc: int, rows_per_con: int, its: int, ls: int, *,
                dense_rows: int | None = None, with_euler: bool = True) -> int:
    """Floating-point operations of one env's fused solve as the kernels
    compute it (a multiply-add counts 2): qM and J builds, two Cholesky
    factorizations (n^3 / 3 each), its + 3 (L L^T)^-1 applies (2 n^2 each),
    the J, J^T and M products, and the linesearch's row passes (about 6
    operations per limit or pyramid row and 60 per cone block). A dense J
    of `dense_rows` rows (cg_solve_dense) is read, not built, and takes the
    solve's products (the pyramidal solve's incremental ones for K2's,
    `rows_per_con` 4; K3's fresh ones over nl scalar rows and nc cone blocks,
    3); without the Euler solve, one factor and one apply less."""
    e = nl + rows_per_con * nc if dense_rows is None else dense_rows
    qm = 6 * n * (n + 1)
    jb = 0 if dense_rows is not None else nc * n * (36 + (8 if rows_per_con == 4 else 0)) + nl * n
    factor = (2 if with_euler else 1) * n**3 // 3
    applies = (its + (3 if with_euler else 2)) * 2 * n * n
    if rows_per_con == 4:  # incremental jar / M dx: 2 J, 1 M, 1 J^T per iteration
        mv_j, mv_jt, mv_m = 2 + its, 1 + its + 1, 1 + its
        row_pass = (ls + 1) * 6 * e
    else:  # fresh jar / M (x - smooth): 2 J, 2 M, 1 J^T per iteration
        mv_j, mv_jt, mv_m = 2 + 2 * its, 1 + its + 1, 1 + 2 * its
        row_pass = (ls + 3) * (6 * nl + 60 * nc)
    return (qm + jb + factor + applies + 2 * e * n * (mv_j + mv_jt) + 2 * n * n * mv_m
            + its * row_pass)


def factor_flops(n: int) -> int:
    """Operations of one n x n Cholesky as `factor` computes it: step j
    scales the n - j entries of column j and updates the (n-j-1)(n-j)/2
    entries of the trailing lower triangle with one multiply-add each."""
    return sum(k + (k - 1) * k for k in range(1, n + 1))


def substitution_flops(n: int) -> int:
    """Operations of one L L^T x = b solve: per row and sweep, one
    multiply-add per solved entry before it, a subtraction and a division."""
    return 2 * sum(2 * i + 2 for i in range(n))


def tensor_bytes(tensors) -> int:
    """Bytes of `tensors`, each read or written once in full."""
    return sum(t.numel() * t.element_size() for t in tensors)


def lower_triangle_bytes(a: torch.Tensor) -> int:
    """Bytes of the lower triangles, diagonal included, of a batch of square
    matrices: all that a factorization or a substitution needs to read of
    its matrix input."""
    n = a.shape[-1]
    return a.numel() // (n * n) * (n * (n + 1) // 2) * a.element_size()


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take for a call: the `nbytes` it must
    move over the HBM rate, against its operations `flops` over the float32
    rate; returns (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")


def no_logging(**_) -> None:
    """train.main's per-eval logging rollout, left out: phases 8-11c hold
    the trainer's own launches and rates; phase 13 runs the logging."""


def run_dirs(model_path: str) -> list:
    """The run directories in a model path (train.main's log, wandb_local,
    sits beside them)."""
    return sorted(d for d in os.listdir(model_path) if d != "wandb_local" and os.path.isdir(os.path.join(model_path, d)))


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Phases:
    def __init__(self, card: str, device: str = "cuda"):
        from track_mjx_tpu_torch.ops import batched_linalg as bl
        from track_mjx_tpu_torch.ops import cg_solver_kernel as tk
        from track_mjx_tpu_torch.physics import forward as tf
        from track_mjx_tpu_torch.physics import model as tm
        from track_mjx_tpu_torch.physics import solver as ts

        self.bl, self.tk, self.tf, self.tm, self.ts = bl, tk, tf, tm, ts
        self.card = card
        self.dev = torch.device(device)
        self.gen = torch.Generator(device=self.dev)
        self.gen.manual_seed(SEED)
        self.train_runs = {}  # phase -> (run directory, config) of its train.main run

    def uniform(self, shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen, device=self.dev)

    def pre_solve(self, plan, model, d):
        """forward's stages before the solve: (data, constraint rows)."""
        tf = self.tf
        d, efc = tf.fwd_position(plan, model, d)
        d = tf.fwd_velocity(plan, model, d)
        d = tf.fwd_actuation(plan, model, d)
        return tf.fwd_acceleration(plan, model, d), efc

    def solver_inputs(self, plan, model, qpos, qvel, ctrl, warm, inputs_of):
        d = self.tm.make_data(plan, model, qpos.shape[0]).replace(
            qpos=qpos, qvel=qvel, ctrl=ctrl, qacc_warmstart=warm
        )
        return inputs_of(plan, model, *self.pre_solve(plan, model, d))

    def main_path(self, plan, model, per_substep, control_steps, ctrl_scale, reset_noise=0.001,
                  data=None, contacts=True, n_envs=N_ENVS, substeps=SUBSTEPS):
        """Warm-up + timed control steps of n_step(..., substeps) on n_envs envs,
        from qpos0 with `reset_noise` on the joints after the free root, or
        from `data`. `per_substep` maps each kernel wrapper of the path (and
        any that must not launch, to 0) to its launches per substep. Returns
        the start, the controls, the state after the warm-up, the final
        state and the launches by wrapper name. With `contacts`, some contact
        must be active."""
        tf, tm = self.tf, self.tm
        if data is None:
            data = tm.make_data(plan, model, n_envs)
            qpos = data.qpos.clone()
            qpos[:, 7:] += self.uniform((n_envs, plan.nq - 7), -reset_noise, reset_noise)
            data = data.replace(qpos=qpos)
        ctrls = [ctrl_scale * self.uniform((n_envs, plan.nu), -1.0, 1.0)
                 for _ in range(1 + control_steps)]
        start = tf.slim_data(data)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for op in per_substep:
            op.launches = 0  # the kernels of this path; launches below are the path's
        active = 0
        data = tf.n_step(plan, model, data.replace(ctrl=ctrls[0]), substeps)
        torch.cuda.synchronize()
        after_warmup = tf.slim_data(data)
        active += int((data.contact_dist < 0).sum())
        t0 = time.perf_counter()
        for c in range(1, 1 + control_steps):
            data = tf.n_step(plan, model, data.replace(ctrl=ctrls[c]), substeps)
            active += int((data.contact_dist < 0).sum())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {op.__name__: op.launches for op in per_substep}
        peak = torch.cuda.max_memory_allocated()
        for op, per in per_substep.items():
            expected = (1 + control_steps) * substeps * per
            assert op.launches == expected, f"{op.__name__} launched {op.launches} times, expected {expected}"
        for name in ("qpos", "qvel", "act", "qacc", "qacc_eff", "efc_force", "sensordata", "xpos"):
            t = getattr(data, name)
            assert t.shape[0] == n_envs and torch.isfinite(t).all(), f"{name} is not finite"
        assert active > 0 or not contacts, "no contact is active"
        env_steps = control_steps * n_envs / seconds if control_steps else None
        self.last_env_steps = env_steps
        timed = (f"{control_steps} control steps x {substeps} substeps in {seconds:.3f} s: {env_steps:.1f} "
                 f"env-steps/s, {env_steps * substeps:.1f} env-substeps/s" if control_steps else "the warm-up only")
        print(f"main path: {n_envs} envs x {timed}; "
              f"launches {launches} ({1 + control_steps} control steps); active contacts/env at the control steps' ends "
              f"{active / n_envs / (1 + control_steps):.2f}; peak memory {peak} B ({self.card})")
        return start, ctrls, after_warmup, data, launches

    def first_envs(self, model, n: int):
        """`model` with each per-env leaf cut to its first n envs."""
        tm = self.tm
        return dataclasses.replace(model, **{f: getattr(model, f)[:n] for f in tm.LEAF_RANK if tm.is_per_env(model, f)})

    def cpu_warmup(self, snap, start, ctrl0, substeps=SUBSTEPS, model=None):
        """The warm-up control step of the first N_CPU envs on the CPU, from
        the model snapshot `snap` (with the first N_CPU envs' leaves of
        `model`'s per-env ones)."""
        tf, tm = self.tf, self.tm
        cpu_plan, cpu_model = tm.put_model(snap, device="cpu")
        if model is not None:
            cut = self.first_envs(model, N_CPU)
            cpu_model = dataclasses.replace(cpu_model, **{
                f: getattr(cut, f).cpu() for f in tm.LEAF_RANK if tm.is_per_env(cut, f)})
        cpu = tm.make_data(cpu_plan, cpu_model, N_CPU).replace(
            **{k: getattr(start, k)[:N_CPU].cpu() for k in ("time", "qpos", "qvel", "act", "qacc_warmstart")},
            ctrl=ctrl0[:N_CPU].cpu(),
        )
        return cpu_plan, cpu_model, tf.n_step(cpu_plan, cpu_model, cpu, substeps)

    def versus_cpu(self, what, snap, plan, model, start, ctrls, after_warmup, step_rel, substep_rel,
                   f64: bool = False, qpos_by_f64: bool = False, substeps=SUBSTEPS):
        """The warm-up control step of the first N_CPU envs repeated on the
        CPU from the same start and controls (`snap` put on the CPU), its
        qpos held on the worst env and its qvel on the median one to
        `step_rel`; then one substep from the card's state after it, card
        and CPU each, held on the worst env to `substep_rel` (its keys name
        the outputs). With `f64` (F64_PATHS) also: the control step and the
        substep, card and CPU, against float64 CPU runs on the worst and the
        median env (`versus_f64`), and the card's solve of its own rows
        against the CPU's solve of them within `substep_rel`, its worst env
        taken apart (`solve_split`). With `qpos_by_f64` the control step's
        worst-env qpos is held by that float64 rule instead of
        step_rel["qpos_max"]. `substeps` per control step."""
        cpu_plan, cpu_model, cpu = self.cpu_warmup(snap, start, ctrls[0], substeps, model)
        errs = {}
        for name in ("qpos", "qvel"):
            per_env = _per_env(getattr(after_warmup, name)[:N_CPU].cpu(), getattr(cpu, name))
            errs[name] = (float(per_env.median()), float(per_env.max()))
            print(f"{what}card vs CPU, one control step, {N_CPU} envs, {name}: per-env rel err "
                  f"median {errs[name][0]:.3e} max {errs[name][1]:.3e} (env {int(per_env.argmax())})")
        if f64:
            cpu64, sub64 = self.cpu_float64(cpu_plan, cpu_model, start, ctrls[0], after_warmup)
            for name in ("qpos", "qvel"):
                self.versus_f64(f"{what}one control step", name, getattr(after_warmup, name)[:N_CPU],
                                getattr(cpu, name), getattr(cpu64, name), ("max", "median"))
        if not qpos_by_f64:
            assert errs["qpos"][1] < step_rel["qpos_max"], f"{what}card and CPU qpos differ: {errs['qpos']}"
        assert errs["qvel"][0] < step_rel["qvel_median"], f"{what}card and CPU qvel differ: {errs['qvel']}"

        slim, card_sub, cpu_sub = self.one_substep(plan, model, cpu_plan, cpu_model, after_warmup)
        worst = {}
        for name, bar in substep_rel.items():
            worst[name] = float(_per_env(getattr(card_sub, name).cpu(), getattr(cpu_sub, name)).max())
            print(f"{what}card vs CPU, one substep, {N_CPU} envs, {name}: per-env rel err "
                  f"max {worst[name]:.3e} (bar {bar:.0e})")
        for name, bar in substep_rel.items():
            assert worst[name] < bar, f"{what}card and CPU {name} differ after one substep: {worst[name]:.3e}"
        if f64:
            for name in substep_rel:
                self.versus_f64(f"{what}one substep", name, getattr(card_sub, name), getattr(cpu_sub, name),
                                getattr(sub64, name), ("max", "median"))
            self.solve_split(what, plan, model, cpu_plan, cpu_model, slim, substep_rel)

    def model64(self, cpu_model):
        tm = self.tm
        return tm.Model(**{f: getattr(cpu_model, f).double() for f in tm.Model.__dataclass_fields__})

    def cpu_float64(self, cpu_plan, cpu_model, start, ctrl0, after_warmup):
        """The warm-up control step of the first N_CPU envs and one substep
        from the card's state after it, on the CPU in float64."""
        tf, tm = self.tf, self.tm
        model64 = self.model64(cpu_model)
        cpu64 = tf.n_step(cpu_plan, model64, tm.make_data(cpu_plan, model64, N_CPU).replace(
            **{k: getattr(start, k)[:N_CPU].cpu().double()
               for k in ("time", "qpos", "qvel", "act", "qacc_warmstart")},
            ctrl=ctrl0[:N_CPU].cpu().double(),
        ), SUBSTEPS)
        slim64 = tf.SlimData(**{f: getattr(after_warmup, f)[:N_CPU].cpu().double() for f in tf._CARRY_FIELDS})
        return cpu64, tf.step(cpu_plan, model64, tf.expand_slim(cpu_plan, model64, slim64))

    @staticmethod
    def versus_f64(what, name, card_t, cpu_t, ref, stats, gate: bool = True):
        """The card's per-env distance to the float64 CPU run `ref`, on each
        of `stats` ("median", "max": the median and the worst env), within
        FLY_VS_F64 times the float32 CPU run's, plus FLY_F64_FLOOR (printed
        only, without `gate`)."""
        card_e = _per_env(card_t.cpu().double(), ref)
        cpu_e = _per_env(cpu_t.double(), ref)
        held = _f64_stats(card_e, cpu_e, stats, FLY_VS_F64, FLY_F64_FLOOR)
        w = int(card_e.argmax())
        print(f"{what}, {N_CPU} envs, {name} against float64 CPU: per-env rel err, card "
              f"median {float(card_e.median()):.3e} max {float(card_e.max()):.3e} (env {w}; the CPU's there "
              f"{float(cpu_e[w]):.3e}); CPU float32 median {float(cpu_e.median()):.3e} max {float(cpu_e.max()):.3e} "
              f"(env {int(cpu_e.argmax())}); bar on the card's "
              + ", ".join(f"{stat} {bar:.3e}" for stat, (_, _, bar) in held.items())
              + ("" if gate else " (printed, not gated)"))
        for stat, (card_v, _, bar) in held.items():
            assert card_v <= bar or not gate, (
                f"card {name} further from float64 than the CPU on the {stat} env ({what})")

    def solve_split(self, what, plan, model, cpu_plan, cpu_model, slim, substep_rel):
        """From the card's state `slim` (N_CPU envs), forward's stages up to
        the solve on the card and on the CPU, then the card's rows solved on
        the card and on the CPU (the plain versions), and each row set
        solved in float64 on the CPU. The card's solve is held to the CPU's
        solve of the same rows within `substep_rel` on the worst env. The
        worst env of the card's solve against the CPU's (by qacc) is taken
        apart: its rows' split, its contacts and active rows that differ,
        each float32 solve's distance to the float64 solve of its own rows,
        and the two float64 solves' split (what the exact solve makes of the
        rows' roundoff)."""
        tf, ts = self.tf, self.ts
        model = self.first_envs(model, N_CPU)
        card_d, card_efc = self.pre_solve(plan, model, tf.expand_slim(plan, model, slim))
        cpu_slim = tf.SlimData(**{f: getattr(slim, f).cpu() for f in tf._CARRY_FIELDS})
        cpu_d, cpu_efc = self.pre_solve(cpu_plan, cpu_model, tf.expand_slim(cpu_plan, cpu_model, cpu_slim))
        model64 = self.model64(cpu_model)
        card = ts.solve(plan, model, card_d, card_efc)
        moved = ts.solve(cpu_plan, cpu_model, _on_cpu(card_d), _on_cpu(card_efc))
        cpu = ts.solve(cpu_plan, cpu_model, cpu_d, cpu_efc)
        exact_card = ts.solve(cpu_plan, model64, _on_cpu(card_d, torch.float64), _on_cpu(card_efc, torch.float64))
        exact_cpu = ts.solve(cpu_plan, model64, _on_cpu(cpu_d, torch.float64), _on_cpu(cpu_efc, torch.float64))
        outs = [k for k in ("qacc", "efc_force", "qacc_eff") if k in substep_rel]

        def split(a, b, name):
            return _per_env(getattr(a, name).cpu().double(), getattr(b, name).double())

        worst = {}
        for name in outs:
            e = split(card, moved, name)
            worst[name] = float(e.max())
            print(f"{what}one substep, {N_CPU} envs: the card's solve against the CPU's solve of the card's rows, "
                  f"{name}: per-env rel err median {float(e.median()):.3e} max {worst[name]:.3e} "
                  f"(bar {substep_rel[name]:.0e})")
        w = int(split(card, cpu, "qacc").argmax())
        rows = {name: float(_per_env(getattr(card_efc, name)[w : w + 1].cpu().double().flatten(1),
                                     getattr(cpu_efc, name)[w : w + 1].double().flatten(1)))
                for name in ("J", "aref", "D") if getattr(card_efc, name) is not None}
        dist = card_d.contact_dist[w].cpu(), cpu_d.contact_dist[w]
        flips = int(((dist[0] < 0) != (dist[1] < 0)).sum())
        active = int(((card.efc_force[w].cpu() != 0) != (cpu.efc_force[w] != 0)).sum())
        print(f"{what}one substep, the worst env of the card's solve against the CPU's ({w}): rows' per-env rel "
              f"split " + ", ".join(f"{k} {v:.3e}" for k, v in rows.items())
              + f"; contacts active on one side only {flips}, rows with force on one side only {active} of "
              f"{plan.nefc}")
        for name in outs:
            one = {k: float(split(a, b, name)[w]) for k, (a, b) in dict(
                whole=(card, cpu), same_rows=(card, moved), card64=(card, exact_card), cpu64=(cpu, exact_cpu),
                exact=(exact_card, exact_cpu)).items()}
            print(f"{what}one substep, env {w}, {name}: card against CPU {one['whole']:.3e}; the card's solve "
                  f"against the CPU's of the same rows {one['same_rows']:.3e}; against the float64 solve of its "
                  f"own rows: card {one['card64']:.3e}, CPU {one['cpu64']:.3e}; float64 solves of the card's rows "
                  f"against the CPU's {one['exact']:.3e}")
        for name in outs:
            assert worst[name] < substep_rel[name], (
                f"{what}the card's solve and the CPU's solve of the same rows differ in {name}: {worst[name]:.3e}")

    def one_substep(self, plan, model, cpu_plan, cpu_model, after_warmup):
        tf = self.tf
        slim = tf.SlimData(**{f: getattr(after_warmup, f)[:N_CPU] for f in tf._CARRY_FIELDS})
        model = self.first_envs(model, N_CPU)
        card_sub = tf.step(plan, model, tf.expand_slim(plan, model, slim))
        cpu_sub = tf.step(cpu_plan, cpu_model, tf.expand_slim(
            cpu_plan, cpu_model, tf.SlimData(**{f: getattr(slim, f).cpu() for f in tf._CARRY_FIELDS})))
        return slim, card_sub, cpu_sub

    # -----------------------------------------------------------------------
    # rodent
    # -----------------------------------------------------------------------

    def rodent_drop(self, plan, model, n_envs=N_ENVS):
        """Contact-rich rodent starts (qpos, qvel, ctrl, warmstart): feet
        dropped into the floor, joints perturbed, random qvel, ctrl and
        warmstart (tests/test_cg_kernel_parity.py)."""
        qpos = model.qpos0.expand(n_envs, plan.nq).clone()
        qpos[:, 2] -= self.uniform((n_envs,), 0.008, 0.016)
        qpos[:, 7:] += self.uniform((n_envs, plan.nq - 7), -0.08, 0.08)
        qvel = self.uniform((n_envs, plan.nv), -0.5, 0.5)
        ctrl = self.uniform((n_envs, plan.nu), -0.5, 0.5)
        return qpos, qvel, ctrl, self.uniform((n_envs, plan.nv), -1.0, 1.0)

    def rodent_states(self, plan, model, n_envs=N_ENVS):
        """Contact-rich rodent solver inputs of the fused solve."""
        return self.solver_inputs(plan, model, *self.rodent_drop(plan, model, n_envs), self.ts.solve_inputs)

    def cg_kernel_info(self, op: str, n: int, nl: int, nc: int, n_envs: int = N_ENVS) -> None:
        """Registers, shared memory, resident CTAs per SM and threads of the
        fused solve kernel `op` (cg_solve, ell_cg_solve) at the walker's
        sizes, as built, and the waves of N_ENVS envs (one per CTA) over the
        card's SMs."""
        from track_mjx_tpu_torch.ops import kernel_lib

        info = (ctypes.c_int * 4)()
        err = getattr(kernel_lib.load_library(), f"{op}_kernel_info")(n, nl, nc, info)
        assert err == 0, f"{op}_kernel_info failed with cudaError {err}"
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        waves = -(-n_envs // (info[2] * sms))
        print(f"{op} kernel at n={n}, nl={nl}, nc={nc}: {info[3]} threads per CTA (one env), "
              f"{info[0]} registers per thread, {info[1]} B of shared memory per CTA, {info[2]} "
              f"resident CTAs per SM, {waves} waves of {n_envs} envs on {sms} SMs ({self.card})")
        return info

    def rodent(self) -> list:
        tk, tm = self.tk, self.tm
        plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        print(f"rodent: nq={plan.nq} nv={plan.nv} nu={plan.nu} ncon={plan.ncon} "
              f"nefc={plan.nefc} cg {its}/{ls} dt={float(model.opt_timestep)}")

        # kernel against plain on contact-rich states
        inputs = self.rodent_states(plan, model)
        before = tk.cg_solve.launches
        kernel = tk.cg_solve(**inputs, iterations=its, ls_iterations=ls)
        torch.cuda.synchronize()
        assert tk.cg_solve.launches == before + 1, "the wrapper did not launch the kernel"
        plain = tk.cg_solve_plain(**inputs, iterations=its, ls_iterations=ls)
        torch.cuda.synchronize()
        rich = float((plain.efc_force != 0).any(dim=1).float().mean())
        print(f"{N_ENVS} states, share with active constraint rows {rich:.3f}")
        assert rich > 0.9, "states are not contact-rich"
        max_abs = 0.0
        for name, bar in KERNEL_REL.items():
            a, b = getattr(kernel, name), getattr(plain, name)
            assert torch.isfinite(a).all(), f"kernel {name} not finite"
            err = _rel(a, b)
            abs_err = float((a - b).abs().max())
            max_abs = max(max_abs, abs_err)
            print(f"cg_solve vs plain {name}: max rel err {err:.3e} (bar {bar:.0e}), "
                  f"max abs err {abs_err:.3e}, max |plain| {float(b.abs().max()):.3e}")
            assert err < bar, f"kernel {name} disagrees with plain: {err:.3e} >= {bar:.0e}"

        nc, nl = inputs["fq"].shape[1], inputs["lim1h"].shape[0]
        self.cg_kernel_info("cg_solve", plan.nv, nl, nc)
        kernel_ms = _time_ms(lambda: tk.cg_solve(**inputs, iterations=its, ls_iterations=ls), 20)
        plain_ms = _time_ms(lambda: tk.cg_solve_plain(**inputs, iterations=its, ls_iterations=ls), 3)
        b_ms, b_by = bound_ms(tensor_bytes([*inputs.values(), *kernel]),
                              N_ENVS * solve_flops(plan.nv, nl, nc, 4, its, ls))
        print(f"cg_solve at B={N_ENVS}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) ({self.card})")
        self.phase2 = inputs, kernel  # the no-Euler mode is held on the same states (phase 11)
        del plain

        # main path
        start, ctrls, after_warmup, _, launches = self.main_path(
            plan, model, {tk.cg_solve: 1}, RODENT_CONTROL_STEPS, RODENT_CTRL_SCALE
        )
        self.physics_env_steps = self.last_env_steps
        self.versus_cpu("", tm.load_snapshot("rodent-full-clips"), plan, model, start, ctrls, after_warmup,
                        STEP_REL, SUBSTEP_REL)

        return [{
            "name": "cg_solve",
            "route": "cuda",
            "source": "track_mjx_tpu_torch/csrc/cg_solve.cu",
            "replaces": "track_mjx_tpu/ops/cg_solver_kernel.py:146",
            "launches": launches["cg_solve"],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the fused solve
        }]

    # -----------------------------------------------------------------------
    # rodent rollout: the tracking env and the intention policy
    # -----------------------------------------------------------------------

    def rollout(self) -> int:
        """The rodent rollout at 4096 envs (phase 4); returns cg_solve's
        launches in reset and the first unroll."""
        from track_mjx_tpu_torch import rollout as trollout
        from track_mjx_tpu_torch.agent import acting
        from track_mjx_tpu_torch.envs.base import Wrapper, map_tensors

        tk = self.tk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = phase_t0 = time.perf_counter()
        ro = trollout.make_rollout(n_clips=ROLLOUT_CLIPS, seed=SEED, device=self.dev)
        env, unroll = ro.tracking, ro.unroll_length
        torch.cuda.synchronize()
        print(f"rollout: {ROLLOUT_CLIPS} clips x {env._clip_frames} frames synthesized and the env and "
              f"networks built on the card in {time.perf_counter() - t0:.1f} s; obs {env.observation_size} "
              f"(reference {env.reference_obs_size}), actions {env.action_size}, episode length "
              f"{ro.episode_length}, unroll length {unroll}, policy parameters "
              f"{sum(p.numel() for p in ro.networks.policy_network.parameters())}")

        class Recorder(Wrapper):
            """Counts, per step, the envs that hit the NaN guard."""

            nans: list = []

            def step(self, state, action):
                state = self.env.step(state, action)
                self.nans.append(int(state.metrics["nan"].sum()))
                return state

        wrapped = Recorder(ro.env)
        policy = ro.policy()
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        plain_calls = [0]
        plain = tk.cg_solve_plain

        def counting_plain(*args, **kwargs):
            plain_calls[0] += 1
            return plain(*args, **kwargs)

        tk.cg_solve_plain = counting_plain
        others = (tk.ell_cg_solve, self.bl.cholesky, self.bl.cho_solve, self.bl.solve_spd)
        for op in (tk.cg_solve, *others):
            op.launches = 0  # reset and the first unroll: the path's launches
        t0 = time.perf_counter()
        state = wrapped.reset(gen, N_ENVS)
        state, data = acting.generate_unroll(wrapped, state, policy, gen, unroll)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = tk.cg_solve.launches
        expected = 1 + unroll * SUBSTEPS
        assert launches == expected, f"cg_solve launched {launches} times in reset and {unroll} steps, expected {expected}"
        for op in others:
            assert op.launches == 0, f"the rollout launched {op.__name__}"
        fields = {f: getattr(data, f) for f in ("observation", "action", "reward", "discount", "next_observation")}
        fields.update({f"extras.{k}": v for k, v in data.extras["policy_extras"].items()})
        for name, t in fields.items():
            assert t.shape[:2] == (unroll, N_ENVS) and torch.isfinite(t).all(), f"transition {name} is not finite"
        dones = int((data.discount == 0).sum())
        print(f"rollout: reset + {unroll} steps of {N_ENVS} envs in {first_s:.3f} s, cg_solve launches "
              f"{launches} (1 + {unroll} x {SUBSTEPS}); every Transition field finite; env-steps that ended "
              f"an episode {dones} of {unroll * N_ENVS}, that hit the NaN guard {sum(wrapped.nans)} "
              f"(per step {wrapped.nans})")

        seconds = []
        for _ in range(ROLLOUT_TIMED):
            before = tk.cg_solve.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, data = acting.generate_unroll(wrapped, state, policy, gen, unroll)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            assert tk.cg_solve.launches - before == unroll * SUBSTEPS, "a timed unroll launched cg_solve otherwise"
            assert torch.isfinite(data.observation).all() and torch.isfinite(data.reward).all()
        tk.cg_solve_plain = plain
        assert plain_calls[0] == 0, f"the rollout called cg_solve_plain {plain_calls[0]} times"
        peak = torch.cuda.max_memory_allocated()
        rates = sorted(unroll * N_ENVS / s for s in seconds)
        median = rates[len(rates) // 2] if len(rates) % 2 else 0.5 * (rates[len(rates) // 2 - 1] + rates[len(rates) // 2])
        self.rollout_step_ms = 1e3 * N_ENVS / median  # ms per control step at the median rate (phase 13)
        policy_ms, policy_host_ms = _times(lambda: policy(state.obs, gen), 20)
        # the policy's products (a multiply-add counts 2) and weights, read once
        linears = [m for m in ro.networks.policy_network.modules() if isinstance(m, torch.nn.Linear)]
        policy_flops = sum(2 * N_ENVS * m.in_features * m.out_features for m in linears)
        policy_bound, policy_by = bound_ms(tensor_bytes([*ro.networks.policy_network.parameters(), state.obs]),
                                           policy_flops)
        print(f"rollout: {ROLLOUT_TIMED} timed unrolls of {unroll} steps x {N_ENVS} envs in "
              f"{', '.join(f'{x:.3f}' for x in seconds)} s: {median:.1f} env-steps/s median (spread "
              f"{rates[0]:.1f}-{rates[-1]:.1f}), policy included; physics alone (phase 3, this run) "
              f"{self.physics_env_steps:.1f} env-steps/s; cg_solve_plain calls 0; policy forward at "
              f"B={N_ENVS} {policy_ms:.3f} ms (CUDA events; host issue {policy_host_ms:.3f} ms; bound "
              f"{policy_bound:.4f} ms ({policy_by}), {policy_flops / 1e9:.2f} GFLOP in float32); peak "
              f"memory {peak} B ({self.card})")

        # card against CPU on N_CPU envs, one env step from the state after
        # the first unroll (the unwrapped env: the Data of the step is kept)
        sub = map_tensors(lambda t: t[:N_CPU] if t.dim() and t.shape[0] == N_ENVS else t, state)
        action, _ = policy(sub.obs, gen)
        card = env.step(sub, action)
        cpu_ro = trollout.make_rollout(clips=env._reference_clips.to("cpu"), seed=SEED, device="cpu")
        cpu_env = cpu_ro.tracking
        to_cpu = lambda tree: map_tensors(lambda t: t.cpu(), tree)  # noqa: E731
        cpu_sub, cpu_action = to_cpu(sub), action.cpu()
        cpu = cpu_env.step(cpu_sub, cpu_action)
        cpu_env.pipeline_step = lambda data, ctrl: to_cpu(card.pipeline_state)
        layer = cpu_env.step(cpu_sub, cpu_action)
        del cpu_env.pipeline_step
        cpu_env.model = self.tm.Model(**{f: getattr(cpu_env.model, f).double() for f in self.tm.Model.__dataclass_fields__})
        cpu_env._pack = cpu_env._pack.double()
        f64 = cpu_env.step(map_tensors(lambda t: t.double() if t.is_floating_point() else t, cpu_sub),
                           cpu_action.double())

        def pairs(out):
            got = {"obs": out.obs, "reward": out.reward[:, None]}
            got.update({k: out.metrics[k][:, None] for k in REWARD_TERMS})
            return got

        card_v, cpu_v, layer_v, f64_v = pairs(card), pairs(cpu), pairs(layer), pairs(f64)
        worst = 0.0
        for name in card_v:
            worst = max(worst, float(_per_env(card_v[name].cpu(), layer_v[name]).max()))
        flags = ("done", "too_far", "bad_pose", "bad_quat", "fall", "nan")
        flags_equal = all(torch.equal(card.metrics[k].cpu(), layer.metrics[k]) for k in flags)
        print(f"rollout, card vs CPU on the card's physics, {N_CPU} envs: env layer worst per-env rel err "
              f"{worst:.3e} over obs, reward and the reward terms (bar {ROLLOUT_LAYER_REL:.0e}); flags equal {flags_equal}")
        assert worst < ROLLOUT_LAYER_REL, f"the card's env layer disagrees with the CPU's: {worst:.3e}"
        assert flags_equal, "the card's flags disagree with the CPU's on the same physics"
        for name in card_v:
            ref = f64_v[name].double()
            card_e = _per_env(card_v[name].cpu().double(), ref)
            cpu_e = _per_env(cpu_v[name].double(), ref)
            bar = ROLLOUT_VS_F64 * float(cpu_e.median()) + ROLLOUT_F64_FLOOR
            print(f"rollout, one env step, {N_CPU} envs, {name} against float64 CPU: per-env rel err, card "
                  f"median {float(card_e.median()):.3e} max {float(card_e.max()):.3e}; CPU float32 median "
                  f"{float(cpu_e.median()):.3e} max {float(cpu_e.max()):.3e}; bar on the card's median {bar:.3e}")
            assert float(card_e.median()) <= bar, f"rollout: card {name} further from float64 than the CPU"
        done_card, done_cpu = int(card.done.sum()), int(cpu.done.sum())
        print(f"rollout, one env step, {N_CPU} envs: done on the card {done_card}, on the CPU {done_cpu}, "
              f"in float64 {int(f64.done.sum())}")

        # the networks, card against CPU (the same seeded weights)
        obs = sub.obs
        card_out = ro.networks.policy_network(ro.normalizer, obs, None)
        cpu_out = cpu_ro.networks.policy_network(cpu_ro.normalizer, obs.cpu(), None)
        card_value = ro.networks.value_network(ro.normalizer, obs)
        cpu_value = cpu_ro.networks.value_network(cpu_ro.normalizer, obs.cpu())
        for name, a, b in zip(("logits", "latent_mean", "latent_logvar", "value"),
                              (*card_out, card_value[:, None]), (*cpu_out, cpu_value[:, None])):
            err = float(_per_env(a.detach().cpu(), b.detach()).max())
            print(f"rollout, policy card vs CPU, {N_CPU} observations, {name}: worst per-env rel err "
                  f"{err:.3e} (bar {POLICY_REL:.0e})")
            assert err < POLICY_REL, f"the card's {name} disagree with the CPU's: {err:.3e}"
        del ro, cpu_ro, state, data, sub
        torch.cuda.empty_cache()
        print(f"rollout phase: {time.perf_counter() - phase_t0:.1f} s ({self.card})")
        return launches

    # -----------------------------------------------------------------------
    # rodent training: the trainer through its entry point
    # -----------------------------------------------------------------------

    def training(self, config: str = "rodent-full-clips", extra=(), what: str = "rodent training",
                 phase="8", cuts=TRAIN_OVERRIDES, step_by_step: bool = False) -> int:
        """PPO training of workload `config` (with the depth `cuts` and `extra`
        overrides) at full width through train.main (phases 8-10 and 11c);
        returns the launches of the path's fused solve in the phase. The
        learning half is held against the CPU as a whole, or with
        `step_by_step` step by step. The run's directory and config stay in
        `self.train_run`."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.agent import checkpointing
        from track_mjx_tpu_torch.envs.base import map_tensors
        from track_mjx_tpu_torch.io import load
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        phase_t0 = time.perf_counter()
        root = os.path.join(REPO, "build", f"chip_smoke_train_{phase}")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        mocap_hz = load_config(config).env_config.env_args.mocap_hz
        clips = synthesize_clips(self.tm.load_snapshot(config), n_clips=TRAIN_CLIPS,
                                 n_frames=TRAIN_CLIP_LENGTH, mocap_hz=mocap_hz, seed=SEED, device=self.dev)
        load.save_npz(clips, os.path.join(root, "clips.npz"))
        cfg = load_config(config, [
            f"device={self.dev.type}",
            f"data_path={os.path.join(root, 'clips.npz')}",
            f"logging_config.model_path={os.path.join(root, 'ckpts')}",
            *cuts,
            *extra,
        ])
        tc, net = cfg.train_setup.train_config, cfg.network_config
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        lstm = bool(tc.get("use_lstm", False))
        widths = (net.encoder_layer_sizes, net.decoder_layer_sizes, net.critic_layer_sizes, net.intention_size)
        assert widths == TRAIN_WIDTHS[config], widths
        if lstm:
            assert (net.hidden_layer_num, net.hidden_state_size) == LSTM_CARRY
        per_step = tc.batch_size * tc.unroll_length * tc.num_minibatches * tc.action_repeat
        num_evals = int(tc.num_timesteps / cfg.train_setup.eval_every)
        resets_per_eval = cfg.train_setup.eval_every // cfg.train_setup.reset_every
        steps = -(-tc.num_timesteps // (max(num_evals - 1, 1) * per_step * max(resets_per_eval, 1)))
        unrolls = tc.batch_size * tc.num_minibatches // tc.num_envs
        # control steps of an episode: its frames times the control steps per
        # frame (2 at rodent-sps-per-actor's 5 substeps), as workload.episode_length
        env_args = cfg.env_config.env_args
        per_frame = (1.0 / (env_args.mocap_hz * env_args.mj_model_timestep)) / substeps
        episode = int((TRAIN_CLIP_LENGTH - cfg.reference_config.random_init_range
                       - cfg.reference_config.traj_length) * per_frame)

        captured, progress = {}, []

        def on_batch(state, data, make_learner):  # the last step's state and batch, before its learning half
            captured["make_learner"] = make_learner
            captured["state"] = checkpointing.cpu_copy(state.state_dict())
            n = TRAIN_CPU_MINIBATCH * tc.num_minibatches
            captured["data"] = map_tensors(lambda x: x[:n].detach().to("cpu", copy=True), data)
            captured["obs"] = data.observation[:, 0].clone()
            if lstm:
                captured["carry"] = tuple(x.clone() for x in state.hidden_state)

        # the path's fused solve, and its plain version counted
        solve = "ell_cg_solve" if config == "fly-mc-intention" else "cg_solve"
        kernel = getattr(tk, solve)
        plain_calls = [0]
        plain = getattr(tk, f"{solve}_plain")

        def counting_plain(*args, **kwargs):
            plain_calls[0] += 1
            return plain(*args, **kwargs)

        setattr(tk, f"{solve}_plain", counting_plain)
        others = [op for op in (tk.cg_solve, tk.ell_cg_solve, self.bl.cholesky, self.bl.cho_solve, self.bl.solve_spd)
                  if op is not kernel]
        for op in (kernel, *others):
            op.launches = 0  # the trainer's run: the path's launches
        t0 = time.perf_counter()
        make_policy, params = ttrain.main(cfg, progress_fn=lambda s, m: progress.append((s, m)),
                                          batch_callback=on_batch, policy_params_fn=no_logging)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = kernel.launches
        setattr(tk, f"{solve}_plain", plain)
        # reset, the unrolls, the reset after each epoch, and per eval a reset
        # and its episode, with the initial eval only when num_evals > 1
        evals = max(num_evals - 1, 1) + (1 if num_evals > 1 else 0)
        epochs = max(num_evals - 1, 1) * max(resets_per_eval, 1)
        expected = (1 + epochs * steps * unrolls * tc.unroll_length * substeps
                    + (epochs if resets_per_eval > 0 else 0) + evals * (1 + episode * substeps))
        print(f"{what}: {solve} launches {launches}, expected 1 (reset) + {epochs} epoch x {steps} training "
              f"steps x {unrolls} unroll x {tc.unroll_length} steps x {substeps} + "
              f"{epochs if resets_per_eval > 0 else 0} (reset after the epoch) + {evals} eval x (1 + {episode} "
              f"x {substeps}) = {expected}; {solve}_plain calls {plain_calls[0]}; "
              f"{', '.join(f'{op.__name__} {op.launches}' for op in others)}")
        assert launches == expected, f"{solve} launched {launches} times, expected {expected}"
        assert plain_calls[0] == 0, f"the trainer called {solve}_plain {plain_calls[0]} times"
        for op in others:
            assert op.launches == 0, f"the trainer launched {op.__name__}"

        final = progress[-1][1]
        losses = {k: v for k, v in final.items() if k.startswith("training/") and k.endswith("loss")}
        assert len(losses) == 5 and all(math.isfinite(v) for v in losses.values()), losses
        run_dir = os.path.join(root, "ckpts", run_dirs(os.path.join(root, "ckpts"))[0])
        store = checkpointing.CheckpointStore(run_dir)
        stored = store.training_state()
        for group in ("policy", "value"):
            for k, v in stored["params"][group].items():
                assert torch.isfinite(v).all(), f"{group} parameter {k} is not finite"
        env_steps = 0
        for _ in range(epochs * steps):  # ppo.py: jnp.int32(env_steps + per_step / 1e3), in float32
            env_steps = int(np.int32(np.float32(env_steps) + np.float32(per_step / 1e3)))
        assert stored["env_steps"] == env_steps == progress[-1][0], (stored["env_steps"], env_steps)
        print(f"{what}: {train_s:.1f} s in train.main; every loss metric and parameter finite; env_steps "
              f"{stored['env_steps']} thousand (JAX formula: {epochs * steps} x int32(float32(e) + "
              f"{per_step / 1e3}) = {env_steps}); losses {json.dumps(losses)}")
        if lstm:
            carry = stored["hidden_state"]
            shapes = [tuple(x.shape) for x in carry]
            finite = all(bool(torch.isfinite(x).all()) for x in carry)
            print(f"{what}: the stored rollout carry (h, c) has shapes {shapes}, finite {finite}, "
                  f"max |h| {float(carry[0].abs().max()):.4f}")
            assert shapes == [(tc.num_envs, *LSTM_CARRY)] * 2 and finite, "the rollout carry is off"
        print(f"{what} sps {final['training/sps']:.1f}, eval sps {final['eval/sps']:.1f} (the trainer's metrics); "
              f"host ms per training step: rollout {final['training/rollout_ms']:.1f}, normalizer update "
              f"{final['training/normalizer_update_ms']:.3f}, sgd {final['training/sgd_ms']:.1f}; eval "
              f"{final['eval/epoch_eval_time']:.1f} s for {tc.get('num_eval_envs', 128)} envs x {episode} steps; "
              f"eval episode reward {final['eval/episode_reward']:.4f}, length {final['eval/avg_episode_length']:.2f} "
              f"({self.card})")

        # the checkpoint's policy acts as the trained one, bit for bit (the
        # recurrent one from the same carry)
        bundle = store.for_eval(device=self.dev)
        loaded = checkpointing.load_inference_fn(bundle["cfg"], bundle["policy"], device=self.dev)
        trained = make_policy(params[0], deterministic=True)
        obs = captured["obs"]
        if lstm:
            got, want = loaded(obs, None, captured["carry"]), trained(obs, None, captured["carry"])
            same = torch.equal(got[0], want[0]) and all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
        else:
            same = torch.equal(loaded(obs)[0], trained(obs)[0])
        print(f"{what}: checkpoint {os.path.basename(run_dir)}/PPONetwork_{store.resolve_step(None)} loaded "
              f"for eval; its actions{' and carry' if lstm else ''} on {obs.shape[0]} observations equal the "
              f"trained policy's bit for bit: {same}")
        assert same, "the checkpoint's policy acts otherwise than the trained one"

        check = self.learning_steps_versus_cpu if step_by_step else self.learning_half_versus_cpu
        check(bundle["cfg"], captured, what)
        self.train_run = run_dir, cfg
        self.train_runs[phase] = run_dir, cfg
        if config == "fly-mc-intention":
            self.fly_env_layer_versus_cpu(cfg, clips)
        peak = torch.cuda.max_memory_allocated()
        print(f"{what} phase: {time.perf_counter() - phase_t0:.1f} s, peak memory {peak} B ({self.card})")
        del make_policy, params, captured, bundle, loaded, trained
        torch.cuda.empty_cache()
        return launches

    def fly_env_layer_versus_cpu(self, cfg, clips) -> None:
        """The fly's env layer, card against CPU, on N_CPU envs: one env step
        from a reset on the card, the CPU's env handed the card's physics
        output (phase 4's check of the rodent)."""
        from track_mjx_tpu_torch import workload
        from track_mjx_tpu_torch.envs.base import map_tensors

        env = workload.make_env(cfg, clips, device=self.dev)
        state = env.reset(self.gen, N_CPU)
        action = self.uniform((N_CPU, env.action_size), -1.0, 1.0)
        card = env.step(state, action)
        cpu_env = workload.make_env(cfg, clips.to("cpu"), device="cpu")
        to_cpu = lambda tree: map_tensors(lambda t: t.cpu(), tree)  # noqa: E731
        cpu_env.pipeline_step = lambda data, ctrl: to_cpu(card.pipeline_state)
        layer = cpu_env.step(to_cpu(state), action.cpu())
        worst = 0.0
        for name in ("obs", "reward", *REWARD_TERMS):
            a = card.obs if name == "obs" else (card.reward if name == "reward" else card.metrics[name])
            b = layer.obs if name == "obs" else (layer.reward if name == "reward" else layer.metrics[name])
            worst = max(worst, float(_per_env(a.reshape(N_CPU, -1).cpu(), b.reshape(N_CPU, -1)).max()))
        flags = ("done", "too_far", "bad_pose", "bad_quat", "fall", "nan")
        flags_equal = all(torch.equal(card.metrics[k].cpu(), layer.metrics[k]) for k in flags)
        print(f"fly training, env layer card vs CPU on the card's physics, {N_CPU} envs, one step from a reset: "
              f"worst per-env rel err {worst:.3e} over obs, reward and the reward terms (bar "
              f"{ROLLOUT_LAYER_REL:.0e}); flags equal {flags_equal}; done on the card {int(card.done.sum())}")
        assert worst < ROLLOUT_LAYER_REL, f"the card's fly env layer disagrees with the CPU's: {worst:.3e}"
        assert flags_equal, "the card's fly flags disagree with the CPU's on the same physics"

    def learning_sides(self, cfg, captured):
        """The card's and the CPU's learning halves from the same state: per
        device the networks (from the checkpoint's config), the trainer's own
        Learner (`make_learner`, handed over by ppo.train's batch_callback),
        the training state, TRAIN_CPU_MINIBATCH trajectories per minibatch
        of the phase's last batch and the same permutations and noises."""
        from track_mjx_tpu_torch.agent import checkpointing, running_statistics
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo
        from track_mjx_tpu_torch.envs.base import map_tensors

        tc, net = cfg["train_setup"]["train_config"], cfg["network_config"]
        mbs, passes = tc["num_minibatches"], tc["num_updates_per_batch"]
        n = TRAIN_CPU_MINIBATCH * mbs
        unroll, actions, latents = tc["unroll_length"], net["action_size"], net["intention_size"]
        gen = torch.Generator().manual_seed(SEED)
        draws = [ppo.UpdateDraws(torch.randperm(n, generator=gen), [
            (torch.randn(unroll, n // mbs, latents, generator=gen), torch.randn(unroll, n // mbs, actions, generator=gen))
            for _ in range(mbs)]) for _ in range(passes)]
        sides = {}
        for dev in (self.dev, torch.device("cpu")):
            networks = checkpointing.make_ppo_network_from_cfg(cfg, dev)
            learner = captured["make_learner"](networks)
            assert (learner.num_minibatches, learner.num_updates_per_batch) == (mbs, passes)
            state = ppo.TrainingState(
                networks, learner.optimizer, running_statistics.init_state(net["observation_size"], dev), 0)
            state.load_state_dict(captured["state"])
            move = lambda d: ppo.UpdateDraws(d.permutation.to(dev), [(a.to(dev), b.to(dev)) for a, b in d.noises])  # noqa: E731
            sides[dev.type] = dict(networks=networks, learner=learner, state=state,
                                   data=map_tensors(lambda x: x.to(dev), captured["data"]),
                                   draws=[move(d) for d in draws])
        return sides, n, mbs, passes

    @staticmethod
    def _params(networks) -> dict:
        return {k: v.detach().cpu() for m in (networks.policy_network, networks.value_network)
                for k, v in m.state_dict().items()}

    def learning_half_versus_cpu(self, cfg, captured, what: str) -> None:
        """One learning half (the normalizer update, then the passes over the
        minibatches) on the card and on the CPU from the same training state
        (`learning_sides`; the state has taken a training step: Adam's bias
        correction and the normalizer are not at their start); the first
        minibatch's gradients too."""
        from track_mjx_tpu_torch.agent import checkpointing, running_statistics
        from track_mjx_tpu_torch.envs.base import map_tensors

        tc = cfg["train_setup"]["train_config"]
        unroll = tc["unroll_length"]
        sides, n, mbs, passes = self.learning_sides(cfg, captured)
        out = {}
        for dev, side in sides.items():
            networks, learner, state, data, dev_draws = (side[k] for k in ("networks", "learner", "state", "data",
                                                                            "draws"))
            # the first minibatch's gradients, from the normalizer its passes
            # run on (the LSTM trainer's passes run on the pre-update one)
            normalizer = state.normalizer_params
            if not learner.normalizer_after_sgd:
                normalizer = running_statistics.update(normalizer, data.observation)
            first = map_tensors(lambda x: x[dev_draws[0].permutation[: n // mbs]], data)
            loss, _ = learner.loss_fn(normalizer, first, *dev_draws[0].noises[0], 1)
            loss.backward()
            grads = {k: p.grad.detach().cpu().clone() for m in (networks.policy_network, networks.value_network)
                     for k, p in m.named_parameters()}
            learner.optimizer.zero_grad()
            metrics = learner(state, data, 1, draws=dev_draws)
            out[dev] = {
                "grads": grads,
                "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
                "params": self._params(networks),
                "normalizer": checkpointing.normalizer_to_dict(state.normalizer_params),
            }
        card, cpu = out[self.dev.type], out["cpu"]
        loss_err = max(abs(a[k] - b[k]) / max(1.0, abs(b[k])) for a, b in zip(card["metrics"], cpu["metrics"]) for k in b)
        grad_err = max(float((card["grads"][k] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                       for k, g in cpu["grads"].items())
        lr = tc["learning_rate"]
        param_err = max(float((card["params"][k] - p).abs().max()) / lr for k, p in cpu["params"].items())
        norm_err = max(_rel(card["normalizer"][k], v) for k, v in cpu["normalizer"].items())
        print(f"{what}, one learning half card vs CPU ({n} trajectories x {unroll} steps of the last batch, "
              f"{passes} passes x {mbs} minibatches, same state, permutations and noises, full width): loss terms "
              f"of every step worst rel err {loss_err:.3e} (bar {TRAIN_LOSS_REL:.0e}); first minibatch's gradients "
              f"worst err relative to each tensor's largest element {grad_err:.3e} (bar {TRAIN_GRAD_REL:.0e}); "
              f"parameters after the half worst {param_err:.3e} lr (bar {TRAIN_PARAM_LR:.0e} lr); normalizer "
              f"{norm_err:.3e} (bar {TRAIN_NORM_REL:.0e})")
        assert loss_err < TRAIN_LOSS_REL, f"the card's loss terms disagree with the CPU's: {loss_err:.3e}"
        assert grad_err < TRAIN_GRAD_REL, f"the card's gradients disagree with the CPU's: {grad_err:.3e}"
        assert param_err < TRAIN_PARAM_LR, f"the card's parameters disagree with the CPU's: {param_err:.3e} lr"
        assert norm_err < TRAIN_NORM_REL, f"the card's normalizer disagrees with the CPU's: {norm_err:.3e}"

    def learning_steps_versus_cpu(self, cfg, captured, what: str) -> None:
        """The learning half step by step (phase 11c: over its 4 passes of 16
        minibatches two float32 runs part by more than phase 8's bars, on an
        NVIDIA H100 1.3e-4 to 2.9e-2 in the loss terms against 1.2e-6 over
        phase 8's 16 steps): the normalizer update on each side, then before each
        gradient step the CPU takes the card's parameters and Adam state, and
        the step's loss terms, its clipped gradients and the parameters after
        it are held to phase 8's bars, on the card's updated normalizer."""
        from track_mjx_tpu_torch.agent import checkpointing, running_statistics
        from track_mjx_tpu_torch.envs.base import map_tensors

        tc = cfg["train_setup"]["train_config"]
        lr = tc["learning_rate"]
        sides, n, mbs, passes = self.learning_sides(cfg, captured)
        card, cpu = sides[self.dev.type], sides["cpu"]
        assert not card["learner"].normalizer_after_sgd
        normalizers = {k: running_statistics.update(v["state"].normalizer_params, v["data"].observation)
                       for k, v in sides.items()}
        norm_err = max(_rel(getattr(normalizers[self.dev.type], k).cpu(), getattr(normalizers["cpu"], k))
                       for k in ("count", "mean", "summed_variance", "std"))
        normalizer_on_cpu = checkpointing.normalizer_from_dict(
            checkpointing.normalizer_to_dict(normalizers[self.dev.type]), "cpu")
        worst = {"loss": 0.0, "grad": 0.0, "param": 0.0}
        for u in range(passes):
            shuffled = {k: map_tensors(lambda x: x[v["draws"][u].permutation].reshape((mbs, -1) + x.shape[1:]),
                                       v["data"]) for k, v in sides.items()}
            for m in range(mbs):
                for sd, src in ((cpu["networks"].policy_network, card["networks"].policy_network),
                                (cpu["networks"].value_network, card["networks"].value_network)):
                    sd.load_state_dict(checkpointing.cpu_copy(src.state_dict()))
                cpu["learner"].optimizer.load_state_dict(checkpointing.cpu_copy(
                    card["learner"].optimizer.state_dict()))
                step = {}
                for k, side in sides.items():
                    normalizer = normalizers[k] if k != "cpu" else normalizer_on_cpu
                    mb = map_tensors(lambda x: x[m], shuffled[k])
                    _, aux = side["learner"].update_fn(normalizer, mb, *side["draws"][u].noises[m], 1)
                    nets = side["networks"]
                    step[k] = ({name: float(v.detach()) for name, v in aux.items()},
                               {name: p.grad.detach().cpu() for mod in (nets.policy_network, nets.value_network)
                                for name, p in mod.named_parameters() if p.grad is not None},
                               self._params(nets))
                (a_m, a_g, a_p), (b_m, b_g, b_p) = step[self.dev.type], step["cpu"]
                worst["loss"] = max(worst["loss"], max(abs(a_m[k] - b_m[k]) / max(1.0, abs(b_m[k])) for k in b_m))
                worst["grad"] = max(worst["grad"], max(
                    float((a_g[k] - g).abs().max() / g.abs().max().clamp(min=1e-30)) for k, g in b_g.items()))
                worst["param"] = max(worst["param"], max(float((a_p[k] - p).abs().max()) / lr for k, p in b_p.items()))
        print(f"{what}, the learning half card vs CPU step by step ({n} trajectories x {tc['unroll_length']} steps "
              f"of the last batch, {passes} passes x {mbs} minibatches, each step from the card's parameters and Adam "
              f"state, full width): loss terms worst rel err {worst['loss']:.3e} (bar {TRAIN_LOSS_REL:.0e}); clipped "
              f"gradients worst err relative to each tensor's largest element {worst['grad']:.3e} (bar "
              f"{TRAIN_GRAD_REL:.0e}); parameters after a step worst {worst['param']:.3e} lr (bar {TRAIN_PARAM_LR:.0e} "
              f"lr); normalizer update {norm_err:.3e} (bar {TRAIN_NORM_REL:.0e})")
        assert worst["loss"] < TRAIN_LOSS_REL, f"the card's loss terms disagree with the CPU's: {worst['loss']:.3e}"
        assert worst["grad"] < TRAIN_GRAD_REL, f"the card's gradients disagree with the CPU's: {worst['grad']:.3e}"
        assert worst["param"] < TRAIN_PARAM_LR, f"the card's parameters disagree with the CPU's: {worst['param']:.3e} lr"
        assert norm_err < TRAIN_NORM_REL, f"the card's normalizer disagrees with the CPU's: {norm_err:.3e}"

    # -----------------------------------------------------------------------
    # fly
    # -----------------------------------------------------------------------

    def ell_objective(self, inputs, x, nl):
        """Per-env objective of the elliptic solve in float64 of a fused
        solve's `inputs` (ell_cg_solve's or ell_cg_solve_dense's): 0.5 dx M
        dx with dx = x - qacc_smooth, plus the scalar rows' and cone blocks'
        costs at jar = J x - aref, the first nl rows scalar."""
        tk = self.tk
        f64 = {k: v.double() for k, v in inputs.items() if isinstance(v, torch.Tensor)}
        qm = tk.assemble_qm(f64["buf"], f64["cdof"], f64["anc"], f64["arm"])
        j = f64["J"] if "J" in f64 else tk.build_j_ell(f64["fq"], f64["sw"], f64["ll"], f64["dm"], f64["lim1h"])
        smooth = torch.linalg.solve(qm, f64["qfrc_smooth"][..., None])[..., 0]
        x = x.double()
        dx = x - smooth
        jar = (j @ x[..., None])[..., 0] - f64["aref"]
        bsz = x.shape[0]
        d = f64["D"]
        jar_s, u = jar[:, :nl], jar[:, nl:].reshape(bsz, -1, 3)
        cs = 0.5 * torch.where(jar_s < 0, d[:, :nl] * jar_s**2, torch.zeros_like(jar_s)).sum(1)
        p = -torch.sqrt(d[:, nl:].reshape(bsz, -1, 3)) * u
        t = torch.sqrt(torch.clamp(p[..., 1] ** 2 + p[..., 2] ** 2, min=1e-24))
        mu = f64["mu"]
        bottom, top = mu * p[..., 0] >= t, p[..., 0] <= -mu * t
        quad = 0.5 * (p * p).sum(-1)
        mid = quad - 0.5 * (t - mu * p[..., 0]) ** 2 / (1 + mu * mu)
        cb = torch.where(bottom, quad, torch.where(top, torch.zeros_like(quad), mid)).sum(1)
        return 0.5 * (dx * (qm @ dx[..., None])[..., 0]).sum(1) + cs + cb

    def gap_check(self, inputs, qacc, qacc_ref, nl, what):
        """Optimality gaps against a converged plain solve (60/15): the JAX
        package's objective-parity bound gap <= 2 gap_ref + 1e-3 |cost*| on
        all but GAP_SHARE of the envs, and the summed gap within GAP_SUM of
        the reference's. The mirrored count (the reference over the bound
        set by `qacc`) is printed beside it."""
        star = self.ell_plain(inputs, 60, 15)
        cost_star = self.ell_objective(inputs, star.qacc, nl)
        gap = self.ell_objective(inputs, qacc, nl) - cost_star
        gap_ref = self.ell_objective(inputs, qacc_ref, nl) - cost_star
        over = int((gap > 2.0 * gap_ref + 1e-3 * cost_star.abs()).sum())
        mirrored = int((gap_ref > 2.0 * gap + 1e-3 * cost_star.abs()).sum())
        ratio = float(gap.sum() / gap_ref.sum())
        allowed = max(1, int(GAP_SHARE * gap.numel()))
        print(f"{what}: envs over the gap bound {over} of {gap.numel()} (allowed {allowed}; "
              f"reference over the mirrored bound {mirrored}); summed gap / reference {ratio:.4f} "
              f"(bar {GAP_SUM})")
        assert over <= allowed, f"{what}: {over} envs over the optimality-gap bound"
        assert ratio <= GAP_SUM, f"{what}: summed optimality gap {ratio:.4f} x the reference's"

    def fly_states(self, plan, model, dense: bool = False):
        """Contact-rich fly solver inputs in the manner of
        tests/test_cg_kernel_parity.py: legs dropped into the floor, joints
        perturbed, random qvel, ctrl and warmstart; the last quarter are
        static drops warm-started at a converged plain solve, which puts cone
        blocks in the static-friction zone. With `dense`, ell_cg_solve_dense's
        inputs (a plan with condim-1 contacts)."""
        ts = self.ts
        n_static = N_ENVS // 4
        qpos = model.qpos0.expand(N_ENVS, plan.nq).clone()
        qpos[:, 2] -= self.uniform((N_ENVS,), 0.02, 0.12)
        qpos[:, 7:] += self.uniform((N_ENVS, plan.nq - 7), -0.10, 0.10)
        qvel = self.uniform((N_ENVS, plan.nv), -2.0, 2.0)
        ctrl = self.uniform((N_ENVS, plan.nu), -0.3, 0.3)
        warm = self.uniform((N_ENVS, plan.nv), -5.0, 5.0)
        s = slice(N_ENVS - n_static, N_ENVS)
        qpos[s] = model.qpos0
        qpos[s, 7:] += self.uniform((n_static, plan.nq - 7), -0.02, 0.02)
        qpos[s, 2] -= self.uniform((n_static,), 0.02, 0.04)
        qvel[s] = 0.0
        ctrl[s] = 0.0
        warm[s] = 0.0
        inputs = self.solver_inputs(plan, model, qpos, qvel, ctrl, warm,
                                    ts.ell_dense_solve_inputs if dense else ts.ell_solve_inputs)
        static = {k: (v[s] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == N_ENVS else v)
                  for k, v in inputs.items()}
        warm[s] = self.ell_plain(static, 60, 15).qacc
        inputs["warm"] = warm.contiguous()
        return inputs

    def ell_plain(self, inputs, its, ls, with_euler=True):
        """The plain version of the elliptic solve that takes `inputs`
        (ell_cg_solve's, or ell_cg_solve_dense's, which carry ns)."""
        tk = self.tk
        plain = tk.ell_cg_solve_dense_plain if "J" in inputs else tk.ell_cg_solve_plain
        return plain(**inputs, iterations=its, ls_iterations=ls, with_euler=with_euler)

    def fly(self) -> list:
        tk, tf, tm = self.tk, self.tf, self.tm
        plan, model = tm.put_model(tm.load_snapshot("fly-mc-intention"), device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        nl, nc = plan.nlimit, plan.ncon
        print(f"fly: nq={plan.nq} nv={plan.nv} nu={plan.nu} ncon={plan.ncon} (elliptic "
              f"{plan.ncon_ell}) nefc={plan.nefc} cg {its}/{ls} dt={float(model.opt_timestep)}")

        # kernel against plain
        inputs = self.fly_states(plan, model)
        before = tk.ell_cg_solve.launches
        kernel1 = tk.ell_cg_solve(**inputs, iterations=1, ls_iterations=0)
        torch.cuda.synchronize()
        assert tk.ell_cg_solve.launches == before + 1, "the wrapper did not launch the kernel"
        plain1 = tk.ell_cg_solve_plain(**inputs, iterations=1, ls_iterations=0)
        rich = float((plain1.efc_force != 0).any(dim=1).float().mean())
        print(f"{N_ENVS} fly states, share with active constraint rows {rich:.3f}")
        assert rich > 0.9, "states are not contact-rich"
        max_abs = 0.0
        for name, bar in FLY_KERNEL_REL.items():
            a, b = getattr(kernel1, name), getattr(plain1, name)
            assert torch.isfinite(a).all(), f"kernel {name} not finite"
            err = _rel(a, b)
            abs_err = float((a - b).abs().max())
            max_abs = max(max_abs, abs_err)
            per_env = _per_env(a, b)
            print(f"ell_cg_solve vs plain, 1 iteration, 1 Newton step, {name}: max rel err {err:.3e} (bar {bar:.0e}), "
                  f"max abs err {abs_err:.3e}, max |plain| {float(b.abs().max()):.3e}; per env "
                  f"median {float(per_env.median()):.3e} max {float(per_env.max()):.3e}")
            assert err < bar, f"kernel {name} disagrees with plain: {err:.3e} >= {bar:.0e}"

        kernel = tk.ell_cg_solve(**inputs, iterations=its, ls_iterations=ls)
        plain = tk.ell_cg_solve_plain(**inputs, iterations=its, ls_iterations=ls)
        err = _rel(kernel.qacc_smooth, plain.qacc_smooth)
        print(f"ell_cg_solve vs plain, {its}/{ls}: qacc_smooth max rel err {err:.3e} "
              f"(bar {FLY_KERNEL_REL['qacc_smooth']:.0e})")
        assert err < FLY_KERNEL_REL["qacc_smooth"], "kernel qacc_smooth disagrees with plain"
        for name in FLY_KERNEL_REL:
            assert torch.isfinite(getattr(kernel, name)).all(), f"kernel {name} not finite"
        self.gap_check(inputs, kernel.qacc, plain.qacc, nl, f"ell_cg_solve vs plain, {its}/{ls}")

        self.cg_kernel_info("ell_cg_solve", plan.nv, nl, nc)
        kernel_ms = _time_ms(lambda: tk.ell_cg_solve(**inputs, iterations=its, ls_iterations=ls), 20)
        plain_ms = _time_ms(lambda: tk.ell_cg_solve_plain(**inputs, iterations=its, ls_iterations=ls), 3)
        b_ms, b_by = bound_ms(tensor_bytes([*inputs.values(), *kernel]),
                              N_ENVS * solve_flops(plan.nv, nl, nc, 3, its, ls))
        print(f"ell_cg_solve at B={N_ENVS}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) ({self.card})")
        self.phase5 = inputs, kernel1, kernel  # the no-Euler mode is held on the same states (phase 11b)
        del plain, plain1

        # main path
        start, ctrls, after_warmup, _, launches = self.main_path(
            plan, model, {tk.ell_cg_solve: 1}, FLY_CONTROL_STEPS, FLY_CTRL_SCALE
        )
        self.fly_env_steps = self.last_env_steps
        self.fly_versus_cpu("fly", tm.load_snapshot("fly-mc-intention"), plan, model, start, ctrls, after_warmup)

        return [{
            "name": "ell_cg_solve",
            "route": "cuda",
            "source": "track_mjx_tpu_torch/csrc/ell_cg_solve.cu",
            "replaces": "track_mjx_tpu/ops/cg_solver_kernel.py:725",
            "launches": launches["ell_cg_solve"],
            "max_abs_err": max_abs,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the fused solve
        }]

    def fly_versus_cpu(self, what, snap, plan, model, start, ctrls, after_warmup, gate_solve: bool = True):
        """The warm-up control step of the first N_CPU envs and one substep
        after it, on the CPU in float32 and in float64 (`snap` put on the
        CPU): the card's per-env distance to float64 within FLY_VS_F64 times
        the float32 CPU's, on the median env (and the worst for
        qacc_smooth, which precedes the solve). Without `gate_solve` (phase
        11b) the distances of the substep's solve outputs are printed, not
        gated: after one substep they are bimodal (envs at rest near 1e-6,
        the knife edge's near 1e-2), and a median of 64 envs falls between
        the modes (on an NVIDIA H100 the card's median qacc at 0.3x to 19x
        the CPU's over seeds of phase 6's own path; PERF.md, Findings).
        Those paths' solves are held on 4096 contact-rich states instead
        (phase 11b's kernels against plain)."""
        cpu_plan, cpu_model, cpu = self.cpu_warmup(snap, start, ctrls[0], model=model)
        cpu64, sub64 = self.cpu_float64(cpu_plan, cpu_model, start, ctrls[0], after_warmup)
        for name in ("qpos", "qvel"):
            self.versus_f64(f"{what}, one control step", name, getattr(after_warmup, name)[:N_CPU],
                            getattr(cpu, name), getattr(cpu64, name), ("median",))
        _, card_sub, cpu_sub = self.one_substep(plan, model, cpu_plan, cpu_model, after_warmup)
        self.versus_f64(f"{what}, one substep", "qacc_smooth", card_sub.qacc_smooth, cpu_sub.qacc_smooth,
                        sub64.qacc_smooth, ("max",))
        names = ("qacc", "qacc_eff", "efc_force", "qvel") if self.ts.fused_euler(plan) else ("qacc", "efc_force",
                                                                                             "qvel")
        for name in names:
            self.versus_f64(f"{what}, one substep", name, getattr(card_sub, name), getattr(cpu_sub, name),
                            getattr(sub64, name), ("median",), gate=gate_solve)

    # -----------------------------------------------------------------------
    # rodent under the Newton solver
    # -----------------------------------------------------------------------

    def newton_matrices(self, plan, model):
        """The matrices the Newton path hands the standalone kernels, from
        N_ENVS contact-rich rodent states made with the port's stages: qM
        (cholesky), its factor and qfrc_smooth (cho_solve), M + h D with
        qfrc_smooth + qfrc_constraint (Euler's solve_spd) and the first
        Newton iteration's H with its gradient (Newton's solve_spd)."""
        ts = self.ts
        d, efc = self.solver_inputs(plan, model, *self.rodent_drop(plan, model), lambda p, m, d, e: (d, e))
        j = ts.dense_j(plan, d, efc)
        jar, _, grad = ts._cost_grad(d, efc, j, ts.newton_start(d, efc, j))
        rich = float((jar < 0).any(dim=1).float().mean())
        print(f"{N_ENVS} Newton states, share with active constraint rows at the start {rich:.3f}")
        assert rich > 0.9, "states are not contact-rich"
        solved = ts.solve(plan, model, d, efc)
        mh = d.qM + torch.diag_embed((model.opt_timestep * model.dof_damping).expand(N_ENVS, plan.nv))
        return {
            "qM": d.qM.contiguous(),
            "qLD": d.qLD,
            "qfrc_smooth": d.qfrc_smooth.contiguous(),
            "H": ts.newton_hessian(d.qM, j, efc.D, jar),
            "grad": grad,
            "M+hD": mh,
            "euler_rhs": (d.qfrc_smooth + solved.qfrc_constraint).contiguous(),
        }

    def tiled_kernel_info(self, n: int) -> None:
        """Registers, shared memory and resident CTAs per SM of the
        standalone kernels at n, as built: the tiled factor's (cholesky,
        solve_spd) and cho_solve's."""
        from track_mjx_tpu_torch.ops import kernel_lib

        lib = kernel_lib.load_library()
        for solve, name in enumerate(self.bl.TILED):
            info = (ctypes.c_int * 5)()
            err = lib.tiled_kernel_info(solve, n, info)
            assert err == 0, f"tiled_kernel_info({name}) failed with cudaError {err}"
            print(f"{name} kernel at n={n}: panel {info[4]}, {info[3]} threads per CTA (one env), "
                  f"{info[0]} registers per thread, {info[1]} B of shared memory per CTA, "
                  f"{info[2]} resident CTAs per SM ({self.card})")
        info = (ctypes.c_int * 4)()
        err = lib.cho_solve_kernel_info(n, info)
        assert err == 0, f"cho_solve_kernel_info failed with cudaError {err}"
        print(f"cho_solve kernel at n={n}: {info[3]} threads per CTA (one env), "
              f"{info[0]} registers per thread, {info[1]} B of shared memory per CTA, "
              f"{info[2]} resident CTAs per SM ({self.card})")

    def linalg_kernels(self, m) -> list:
        """Each standalone kernel against its plain version on the path's
        matrices and on a ragged batch of RAGGED envs, and with a NaN-filled
        strict upper triangle of its matrix, which must not change its
        output. Then kernel, plain and library call are
        timed on the same inputs, with the host's issue time per call and
        the kernel's device time from torch.profiler, which is the kernel's
        time where the host is the slower. Returns the kernels' records,
        launches still to be set."""
        bl = self.bl
        n = m["qM"].shape[-1]
        self.tiled_kernel_info(n)
        cases = {  # name: (wrapper, plain, library call, [(what, args)], flops per env, CUDA kernel)
            "cholesky": (bl.cholesky, bl.cholesky_plain, torch.linalg.cholesky_ex,
                         [("qM", (m["qM"],))], factor_flops(n), "tiled_kernel"),
            "cho_solve": (bl.cho_solve, bl.cho_solve_plain,
                          lambda l, b: torch.cholesky_solve(b[..., None], l),
                          [("qLD, qfrc_smooth", (m["qLD"], m["qfrc_smooth"]))], substitution_flops(n),
                          "cho_solve_kernel"),
            "solve_spd": (bl.solve_spd, bl.solve_spd_plain, torch.linalg.solve,
                          [("Newton H, grad", (m["H"], m["grad"])),
                           ("M + h D, qfrc_smooth + qfrc_constraint", (m["M+hD"], m["euler_rhs"]))],
                          factor_flops(n) + substitution_flops(n), "tiled_kernel"),
        }
        upper = torch.ones_like(m["qM"][0], dtype=torch.bool).triu(1)
        nan_upper = {"qM": m["qM"].masked_fill(upper, float("nan")),
                     "qLD": m["qLD"].masked_fill(upper, float("nan"))}
        records = []
        for name, (op, plain, library, inputs, flops, kernel_name) in cases.items():
            bar = LINALG_REL[name]
            max_abs = 0.0
            what0, args0 = inputs[0]
            ragged = (f"{what0}, first {RAGGED} envs", tuple(t[:RAGGED].contiguous() for t in args0))
            for what, args in [*inputs, ragged]:
                before = op.launches
                got = op(*args)
                torch.cuda.synchronize()
                assert op.launches == before + 1, f"{name}: the wrapper did not launch the kernel"
                want = plain(*args)
                assert torch.isfinite(got).all(), f"{name} not finite on {what}"
                err = _rel(got, want)
                abs_err = float((got - want).abs().max())
                max_abs = max(max_abs, abs_err)
                per_env = _per_env(got.flatten(1), want.flatten(1))
                print(f"{name} vs plain on {what}: max rel err {err:.3e} (bar {bar:.0e}), max abs err "
                      f"{abs_err:.3e}, max |plain| {float(want.abs().max()):.3e}; per env median "
                      f"{float(per_env.median()):.3e} max {float(per_env.max()):.3e}")
                assert err < bar, f"{name} disagrees with plain on {what}: {err:.3e} >= {bar:.0e}"
            args = args0
            mat = "qLD" if op is bl.cho_solve else "qM"
            clean, dirty = op(m[mat], *args[1:]), op(nan_upper[mat], *args[1:])
            torch.cuda.synchronize()
            assert torch.equal(clean, dirty), f"{name} read above the diagonal"
            print(f"{name} on {mat} with a NaN strict upper triangle: output bitwise equal to the clean input's")
            event_ms, host_ms = _times(lambda: op(*args), 20)
            device_ms = _profiled_ms(lambda: op(*args), 20, kernel_name)
            # the kernel's own time: the events', unless issuing a call takes
            # the host longer, when the events measure the host's rate
            kernel_ms = device_ms if host_ms >= event_ms else event_ms
            plain_ms = _time_ms(lambda: plain(*args), 3)
            library_ms = _time_ms(lambda: library(*args), 20)
            out = op(*args)
            # each kernel needs only the lower triangle of its matrix input;
            # cholesky writes its whole factor, upper zeros included
            b_ms, b_by = bound_ms(lower_triangle_bytes(args[0]) + tensor_bytes([*args[1:], out]), N_ENVS * flops)
            print(f"{name} at B={N_ENVS}, n={n} on {what0}: kernel {kernel_ms:.4f} ms (CUDA events "
                  f"{event_ms:.4f} ms, host issue {host_ms:.4f} ms per call, profiler device "
                  f"{device_ms:.4f} ms), plain {plain_ms:.3f} ms, library {library_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}); {100 * b_ms / kernel_ms:.1f}% of the bound, library / kernel "
                  f"{library_ms / kernel_ms:.2f}x ({self.card})")
            records.append({
                "name": name,
                "route": "cuda",
                "source": "track_mjx_tpu_torch/csrc/batched_linalg.cu",
                "replaces": REPLACES[name],
                "launches": None,
                "max_abs_err": max_abs,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": library_ms,
            })
        return records

    def newton_main_path(self):
        """Phase 7; returns what the standalone kernels' phase needs."""
        tk, tm, bl = self.tk, self.tm, self.bl
        snap = tm.load_snapshot("rodent-full-clips")
        snap.opt.solver = tm.SOLVER_NEWTON
        plan, model = tm.put_model(snap, device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        print(f"rodent, Newton: nv={plan.nv} nefc={plan.nefc} newton {its}/{ls} "
              f"dt={float(model.opt_timestep)}")

        # main path: per substep factor_m, solve_m, one Newton H solve per
        # iteration (all `iterations`, converged envs masked) and Euler's
        per_substep = {bl.cholesky: 1, bl.cho_solve: 1, bl.solve_spd: its + 1, tk.cg_solve: 0}
        start, ctrls, after_warmup, _, launches = self.main_path(
            plan, model, per_substep, NEWTON_CONTROL_STEPS, RODENT_CTRL_SCALE
        )
        self.versus_cpu("Newton: ", snap, plan, model, start, ctrls, after_warmup, NEWTON_STEP_REL,
                        NEWTON_SUBSTEP_REL)

        return plan, model, launches

    def newton_kernels(self, plan, model, launches) -> list:
        """Phase 12, last: the kernels' timings start torch.profiler, which
        no host-clock rate may run after."""
        records = self.linalg_kernels(self.newton_matrices(plan, model))
        for r in records:
            r["launches"] = launches[r["name"]]
        return records

    # -----------------------------------------------------------------------
    # the rest of the physics (phase 11)
    # -----------------------------------------------------------------------

    def fused_kernel_vs_plain(self, op, plain, inputs, what, its, ls, with_euler, gate: bool, bars=KERNEL_REL,
                              hold_f64: bool = True):
        """One launch of `op` against `plain` on `inputs`, in float32 and in
        float64. Every output is held, with `gate`, within `bars` of the
        float32 plain version's, and always by the float64 rule: over the
        batch, and per env on the worst and the median env (KERNEL_VS_F64).
        Returns the kernel's outputs and the largest absolute error against
        the float32 plain version."""
        before = op.launches
        kernel = op(**inputs, with_euler=with_euler, iterations=its, ls_iterations=ls)
        torch.cuda.synchronize()
        assert op.launches == before + 1, f"{op.__name__}: the wrapper did not launch the kernel"
        steps = dict(with_euler=with_euler, iterations=its, ls_iterations=ls)
        want = plain(**inputs, **steps)
        exact = plain(**{k: (v.double() if isinstance(v, torch.Tensor) else v) for k, v in inputs.items()}, **steps)
        torch.cuda.synchronize()
        max_abs = 0.0
        for name, bar in bars.items():
            a, b, c = getattr(kernel, name), getattr(want, name), getattr(exact, name)
            if name == "qacc_eff" and not with_euler:
                assert a is None and b is None, "qacc_eff without the Euler solve"
                continue
            assert torch.isfinite(a).all(), f"{op.__name__} {name} not finite"
            err, abs_err = _rel(a, b), float((a - b).abs().max())
            e_kernel, e_plain = _rel(a.double(), c), _rel(b.double(), c)
            held = _f64_stats(_per_env(a.double(), c), _per_env(b.double(), c), ("max", "median"),
                              KERNEL_VS_F64, KERNEL_F64_FLOOR)
            max_abs = max(max_abs, abs_err)
            print(f"{op.__name__} (with_euler={with_euler}) vs plain on {what} {name}: max rel err {err:.3e} "
                  f"({'within' if err < bar else 'over'} its bar {bar:.0e}{'' if gate else ', not gated here'}), "
                  f"max abs err {abs_err:.3e}; against float64 plain: kernel {e_kernel:.3e}, float32 plain "
                  f"{e_plain:.3e}; per env, kernel / float32 plain / bar: "
                  + ", ".join(f"{stat} {k:.3e} / {p:.3e} / {bb:.3e}" for stat, (k, p, bb) in held.items()))
            if gate:
                assert err < bar, f"{op.__name__} {name} disagrees with plain: {err:.3e} >= {bar:.0e}"
            if not hold_f64:  # printed only
                continue
            assert e_kernel <= KERNEL_VS_F64 * e_plain + KERNEL_F64_FLOOR, (
                f"{op.__name__} {name}: {e_kernel:.3e} from float64, over {KERNEL_VS_F64} x {e_plain:.3e}")
            for stat, (k, p, bb) in held.items():
                assert k <= bb, f"{op.__name__} {name}: {stat} env {k:.3e} from float64, over {bb:.3e}"
        return kernel, max_abs

    def time_fused(self, op, plain, inputs, its, ls, with_euler, nbytes, flops):
        kernel_ms = _time_ms(lambda: op(**inputs, with_euler=with_euler, iterations=its, ls_iterations=ls), 20)
        plain_ms = _time_ms(lambda: plain(**inputs, with_euler=with_euler, iterations=its, ls_iterations=ls), 3)
        b_ms, b_by = bound_ms(nbytes, N_ENVS * flops)
        print(f"{op.__name__} (with_euler={with_euler}) at B={N_ENVS}: kernel {kernel_ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / kernel_ms:.1f}% of the bound "
              f"({self.card})")
        return kernel_ms, plain_ms, b_ms, b_by

    def no_euler_kernel(self) -> dict:
        """The compact cg_solve without the Euler solve (RK4 and implicit
        plans) against its plain version: on phase 2's states, within
        KERNEL_REL, its outputs bitwise those of phase 2's launch with the
        Euler solve; on a second draw of contact-rich rodent states by the
        float64 rule."""
        tk, tm = self.tk, self.tm
        plan, model = tm.put_model(tm.load_snapshot("rodent-full-clips"), device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        inputs, with_euler = self.phase2
        del self.phase2
        bare, max_abs = self.fused_kernel_vs_plain(tk.cg_solve, tk.cg_solve_plain, inputs, "phase 2's states",
                                                   its, ls, False, gate=True)
        for name in ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint"):
            assert torch.equal(getattr(bare, name), getattr(with_euler, name)), (
                f"cg_solve without the Euler solve: {name} is not phase 2's")
        print("cg_solve (with_euler=False) on phase 2's states: qacc_smooth, qacc, efc_force and qfrc_constraint "
              "bitwise those of phase 2's launch with the Euler solve")
        del bare, with_euler
        inputs = self.rodent_states(plan, model)
        max_abs = max(max_abs, self.fused_kernel_vs_plain(tk.cg_solve, tk.cg_solve_plain, inputs,
                                                          "a second draw of rodent states", its, ls, False,
                                                          gate=False)[1])
        nc, nl = inputs["fq"].shape[1], inputs["lim1h"].shape[0]
        out = tk.cg_solve(**inputs, with_euler=False, iterations=its, ls_iterations=ls)
        nbytes = tensor_bytes([v for k, v in inputs.items() if k != "hd"] + [t for t in out if t is not None])
        ms, plain_ms, b_ms, b_by = self.time_fused(
            tk.cg_solve, tk.cg_solve_plain, inputs, its, ls, False, nbytes,
            solve_flops(plan.nv, nl, nc, 4, its, ls, with_euler=False))
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs}

    def dense_kernel(self, plan, model) -> dict:
        """cg_solve_dense against its plain version on contact-rich states of
        the rodent with mixed condims, with and without the Euler solve;
        timed, with its bound (the dense J counted as B x nefc x nv x 4 bytes
        of input)."""
        tk, ts = self.tk, self.ts
        its, ls = plan.iterations, plan.ls_iterations
        qpos, qvel, ctrl, warm = self.rodent_drop(plan, model)
        d, efc = self.solver_inputs(plan, model, qpos, qvel, ctrl, warm, lambda p, m, d, e: (d, e))
        inputs = ts.dense_solve_inputs(plan, model, d, efc)
        e = inputs["J"].shape[1]
        rich = float(efc.active_row.any(dim=1).float().mean())
        slots = {c: int((plan.contact_condim == c).sum()) for c in (1, 4, 6)}
        active = {c: int((d.contact_dist[:, torch.as_tensor(plan.contact_condim == c, device=self.dev)] < 0).sum())
                  for c in (1, 4, 6)}
        print(f"{N_ENVS} mixed-condim states: nefc {e}, contact slots by condim {slots}, active contacts by "
              f"condim {active}, share with active rows {rich:.3f}")
        assert rich > 0.9 and min(active.values()) > 0, "states are not contact-rich in every condim"
        max_abs = max(self.fused_kernel_vs_plain(tk.cg_solve_dense, tk.cg_solve_dense_plain, inputs,
                                                 "mixed-condim states", its, ls, we, gate=True)[1]
                      for we in (True, False))
        info = (ctypes.c_int * 4)()
        from track_mjx_tpu_torch.ops import kernel_lib

        lib = kernel_lib.load_library()
        err = lib.cg_solve_dense_kernel_info(plan.nv, e, info)
        assert err == 0, f"cg_solve_dense_kernel_info failed with cudaError {err}"
        panels = (ctypes.c_int * 3)()
        assert lib.cg_solve_dense_panels(plan.nv, e, panels) == 0
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"cg_solve_dense kernel at n={plan.nv}, e={e}: {info[3]} threads per CTA (one env), {info[0]} "
              f"registers per thread, {info[1]} B of shared memory per CTA, {info[2]} resident CTAs per SM, "
              f"{-(-N_ENVS // (info[2] * sms))} waves of {N_ENVS} envs on {sms} SMs; J walked in {panels[1]} panels "
              f"of at most {panels[0]} rows{' (copied once)' if panels[2] else ''} ({self.card})")
        times = {}
        for we in (True, False):
            out = tk.cg_solve_dense(**inputs, with_euler=we, iterations=its, ls_iterations=ls)
            used = [v for k, v in inputs.items() if we or k != "hd"]
            times[we] = self.time_fused(tk.cg_solve_dense, tk.cg_solve_dense_plain, inputs, its, ls, we,
                                        tensor_bytes(used + [t for t in out if t is not None]),
                                        solve_flops(plan.nv, 0, 0, 4, its, ls, dense_rows=e, with_euler=we))
        ms, plain_ms, b_ms, b_by = times[True]
        return {
            "name": "cg_solve_dense",
            "route": "cuda",
            "source": "track_mjx_tpu_torch/csrc/cg_solve.cu",
            "replaces": "track_mjx_tpu/ops/cg_solver_kernel.py:176",
            "launches": None,
            "max_abs_err": max_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the fused solve
            "no_euler": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), times[False])),
        }

    def no_plain_calls(self):
        """Replaces each kernel's plain version by a counting call of itself;
        returns the counts and a function that restores them."""
        mods = [(self.tk, n) for n in ("cg_solve_plain", "cg_solve_dense_plain", "ell_cg_solve_plain",
                                       "ell_cg_solve_dense_plain")]
        mods += [(self.bl, n) for n in ("cholesky_plain", "cho_solve_plain", "solve_spd_plain")]
        calls = {n: 0 for _, n in mods}
        saved = [(m, n, getattr(m, n)) for m, n in mods]

        def counting(n, fn):
            def call(*args, **kwargs):
                calls[n] += 1
                return fn(*args, **kwargs)
            return call

        for m, n, fn in saved:
            setattr(m, n, counting(n, fn))

        def restore():
            for m, n, fn in saved:
                setattr(m, n, fn)
        return calls, restore

    def variant(self, what, snap, per_substep, substep_rel, check=None, data_of=None, contacts=True,
                f64=False, control_steps=REST_CONTROL_STEPS, ctrl_scale=RODENT_CTRL_SCALE):
        """One path of phase 11 at N_ENVS envs: 1 warm-up and `control_steps`
        timed control steps with exact launches and no plain version, from
        main_path's start or `data_of(plan, model)`; `check` on the plan and
        final state, then N_CPU envs against the CPU (phase 3's bars
        `substep_rel`; None: phase 6's against float64, the substep's solve
        outputs printed only). Returns
        (env-steps/s, None without timed steps; launches by wrapper)."""
        tm = self.tm
        t0 = time.perf_counter()
        plan, model = tm.put_model(snap, device=self.dev)
        print(f"{what}: nv={plan.nv} nefc={plan.nefc} ne={plan.ne} nf={plan.nf} nlimit={plan.nlimit} "
              f"ncon={plan.ncon} integrator={plan.integrator} solver={plan.solver} "
              f"{plan.iterations}/{plan.ls_iterations}")
        calls, restore = self.no_plain_calls()
        try:
            start, ctrls, after_warmup, data, launches = self.main_path(
                plan, model, per_substep, control_steps, ctrl_scale,
                data=None if data_of is None else data_of(plan, model), contacts=contacts)
        finally:
            restore()
        assert not any(calls.values()), f"{what}: a plain version ran on the card: {calls}"
        if check is not None:
            check(plan, data)
        rate = self.last_env_steps
        t1 = time.perf_counter()
        if substep_rel is None:
            self.fly_versus_cpu(what, snap, plan, model, start, ctrls, after_warmup, gate_solve=False)
        else:
            self.versus_cpu(f"{what}: ", snap, plan, model, start, ctrls, after_warmup, STEP_REL, substep_rel, f64,
                            qpos_by_f64=what in QPOS_BY_F64)
        print(f"{what}: {t1 - t0:.1f} s on the card, {time.perf_counter() - t1:.1f} s against the CPU")
        return rate, launches

    def dropped_start(self, plan, model):
        """main_path's start with the root RK4_DROP lower."""
        data = self.tm.make_data(plan, model, N_ENVS)
        qpos = data.qpos.clone()
        qpos[:, 7:] += self.uniform((N_ENVS, plan.nq - 7), -0.001, 0.001)
        qpos[:, 2] -= RK4_DROP
        return data.replace(qpos=qpos)

    def probe_start(self, plan, model):
        """Probe states as tests/test_equality.py draws them: qpos0 +
        U(-0.05, 0.05), quaternions normalized, qvel U(-0.3, 0.3)."""
        tm = self.tm
        data = tm.make_data(plan, model, N_ENVS)
        qpos = data.qpos + self.uniform((N_ENVS, plan.nq), -0.05, 0.05)
        for j in np.nonzero((plan.jnt_type == tm.JNT_BALL) | (plan.jnt_type == tm.JNT_FREE))[0]:
            a = int(plan.jnt_qposadr[j]) + (3 if plan.jnt_type[j] == tm.JNT_FREE else 0)
            qpos[:, a : a + 4] = qpos[:, a : a + 4] / qpos[:, a : a + 4].norm(dim=1, keepdim=True)
        return data.replace(qpos=qpos, qvel=self.uniform((N_ENVS, plan.nv), -0.3, 0.3))

    def per_substep(self, **counts):
        """Launches per substep of every kernel wrapper: `counts` by name, 0
        for the others."""
        tk, bl = self.tk, self.bl
        wrappers = (tk.cg_solve, tk.cg_solve_dense, tk.ell_cg_solve, tk.ell_cg_solve_dense, bl.cholesky,
                    bl.cho_solve, bl.solve_spd)
        return {op: counts.get(op.__name__, 0) for op in wrappers}

    def check_frictionloss(self, plan, data):
        floss = torch.as_tensor(FRICTIONLOSS, device=self.dev)
        force = data.efc_force[:, plan.ne : plan.ne + plan.nf].abs()
        clamped = float((force >= floss * (1 - 1e-6)).float().mean())
        print(f"frictionloss {FRICTIONLOSS} on {plan.nf} hinge dofs: at the last control step {clamped:.4f} of "
              f"the rows clamped at +-frictionloss, {1 - clamped:.4f} in the quadratic zone")
        assert 0 < clamped < 1, "the frictionloss rows must sit in both zones"

    def rest_of_physics(self) -> tuple[dict, dict, dict]:
        """Phase 11; returns the dense kernel's record, the no-Euler mode's
        numbers and the launches of every path by wrapper name."""
        tk, tm, bl = self.tk, self.tm, self.bl
        no_euler = self.no_euler_kernel()
        mplan, mmodel = tm.put_model(mixed_condim(tm.load_snapshot("rodent-full-clips")), device=self.dev)
        dense = self.dense_kernel(mplan, mmodel)
        del mplan, mmodel

        per = self.per_substep
        def rodent(integrator=None):
            snap = tm.load_snapshot("rodent-full-clips")
            if integrator is not None:
                snap.opt.integrator = integrator
            if integrator == tm.INT_RK4:
                snap.opt.timestep = RK4_TIMESTEP
            return snap

        def check_mixed(plan, data):
            active = {c: int((data.contact_dist[:, torch.as_tensor(plan.contact_condim == c, device=self.dev)] < 0)
                             .sum()) for c in (1, 4, 6)}
            print(f"mixed condims: contact slots by condim "
                  f"{ {c: int((plan.contact_condim == c).sum()) for c in (1, 4, 6)} }, nefc {plan.nefc}, active "
                  f"contacts by condim at the last control step {active}")
            assert min(active.values()) > 0, "a condim has no active contact"

        its = 5
        paths = {
            "rodent RK4": (rodent(tm.INT_RK4), per(cg_solve=4), REST_SUBSTEP_REL, None),
            "rodent implicitfast": (rodent(tm.INT_IMPLICITFAST), per(cg_solve=1, solve_spd=1), REST_SUBSTEP_REL,
                                    None),
            "rodent implicit": (rodent(tm.INT_IMPLICIT), per(cg_solve=1), REST_SUBSTEP_REL, None),
            "rodent mixed condims": (mixed_condim(rodent()), per(cg_solve_dense=1), SUBSTEP_REL, check_mixed),
            "rodent frictionloss": (with_frictionloss(rodent(), FRICTIONLOSS),
                                    per(cholesky=1, cho_solve=2 + its, solve_spd=1), REST_SUBSTEP_REL,
                                    self.check_frictionloss),
        }
        rates, launches = {}, {}
        for what, (snap, per_substep, substep_rel, check) in paths.items():
            assert snap.opt.iterations == its
            rates[what], launches[what] = self.variant(
                what, snap, per_substep, substep_rel, check,
                data_of=self.dropped_start if what == "rodent RK4" else None,
                f64=what in F64_PATHS)
        for name in PROBES:
            snap = tm.load_snapshot("probe-" + name)
            what = f"probe {name}"
            rates[what], launches[what] = self.variant(
                what, snap, per(cholesky=1, cho_solve=2 + snap.opt.iterations, solve_spd=1), REST_SUBSTEP_REL,
                data_of=self.probe_start, contacts=False, control_steps=0)
        for what, rate in rates.items():
            if rate is None:
                continue
            print(f"{what}: {rate:.1f} env-steps/s against the Euler rodent's {self.physics_env_steps:.1f} "
                  f"(phase 3), {rate / self.physics_env_steps:.3f}x ({self.card})")
        return dense, no_euler, launches


    # -----------------------------------------------------------------------
    # the fly's remainder (phase 11b): elliptic plans off the compact layout
    # -----------------------------------------------------------------------

    def ell_no_euler_kernel(self) -> dict:
        """The compact ell_cg_solve without the Euler solve (the fly on RK4 and
        the implicit integrators) on phase 5's states: at 1/0 within
        FLY_KERNEL_REL and by the float64 rule, its four outputs at 1/0 and
        at 4/4 bitwise phase 5's launches with the Euler solve; timed."""
        tk, tm = self.tk, self.tm
        plan, _ = tm.put_model(tm.load_snapshot("fly-mc-intention"), device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        inputs, euler1, euler = self.phase5
        del self.phase5
        bare1, max_abs = self.fused_kernel_vs_plain(tk.ell_cg_solve, tk.ell_cg_solve_plain, inputs,
                                                    "phase 5's fly states at 1/0", 1, 0, False, gate=True,
                                                    bars=FLY_KERNEL_REL)
        bare = tk.ell_cg_solve(**inputs, with_euler=False, iterations=its, ls_iterations=ls)
        for name in ("qacc_smooth", "qacc", "efc_force", "qfrc_constraint"):
            for got, want, cfg in ((bare1, euler1, "1/0"), (bare, euler, f"{its}/{ls}")):
                assert torch.equal(getattr(got, name), getattr(want, name)), (
                    f"ell_cg_solve without the Euler solve at {cfg}: {name} is not phase 5's")
        print(f"ell_cg_solve (with_euler=False) on phase 5's states at 1/0 and {its}/{ls}: qacc_smooth, qacc, "
              "efc_force and qfrc_constraint bitwise those of phase 5's launches with the Euler solve")
        nl, nc = inputs["lim1h"].shape[0], inputs["fq"].shape[1]
        nbytes = tensor_bytes([v for k, v in inputs.items() if k != "hd"] + [t for t in bare if t is not None])
        ms, plain_ms, b_ms, b_by = self.time_fused(
            tk.ell_cg_solve, tk.ell_cg_solve_plain, inputs, its, ls, False, nbytes,
            solve_flops(plan.nv, nl, nc, 3, its, ls, with_euler=False))
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs}

    def ell_dense_kernel(self, plan, model) -> dict:
        """ell_cg_solve_dense against its plain version on 4096 contact-rich
        states of the fly with a condim-1 leg (fly_states), with and without
        the Euler solve: at 1/0 within FLY_KERNEL_REL and by the float64
        rule, at 4/4 by the optimality gap; registers, shared memory and
        CTAs per SM; timed, with its bound (the dense J counted as B x nefc x
        nv x 4 bytes of input)."""
        tk, tm = self.tk, self.tm
        from track_mjx_tpu_torch.ops import kernel_lib

        its, ls = plan.iterations, plan.ls_iterations
        inputs = self.fly_states(plan, model, dense=True)
        ns, e = inputs["ns"], inputs["J"].shape[1]
        nc = (e - ns) // 3
        cd1 = inputs["J"][:, plan.nlimit : ns].abs().sum(-1) > 0  # a condim-1 row is zero unless active
        print(f"{N_ENVS} fly condim-1 states: nefc {e} (ns {ns}, {nc} cone blocks), condim-1 rows {ns - plan.nlimit},"
              f" active on {int(cd1.any(dim=1).sum())} envs")
        assert bool(cd1.any()), "no condim-1 row is active"
        max_abs = 0.0
        for we in (True, False):
            max_abs = max(max_abs, self.fused_kernel_vs_plain(
                tk.ell_cg_solve_dense, tk.ell_cg_solve_dense_plain, inputs, "fly condim-1 states at 1/0", 1, 0, we,
                gate=True, bars=FLY_KERNEL_REL)[1])
        kernel = tk.ell_cg_solve_dense(**inputs, with_euler=True, iterations=its, ls_iterations=ls)
        plain = self.ell_plain(inputs, its, ls)
        for name in FLY_KERNEL_REL:
            assert torch.isfinite(getattr(kernel, name)).all(), f"ell_cg_solve_dense {name} not finite"
        err = _rel(kernel.qacc_smooth, plain.qacc_smooth)
        assert err < FLY_KERNEL_REL["qacc_smooth"], f"ell_cg_solve_dense qacc_smooth disagrees with plain: {err:.3e}"
        self.gap_check(inputs, kernel.qacc, plain.qacc, ns, f"ell_cg_solve_dense vs plain, {its}/{ls}")
        del plain
        info = (ctypes.c_int * 4)()
        lib = kernel_lib.load_library()
        err = lib.ell_cg_solve_dense_kernel_info(plan.nv, ns, nc, info)
        assert err == 0, f"ell_cg_solve_dense_kernel_info failed with cudaError {err}"
        panels = (ctypes.c_int * 3)()
        assert lib.ell_cg_solve_dense_panels(plan.nv, ns, nc, panels) == 0
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        print(f"ell_cg_solve_dense kernel at n={plan.nv}, ns={ns}, nc={nc}: {info[3]} threads per CTA (one env), "
              f"{info[0]} registers per thread, {info[1]} B of shared memory per CTA, {info[2]} resident CTAs per "
              f"SM, {-(-N_ENVS // (info[2] * sms))} waves of {N_ENVS} envs on {sms} SMs; J walked in {panels[1]} "
              f"panels of at most {panels[0]} rows{' (copied once)' if panels[2] else ''} ({self.card})")
        times = {}
        for we in (True, False):
            out = tk.ell_cg_solve_dense(**inputs, with_euler=we, iterations=its, ls_iterations=ls)
            used = [v for k, v in inputs.items() if isinstance(v, torch.Tensor) and (we or k != "hd")]
            times[we] = self.time_fused(tk.ell_cg_solve_dense, tk.ell_cg_solve_dense_plain, inputs, its, ls, we,
                                        tensor_bytes(used + [t for t in out if t is not None]),
                                        solve_flops(plan.nv, ns, nc, 3, its, ls, dense_rows=e, with_euler=we))
        ms, plain_ms, b_ms, b_by = times[True]
        return {
            "name": "ell_cg_solve_dense",
            "route": "cuda",
            "source": "track_mjx_tpu_torch/csrc/ell_cg_solve.cu",
            "replaces": "track_mjx_tpu/ops/cg_solver_kernel.py:758",
            "launches": None,
            "max_abs_err": max_abs,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the fused solve
            "no_euler": dict(zip(("ms", "plain_ms", "bound_ms", "bound_by"), times[False])),
        }

    def fly_remainder(self) -> tuple[dict, dict, dict]:
        """Phase 11b; returns ell_cg_solve_dense's record, the no-Euler
        ell_cg_solve's numbers and the launches of every path by wrapper
        name."""
        tm = self.tm
        no_euler = self.ell_no_euler_kernel()
        plan, model = tm.put_model(fly_condim1(tm.load_snapshot("fly-mc-intention")), device=self.dev)
        dense = self.ell_dense_kernel(plan, model)
        del plan, model
        per = self.per_substep

        def fly(edit=None):
            snap = tm.load_snapshot("fly-mc-intention")
            return snap if edit is None else edit(snap)

        def rk4(snap):
            snap.opt.integrator = tm.INT_RK4
            return snap

        def check_condim1(plan, data):
            cd1 = torch.as_tensor(plan.contact_condim == 1, device=self.dev)
            active = int((data.contact_dist[:, cd1] < 0).sum())
            print(f"fly condim 1: nefc {plan.nefc} (ns {plan.nefc - 3 * plan.ncon_ell}, {plan.ncon_ell} cone blocks),"
                  f" active condim-1 contacts at the last control step {active} of {N_ENVS} x {int(cd1.sum())} slots")
            assert active > 0, "no condim-1 contact is active"

        def check_frictionloss(plan, data):
            assert plan.nf == plan.nv - 6 and plan.ncon_ell == plan.ncon
            self.check_frictionloss(plan, data)

        its = 4
        paths = {
            "fly condim 1": (fly(fly_condim1), per(ell_cg_solve_dense=1), check_condim1),
            "fly RK4": (fly(rk4), per(ell_cg_solve=4), None),
            "fly frictionloss": (fly(lambda s: with_frictionloss(s, FRICTIONLOSS)),
                                 per(cholesky=1, cho_solve=2 + its, solve_spd=1), check_frictionloss),
        }
        rates, launches = {}, {}
        for what, (snap, per_substep, check) in paths.items():
            assert snap.opt.iterations == its
            rates[what], launches[what] = self.variant(what, snap, per_substep, None, check,
                                                       ctrl_scale=FLY_CTRL_SCALE)
        for what, rate in rates.items():
            print(f"{what}: {rate:.1f} env-steps/s against the fly's {self.fly_env_steps:.1f} (phase 6), "
                  f"{rate / self.fly_env_steps:.3f}x ({self.card})")
        return dense, no_euler, launches


    # -----------------------------------------------------------------------
    # rodent-sps-per-actor (phase 11c): the third workload config
    # -----------------------------------------------------------------------

    def sps_kernel(self, plan, model, state) -> dict:
        """cg_solve at the config's batch and CG iterations on the solver
        inputs of the physics path's last state (`state`, in contact),
        against its plain version within KERNEL_REL and by the float64 rule
        (fused_kernel_vs_plain); then on as many dropped rodent states
        (rodent_drop, phase 2's recipe), printed only: two float32 solves of
        such a draw at 4/4 part by more than KERNEL_REL (qacc 6.6e-5 and
        2.5e-4 on two draws of 8192, the second 3.1x the float32 plain
        version's distance from float64, PERF.md); registers, shared memory,
        CTAs per SM and waves; timed on the path's inputs beside the plain
        version and the bound."""
        tk, tm = self.tk, self.tm
        n_envs = state.qpos.shape[0]
        its, ls = plan.iterations, plan.ls_iterations
        d = tm.make_data(plan, model, n_envs).replace(
            **{k: getattr(state, k) for k in ("qpos", "qvel", "act", "ctrl", "qacc_warmstart")})
        inputs = self.ts.solve_inputs(plan, model, *self.pre_solve(plan, model, d))
        kernel, max_abs = self.fused_kernel_vs_plain(tk.cg_solve, tk.cg_solve_plain, inputs,
                                                     f"the {n_envs} {SPS_CONFIG} path states", its, ls, True,
                                                     gate=True)
        rich = float((kernel.efc_force != 0).any(dim=1).float().mean())
        print(f"{SPS_CONFIG}: {n_envs} path states, share with active constraint rows {rich:.3f}, active contacts/env "
              f"{float((state.contact_dist < 0).sum()) / n_envs:.2f}")
        assert rich > 0.9, "states are not contact-rich"
        dropped = self.rodent_states(plan, model, n_envs)
        self.fused_kernel_vs_plain(tk.cg_solve, tk.cg_solve_plain, dropped, f"{n_envs} dropped {SPS_CONFIG} states",
                                   its, ls, True, gate=False, hold_f64=False)
        del dropped
        nc, nl = inputs["fq"].shape[1], inputs["lim1h"].shape[0]
        self.cg_kernel_info("cg_solve", plan.nv, nl, nc, n_envs)
        kernel_ms = _time_ms(lambda: tk.cg_solve(**inputs, iterations=its, ls_iterations=ls), 20)
        plain_ms = _time_ms(lambda: tk.cg_solve_plain(**inputs, iterations=its, ls_iterations=ls), 3)
        b_ms, b_by = bound_ms(tensor_bytes([*inputs.values(), *kernel]),
                              n_envs * solve_flops(plan.nv, nl, nc, 4, its, ls))
        print(f"{SPS_CONFIG}: cg_solve at B={n_envs}, {its}/{ls}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / kernel_ms:.1f}% of the bound ({self.card})")
        return {"envs": n_envs, "iterations": its, "ls_iterations": ls, "ms": kernel_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs}

    def sps_randomized(self, snap, plan, model, settled, substeps) -> int:
        """One control step with geom_friction and dof_damping randomized per
        env (the stages broadcast them; K2 takes per-env mu and damping),
        from the physics path's last state (`settled`, SlimData, in
        contact): exact launches and no plain version; then one substep from
        that state on N_CPU envs, card against CPU on the same leaves within
        SUBSTEP_REL, as phase 3 holds a substep. Envs 0 and 1 share their
        state, controls and damping and differ in friction only, and must
        differ in qacc."""
        tf, tm, tk = self.tf, self.tm, self.tk
        n_envs = settled.qpos.shape[0]
        frictions = model.geom_friction * self.uniform((n_envs, 1, 1), *SPS_RANDOM_SCALE)
        dampings = model.dof_damping * self.uniform((n_envs, 1), *SPS_RANDOM_SCALE)
        dampings[1] = dampings[0]
        model_v = dataclasses.replace(model, geom_friction=frictions, dof_damping=dampings)
        fields = {k: getattr(settled, k).clone() for k in ("time", "qpos", "qvel", "act", "qacc_warmstart")}
        fields["ctrl"] = RODENT_CTRL_SCALE * self.uniform((n_envs, plan.nu), -1.0, 1.0)
        for t in fields.values():
            t[1] = t[0]
        start = tm.make_data(plan, model_v, n_envs).replace(**fields)
        calls, restore = self.no_plain_calls()
        tk.cg_solve.launches = 0
        try:
            out = tf.n_step(plan, model_v, start, substeps)
            torch.cuda.synchronize()
            launches = tk.cg_solve.launches
            card_sub = tf.step(plan, model_v, start)  # the substep held against the CPU, not counted
        finally:
            restore()
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        assert launches == substeps, f"cg_solve launched {launches} times, expected {substeps}"
        for name in ("qpos", "qvel", "qacc", "efc_force"):
            assert torch.isfinite(getattr(out, name)).all(), f"{name} is not finite"
        gap = float((out.qacc[0] - out.qacc[1]).abs().max())
        print(f"{SPS_CONFIG}, randomized: {n_envs} envs, geom friction and dof damping x U{SPS_RANDOM_SCALE} per "
              f"env, one control step from the path's last state, cg_solve launches {launches}; envs 0 and 1 "
              f"(frictions x {float(frictions[0, 0, 0] / model.geom_friction[0, 0]):.3f} and "
              f"{float(frictions[1, 0, 0] / model.geom_friction[0, 0]):.3f}, all else equal) part in qacc by "
              f"{gap:.3e}; active contacts/env {float((out.contact_dist < 0).sum()) / n_envs:.2f}")
        assert gap > 1e-3, "the friction did not reach the solve"
        cpu_plan, cpu_model = tm.put_model(snap, device="cpu")
        cpu_model = dataclasses.replace(cpu_model, geom_friction=frictions[:N_CPU].cpu(),
                                        dof_damping=dampings[:N_CPU].cpu())
        cpu_sub = tf.step(cpu_plan, cpu_model, tm.make_data(cpu_plan, cpu_model, N_CPU).replace(
            **{k: v[:N_CPU].cpu() for k, v in fields.items()}))
        for name, bar in SUBSTEP_REL.items():
            worst = float(_per_env(getattr(card_sub, name)[:N_CPU].cpu(), getattr(cpu_sub, name)).max())
            print(f"{SPS_CONFIG}, randomized: card vs CPU, one substep, {N_CPU} envs with their own leaves, {name}: "
                  f"per-env rel err max {worst:.3e} (bar {bar:.0e})")
            assert worst < bar, f"card and CPU {name} differ after one randomized substep: {worst:.3e}"
        return launches

    def sps_freeze(self, run_dir) -> int:
        """One epoch with freeze_decoder from the training run's checkpoint
        through train.main: a new run whose decoder is the checkpoint's bit
        for bit and whose encoder moved; returns cg_solve's launches."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.agent import checkpointing, network_masks
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        root = os.path.dirname(os.path.dirname(run_dir))
        cfg = load_config(SPS_CONFIG, [
            f"device={self.dev.type}",
            f"data_path={os.path.join(root, 'clips.npz')}",
            f"logging_config.model_path={os.path.join(root, 'transfer')}",
            *SPS_FREEZE_CUTS,
            f"train_setup.checkpoint_to_restore={run_dir}",
            "train_setup.freeze_decoder=true",
        ])
        tk.cg_solve.launches = 0
        t0 = time.perf_counter()
        _, (_, policy) = ttrain.main(cfg, policy_params_fn=no_logging)
        torch.cuda.synchronize()
        launches = tk.cg_solve.launches
        _, source = checkpointing.CheckpointStore(run_dir).policy(device=self.dev)  # the state dict on the CPU
        policy = {k: v.cpu() for k, v in policy.items()}
        decoder = [k for k in policy if network_masks.is_decoder(k)]
        encoder = [k for k in policy if ".encoder." in f".{k}"]
        same = all(torch.equal(policy[k], source[k]) for k in decoder)
        moved = max(float((policy[k] - source[k]).abs().max()) for k in encoder)
        runs = run_dirs(os.path.join(root, "transfer"))
        print(f"{SPS_CONFIG}, freeze_decoder: one training step and one eval in {time.perf_counter() - t0:.1f} s, "
              f"cg_solve launches {launches}, new run {runs}; the {len(decoder)} decoder tensors bitwise the "
              f"checkpoint's: {same}; the encoder moved by up to {moved:.3e}")
        assert same and len(runs) == 1, "the frozen decoder changed"
        assert moved > 0, "the encoder did not train"
        return launches

    def sps_bf16(self, run_dir, n_envs, substeps) -> int:
        """One unroll of the rollout with the trained policy in bf16
        (rollout_bf16's policy): exact launches, finite transitions, float32
        master parameters; its actions on the unroll's first observations
        against the float32 policy's with the same noise."""
        from track_mjx_tpu_torch import rollout as trollout
        from track_mjx_tpu_torch.agent import acting, checkpointing, types
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks

        tk = self.tk
        ro = trollout.make_rollout(SPS_CONFIG, seed=SEED, device=self.dev)
        normalizer, params = checkpointing.CheckpointStore(run_dir).policy(device=self.dev)
        ro.networks.policy_network.load_state_dict(params)
        bf16 = ppo_networks.make_inference_fn(ro.networks)(normalizer, compute_dtype=torch.bfloat16)
        f32 = ppo_networks.make_inference_fn(ro.networks)(normalizer)
        calls, restore = self.no_plain_calls()
        tk.cg_solve.launches = 0
        try:
            state = ro.env.reset(self.gen, n_envs)
            t0 = time.perf_counter()
            _, data = acting.generate_unroll(ro.env, state, bf16, self.gen, ro.unroll_length)
            torch.cuda.synchronize()
            unroll_s = time.perf_counter() - t0
        finally:
            restore()
        launches = tk.cg_solve.launches
        expected = 1 + ro.unroll_length * substeps
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        assert launches == expected, f"cg_solve launched {launches} times, expected {expected}"
        for name in ("observation", "action", "reward", "discount"):
            assert torch.isfinite(getattr(data, name)).all(), f"transition {name} is not finite"
        assert all(p.dtype == torch.float32 for p in ro.networks.policy_network.parameters())
        obs = data.observation[0]
        noise = types.PolicyNoise(torch.randn(n_envs, ro.networks.policy_network.module.encoder.fc2_mean.out_features,
                                              generator=self.gen, device=self.dev),
                                  torch.randn(n_envs, ro.tracking.action_size, generator=self.gen, device=self.dev))
        gap = (bf16(obs, noise)[0] - f32(obs, noise)[0]).abs()
        print(f"{SPS_CONFIG}, rollout_bf16: reset + one unroll of {ro.unroll_length} steps x {n_envs} envs in "
              f"{unroll_s:.1f} s, cg_solve launches {launches} (1 + {ro.unroll_length} x {substeps}); every "
              f"Transition field finite; master parameters float32; bf16 against float32 actions on the same "
              f"observations and noise: max {float(gap.max()):.4f} (bar {BF16_ACTION_MAX}), mean "
              f"{float(gap.mean()):.5f} (bar {BF16_ACTION_MEAN})")
        assert float(gap.max()) < BF16_ACTION_MAX and float(gap.mean()) < BF16_ACTION_MEAN
        assert float(gap.max()) > 0, "the bf16 policy computed in float32"
        return launches

    def sps_foreign(self) -> None:
        """The point-mass foreign env (track_mjx_tpu_torch.testing) trains
        one epoch on the card through wrap_external: finite losses and
        parameters, and no physics kernel launched."""
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo, ppo_networks
        from track_mjx_tpu_torch.testing import PointMassEnv
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        tk.cg_solve.launches = 0
        t0 = time.perf_counter()
        _, (normalizer, policy), metrics = ppo.train(
            environment=PointMassEnv(self.dev), num_timesteps=SPS_FOREIGN_ENVS * 20 * 4, episode_length=50,
            num_envs=SPS_FOREIGN_ENVS, batch_size=SPS_FOREIGN_ENVS, num_minibatches=4, unroll_length=20,
            num_updates_per_batch=4, num_evals=2, num_eval_envs=128, normalize_observations=True,
            network_factory=ppo_networks.network_factory(load_config(SPS_CONFIG).network_config), device=self.dev)
        losses = {k: v for k, v in metrics.items() if k.startswith("training/") and k.endswith("loss")}
        print(f"point-mass foreign env through wrap_external: one epoch at {SPS_FOREIGN_ENVS} envs in "
              f"{time.perf_counter() - t0:.1f} s, training sps {metrics['training/sps']:.1f}, eval episode reward "
              f"{metrics['eval/episode_reward']:.3f}, losses {json.dumps(losses)}")
        assert len(losses) == 5 and all(math.isfinite(v) for v in losses.values()), losses
        assert all(torch.isfinite(v).all() for v in policy.values()) and torch.isfinite(normalizer.mean).all()
        assert tk.cg_solve.launches == 0

    def sps_per_actor(self) -> tuple[dict, dict]:
        """Phase 11c; returns K2's record at this config's shape and the
        launches of each of its paths."""
        from track_mjx_tpu_torch.utils.config import load_config

        tk, tm, tf = self.tk, self.tm, self.tf
        t_start = time.perf_counter()
        cfg = load_config(SPS_CONFIG)
        n_envs = cfg.train_setup.train_config.num_envs
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        snap = tm.load_snapshot(SPS_CONFIG)
        plan, model = tm.put_model(snap, device=self.dev)
        print(f"{SPS_CONFIG}: nq={plan.nq} nv={plan.nv} nu={plan.nu} na={plan.na} ncon={plan.ncon} nefc={plan.nefc} "
              f"cg {plan.iterations}/{plan.ls_iterations}, {substeps} substeps, {n_envs} envs; actuators gain "
              f"{sorted(set(plan.actuator_gaintype.tolist()))} bias {sorted(set(plan.actuator_biastype.tolist()))} "
              f"dyn {sorted(set(plan.actuator_dyntype.tolist()))}")
        launches = {}
        calls, restore = self.no_plain_calls()
        try:
            start, ctrls, after_warmup, final, counts = self.main_path(
                plan, model, {tk.cg_solve: 1}, SPS_CONTROL_STEPS, RODENT_CTRL_SCALE, n_envs=n_envs, substeps=substeps)
        finally:
            restore()
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        launches["rodent-sps-per-actor control steps (phase 11c)"] = counts["cg_solve"]
        rate = self.last_env_steps
        self.versus_cpu(f"{SPS_CONFIG}: ", snap, plan, model, start, ctrls, after_warmup, STEP_REL, SUBSTEP_REL,
                        substeps=substeps)
        print(f"{SPS_CONFIG}: {rate:.1f} env-steps/s at {n_envs} envs x {substeps} substeps against phase 3's "
              f"{self.physics_env_steps:.1f} at {N_ENVS} x {SUBSTEPS}, {rate / self.physics_env_steps:.3f}x "
              f"({self.card})")
        del start, ctrls, after_warmup
        record = self.sps_kernel(plan, model, final)
        settled = tf.slim_data(final)
        del final
        torch.cuda.empty_cache()

        launches["rodent-sps-per-actor training, train.main (phase 11c)"] = self.training(
            SPS_CONFIG, what=f"{SPS_CONFIG} training", phase="11c", cuts=SPS_CUTS, step_by_step=True)
        run_dir, _ = self.train_run
        launches["rodent-sps-per-actor freeze_decoder, train.main (phase 11c)"] = self.sps_freeze(run_dir)
        launches["rodent-sps-per-actor rollout_bf16 unroll (phase 11c)"] = self.sps_bf16(run_dir, n_envs, substeps)
        launches["rodent-sps-per-actor randomized control step (phase 11c)"] = self.sps_randomized(
            snap, plan, model, settled, substeps)
        self.sps_foreign()
        torch.cuda.empty_cache()
        print(f"phase 11c: {time.perf_counter() - t_start:.1f} s ({self.card})")
        return record, launches

    # -----------------------------------------------------------------------
    # phase 13: the CLI's run management and per-eval logging
    # -----------------------------------------------------------------------

    def run_logging(self) -> dict:
        """train.main on rodent-full-clips at the config's widths (LOG_*
        cuts): a first run stopped after its first checkpoint leaves its
        run-state record, a second run of the same config resumes it (same
        run directory, a later step, the record removed), logs to
        metrics.jsonl and renders the logging rollout's ghost video; the
        LSTM and fly logging rollouts; K2 and K3 at B = 1 against their
        plain versions on those rollouts' states. Returns the kernels' B = 1
        records and launches."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.agent import checkpointing, preemption
        from track_mjx_tpu_torch.agent import wandb_logging as wl
        from track_mjx_tpu_torch.io import load
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        phase_t0 = time.perf_counter()
        root = os.path.join(REPO, "build", "chip_smoke_logging")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        clips = synthesize_clips(self.tm.load_snapshot("rodent-full-clips"), n_clips=LOG_CLIPS,
                                 n_frames=LOG_CLIP_LENGTH, mocap_hz=50, seed=SEED, device=self.dev)
        load.save_npz(clips, os.path.join(root, "clips.npz"))
        cfg = load_config("rodent-full-clips", log_overrides(self.dev.type, root))
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        net = cfg.network_config
        assert (net.encoder_layer_sizes, net.decoder_layer_sizes, net.critic_layer_sizes,
                net.intention_size) == TRAIN_WIDTHS["rodent-full-clips"]

        # the logging rollouts and the videos, as train.main's hook runs them
        rollouts, videos = [], []
        collect, write, ghost = wl.collect_rollout, wl.write_video, wl.render_ghost_video

        def counted_collect(*args, **kwargs):
            torch.cuda.synchronize()
            before, t0 = tk.cg_solve.launches, time.perf_counter()
            trace = collect(*args, **kwargs)
            torch.cuda.synchronize()
            rollouts.append({"s": time.perf_counter() - t0, "launches": tk.cg_solve.launches - before,
                             "steps": trace.latent_means.shape[0]})
            return trace

        def timed_ghost(*args, **kwargs):
            t0 = time.perf_counter()
            path = ghost(*args, **kwargs)
            videos[-1]["s"] = time.perf_counter() - t0
            return path

        def kept_write(frames, path_stem, fps):
            path = write(frames, path_stem, fps)
            videos.append({"shape": tuple(frames.shape), "dtype": str(frames.dtype), "min": int(frames.min()),
                           "max": int(frames.max()), "path": path})
            return path

        old_job = os.environ.get("SLURM_JOB_ID")
        os.environ["SLURM_JOB_ID"] = LOG_JOB
        wl.collect_rollout, wl.write_video, wl.render_ghost_video = counted_collect, kept_write, timed_ghost
        try:
            record = preemption.RunStateStore(cfg).path
            make_callback = preemption.RunStateStore.checkpoint_callback

            def preempting(store, *args):
                update = make_callback(store, *args)

                def on_checkpoint(step):
                    update(step)
                    raise Preempted

                return on_checkpoint

            tk.cg_solve.launches = 0
            t0 = time.perf_counter()
            preemption.RunStateStore.checkpoint_callback = preempting
            try:
                ttrain.main(cfg)
                raise AssertionError("the first run was not stopped")
            except Preempted:
                pass
            finally:
                preemption.RunStateStore.checkpoint_callback = make_callback
            first_s, first_launches = time.perf_counter() - t0, tk.cg_solve.launches
            kept = json.loads(open(record).read())
            (run_dir,) = run_dirs(os.path.join(root, "ckpts"))
            run_dir = os.path.join(root, "ckpts", run_dir)
            steps = sorted(checkpointing.committed_steps(run_dir))
            print(f"logging: first run stopped after its first checkpoint in {first_s:.1f} s (cg_solve launches "
                  f"{first_launches}); record {os.path.basename(record)} kept with latest_checkpoint_step "
                  f"{kept.get('latest_checkpoint_step')} (written by checkpoint_callback), run {kept['run_id']}, "
                  f"steps {steps}")
            assert kept.get("latest_checkpoint_step") == 0 and steps == [0] and not rollouts
            assert first_launches == 1 + 1 + (LOG_CLIP_LENGTH - 10) * substeps, "the first run went past its eval"
            assert kept["checkpoint_path"] == os.path.realpath(run_dir)

            seen = []
            tk.cg_solve.launches = 0
            t0 = time.perf_counter()
            ttrain.main(cfg, progress_fn=lambda s, m: seen.append(record.exists()))
            torch.cuda.synchronize()
            second_s, launches = time.perf_counter() - t0, tk.cg_solve.launches
        finally:
            wl.collect_rollout, wl.write_video, wl.render_ghost_video = collect, write, ghost
            if old_job is None:
                os.environ.pop("SLURM_JOB_ID", None)
            else:
                os.environ["SLURM_JOB_ID"] = old_job

        steps = sorted(checkpointing.committed_steps(run_dir))
        print(f"logging: second run (the first resumed) in {second_s:.1f} s: record there at each progress report "
              f"{seen}, after the run {record.exists()}; runs {run_dirs(os.path.join(root, 'ckpts'))}, steps {steps}")
        assert seen and all(seen) and not record.exists(), "the run-state record was not kept during the run"
        assert run_dirs(os.path.join(root, "ckpts")) == [os.path.basename(run_dir)] and steps == [0, 1]

        # K2 launches: the trainer's own (reset, one unroll, the reset after
        # the epoch, 2 evals) and one logging rollout (reset + a control step
        # per frame)
        episode = LOG_CLIP_LENGTH - 5 - 5
        trainer = 1 + 20 * substeps + 1 + 2 * (1 + episode * substeps)
        per_rollout = 1 + LOG_CLIP_LENGTH * substeps
        print(f"logging: cg_solve launches {launches} = trainer {trainer} + logging rollouts "
              f"{[r['launches'] for r in rollouts]} (expected {per_rollout} each: 1 + {LOG_CLIP_LENGTH} x {substeps})")
        assert len(rollouts) == 1 and rollouts[0]["launches"] == per_rollout and rollouts[0]["steps"] == LOG_CLIP_LENGTH
        assert launches == trainer + per_rollout, f"cg_solve launched {launches}, expected {trainer + per_rollout}"

        (metrics_path,) = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "ckpts", "wandb_local"))
                           for f in fs if f == "metrics.jsonl"]
        lines = [json.loads(x) for x in open(metrics_path)]
        keys = set().union(*lines)
        latents = sorted(k for k in keys if k.startswith("latents/"))
        last = lines[-1]
        print(f"logging: {metrics_path} holds {len(lines)} lines (both runs, one wandb run "
              f"{os.path.basename(os.path.dirname(metrics_path))}); last eval/episode_reward "
              f"{last.get('eval/episode_reward')}, {len(latents)} latents/* keys, latents/nonfinite_frames "
              f"{last.get('latents/nonfinite_frames')}, eval/rollout_pos_reward {last.get('eval/rollout_pos_reward')}")
        assert os.path.basename(os.path.dirname(metrics_path)) == kept["wandb_run_id"]
        assert "eval/episode_reward" in keys and "eval/rollout_pos_reward" in keys
        assert len(latents) == 1 + 4 * net.intention_size

        (video,) = videos
        frames = (LOG_CLIP_LENGTH, *LOG_FRAME, 3)
        print(f"logging: video {video['path']}: frames {video['shape']} {video['dtype']}, values "
              f"{video['min']}-{video['max']}; rendered and written in {video['s']:.2f} s")
        assert os.path.exists(video["path"]) and os.path.dirname(video["path"]) == run_dir
        assert video["shape"] == frames and video["min"] < video["max"], f"the video is not {LOG_CLIP_LENGTH} non-constant frames"
        assert last["videos/rollout"]["path"] == video["path"]

        step_ms = 1e3 * rollouts[0]["s"] / LOG_CLIP_LENGTH
        frame_ms = 1e3 * video["s"] / LOG_CLIP_LENGTH

        # the LSTM and fly logging rollouts, and K2 and K3 at B = 1 on their states
        lstm_launches, lstm_state, lstm_plan = self.other_logging_rollout("rodent-full-clips", clips, LSTM_OVERRIDES)
        fly_launches, fly_state, fly_plan = self.other_logging_rollout("fly-mc-intention", None, [])
        k2 = self.kernel_at_one_env(tk.cg_solve, tk.cg_solve_plain, lstm_plan, lstm_state, "solve_inputs", 4,
                                    "the rodent LSTM logging rollout's last state", KERNEL_REL, None)
        k3 = self.kernel_at_one_env(tk.ell_cg_solve, tk.ell_cg_solve_plain, fly_plan, fly_state, "ell_solve_inputs",
                                    3, "the fly logging rollout's last state", FLY_KERNEL_REL, (1, 0))
        seconds = time.perf_counter() - phase_t0
        ref_steps = 250  # rodent-full-clips' clip_length: the reference run's logging rollout
        print(f"logging: {step_ms:.1f} ms per logging control step at B = 1 (host clock, policy and env included) "
              f"against {self.rollout_step_ms:.1f} ms per rollout control step at B = {N_ENVS} (phase 4, this run); "
              f"{frame_ms:.1f} ms per rendered 512 x 512 frame (playback kinematics on the card, rasterization "
              f"and the file on the host); at the reference clip of {ref_steps} frames an eval gains "
              f"{ref_steps * step_ms / 1e3:.1f} s of logging rollout and, every render_interval evals, "
              f"{ref_steps * frame_ms / 1e3:.1f} s of video (extrapolated from {LOG_CLIP_LENGTH} frames); "
              f"phase {seconds:.1f} s ({self.card})")
        return {
            "cg_solve": {**k2, "launches_by_path": {
                "rodent logging rollout, train.main (phase 13)": rollouts[0]["launches"],
                "rodent training with logging, both runs of train.main (phase 13)": first_launches + launches,
                "rodent LSTM logging rollout (phase 13)": lstm_launches}},
            "ell_cg_solve": {**k3, "launches_by_path": {"fly logging rollout (phase 13)": fly_launches}},
            "logging": {"ms_per_control_step_b1": step_ms, "rollout_ms_per_control_step_b4096": self.rollout_step_ms,
                        "ms_per_frame": frame_ms, "seconds": seconds},
        }

    def other_logging_rollout(self, config: str, clips, extra) -> tuple:
        """LOG_OTHER_STEPS control steps of a logging rollout (the render
        wrapper, the config's full-width networks, deterministic) through
        wandb_logging.collect_rollout, and one frame of it rendered; returns
        the path's fused solve's launches, the last state's Data and (plan,
        model)."""
        from track_mjx_tpu_torch import workload
        from track_mjx_tpu_torch.agent import running_statistics
        from track_mjx_tpu_torch.agent import wandb_logging as wl
        from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as lstm_networks
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as mlp_networks
        from track_mjx_tpu_torch.analysis import render
        from track_mjx_tpu_torch.envs import wrappers
        from track_mjx_tpu_torch.envs.base import Wrapper
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        cfg = load_config(config, [f"device={self.dev.type}", *extra])
        lstm = bool(cfg.train_setup.train_config.get("use_lstm", False))
        if clips is None:
            clips = synthesize_clips(self.tm.load_snapshot(config), n_clips=2, n_frames=LOG_CLIP_LENGTH,
                                     mocap_hz=cfg.env_config.env_args.mocap_hz, seed=SEED, device=self.dev)
        env = workload.make_env(cfg, clips, device=self.dev)
        pn = lstm_networks if lstm else mlp_networks
        networks = pn.network_factory(cfg.network_config, torch.Generator().manual_seed(SEED))(
            env.observation_size, env.reference_obs_size, env.action_size,
            preprocess_observations_fn=running_statistics.normalize, device=self.dev)
        policy = pn.make_inference_fn(networks)(running_statistics.init_state(env.observation_size, self.dev),
                                                deterministic=True)
        if lstm:
            rw = wrappers.RenderRolloutWrapperTrackingLSTM(env, lstm_features=cfg.network_config.hidden_state_size,
                                                           hidden_layer_num=cfg.network_config.hidden_layer_num)
        else:
            rw = wrappers.RenderRolloutWrapperMulticlipTracking(env)

        class Keep(Wrapper):
            """Keeps the last step's Data (the kernels' B = 1 inputs)."""

            def reset(self, rng):
                return self.env.reset(rng)

            def step(self, state, action):
                state = self.env.step(state, action)
                self.last = state.pipeline_state
                return state

        kept = Keep(rw)
        op = tk.ell_cg_solve if config == "fly-mc-intention" else tk.cg_solve
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        torch.cuda.synchronize()
        op.launches, t0 = 0, time.perf_counter()
        trace = wl.collect_rollout(kept, cfg, policy, torch.Generator(device=self.dev).manual_seed(SEED),
                                   steps=LOG_OTHER_STEPS)
        torch.cuda.synchronize()
        rollout_s, launches = time.perf_counter() - t0, op.launches
        renderer = render.make_rollout_renderer(cfg, self.dev)
        qref = wl.reference_qpos(rw, trace.info)
        t0 = time.perf_counter()
        frame = renderer.render(torch.cat([trace.qpos[-1:], qref[LOG_OTHER_STEPS:LOG_OTHER_STEPS + 1]], dim=-1),
                                cfg.env_config.render_camera_name)
        frame_s = time.perf_counter() - t0
        expected = 1 + LOG_OTHER_STEPS * substeps
        what = f"{config}{' LSTM' if lstm else ''}"
        print(f"logging: {what} logging rollout of {LOG_OTHER_STEPS} control steps at B = 1 in {rollout_s:.2f} s "
              f"({1e3 * rollout_s / LOG_OTHER_STEPS:.1f} ms a step), {op.__name__} launches {launches} (expected "
              f"1 + {LOG_OTHER_STEPS} x {substeps}), latents finite {bool(torch.isfinite(trace.latent_means).all())}; "
              f"one frame {frame.shape} from {cfg.env_config.render_camera_name} in {1e3 * frame_s:.1f} ms, "
              f"{int((frame != 255).any(-1).sum())} pixels drawn")
        assert launches == expected, f"{op.__name__} launched {launches} times, expected {expected}"
        assert trace.latent_means.shape[0] == LOG_OTHER_STEPS and torch.isfinite(trace.latent_means).all()
        assert frame.shape == (1, *LOG_FRAME, 3) and (frame != 255).any(), "the frame is empty"
        return launches, kept.last, (env.plan, env.model)

    def kernel_at_one_env(self, op, plain, plan_model, data, inputs_of, rows_per_con, what, bars, gate_its) -> dict:
        """`op` at B = 1 on a logging rollout's state against its plain
        version (at `gate_its` iterations and linesearch steps, or the
        plan's), within `bars` and by the float64 rule; timed beside the
        plain version, with the bound of one env's work."""
        plan, model = plan_model
        its, ls = plan.iterations, plan.ls_iterations
        inputs = self.solver_inputs(plan, model, data.qpos, data.qvel, data.ctrl, data.qacc_warmstart,
                                    getattr(self.ts, inputs_of))
        g_its, g_ls = gate_its or (its, ls)
        out, max_abs = self.fused_kernel_vs_plain(op, plain, inputs, f"{what} (B = 1, {g_its}/{g_ls})", g_its, g_ls,
                                                  True, gate=True, bars=bars)
        active = int((out.efc_force != 0).sum())
        out = op(**inputs, iterations=its, ls_iterations=ls)
        nl, nc = inputs["lim1h"].shape[0], inputs["fq"].shape[1]
        ms = _time_ms(lambda: op(**inputs, iterations=its, ls_iterations=ls), 50)
        plain_ms = _time_ms(lambda: plain(**inputs, iterations=its, ls_iterations=ls), 5)
        b_ms, b_by = bound_ms(tensor_bytes([*inputs.values(), *[t for t in out if t is not None]]),
                              solve_flops(plan.nv, nl, nc, rows_per_con, its, ls))
        print(f"{op.__name__} at B = 1 on {what}: {active} active rows; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}) at {its}/{ls}: one CTA on one of "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, so the kernel's latency, not the "
              f"card's bandwidth or rate, sets its time ({self.card})")
        return {"b1": {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs}}

    def analysis_config(self, cfg, root: str, name: str, n_clips: int, n_frames: int, snapshot) -> dict:
        """A copy of `cfg` (a checkpoint's config) pointed at `n_clips`
        synthetic clips of `n_frames` frames of `snapshot`'s walker, written
        to <root>/<name>.npz, with the NaN guard's flag among the rollout
        metrics."""
        from track_mjx_tpu_torch.io import load
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips

        cfg = json.loads(json.dumps(cfg))
        clips = synthesize_clips(snapshot, n_clips=n_clips, n_frames=n_frames,
                                 mocap_hz=cfg["env_config"]["env_args"]["mocap_hz"], seed=SEED, device=self.dev)
        cfg["data_path"] = os.path.join(root, f"{name}.npz")
        load.save_npz(clips, cfg["data_path"])
        cfg["reference_config"]["clip_length"] = n_frames
        metrics = cfg["logging_config"].get("rollout_metrics", [])
        cfg["logging_config"]["rollout_metrics"] = [*metrics, *(["nan"] if "nan" not in metrics else [])]
        return cfg

    def analysis_rollout(self, what: str, cfg, env, policy, n: int, model: str = "mlp") -> tuple:
        """create_rollout_generator's rollout of `n` clips with every channel
        logged; checks the JAX tests' shapes (tests/test_analysis.py:54-83)
        and that every channel is finite up to the state at which the NaN
        guard first flags its env (the rollout steps on past it, as the JAX
        one does). Returns (outputs, seconds, the valid states [n, steps]:
        those before each env's first flagged one)."""
        from track_mjx_tpu_torch.analysis import rollout as arollout

        gen = arollout.create_rollout_generator(cfg, env, policy, model=model, log_activations=True, log_metrics=True,
                                                log_sensor_data=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen(torch.arange(n, device=self.dev), seed=SEED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        steps = int(cfg["reference_config"]["clip_length"] * env._steps_for_cur_frame)
        p = env.plan
        ref_steps = env._clip_frames * int(env._steps_for_cur_frame)  # the whole clip's, as in JAX
        shapes = {"qposes_rollout": (n, steps, p.nq), "qposes_ref": (n, ref_steps, p.nq), "ctrl": (n, steps - 1, p.nu),
                  "state_rewards": (n, steps), "joint_forces": (n, steps - 1, p.nbody, 6),
                  "sensor_readings": (n, steps - 1, p.nsensordata)}
        got = {k: tuple(out[k].shape) for k in shapes}
        assert got == shapes, f"{what}: shapes {got}, expected {shapes}"
        names = cfg["logging_config"]["rollout_metrics"]
        assert sorted(out["rollout_metrics"]) == sorted(f"{k}s" for k in names)
        assert all(v.shape == (n, steps) for v in out["rollout_metrics"].values())
        taps = {}

        def leaves(tree, path):
            if isinstance(tree, torch.Tensor):
                taps[path] = tree
            elif isinstance(tree, dict):
                for k, v in tree.items():
                    leaves(v, f"{path}/{k}")
            else:
                for i, v in enumerate(tree):
                    leaves(v, f"{path}/{i}")

        leaves(out["activations"], "activations")
        assert all(t.shape[:2] == (n, steps - 1) for t in taps.values()), {k: t.shape for k, t in taps.items()}
        # states before each env's first flagged one; a transition is valid
        # where the state it ends in is
        valid = torch.cumsum(out["rollout_metrics"]["nans"] > 0, dim=1) == 0
        per_state = {"qposes_rollout": out["qposes_rollout"], "state_rewards": out["state_rewards"],
                     **{f"rollout_metrics/{k}": v for k, v in out["rollout_metrics"].items()}}
        per_step = {k: out[k] for k in ("ctrl", "joint_forces", "sensor_readings")} | taps
        bad = sorted([k for k, v in per_state.items() if not torch.isfinite(v[valid]).all()]
                     + [k for k, v in per_step.items() if not torch.isfinite(v[valid[:, 1:]]).all()])
        flagged = ~valid[:, -1]
        first = (~valid).float().argmax(1)[flagged]
        print(f"analysis: {what}: {n} clips x {steps - 1} control steps in {seconds:.1f} s; shapes {got}; activation "
              f"taps {sorted(taps)}; envs flagged by the NaN guard {int(flagged.sum())} (first flagged at control "
              f"steps {sorted(first.tolist())[:8]}...; {float(valid.float().mean()):.3f} of the states before "
              f"it); channels non-finite before an env's first flag {bad}")
        assert not bad, f"{what}: non-finite {bad} before the NaN guard flagged the env"
        return out, seconds, valid

    def analysis(self) -> dict:
        """Phase 14 (module docstring): the analysis path from phase 8's,
        9's and 10's checkpoints; returns the fused solves' launches on its
        paths and its times."""
        from track_mjx_tpu_torch import workload
        from track_mjx_tpu_torch.agent import checkpointing, running_statistics
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as mlp_networks
        from track_mjx_tpu_torch.analysis import rollout as arollout
        from track_mjx_tpu_torch.envs import wrappers
        from track_mjx_tpu_torch.envs.base import Wrapper
        from track_mjx_tpu_torch.physics import postconstraint
        from track_mjx_tpu_torch.utils.config import load_config

        tk, tm, bl = self.tk, self.tm, self.bl
        ops = (tk.cg_solve, tk.ell_cg_solve, tk.cg_solve_dense, tk.ell_cg_solve_dense, bl.cholesky, bl.cho_solve,
               bl.solve_spd)

        def counts():
            return {op.__name__: op.launches for op in ops if op.launches}

        def zero():
            for op in ops:
                op.launches = 0

        phase_t0 = time.perf_counter()
        root = os.path.join(REPO, "build", "chip_smoke_analysis")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        launches = {"cg_solve": {}, "ell_cg_solve": {}}

        # the rodent at full width over ANALYSIS_CLIPS clips, phase 8's checkpoint
        run_dir = self.train_runs["8"][0]
        bundle = checkpointing.load_checkpoint_for_eval(run_dir, device=self.dev)
        cfg = self.analysis_config(bundle["cfg"], root, "rodent", ANALYSIS_CLIPS, ANALYSIS_FRAMES,
                                   tm.load_snapshot(workload.snapshot_name(bundle["cfg"])))
        env = arollout.create_environment(cfg, device=self.dev)
        substeps = cfg["env_config"]["env_args"]["physics_steps_per_control_step"]
        policy = checkpointing.load_inference_fn(cfg, bundle["policy"], get_activation=True, device=self.dev)
        cfrc = postconstraint.cfrc_ext
        seen = {"pen": [], "forced": [], "hit": [], "d64": []}
        contact_rows = env.plan.ne + env.plan.nf + len(env.plan.limited_jnt_ids)  # the efc rows before the contacts'

        def kept_cfrc(plan, model, data):  # per step: contacts in and with force, a nonzero wrench, Data
            out = cfrc(plan, model, data)
            seen["data"] = data
            seen["pen"].append((data.contact_dist < 0).any(1))
            seen["forced"].append(data.efc_force[:, contact_rows:].abs().amax(1) > 0)
            seen["hit"].append(out.abs().flatten(1).amax(1) > 0)
            seen["d64"].append(dataclasses.replace(
                data, **{f.name: getattr(data, f.name)[:ANALYSIS_CPU] for f in dataclasses.fields(data)}))
            return out

        steps = ANALYSIS_FRAMES * int(env._steps_for_cur_frame) - 1
        zero()
        postconstraint.cfrc_ext = kept_cfrc
        try:
            out, rollout_s, valid = self.analysis_rollout("rodent (phase 8's checkpoint)", cfg, env, policy,
                                                          ANALYSIS_CLIPS)
        finally:
            postconstraint.cfrc_ext = cfrc
        expected = 1 + steps * substeps
        got = counts()
        print(f"analysis: rodent launches {got}, expected cg_solve 1 (reset) + {steps} x {substeps} = {expected}")
        assert got == {"cg_solve": expected}, got
        launches["cg_solve"][f"rodent analysis rollout, {ANALYSIS_CLIPS} clips (phase 14)"] = expected
        ok = valid[:, 1:]  # the steps that end before the env's first flag
        pen, forced, hit = (torch.stack(seen[k], 1) & ok for k in ("pen", "forced", "hit"))
        print(f"analysis: before their first flag, {int(forced.any(1).sum())} of {ANALYSIS_CLIPS} envs had contact "
              f"rows with force ({int(forced.sum())} of {int(ok.sum())} env steps) and a nonzero contact wrench in "
              f"each of those steps: {bool(torch.equal(forced, hit))}; a penetrating contact in {int(pen.sum())} env "
              f"steps ({int((pen & ~forced).sum())} of them with no force: separating); max |wrench| "
              f"{float(out['joint_forces'][ok].abs().max()):.4f}")
        assert forced.any() and torch.equal(forced, hit), "the contact forces of an env step gave no wrench, or no force one"

        # cfrc_ext on the card against the CPU's on the same Data: the last
        # step at which the first envs are all unflagged
        first_ok = ok[:ANALYSIS_CPU]
        t_cmp = max([t for t in range(steps) if first_ok[:, t].all()] or [0])
        d64 = seen["d64"][t_cmp]
        keep = first_ok[:, t_cmp]
        card_w = cfrc(env.plan, env.model, d64).cpu()[keep.cpu()]
        cpu_w = cfrc(env.plan, _on_cpu(env.model), _on_cpu(d64))[keep.cpu()]
        err = _rel(card_w, cpu_w)
        cfrc_ms = _time_ms(lambda: cfrc(env.plan, env.model, seen["data"]), 20)
        print(f"analysis: cfrc_ext on the Data of control step {t_cmp + 1} of {int(keep.sum())} of the first "
              f"{ANALYSIS_CPU} envs (unflagged), card against CPU: max |diff| / max(1, max |CPU|) {err:.3e} (bar "
              f"{CFRC_REL}; max |wrench| {float(cpu_w.abs().max()):.4f}); {cfrc_ms:.3f} ms a call at "
              f"B = {ANALYSIS_CLIPS}")
        assert float(cpu_w.abs().max()) > 0 and err < CFRC_REL, f"cfrc_ext card against CPU: {err:.3e}"
        step_ms = 1e3 * rollout_s / steps

        # the LSTM rodent (phase 10's checkpoint) and the fly (phase 9's)
        for phase, what, op, model in (("10", "rodent LSTM", tk.cg_solve, "lstm"), ("9", "fly", tk.ell_cg_solve, "mlp")):
            b = checkpointing.load_checkpoint_for_eval(self.train_runs[phase][0], device=self.dev)
            c = self.analysis_config(b["cfg"], root, what.replace(" ", "_"), ANALYSIS_OTHER_CLIPS,
                                     ANALYSIS_OTHER_STEPS + 1, tm.load_snapshot(workload.snapshot_name(b["cfg"])))
            assert bool(c["train_setup"]["train_config"].get("use_lstm", False)) == (model == "lstm")
            e = arollout.create_environment(c, device=self.dev)
            p = checkpointing.load_inference_fn(c, b["policy"], get_activation=True, device=self.dev)
            zero()
            self.analysis_rollout(f"{what} (phase {phase}'s checkpoint)", c, e, p, ANALYSIS_OTHER_CLIPS, model)
            sub = c["env_config"]["env_args"]["physics_steps_per_control_step"]
            n_steps = int((ANALYSIS_OTHER_STEPS + 1) * e._steps_for_cur_frame) - 1
            expected_other = 1 + n_steps * sub
            got = counts()
            print(f"analysis: {what} launches {got}, expected {op.__name__} 1 + {n_steps} x {sub} = {expected_other}")
            assert got == {op.__name__: expected_other}, got
            launches[op.__name__][f"{what} analysis rollout, {ANALYSIS_OTHER_CLIPS} clips (phase 14)"] = expected_other

        # the wrappers on the rodent's analysis env
        class Keep(Wrapper):
            """Keeps the unwrapped step's state."""

            def step(self, state, action):
                self.last = self.env.step(state, action)
                return self.last

        kept = Keep(env)
        aligned = wrappers.AutoAlignWrapperTracking(kept)
        render = wrappers.RenderRolloutWrapperMulticlipTracking(env)
        state = render.reset(self.gen, torch.arange(ANALYSIS_CLIPS, device=self.dev), batch_size=ANALYSIS_CLIPS)
        zero()
        realigned = 0
        for t in range(ALIGN_STEPS):
            action = self.uniform((ANALYSIS_CLIPS, env.action_size), -RODENT_CTRL_SCALE, RODENT_CTRL_SCALE)
            state = aligned.step(state, action)
            inner = kept.last
            done = state.done > 0
            assert torch.equal(state.done, inner.done)
            ref, d, di = state.info["reference_frame"], state.pipeline_state, inner.pipeline_state
            assert torch.equal(d.qpos[done], torch.cat([ref.position, ref.quaternion, ref.joints], -1)[done])
            assert torch.equal(d.qvel[done], torch.cat([ref.velocity, ref.angular_velocity, ref.joints_velocity],
                                                       -1)[done])
            assert torch.isfinite(d.xpos[done]).all()
            for f in dataclasses.fields(d):
                assert torch.equal(getattr(d, f.name)[~done], getattr(di, f.name)[~done]), f"{f.name} at step {t}"
            assert torch.equal(state.obs[~done], inner.obs[~done])
            realigned += int(done.sum())
        align_launches = counts()
        print(f"analysis: AutoAlignWrapperTracking, {ALIGN_STEPS} control steps of {ANALYSIS_CLIPS} envs under "
              f"{RODENT_CTRL_SCALE} x U(-1, 1) controls: {realigned} env steps ended done and sit at their reference "
              f"pose (qpos, qvel bitwise, kinematics run again); the others equal the unwrapped step bit for bit "
              f"(every Data field and the obs); launches {align_launches}")
        assert realigned > 0, "no env ended done: the realignment was not exercised"
        assert align_launches == {"cg_solve": ALIGN_STEPS * substeps}, align_launches
        launches["cg_solve"]["rodent AutoAlignWrapperTracking (phase 14)"] = ALIGN_STEPS * substeps

        evaluation = wrappers.EvalClipWrapperTracking(env)
        clip = torch.arange(ANALYSIS_CLIPS, device=self.dev).flip(0)
        noise = env._uniform(self.gen, (ANALYSIS_CLIPS, env.plan.nq))
        s = evaluation.reset_from_draws(clip, noise)
        rc = env._reference_clips
        frame0 = torch.cat([rc.position, rc.quaternion, rc.joints], -1)[clip, 0]
        drawn = evaluation.reset(self.gen, clip_idx=3, batch_size=4)
        print(f"analysis: EvalClipWrapperTracking.reset: qpos is each clip's frame 0 plus the qpos draw bit for bit "
              f"{torch.equal(s.pipeline_state.qpos, frame0 + noise)}, qvel zero {not s.pipeline_state.qvel.any()}, "
              f"start frame 0 {not s.info['start_frame'].any()}; from a generator: clips "
              f"{drawn.info['clip_idx'].tolist()}, qvel zero {not drawn.pipeline_state.qvel.any()}")
        assert torch.equal(s.pipeline_state.qpos, frame0 + noise) and not s.pipeline_state.qvel.any()
        assert not s.info["start_frame"].any() and drawn.info["clip_idx"].tolist() == [3] * 4
        assert not drawn.pipeline_state.qvel.any()

        decoder = mlp_networks.make_decoder_policy_fn(run_dir, device=self.dev)
        full = checkpointing.load_inference_fn(cfg, bundle["policy"], get_activation=False, device=self.dev)
        recorded = {}

        def recording(x):
            recorded["action"], extras = decoder(x)
            return recorded["action"], extras

        high = wrappers.HighLevelWrapper(env, recording, env.reference_obs_size)
        state = render.reset(self.gen, torch.arange(ANALYSIS_CLIPS, device=self.dev), batch_size=ANALYSIS_CLIPS)
        zero()
        same = []
        for _ in range(HIGH_LEVEL_STEPS):
            action, extras = full(state.obs)
            state = high.step(state, extras["latent_mean"])
            same.append(torch.equal(recorded["action"], action))
        high_launches = counts()
        print(f"analysis: HighLevelWrapper driven by make_decoder_policy_fn({os.path.basename(run_dir)}): "
              f"{HIGH_LEVEL_STEPS} control steps of {ANALYSIS_CLIPS} envs, latents the full policy's means; the "
              f"decoder's action equals the full policy's bit for bit at each step {same}; launches {high_launches}")
        assert all(same), "the decoder-only policy acts otherwise than the full policy's decoder"
        assert high_launches == {"cg_solve": HIGH_LEVEL_STEPS * substeps}, high_launches
        launches["cg_solve"]["rodent HighLevelWrapper, decoder-only policy (phase 14)"] = HIGH_LEVEL_STEPS * substeps

        # the stick: its snapshot's names, rodent-full-clips' env args and widths
        snap = tm.load_snapshot("stick")
        base = load_config("rodent-full-clips", [f"device={self.dev.type}"]).to_dict()
        base["env_config"]["walker_name"] = "stick"
        base["walker_config"] = {
            "joint_names": [str(x) for x in snap.names.joint[1:]],
            "body_names": [str(x) for x in snap.names.body[2:]],
            "end_eff_names": [str(x) for x in snap.names.body if "claws" in str(x)],
            "torque_actuators": False,
            "rescale_factor": 1.0,
        }
        c = self.analysis_config(base, root, "stick", STICK_CLIPS, STICK_FRAMES, snap)
        c["reference_config"]["clip_length"] = STICK_STEPS + 1
        e = arollout.create_environment(c, device=self.dev)
        networks = mlp_networks.network_factory(c["network_config"], torch.Generator().manual_seed(SEED))(
            e.observation_size, e.reference_obs_size, e.action_size,
            preprocess_observations_fn=running_statistics.normalize, device=self.dev)
        p = mlp_networks.make_inference_fn(networks)(running_statistics.init_state(e.observation_size, self.dev),
                                                      deterministic=True, get_activation=True)
        zero()
        stick_out, stick_s, _ = self.analysis_rollout("stick", c, e, p, STICK_CLIPS)
        stick_launches = counts()
        per_substep = 4 if e.plan.integrator == tm.INT_RK4 else 1
        stick_expected = 1 + STICK_STEPS * substeps * per_substep
        print(f"analysis: stick (nq {e.plan.nq}, nv {e.plan.nv}, nu {e.plan.nu}, {e.plan.nefc} rows: limits only, "
              f"integrator {e.plan.integrator}, solver {e.plan.solver} {e.plan.iterations}/{e.plan.ls_iterations}): "
              f"{STICK_STEPS} control steps of {STICK_CLIPS} envs in {stick_s:.1f} s; solve kernels launched "
              f"{stick_launches} (expected cg_solve without its Euler solve 1 + {STICK_STEPS} x {substeps} x "
              f"{per_substep} = {stick_expected}); largest qpos change in a control step "
              f"{float(stick_out['qposes_rollout'].diff(dim=1).abs().max()):.4f}")
        assert stick_launches == {"cg_solve": stick_expected}, stick_launches
        launches["cg_solve"]["stick analysis rollout, RK4 without the Euler solve (phase 14)"] = stick_expected

        seconds = time.perf_counter() - phase_t0
        print(f"analysis: {step_ms:.1f} ms per analysis control step at B = {ANALYSIS_CLIPS} (host clock; policy with "
              f"taps, env, cfrc_ext and the logged channels) against {self.rollout_step_ms:.1f} ms per rollout control "
              f"step at B = {N_ENVS} (phase 4, this run); cfrc_ext {cfrc_ms:.3f} ms a step at B = {ANALYSIS_CLIPS}; "
              f"phase {seconds:.1f} s ({self.card})")
        return {"launches": launches, "ms_per_control_step": step_ms, "cfrc_ext_ms": cfrc_ms, "seconds": seconds}

    def dp_launches(self, substeps: int, episode: int) -> dict:
        """cg_solve's launches in each of phase 15's runs: the reset, the
        unroll, the reset after the epoch; rank 0 and one process the eval
        (a reset and its episode); the CLI's rank also the logging rollout
        at B = 1 (a reset and a control step per frame)."""
        rollout = 1 + DP_UNROLL * substeps + 1
        evals = 1 + episode * substeps
        logging_rollout = 1 + DP_CLIP_LENGTH * substeps
        return {"nccl": rollout + evals + logging_rollout, "one": rollout + evals, "gloo0": rollout + evals,
                "gloo1": rollout}

    def dp_first_step(self, r: int, got: dict, one: dict, envs: slice) -> None:
        """Rank r's first control step against the one-process run's envs
        `envs`: the state it started from (the reset: the rank's rows of
        the global draws) within ROLLOUT_LAYER_REL, its actions (the
        policy's noise rows; the full-width forward at another batch size)
        within DP_ACTION_REL, and the step itself, redone here from the rank's
        state and actions on the one-process run's env, within phase 3's
        bars of the rank's. The rank's state after it against the
        one-process run's is printed only: the untrained policy's O(1)
        actions make the rodent chaotic in float32 (phase 4), so one
        control step takes the actions' roundoff to tenths."""
        from track_mjx_tpu_torch.envs.base import map_tensors

        start, mine = got["state"], map_tensors(lambda x: x[envs], one["state"])
        leaves, want = [], []
        map_tensors(lambda x: leaves.append(x) or x, start)
        map_tensors(lambda x: want.append(x) or x, mine)
        reset = max(_rel(a.double(), b.double()) for a, b in zip(leaves, want) if a.is_floating_point())
        assert all(torch.equal(a, b) for a, b in zip(leaves, want) if not a.is_floating_point()), "frames, clips"
        action = _rel(got["action"], one["action"][envs])
        redo = one["env"].step(map_tensors(lambda x: x.to(self.dev), start), got["action"].to(self.dev))
        errs, chaos = {}, {}
        for name in ("qpos", "qvel"):
            per_env = _per_env(getattr(redo.pipeline_state, name).cpu(), got[name])
            errs[name] = (float(per_env.median()), float(per_env.max()))
            far = _per_env(got[name], one[name][envs])
            chaos[name] = (float(far.median()), float(far.max()))
        print(f"data parallel (b): rank {r}'s first control step against the one-process run's envs "
              f"{envs.start}-{envs.stop - 1}: the state it started from {reset:.3e} (bar {ROLLOUT_LAYER_REL:.0e}), its "
              f"actions {action:.3e} (bar {DP_ACTION_REL:.0e}); the step redone here from them: per-env rel err qpos max "
              f"{errs['qpos'][1]:.3e} (bar {STEP_REL['qpos_max']:.0e}), qvel median {errs['qvel'][0]:.3e} (bar "
              f"{STEP_REL['qvel_median']:.0e}); the states after it, rank against one process (float32 chaos, not "
              f"held): qpos median {chaos['qpos'][0]:.3e} max {chaos['qpos'][1]:.3e}, qvel median "
              f"{chaos['qvel'][0]:.3e} max {chaos['qvel'][1]:.3e}")
        assert reset < ROLLOUT_LAYER_REL and action < DP_ACTION_REL, (reset, action)
        assert errs["qpos"][1] < STEP_REL["qpos_max"] and errs["qvel"][0] < STEP_REL["qvel_median"], errs

    def data_parallel(self) -> dict:
        """Phase 15: data-parallel training of the rodent through train.main's
        distributed key (DP_* cuts). (a) One NCCL rank through the CLI in a
        subprocess (RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, a free port), then
        the same run in this process without distributed; (b) DP_RANKS gloo
        ranks sharing the card, DP_ENVS / DP_RANKS envs each, against that
        one-process run: each rank's envs after the first control step, the
        ranks' learning half against one process's on the same global batch
        and draws (`dp_learning_halves`), the ranks' parameters bit for bit;
        cg_solve's launches exact in every run. Returns cg_solve's launches
        by path."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch import workload
        from track_mjx_tpu_torch.io import load
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips
        from track_mjx_tpu_torch.utils.config import load_config

        phase_t0 = time.perf_counter()
        cuda = self.dev.type == "cuda"
        root = os.path.join(REPO, "build", "chip_smoke_dp")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        clips = synthesize_clips(self.tm.load_snapshot("rodent-full-clips"), n_clips=DP_CLIPS,
                                 n_frames=DP_CLIP_LENGTH, mocap_hz=50, seed=SEED, device=self.dev)
        load.save_npz(clips, os.path.join(root, "clips.npz"))
        cfg = load_config("rodent-full-clips", dp_overrides(self.dev.type, os.path.join(root, "one")))
        tc, net = cfg.train_setup.train_config, cfg.network_config
        assert (net.encoder_layer_sizes, net.decoder_layer_sizes, net.critic_layer_sizes,
                net.intention_size) == TRAIN_WIDTHS["rodent-full-clips"]
        assert (tc.num_minibatches, tc.num_updates_per_batch) == (16, 4), "not the reference's minibatches and passes"
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        expected = self.dp_launches(substeps, DP_CLIP_LENGTH - DP_RANDOM_INIT - cfg.reference_config.traj_length)

        # (b)'s ranks start first, at the lowest CPU priority: they join their
        # group and set up train.main while (a) and (a') are timed, and wait at
        # their first control step for "go"
        with open(os.path.join(root, "gloo.json"), "w") as f:
            json.dump([*dp_overrides(self.dev.type, os.path.join(root, "gloo")), "distributed=true"], f)
        port = free_port()
        logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(DP_RANKS)]
        workers = [
            subprocess.Popen([sys.executable, os.path.join(REPO, "chip_smoke.py"), "--dp-rank", str(r), root,
                              self.dev.type], cwd=REPO, env=dp_env(r, DP_RANKS, DP_RANKS, port), stdout=logs[r],
                             stderr=subprocess.STDOUT)
            for r in range(DP_RANKS)
        ]
        try:
            # (a) one NCCL rank through the CLI
            cmd = [sys.executable, "-m", "track_mjx_tpu_torch.train", "--config-name", "rodent-full-clips",
                   *dp_overrides(self.dev.type, os.path.join(root, "nccl")), "distributed=true"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=REPO, env=dp_env(0, 1, 1, free_port()), capture_output=True, text=True,
                                  timeout=DP_TIMEOUT_S)
            nccl_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            with open(os.path.join(root, "nccl.log"), "w") as f:
                f.write(log)
            if proc.returncode:
                print(log[-6000:])
                raise RuntimeError(f"the distributed CLI run failed ({proc.returncode})")
            (joined,) = [line for line in log.splitlines() if "rank 0 of 1" in line]
            nccl_launches = json.loads(log.split("kernel launches (rank 0): ", 1)[1].splitlines()[0])
            (metrics_path,) = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "nccl", "ckpts"))
                               for f in fs if f == "metrics.jsonl"]
            nccl = [m for m in map(json.loads, open(metrics_path)) if "training/sps" in m][-1]
            print(f"data parallel (a): `{' '.join(cmd[1:4])} ... distributed=true` in {nccl_s:.1f} s: "
                  f"{joined.split(':', 2)[-1].strip()}; cg_solve launches {nccl_launches['cg_solve']} (expected "
                  f"{expected['nccl']}: reset, {DP_UNROLL} x {substeps}, reset, eval, logging rollout), other kernels "
                  f"{ {k: v for k, v in nccl_launches.items() if k != 'cg_solve'} }")
            assert ("over nccl" in joined) == cuda, joined
            assert nccl_launches["cg_solve"] == expected["nccl"], nccl_launches
            assert not any(v for k, v in nccl_launches.items() if k != "cg_solve"), nccl_launches

            # (a') the same run in this process without distributed: the
            # reference of (a)'s rates and of (b)'s ranks
            recorded, progress = {}, []
            make_env = first_step_recorder(recorded)
            for op in ttrain.KERNELS:
                op.launches = 0
            t0 = time.perf_counter()
            try:
                ttrain.main(cfg, progress_fn=lambda s, m: progress.append(m), policy_params_fn=no_logging)
            finally:
                workload.make_env = make_env
            torch.cuda.synchronize() if cuda else None
            one_s = time.perf_counter() - t0
            one_launches = ttrain.kernel_launches()
            one = progress[-1]
            open(os.path.join(root, "go"), "w").close()
            t0 = time.perf_counter()
            codes = [w.wait(timeout=DP_TIMEOUT_S) for w in workers]
            gloo_s = time.perf_counter() - t0
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
            for f in logs:
                f.close()
        if any(codes):
            for r in range(DP_RANKS):
                print(f"--- rank {r} ---\n" + open(os.path.join(root, f"rank{r}.log")).read()[-4000:])
            raise RuntimeError(f"the gloo ranks failed: {codes}")
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
        print(f"data parallel (a'): the same run in this process without distributed in {one_s:.1f} s: cg_solve "
              f"launches {one_launches['cg_solve']} (expected {expected['one']})")
        assert one_launches["cg_solve"] == expected["one"], one_launches
        assert not any(v for k, v in one_launches.items() if k != "cg_solve"), one_launches

        # (b): launches, the first control step, parameters, the learning half
        n = tc.num_envs // DP_RANKS
        for r, rank in enumerate(ranks):
            want = expected[f"gloo{r}"]
            print(f"data parallel (b): gloo rank {r} on {rank['device']}, {n} envs, {rank['seconds']:.1f} s in "
                  f"train.main: cg_solve launches {rank['launches']['cg_solve']} (expected {want})")
            assert rank["launches"]["cg_solve"] == want, rank["launches"]
            assert not any(v for k, v in rank["launches"].items() if k != "cg_solve"), rank["launches"]
            self.dp_first_step(r, rank["first_step"], recorded, slice(r * n, (r + 1) * n))
        same = all(torch.equal(ranks[0]["policy"][k], ranks[1]["policy"][k]) for k in ranks[0]["policy"])
        same_norm = all(torch.equal(getattr(ranks[0]["normalizer"], f), getattr(ranks[1]["normalizer"], f))
                        for f in ("count", "mean", "summed_variance", "std"))
        print(f"data parallel (b): the ranks' trained policies ({len(ranks[0]['policy'])} tensors) bitwise equal: "
              f"{same}; normalizers: {same_norm} (and the trainer's assert_is_replicated passed on both)")
        assert same and same_norm, "the ranks' parameters differ"
        half = ranks[0]["captured"]
        print(f"data parallel (b): the ranks' learning half ({half['steps']} Adam steps, {half['dp_s']:.2f} s) step "
              f"by step against one process's on the gathered batch and the same draws, each step from the ranks' "
              f"parameters, Adam state and normalizer: loss terms {half['loss']:.3e} (bar {TRAIN_LOSS_REL:.0e}), "
              f"clipped gradients {half['grad']:.3e} of each tensor's largest element (bar {TRAIN_GRAD_REL:.0e}), "
              f"parameters after a step {half['param']:.3e} lr, {half['param_bound']:.3e} of the Adam step's bound "
              f"from the gradients' difference (bar 1); the normalizer update "
              f"at most {half['mean']:.3e} (mean) and {half['summed_variance']:.3e} (summed variance) of the float32 "
              f"bound of two summation orders; the ranks' copies bitwise equal (assert_is_replicated)")
        assert half["loss"] < TRAIN_LOSS_REL and half["grad"] < TRAIN_GRAD_REL and half["param_bound"] <= 1.0, half
        assert half["mean"] <= 1.0 and half["summed_variance"] <= 1.0, half

        gloo = dict(ranks[0]["progress"][-1])
        for key, own in (("ms", "training/allreduce_ms"), ("calls", "training/allreduce_calls"),
                         ("mb", "training/allreduce_mb")):
            gloo[own] -= half[key]  # the trainer's own collectives: the check's are left out
        # nor the wait for "go" (in the first rollout step) or the check itself (in the step)
        idle = ranks[0]["first_step"]["wait_s"] + half["check_s"]
        gloo["training/rollout_ms"] -= 1e3 * ranks[0]["first_step"]["wait_s"]
        gloo["training/sps"] = tc.num_envs * DP_UNROLL / (gloo["training/walltime"] - idle)
        seconds = time.perf_counter() - phase_t0

        def step(m):
            return (f"training sps {m['training/sps']:.1f}, rollout {m['training/rollout_ms']:.1f} ms, sgd "
                    f"{m['training/sgd_ms']:.1f} ms per training step"
                    + (f", all-reduce {m['training/allreduce_ms']:.1f} ms in {m['training/allreduce_calls']:.0f} "
                       f"calls ({m['training/allreduce_mb']:.1f} MB)" if "training/allreduce_ms" in m else ""))

        print(f"data parallel: one NCCL rank (CLI): {step(nccl)}; without distributed (this process): {step(one)}; "
              f"gloo, {DP_RANKS} ranks on one card (rank 0, its wait for go and its learning-half check left out): "
              f"{step(gloo)}; a gloo all-reduce of the gradient ({half['n_params']} float32, "
              f"{4e-6 * half['n_params']:.1f} MB) {half['grad_allreduce_ms']:.2f} ms (mean of {DP_ALLREDUCE_REPS}, "
              f"device synchronized around each); (a) {nccl_s:.1f} s, (a') {one_s:.1f} s, (b) {gloo_s:.1f} s after "
              f"go; phase {seconds:.1f} s ({self.card})")
        return {
            "one NCCL rank through the CLI, distributed=true (phase 15)": nccl_launches["cg_solve"],
            "the same run without distributed (phase 15)": one_launches["cg_solve"],
            **{f"gloo rank {r} of {DP_RANKS} (phase 15)": rank["launches"]["cg_solve"] for r, rank in enumerate(ranks)},
        }

    # -----------------------------------------------------------------------
    # phase 16: domain randomization of the Model's leaves
    # -----------------------------------------------------------------------

    def dr_model(self, plan, model, n_envs: int, uniform, offsets: bool = True):
        """The per-env model of DR_SCALES (phase 16's randomizer), drawn by
        `uniform(shape, lo, hi)`; `offsets` adds the body_ipos offsets and
        the hinge qpos0 jitter. Returns (model, the randomized leaves'
        names)."""
        tm = self.tm
        mass = uniform((n_envs, plan.nbody), *DR_SCALES["body_mass"])
        gain = model.actuator_gainprm.expand((n_envs,) + model.actuator_gainprm.shape).clone()
        gain[..., 0] *= uniform((n_envs, plan.nu), *DR_SCALES["actuator_gainprm"])
        leaves = dict(
            geom_friction=model.geom_friction * uniform((n_envs, 1, 1), *DR_SCALES["geom_friction"]),
            dof_frictionloss=model.dof_frictionloss * uniform((n_envs, plan.nv), *DR_SCALES["dof_frictionloss"]),
            dof_armature=model.dof_armature * uniform((n_envs, plan.nv), *DR_SCALES["dof_armature"]),
            body_mass=model.body_mass * mass,
            body_inertia=model.body_inertia * mass[..., None],
            dof_damping=model.dof_damping * uniform((n_envs, plan.nv), *DR_SCALES["dof_damping"]),
            actuator_gainprm=gain,
        )
        if offsets:
            leaves["body_ipos"] = model.body_ipos + uniform((n_envs, plan.nbody, 3), -DR_IPOS, DR_IPOS)
            hinge = torch.as_tensor(plan.jnt_qposadr[plan.jnt_type == tm.JNT_HINGE], device=model.qpos0.device)
            qpos0 = model.qpos0.expand(n_envs, plan.nq).clone()
            qpos0[:, hinge] += uniform((n_envs, len(hinge)), -DR_QPOS0, DR_QPOS0)
            leaves["qpos0"] = qpos0
        return dataclasses.replace(model, **leaves), tuple(leaves)

    def dr_kernel(self, op, plain, inputs, shared_arm, what, its, ls, bars, flops) -> dict:
        """The fused solve `op` with a per-env armature against its plain
        version (fused_kernel_vs_plain, `bars` gated), the per-env envs'
        qacc moved by their armature (the same launch with the shared one,
        per env relative to max(1, max |qacc|): the largest must pass the
        kernel's qacc bar), and its times beside the plain version's and the
        bound."""
        assert inputs["arm"].dim() == 2, "the armature is not per env"
        kernel, max_abs = self.fused_kernel_vs_plain(op, plain, inputs, what, its, ls, True, gate=True, bars=bars)
        shared = op(**dict(inputs, arm=shared_arm.contiguous()), iterations=its, ls_iterations=ls)
        moved = _per_env(kernel.qacc, shared.qacc)
        print(f"{op.__name__} on {what}: each env's armature against the shared one moves qacc per env by up to "
              f"{float(moved.max()):.3e} (env {int(moved.argmax())}), median {float(moved.median()):.3e} "
              f"(the kernel's qacc bar {bars['qacc']:.0e})")
        assert float(moved.max()) > bars["qacc"], f"{op.__name__}: the per-env armature moved no env's qacc"
        ms, plain_ms, b_ms, b_by = self.time_fused(op, plain, inputs, its, ls, True,
                                                   tensor_bytes([*inputs.values(), *kernel]), flops)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": max_abs}

    def dr_rodent(self) -> tuple[dict, int]:
        """rodent-full-clips at N_ENVS envs on DR_SCALES' model: K2 with the
        per-env armature against its plain version on contact-rich states,
        then a reset (qpos at the shared qpos0 plus main_path's noise, as the
        tracking env's reset puts it at its clip's frame) and DR_CONTROL_STEPS
        + 1 control steps with exact launches and no plain version, every
        state finite, N_CPU envs against the CPU on their own leaves at phase
        3's bars."""
        tk, tm = self.tk, self.tm
        snap = tm.load_snapshot("rodent-full-clips")
        plan, model = tm.put_model(snap, device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        model_v, names = self.dr_model(plan, model, N_ENVS, self.uniform)
        print(f"rodent randomized: {N_ENVS} envs, per env {', '.join(names)}; frictionloss rows in the plan: "
              f"{plan.nf} (the rodent has no frictionloss, so that leaf stays zero)")
        inputs = self.rodent_states(plan, model_v, N_ENVS)
        nc, nl = inputs["fq"].shape[1], inputs["lim1h"].shape[0]
        record = self.dr_kernel(tk.cg_solve, tk.cg_solve_plain, inputs, model.dof_armature,
                                f"{N_ENVS} randomized rodent states", its, ls, KERNEL_REL,
                                solve_flops(plan.nv, nl, nc, 4, its, ls))
        del inputs
        # the reset: the randomized model's Data with qpos at the shared qpos0
        # plus main_path's noise, as the tracking env resets qpos from its
        # clip; each env's jittered qpos0 moves its hinges' zero, not qpos.
        # At qpos = its own qpos0 the joints' limits move against the pose:
        # on 32 envs on the CPU, float32 against float64 parts the control
        # step's qpos by 2.5e-4 on the median env from there, 1.5e-7 from here.
        reset = tm.make_data(plan, model_v, N_ENVS)
        qpos = model.qpos0.expand(N_ENVS, plan.nq).clone()
        qpos[:, 7:] += self.uniform((N_ENVS, plan.nq - 7), -0.001, 0.001)
        calls, restore = self.no_plain_calls()
        try:
            start, ctrls, after_warmup, final, launches = self.main_path(
                plan, model_v, {tk.cg_solve: 1}, DR_CONTROL_STEPS, RODENT_CTRL_SCALE, data=reset.replace(qpos=qpos),
                n_envs=N_ENVS)
        finally:
            restore()
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        self.versus_cpu("rodent randomized: ", snap, plan, model_v, start, ctrls, after_warmup, STEP_REL,
                        SUBSTEP_REL)
        return record, launches["cg_solve"]

    def dr_fly(self) -> tuple[dict, int]:
        """fly-mc-intention at N_ENVS envs on DR_SCALES' model (no offsets):
        K3 with the per-env armature against its plain version at 1/0
        (FLY_KERNEL_REL and the float64 rule, as phase 11b), then one control
        step with exact launches and N_CPU envs against the CPU, the
        substep's solve outputs printed ungated (phase 11b's rule)."""
        tk, tm = self.tk, self.tm
        snap = tm.load_snapshot("fly-mc-intention")
        plan, model = tm.put_model(snap, device=self.dev)
        its, ls = plan.iterations, plan.ls_iterations
        model_v, names = self.dr_model(plan, model, N_ENVS, self.uniform, offsets=False)
        print(f"fly randomized: {N_ENVS} envs, per env {', '.join(names)}")
        inputs = self.fly_states(plan, model_v)
        record = self.dr_kernel(tk.ell_cg_solve, tk.ell_cg_solve_plain, inputs, model.dof_armature,
                                f"{N_ENVS} randomized fly states at 1/0", 1, 0, FLY_KERNEL_REL,
                                solve_flops(plan.nv, plan.nlimit, plan.ncon, 3, 1, 0))
        del inputs
        calls, restore = self.no_plain_calls()
        try:
            start, ctrls, after_warmup, _, launches = self.main_path(
                plan, model_v, {tk.ell_cg_solve: 1}, 0, FLY_CTRL_SCALE, n_envs=N_ENVS)
        finally:
            restore()
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        self.fly_versus_cpu("fly randomized", snap, plan, model_v, start, ctrls, after_warmup, gate_solve=False)
        return record, launches["ell_cg_solve"]

    def dr_training(self) -> int:
        """One MLP training step of rodent-full-clips at the config's widths
        through ppo.train with phase 16's randomizer as its
        randomization_fn (train.main's call, the argument added), cut in
        depth as phase 15's in-process run (DP_*): cg_solve's launches
        exact, no plain version, every loss finite. Returns the launches."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
        from track_mjx_tpu_torch.io import load
        from track_mjx_tpu_torch.io.synthetic import synthesize_clips
        from track_mjx_tpu_torch.utils.config import load_config

        tk = self.tk
        root = os.path.join(REPO, "build", "chip_smoke_dr")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        clips = synthesize_clips(self.tm.load_snapshot("rodent-full-clips"), n_clips=DP_CLIPS,
                                 n_frames=DP_CLIP_LENGTH, mocap_hz=50, seed=SEED, device=self.dev)
        load.save_npz(clips, os.path.join(root, "clips.npz"))
        cfg = load_config("rodent-full-clips", dp_overrides(self.dev.type, os.path.join(root, "run")))
        net = cfg.network_config
        assert (net.encoder_layer_sizes, net.decoder_layer_sizes, net.critic_layer_sizes,
                net.intention_size) == TRAIN_WIDTHS["rodent-full-clips"]
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        expected = self.dp_launches(substeps, DP_CLIP_LENGTH - DP_RANDOM_INIT - cfg.reference_config.traj_length)
        drawn = {}
        plan = self.tm.put_model(self.tm.load_snapshot("rodent-full-clips"), device="cpu")[0]

        def randomize(model, generator, num_envs):
            def uniform(shape, lo, hi):
                return lo + (hi - lo) * torch.rand(shape, generator=generator, device=model.qpos0.device)

            model_v, names = self.dr_model(plan, model, num_envs, uniform)
            drawn[num_envs] = names
            return model_v, names

        train = mlp_ppo.train
        mlp_ppo.train = functools.partial(train, randomization_fn=randomize)
        calls, restore = self.no_plain_calls()
        progress = []
        tk.cg_solve.launches = 0
        t0 = time.perf_counter()
        try:
            ttrain.main(cfg, progress_fn=lambda s, m: progress.append(m), policy_params_fn=no_logging)
            torch.cuda.synchronize()
        finally:
            mlp_ppo.train = train
            restore()
        launches = tk.cg_solve.launches
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        losses = {k: v for k, v in progress[-1].items() if k.startswith("training/") and k.endswith("loss")}
        print(f"rodent randomized training: ppo.train with randomization_fn at {DP_ENVS} envs (full width) in "
              f"{time.perf_counter() - t0:.1f} s; randomized for {sorted(drawn)} envs (training, eval); cg_solve "
              f"launches {launches} (expected {expected['one']}: reset, {DP_UNROLL} x {substeps}, reset, eval); "
              f"losses {json.dumps(losses)}")
        assert launches == expected["one"], f"cg_solve launched {launches} times, expected {expected['one']}"
        assert len(losses) == 5 and all(math.isfinite(v) for v in losses.values()), losses
        eval_envs = cfg.train_setup.train_config.get("num_eval_envs", 128)  # ppo.train's default
        assert sorted(drawn) == sorted({DP_ENVS, eval_envs}), drawn
        return launches

    def domain_randomization(self) -> dict:
        """Phase 16: returns each fused solve's per-env-armature record and
        the launches by path."""
        t0 = time.perf_counter()
        rodent, rodent_launches = self.dr_rodent()
        torch.cuda.empty_cache()
        fly, fly_launches = self.dr_fly()
        torch.cuda.empty_cache()
        train_launches = self.dr_training()
        torch.cuda.empty_cache()
        print(f"phase 16: {time.perf_counter() - t0:.1f} s ({self.card})")
        return {
            "cg_solve": (rodent, {"rodent randomized control steps (phase 16)": rodent_launches,
                                  "rodent randomized training, ppo.train (phase 16)": train_launches}),
            "ell_cg_solve": (fly, {"fly randomized control step (phase 16)": fly_launches}),
        }

    def learning_check(self) -> int:
        """Phase 17: tools/long_run_torch.py's main, as a user runs it, at
        N_ENVS envs and full width, cut in depth (LONG_RUN_*). Returns
        cg_solve's launches."""
        import importlib.util

        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.agent import checkpointing
        from track_mjx_tpu_torch.analysis import rollout as arollout
        from track_mjx_tpu_torch.utils.config import load_config

        t0 = time.perf_counter()
        root = os.path.join(REPO, "build", "chip_smoke_long_run")
        shutil.rmtree(root, ignore_errors=True)
        spec = importlib.util.spec_from_file_location("long_run_torch", os.path.join(REPO, "tools", "long_run_torch.py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        cfg = load_config("rodent-full-clips")
        substeps = cfg.env_config.env_args.physics_steps_per_control_step
        episode = LONG_RUN_CLIP_LENGTH - cfg.reference_config.random_init_range - cfg.reference_config.traj_length
        unroll = cfg.train_setup.train_config.unroll_length
        # the reset, one unroll, and two evals of a reset and an episode each
        expected = 1 + unroll * substeps + 2 * (1 + episode * substeps)
        calls, restore = self.no_plain_calls()
        for fn in ttrain.KERNELS:
            fn.launches = 0
        ckpt = os.path.join(root, "ckpt")
        try:
            history = tool.main([*LONG_RUN_ARGS, "--device", self.dev.type,
                                   "--out", os.path.join(root, "records.json"), "--ckpt-dir", ckpt])
            torch.cuda.synchronize()
        finally:
            restore()
        launches = ttrain.kernel_launches()
        keys = {"wall_s", "env_steps_k", "eval_reward", "eval_reward_std", "avg_episode_length", "training_sps",
                "eval_sps"}
        for rec in history:
            print(f"learning check record: {json.dumps(rec)}")
        assert len(history) == 2, history
        for i, rec in enumerate(history):
            assert set(rec) == {*keys, "kernel_launches", *(("step_sps",) if i else ())}, sorted(rec)
            numbers = [v for k, v in rec.items() if k in keys and v is not None]
            assert all(math.isfinite(v) for v in numbers), rec
            assert rec["eval_reward"] is not None and rec["eval_sps"] > 0, rec
        assert history[1]["training_sps"] > 0
        print(f"learning check: tools/long_run_torch.py at {N_ENVS} envs (full width) in "
              f"{time.perf_counter() - t0:.1f} s; kernel launches {json.dumps(launches)}, cg_solve expected 1 (reset) "
              f"+ {unroll} x {substeps} + 2 evals x (1 + {episode} x {substeps}) = {expected}; plain calls {calls}")
        assert history[-1]["kernel_launches"] == launches, "the records' launches are not the wrappers' counts"
        assert launches == {**dict.fromkeys(launches, 0), "cg_solve": expected}, launches
        assert not any(calls.values()), f"a plain version ran on the card: {calls}"
        bundle = checkpointing.load_checkpoint_for_eval(ckpt, device=self.dev)
        env = arollout.create_environment(bundle["cfg"], device=self.dev)
        print(f"learning check: checkpoint PPONetwork_{checkpointing.CheckpointStore(ckpt).resolve_step(None)} "
              f"loaded for eval; its config's env over {env._n_clips} clips of {env._clip_frames} frames")
        assert (env._n_clips, env._clip_frames) == (4, LONG_RUN_CLIP_LENGTH)
        print(f"phase 17: {time.perf_counter() - t0:.1f} s ({self.card})")
        return launches["cg_solve"]

    def sps_profile_dir(self) -> None:
        """Phase 11c's profile_dir check, after every rate of the script: a
        small run of the config through train.main with profile_dir (two
        epochs of one training step, the second traced) writes a trace that
        holds the rollout, normalizer_update and sgd scopes and the cg_solve
        kernel."""
        from track_mjx_tpu_torch import train as ttrain
        from track_mjx_tpu_torch.utils.config import load_config

        run_dir, _ = self.train_run
        root = os.path.dirname(os.path.dirname(run_dir))
        trace_dir = os.path.join(root, "profile")
        cfg = load_config(SPS_CONFIG, [
            f"device={self.dev.type}",
            f"data_path={os.path.join(root, 'clips.npz')}",
            f"logging_config.model_path={os.path.join(root, 'profiled')}",
            f"reference_config.clip_length={TRAIN_CLIP_LENGTH}",
            "reference_config.random_init_range=70",  # an eval of 10 control steps
            # 256 envs, one unroll of one step a training step: 64 x 1 x 4 =
            # 256 env steps; two epochs of one step (eval_every // reset_every
            # = 2) before one eval of 16 envs
            "train_setup.eval_every=512",
            "train_setup.reset_every=256",
            "train_setup.train_config.num_timesteps=512",
            "train_setup.train_config.num_envs=256",
            "train_setup.train_config.batch_size=64",
            "train_setup.train_config.num_minibatches=4",
            "train_setup.train_config.unroll_length=1",
            "train_setup.train_config.num_eval_envs=16",
            f"train_setup.train_config.profile_dir={trace_dir}",
        ])
        t0 = time.perf_counter()
        ttrain.main(cfg, policy_params_fn=no_logging)
        (name,) = os.listdir(trace_dir)
        path = os.path.join(trace_dir, name)
        with open(path) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
        scopes = {k: k in names for k in ("rollout", "normalizer_update", "sgd")}
        kernels = sorted(n for n in names if "cg_solve" in n and "cg_solve_dense" not in n)
        print(f"{SPS_CONFIG}, profile_dir: {time.perf_counter() - t0:.1f} s; trace {name} "
              f"({os.path.getsize(path)} B, {len(names)} distinct event names): scopes {scopes}, cg_solve kernels "
              f"{kernels[:3]}")
        assert all(scopes.values()) and kernels, "the trace lacks a phase scope or the cg_solve kernel"


def main() -> None:
    if sys.argv[1:2] == ["--dp-rank"]:  # one rank of phase 15(b), started by the phase
        dp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, REPO)
    from track_mjx_tpu_torch.ops import kernel_lib
    from track_mjx_tpu_torch.physics import forward as tf

    card = card_name()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    path, build_s, log = kernel_lib.build_library()
    print(f"built {os.path.relpath(path, REPO)} from "
          f"{', '.join(os.path.relpath(s, REPO) for s in kernel_lib.SOURCES)} with nvcc for sm_90a "
          f"in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())
    tf.set_full_f32()
    phases = Phases(card)
    seconds = {"build": build_s}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    kernels = timed("2-3 rodent", phases.rodent)
    rollout_launches = timed("4 rodent rollout", phases.rollout)
    kernels += timed("5-6 fly", phases.fly)
    newton = timed("7 rodent Newton", phases.newton_main_path)
    training_launches = timed("8 rodent training", phases.training)
    fly_training_launches = timed("9 fly training", phases.training, "fly-mc-intention", what="fly training",
                                  phase="9")
    lstm_training_launches = timed("10 rodent LSTM training", phases.training, extra=LSTM_OVERRIDES,
                                   what="rodent LSTM training", phase="10")
    dense, no_euler, rest_launches = timed("11 rest of physics", phases.rest_of_physics)
    dense["launches"] = rest_launches["rodent mixed condims"]["cg_solve_dense"]
    kernels.append(dense)
    ell_dense, ell_no_euler, fly_launches = timed("11b fly remainder", phases.fly_remainder)
    ell_dense["launches"] = fly_launches["fly condim 1"]["ell_cg_solve_dense"]
    kernels.append(ell_dense)
    rest_launches = {f"{k} control steps (phase 11)": v for k, v in rest_launches.items()}
    rest_launches.update({f"{k} control steps (phase 11b)": v for k, v in fly_launches.items()})
    sps_record, sps_launches = timed("11c rodent-sps-per-actor", phases.sps_per_actor)
    logging_record = timed("13 run management and logging", phases.run_logging)
    analysis_record = timed("14 analysis from a checkpoint", phases.analysis)
    dp_launches = timed("15 data parallel", phases.data_parallel)
    randomized = timed("16 domain randomization", phases.domain_randomization)
    learning_launches = timed("17 learning check", phases.learning_check)
    kernels += timed("12 standalone linalg", phases.newton_kernels, *newton)
    timed("11c profile_dir", phases.sps_profile_dir)
    for k in kernels:  # each kernel's launches on every path that runs it, as counted there
        if k["name"] == "cg_solve":
            k["no_euler"] = no_euler
            k["rodent_sps_per_actor"] = sps_record
            k["launches_by_path"] = {"rodent control steps (phase 3)": k["launches"],
                                     "rodent rollout, reset + one unroll (phase 4)": rollout_launches,
                                     "rodent training, train.main (phase 8)": training_launches,
                                     "rodent LSTM training, train.main (phase 10)": lstm_training_launches,
                                     **sps_launches, **dp_launches,
                                     "learning check, tools/long_run_torch.py (phase 17)": learning_launches}
        elif k["name"] == "ell_cg_solve":
            k["no_euler"] = ell_no_euler
            k["launches_by_path"] = {"fly control steps (phase 6)": k["launches"],
                                     "fly training, train.main (phase 9)": fly_training_launches}
        elif k["name"] in ("cg_solve_dense", "ell_cg_solve_dense"):
            k["launches_by_path"] = {}
        else:
            k["launches_by_path"] = {"rodent Newton control steps (phase 7)": k["launches"]}
        for path, counts in rest_launches.items():
            if counts.get(k["name"]):
                k["launches_by_path"][path] = counts[k["name"]]
        if k["name"] in logging_record:  # the logging rollouts at B = 1 (phase 13)
            k["launches_by_path"].update(logging_record[k["name"]]["launches_by_path"])
            k["b1"] = logging_record[k["name"]]["b1"]
        k["launches_by_path"].update(analysis_record["launches"].get(k["name"], {}))  # phase 14
        if k["name"] in randomized:  # phase 16: the launches, and the kernel with an armature per env
            k["per_env_armature"], by_path = randomized[k["name"]]
            k["launches_by_path"].update(by_path)
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; total since start {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
