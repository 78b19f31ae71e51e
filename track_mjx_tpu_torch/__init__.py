"""PyTorch/CUDA port of track_mjx_tpu.

The JAX package `track_mjx_tpu` is the reference; this package mirrors its
module names (`ops/quaternion.py`, `physics/forward.py`, `envs/task/
tracking.py`, `agent/acting.py`, ...) with batch-first torch tensors in
place of per-env functions under `jax.vmap`. It imports torch and numpy
only. The physics path's hand-written kernels, the fused smooth + CG +
Euler constraint solves (pyramidal and elliptic friction cones) and the
standalone dense solves, are CUDA C++ under `csrc/`. `rollout.make_rollout`
builds a workload's tracking env and intention policy.
"""
