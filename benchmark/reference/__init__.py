"""The plain reference the benchmark holds the program against.

`plain/` is a frozen copy, taken when the benchmark was defined, of the
port's plain PyTorch paths: the physics (every fused CUDA solve replaced by
its plain PyTorch version), the tracking envs and wrappers, the clip IO,
the intention networks, the PPO loss and the clipped Adam step. The CPU
tests of the repository hold those paths against the JAX package and
MuJoCo C; here they are kept as they were, so that a later change to the
program is judged against them. Nothing under `reference/` imports the
program. `build.py`, `step.py` and `learner.py` drive the copy.
"""
