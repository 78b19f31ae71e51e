"""The reference's env, networks and policy for a config as the program ran it."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Dict

import torch

from benchmark.reference.plain import workload
from benchmark.reference.plain.agent import running_statistics
from benchmark.reference.plain.agent.mlp_ppo import ppo_networks
from benchmark.reference.plain.envs import wrappers
from benchmark.reference.plain.io import load
from benchmark.reference.plain.physics import forward



def _dataclasses() -> dict:
    """Every dataclass of the reference's loaded modules, by name: the
    program's copied state is rebuilt as these (the copy keeps the port's
    class names)."""
    found = {}
    for name, module in list(sys.modules.items()):
        if not name.startswith("benchmark.reference.plain"):
            continue
        for attr in vars(module).values():
            if isinstance(attr, type) and dataclasses.is_dataclass(attr) and attr.__module__ == name:
                found[attr.__name__] = attr
    return found


CLASSES = _dataclasses()


def env(cfg: dict, clips_path: str, device):
    """The wrapped training env (Episode, AutoReset) over the clips file."""
    clips = load.load_data(clips_path, device=device)
    base = workload.make_env(cfg, clips, device=device)
    return wrappers.wrap(base, episode_length=workload.episode_length(cfg, base), action_repeat=1)


def networks(cfg: dict, obs_size: int, reference_obs_size: int, action_size: int, seed: int, device):
    """The intention networks at the config's widths, their initial weights
    drawn as the trainer draws them from the seed: a CPU generator seeded
    with the seed hands the first of its 62-bit draws to the weights'
    generator."""
    seeds = torch.Generator().manual_seed(int(seed))
    init = torch.Generator().manual_seed(int(torch.randint(2**62, (1,), generator=seeds)))
    normalize = running_statistics.normalize
    return ppo_networks.network_factory(cfg["network_config"])(
        obs_size, reference_obs_size, action_size, preprocess_observations_fn=normalize,
        generator=init, device=device,
    )


def load_params(nets, params: Dict[str, torch.Tensor]) -> None:
    """Loads "policy.*" and "value.*" tensors into the networks."""
    for prefix, module in (("policy.", nets.policy_network), ("value.", nets.value_network)):
        module.load_state_dict({k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)})


def params(nets) -> Dict[str, torch.Tensor]:
    return {
        **{"policy." + k: v for k, v in nets.policy_network.state_dict().items()},
        **{"value." + k: v for k, v in nets.value_network.state_dict().items()},
    }


def initial_normalizer(size: int) -> Dict[str, torch.Tensor]:
    """The trainer's starting normalizer (zero statistics, std one), on the host."""
    state = running_statistics.init_state(size, "cpu")
    return {k: getattr(state, k) for k in ("count", "mean", "summed_variance", "std")}


def normalizer(fields: Dict[str, torch.Tensor], device):
    return running_statistics.RunningStatisticsState(**{k: v.to(device) for k, v in fields.items()})


@contextlib.contextmanager
def precision(tf32: bool):
    """Full float32 (TF32 off), or with `tf32` the lower precision that the
    control computes in: TF32 matmuls, the reference's own full-float32
    guard lifted for the length of the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), forward.check_full_f32)
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        forward.check_full_f32 = lambda: None
    else:
        forward.set_full_f32()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[0], saved[1]
        torch.set_float32_matmul_precision(saved[2])
        forward.check_full_f32 = saved[3]
