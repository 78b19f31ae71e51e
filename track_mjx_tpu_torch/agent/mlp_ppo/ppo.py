"""PPO trainer of the MLP intention pipeline, on one device or data
parallel over the ranks of a `parallel.mesh.Mesh`.

Port of track_mjx_tpu/agent/mlp_ppo/ppo.py. The JAX trainer jits a whole
epoch as one SPMD program; here a training step is eager PyTorch on one
device, with the same structure:

- the rollout: batch_size * num_minibatches / num_envs unrolls of
  unroll_length steps with the truncation flags, laid out [unrolls, T,
  envs] -> [unrolls, envs, T] -> [unrolls * envs, T], so trajectory index =
  unroll * num_envs + env;
- the Welford normalizer update over every observation of the batch;
- num_updates_per_batch passes, each a permutation of the trajectories cut
  into num_minibatches minibatches, one clipped Adam step per minibatch;
- env_steps counted in thousands, truncated to int32 after each training
  step, as the JAX package adds a float32 to an int32;
- the KL schedule driven by the eval iteration `it`, not by env steps;
- an eval (and a checkpoint) per epoch, the initial ones only when
  num_evals > 1; `num_resets_per_eval` resets the envs after each epoch
  (with 0, as the rodent-sps-per-actor config gives, one epoch per eval
  and no reset);
- the options: `freeze_decoder` (with `checkpoint_to_restore`: the
  decoder transfer below), `randomization_fn` (per-env model leaves, any
  of the Model's fields, `wrappers.DomainRandomizationVmapWrapper`:
  `randomization_fn(model, generator, num_envs)`, one generator for the
  training envs and one for the eval envs), `rollout_bf16` (the rollout's policy forward in bf16,
  agent/intention.py), a foreign env (`wrappers.wrap_external`, the whole
  observation feeding the encoder where the env gives no split), and
  `profile_dir` (a torch.profiler trace of the second epoch, the first
  after the warm-up, as `<profile_dir>/epoch_1.pt.trace.json`).

Decoder transfer, as the JAX trainer: the decoder's parameters come from
the checkpoint's policy and stay frozen (the clip's global norm still
counts their gradients; Adam, with fresh state, updates nothing of them);
everything else starts fresh, and the proprioceptive slice of the
normalizer (its last proprioceptive_obs_size entries) is the checkpoint's,
pinned again after every normalizer update.

`Learner`, `EpochTimer`, `steps_per_epoch` and `seeded_generators` serve
the LSTM trainer (agent/lstm_ppo/ppo.py) too.

Data parallel (`mesh`: one process per device, as the JAX trainer's
Mesh(("batch",)) over devices): every rank seeds the same generators and
builds the same networks, which rank 0's broadcast then replicates (after a
restore too); a rank holds the env_slice of num_envs / world_size
consecutive envs (the world size must divide num_envs). Every draw is made
at its global size and the rank keeps its rows (`parallel.mesh.Rows`): the
resets, the rollout's action and latent noise, `randomization_fn`'s per-env
leaves. The learning half sees the global batch: the normalizer update
over every rank's observations, one global permutation per pass (the same
on every rank), of whose minibatch each rank takes the trajectories of its
envs (possibly none), the advantages normalized and the loss's means taken
over the whole minibatch, the gradients and loss terms summed over the
ranks before the clip; every rank then takes the same Adam step. Rank 0
alone runs the evals, the per-eval hook, the progress reports, the
checkpoints and the profile. Before the return every rank's parameters,
Adam state and normalizer must be rank 0's bit for bit
(`assert_is_replicated`), then a barrier. `max_devices_per_host` does not
choose devices here (a process drives one device: launch `torchrun
--nproc_per_node`); a value below the host's number of ranks raises. A
one-device comparison run is a run of world size 1.

The phases run under `torch.profiler.record_function("rollout" |
"normalizer_update" | "sgd")`, the counterparts of the JAX named scopes; on
the card the trainer synchronizes at each phase's end and reports each
phase's host ms per training step as training/{phase}_ms.

One `torch.Generator` on the device drives the env resets, the rollout's
policy noise, the permutations and the loss's latent and entropy noises, a
second the evals; the networks' initial weights are drawn on the CPU. The
streams differ from JAX's; `Learner.__call__` takes explicit draws so that
a test can feed the JAX ones.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import logging
import math
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from track_mjx_tpu_torch.agent import (
    acting, checkpointing, gradients, network_masks, ppo_math, running_statistics, types,
)
from track_mjx_tpu_torch.agent.mlp_ppo import losses, ppo_networks
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.base import Env, map_tensors
from track_mjx_tpu_torch.parallel import mesh as mesh_lib
from track_mjx_tpu_torch.physics.model import _device

Metrics = types.Metrics
STEPS_IN_THOUSANDS = 1e3
PHASES = ("rollout", "normalizer_update", "sgd")


@dataclasses.dataclass
class TrainingState:
    """Learner state. The parameters live in the networks' modules and the
    Adam moments in the optimizer, both updated in place; the normalizer and
    env_steps are replaced at each training step."""

    networks: ppo_networks.PPOImitationNetworks
    optimizer: torch.optim.Optimizer
    normalizer_params: running_statistics.RunningStatisticsState
    env_steps: int

    @property
    def params(self) -> losses.PPONetworkParams:
        return losses.PPONetworkParams(
            self.networks.policy_network.state_dict(), self.networks.value_network.state_dict()
        )

    def policy_params(self) -> Tuple[running_statistics.RunningStatisticsState, dict]:
        """(normalizer, policy state dict): what a policy needs."""
        return self.normalizer_params, self.networks.policy_network.state_dict()

    def state_dict(self) -> dict:
        """The whole state as nested dicts of tensors (live references)."""
        return {
            "optimizer_state": self.optimizer.state_dict(),
            "params": self.params._asdict(),
            "normalizer_params": checkpointing.normalizer_to_dict(self.normalizer_params),
            "env_steps": self.env_steps,
        }

    def load_state_dict(self, state: dict) -> None:
        """Copies `state` in: the optimizer would otherwise keep the given
        step counts (it moves the moments to the parameters' device but
        keeps a CPU step tensor as it is) and count on in the caller's dict."""
        self.networks.policy_network.load_state_dict(state["params"]["policy"])
        self.networks.value_network.load_state_dict(state["params"]["value"])
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer_state"]))
        device = self.normalizer_params.mean.device
        self.normalizer_params = checkpointing.normalizer_from_dict(state["normalizer_params"], device)
        self.env_steps = int(state["env_steps"])


class UpdateDraws(NamedTuple):
    """The draws of one pass over the batch: the permutation of the
    trajectories [N] and, per minibatch, the latent noise [T, N / M,
    latents] and the entropy noise [T, N / M, action_size]."""

    permutation: torch.Tensor
    noises: Sequence[Tuple[torch.Tensor, torch.Tensor]]


def next_env_steps(env_steps: int, env_step_per_training_step: int) -> int:
    """env_steps in thousands after one training step: int32(float32(env_steps)
    + float32(steps / 1000)), the JAX package's weakly typed sum."""
    return int(np.int32(np.float32(env_steps) + np.float32(env_step_per_training_step / STEPS_IN_THOUSANDS)))


def _clock(device: torch.device) -> float:
    """The host clock once the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Learner:
    """The learning half of a training step: the normalizer update over the
    batch's observations, then num_updates_per_batch passes of
    num_minibatches Adam steps (clipped by global norm unless
    `max_grad_norm` is None) that leave the `frozen` parameters as they
    are. With `normalizer_after_sgd` (the LSTM trainer's order) the passes
    run on the normalizer the step started with and the update comes after
    them. With `pinned` (a normalizer's tail slice) every update ends with
    that slice pinned. `phase_s` sums each phase's host seconds.

    With `mesh` the batch is this rank's trajectories of a global batch over
    `num_envs` envs (trajectory = unroll * num_envs + env; the rank's rows
    unroll * envs_per_rank + local env): the normalizer update, the
    permutations, the minibatches, the loss's noises, its means and the
    gradients are the global batch's (module docstring), and a permutation
    given in `draws` is one of the global batch, its noises of the global
    minibatch."""

    def __init__(
        self,
        loss_fn: Callable,
        optimizer: torch.optim.Optimizer,
        num_minibatches: int,
        num_updates_per_batch: int,
        max_grad_norm: Optional[float] = gradients.MAX_GRAD_NORM,
        normalizer_after_sgd: bool = False,
        frozen: Sequence[torch.nn.Parameter] = (),
        pinned: Optional[running_statistics.RunningStatisticsState] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
        num_envs: Optional[int] = None,
    ):
        if mesh is not None and num_envs is None:
            raise ValueError("a data-parallel Learner needs num_envs, the global batch's envs")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.mesh = mesh
        self.num_envs = num_envs
        self.update_fn = gradients.gradient_update_fn(
            loss_fn, optimizer, max_grad_norm, frozen, mesh=mesh, summed=ppo_math.LOSS_TERMS
        )
        self.pinned = pinned
        self.num_minibatches = num_minibatches
        self.num_updates_per_batch = num_updates_per_batch
        self.normalizer_after_sgd = normalizer_after_sgd
        self.phase_s = dict.fromkeys(PHASES[1:], 0.0)

    def _update_normalizer(self, training_state: TrainingState, observation: torch.Tensor) -> None:
        t0 = time.perf_counter()
        with record_function("normalizer_update"):
            normalizer = running_statistics.update(training_state.normalizer_params, observation, group=self.mesh)
            if self.pinned is not None:
                normalizer = running_statistics.pin_tail(normalizer, self.pinned)
            training_state.normalizer_params = normalizer
        self.phase_s["normalizer_update"] += _clock(observation.device) - t0

    def __call__(
        self,
        training_state: TrainingState,
        data: types.Transition,
        it,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Sequence[UpdateDraws]] = None,
    ) -> List[Dict[str, torch.Tensor]]:
        """Updates `training_state` in place from the batch-major batch `data`
        [N, T, ...]; returns each gradient step's loss metrics. The draws come
        from `generator` (per pass, the permutation, then per minibatch the
        latent and the entropy noise), or from `draws`."""
        device = data.observation.device
        if not self.normalizer_after_sgd:
            self._update_normalizer(training_state, data.observation)
        t1 = time.perf_counter()
        n = data.observation.shape[0] * (1 if self.mesh is None else self.mesh.world_size)
        metrics = []
        with record_function("sgd"):
            for u in range(self.num_updates_per_batch):
                if draws is None:
                    perm = torch.randperm(n, generator=generator, device=device)
                else:
                    perm = draws[u].permutation.to(device)
                minibatches = self._minibatches(data, perm, generator, None if draws is None else draws[u].noises)
                for minibatch, latent, entropy, kwargs in minibatches:
                    _, step_metrics = self.update_fn(
                        training_state.normalizer_params, minibatch, latent, entropy, it, **kwargs
                    )
                    metrics.append({k: v.detach() for k, v in step_metrics.items()})
        self.phase_s["sgd"] += _clock(device) - t1
        if self.normalizer_after_sgd:
            self._update_normalizer(training_state, data.observation)
        return metrics

    def _minibatches(self, data: types.Transition, perm: torch.Tensor, generator, noises):
        """(minibatch, latent noise, entropy noise, loss kwargs) of each
        minibatch of one pass: its rows of `data` in `perm`'s order (with a
        mesh, those of this rank's envs and the loss's BatchShard), the
        noises from `generator` or `noises` (with a mesh, their columns of
        those rows)."""
        if self.mesh is None:
            shuffled = map_tensors(lambda x: x[perm].reshape((self.num_minibatches, -1) + x.shape[1:]), data)
            for m in range(self.num_minibatches):
                latent, entropy = (generator, generator) if noises is None else noises[m]
                yield map_tensors(lambda x: x[m], shuffled), latent, entropy, {}
            return
        size = perm.shape[0] // self.num_minibatches
        for m in range(self.num_minibatches):
            rows, positions = mesh_lib.trajectory_rows(self.mesh, perm[m * size : (m + 1) * size], self.num_envs)
            if noises is None:
                latent = entropy = mesh_lib.Rows(generator, size, positions, dim=1)
            else:
                latent, entropy = (x.index_select(1, positions.to(x.device)) for x in noises[m])
            batch = mesh_lib.BatchShard(self.mesh, size)
            yield map_tensors(lambda x: x[rows], data), latent, entropy, {"batch": batch}


def _mean_metrics(metrics: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Each metric's mean over the gradient steps, on the host."""
    means = torch.stack([torch.stack([m[k] for m in metrics]).mean() for k in metrics[0]]).tolist()
    return dict(zip(metrics[0], means))


def _stack_unrolls(unrolls: Sequence[types.Transition]) -> types.Transition:
    """[unrolls][T, envs, ...] -> [unrolls * envs, T, ...]."""
    stacked = acting._stack(list(unrolls))
    return map_tensors(lambda x: x.transpose(1, 2).reshape((-1,) + x.shape[1:2] + x.shape[3:]), stacked)


def bind_randomization(
    randomization_fn: Optional[Callable],
    generator: torch.Generator,
    num_envs: int,
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """`randomization_fn(model, generator, num_envs)` bound to one generator
    stream and env count, as the wrappers take it (None stays None). With a
    mesh of more than one rank it randomizes all `num_envs` envs and keeps
    this rank's env_slice of each randomized leaf, whichever leaves they
    are."""
    if randomization_fn is None:
        return None
    bound = functools.partial(randomization_fn, generator=generator, num_envs=num_envs)
    if mesh is None or mesh.world_size == 1:
        return bound

    def local(model):
        model_v, names = bound(model)
        envs = mesh_lib.env_slice(mesh, num_envs)
        return dataclasses.replace(model_v, **{n: getattr(model_v, n)[envs] for n in names}), names

    return local


def data_parallel_device(
    mesh: Optional[mesh_lib.Mesh], device: torch.device | str, num_envs: int, max_devices_per_host: Optional[int]
) -> torch.device:
    """The trainer's device: `device`, or with a mesh the mesh's, whose
    world size must divide num_envs. A process drives one device, so
    `max_devices_per_host` (None or 0: no bound) below the ranks on this
    host raises: the devices a host uses are torchrun's --nproc_per_node."""
    local_ranks = 1 if mesh is None else mesh.local_world_size
    if max_devices_per_host and max_devices_per_host < local_ranks:
        raise ValueError(
            f"max_devices_per_host={max_devices_per_host}, but this host runs {local_ranks} ranks, one device each: "
            "launch fewer with torchrun --nproc_per_node (a one-device run is a run of world size 1)"
        )
    if mesh is None:
        return _device(device)
    mesh_lib.env_slice(mesh, num_envs)  # raises unless the world size divides num_envs
    if _device(device).type != mesh.device.type:
        raise ValueError(f"device {device} against the mesh's {mesh.device}")
    return mesh.device


def replicated_tensors(training_state: TrainingState) -> List[torch.Tensor]:
    """Every tensor the ranks keep equal: both networks' parameters and
    buffers, the normalizer and the optimizer's state."""
    nets = (training_state.networks.policy_network, training_state.networks.value_network)
    normalizer = training_state.normalizer_params
    return [
        *(t for net in nets for t in (*net.parameters(), *net.buffers())),
        *(getattr(normalizer, f.name) for f in dataclasses.fields(normalizer)),
        *(v for st in training_state.optimizer.state.values() for v in st.values() if isinstance(v, torch.Tensor)),
    ]


def _wrapper_for(env) -> Callable:
    """`wrappers.wrap` for a port env, `wrappers.wrap_external` for a
    foreign one."""
    return wrappers.wrap if isinstance(env, Env) else wrappers.wrap_external


def steps_per_epoch(
    num_timesteps: int,
    num_evals: int,
    env_step_per_training_step: int,
    num_resets_per_eval: int,
    epoch_steps_per_call: Optional[int],
) -> int:
    """Training steps per epoch. The JAX package may split an epoch's
    training steps over several device calls (a bound on a TPU runtime's
    call time) and then runs chunk x num_chunks steps; the port runs the
    same count in one loop."""
    per_epoch = int(
        np.ceil(num_timesteps / (max(num_evals - 1, 1) * env_step_per_training_step * max(num_resets_per_eval, 1)))
    )
    chunk = max(1, min(int(epoch_steps_per_call or per_epoch), per_epoch))
    return chunk * math.ceil(per_epoch / chunk)


def seeded_generators(seed: int, device: torch.device, n: int) -> list:
    """A CPU generator (the networks' initial weights), then `n` on
    `device`, each seeded from one CPU stream seeded with `seed`."""
    seeds = torch.Generator().manual_seed(seed)

    def generator(dev):
        return torch.Generator(device=dev).manual_seed(int(torch.randint(2**62, (1,), generator=seeds)))

    return [generator("cpu")] + [generator(device) for _ in range(n)]


class EpochTimer:
    """Runs the epochs of a trainer and reports each epoch's metrics: the
    JAX package's training/sps (the steps of one epoch times the resets per
    eval, an epoch being one of num_resets_per_eval between evals) and
    walltime, the loss metrics' means, and each phase's host ms per
    training step; with a `mesh`, the host ms of its collectives per
    training step (the device synchronized around each), their count and
    their MB, as training/allreduce_ms, _calls and _mb. With `profile_dir`,
    the second epoch (the first after the warm-up) runs under
    torch.profiler, whose trace goes to `<profile_dir>/epoch_1.pt.trace.json`:
    the phases appear there as record_function scopes, and on the card the
    kernels."""

    def __init__(
        self,
        learner: Learner,
        steps: int,
        env_step_per_training_step: int,
        num_resets_per_eval: int,
        profile_dir: Optional[str] = None,
        mesh: Optional[mesh_lib.Mesh] = None,
    ):
        self.learner = learner
        self.mesh = mesh
        self.steps = steps
        self.env_steps_per_epoch = steps * env_step_per_training_step * max(num_resets_per_eval, 1)
        self.rollout_s = 0.0  # host seconds of the epoch's rollouts, added by the training step
        self.walltime = 0.0
        self.profile_dir = profile_dir
        self.epochs_run = 0

    def __call__(self, training_step: Callable[[], List[Dict[str, torch.Tensor]]]) -> Metrics:
        t = time.time()
        self.rollout_s = 0.0
        self.learner.phase_s = dict.fromkeys(self.learner.phase_s, 0.0)
        collectives = None
        if self.mesh is not None:
            collectives = (self.mesh.collective_s, self.mesh.collective_calls, self.mesh.collective_bytes)
        profile = self.profile_dir is not None and self.epochs_run == 1
        self.epochs_run += 1
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) if profile else contextlib.nullcontext() as prof:
            step_metrics = []
            for _ in range(self.steps):
                step_metrics += training_step()
            loss_metrics = _mean_metrics(step_metrics)  # waits for the last step
        if profile:
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "epoch_1.pt.trace.json")
            prof.export_chrome_trace(path)
            logging.info("profiler trace written to %s", path)
        epoch_training_time = time.time() - t
        self.walltime += epoch_training_time
        phase_ms = {"rollout": self.rollout_s, **self.learner.phase_s}
        metrics = {
            "training/sps": self.env_steps_per_epoch / epoch_training_time,
            "training/walltime": self.walltime,
            **{f"training/{name}": value for name, value in loss_metrics.items()},
            **{f"training/{k}_ms": 1e3 * v / self.steps for k, v in phase_ms.items()},
        }
        if collectives is not None:
            metrics["training/allreduce_ms"] = 1e3 * (self.mesh.collective_s - collectives[0]) / self.steps
            metrics["training/allreduce_calls"] = (self.mesh.collective_calls - collectives[1]) / self.steps
            metrics["training/allreduce_mb"] = 1e-6 * (self.mesh.collective_bytes - collectives[2]) / self.steps
        return metrics


def call_checkpoint_callback(checkpoint_callback: Optional[Callable[[int], None]], step: int, wrote: bool) -> None:
    """`checkpoint_callback(step)` after a save that wrote `step` (one that
    the manager skipped calls nothing); a callback that raises is logged and
    training goes on, as in the JAX package's `checkpointing.save`."""
    if checkpoint_callback is None or not wrote:
        return
    try:
        checkpoint_callback(step)
    except Exception as e:  # noqa: BLE001 - the callback must not stop training
        logging.warning("Checkpoint callback failed: %s", e)


def train(
    environment: Env,
    num_timesteps: int,
    episode_length: int,
    ckpt_mgr: Optional[checkpointing.CheckpointManager] = None,
    config_dict: Optional[dict] = None,
    checkpoint_to_restore: Optional[str] = None,
    action_repeat: int = 1,
    num_envs: int = 1,
    max_devices_per_host: Optional[int] = None,
    num_eval_envs: int = 128,
    learning_rate: float = 1e-4,
    entropy_cost: float = 1e-4,
    kl_weight: float = 1e-3,
    discounting: float = 0.9,
    seed: int = 0,
    unroll_length: int = 10,
    batch_size: int = 32,
    num_minibatches: int = 16,
    num_updates_per_batch: int = 2,
    num_evals: int = 20,
    num_resets_per_eval: int = 0,
    normalize_observations: bool = False,
    reward_scaling: float = 1.0,
    clipping_epsilon: float = 0.3,
    gae_lambda: float = 0.95,
    deterministic_eval: bool = False,
    network_factory=ppo_networks.make_intention_ppo_networks,
    progress_fn: Callable[[int, Metrics], None] = lambda *args: None,
    normalize_advantage: bool = True,
    eval_env: Optional[Env] = None,
    eval_env_test_set: Optional[Env] = None,
    policy_params_fn: Callable[..., None] = lambda *args, **kwargs: None,
    randomization_fn=None,
    get_activation: bool = True,
    use_lstm: bool = False,
    use_kl_schedule: bool = True,
    kl_ramp_up_frac: float = 0.25,
    freeze_decoder: bool = False,
    checkpoint_callback: Optional[Callable[[int], None]] = None,
    epoch_steps_per_call: Optional[int] = None,
    profile_dir: Optional[str] = None,
    rollout_bf16: bool = False,
    *,
    device: torch.device | str = "cuda",
    batch_callback: Optional[Callable[[TrainingState, types.Transition, Callable], None]] = None,
    mesh: Optional[mesh_lib.Mesh] = None,
):
    """Trains an intention PPO policy; returns (make_policy, (normalizer,
    policy state dict), metrics). `make_policy(normalizer, deterministic)`
    acts with the trained networks. `batch_callback(training_state, data,
    make_learner)`, if given, sees each training step's state and batch
    before the learning half changes the state; `make_learner(networks)` is
    the trainer's own Learner (loss, optimizer, minibatches and passes) over
    other networks of the same shapes, e.g. a copy on another device, and
    `make_learner(networks, one_process=True)` the same without the mesh
    (the one-process Learner of the whole batch).
    `randomization_fn(model, generator, num_envs)` (module docstring).
    With `get_activation` the logging policy handed to `policy_params_fn`
    carries the activation taps in its extras, as the JAX trainer's does.
    With `mesh`, data parallel over its ranks (module docstring): the
    batch is this rank's envs' and the metrics are rank 0's ({} on the
    others, as the JAX trainer's on processes other than 0)."""
    if batch_size * num_minibatches % num_envs:
        raise ValueError(f"batch_size * num_minibatches ({batch_size * num_minibatches}) is no multiple of num_envs")
    if use_lstm:
        raise NotImplementedError("use_lstm in the MLP trainer: the LSTM pipeline is agent/lstm_ppo/ppo.py")
    if freeze_decoder and checkpoint_to_restore is None:
        raise ValueError("freeze_decoder needs checkpoint_to_restore, the run whose decoder it freezes")
    device = data_parallel_device(mesh, device, num_envs, max_devices_per_host)
    main = mesh_lib.is_main(mesh)
    local_envs = num_envs // (1 if mesh is None else mesh.world_size)
    xt = time.time()
    config_dict = config_dict if config_dict is not None else {"network_config": {}, "env_config": {"render_interval": 1}}

    env_step_per_training_step = batch_size * unroll_length * num_minibatches * action_repeat
    num_evals_after_init = max(num_evals - 1, 1)
    key_init, key_env, key_train, key_eval, key_eval_test, key_randomize, key_randomize_eval = seeded_generators(
        seed, device, 6
    )
    # this rank's rows of the resets' and the rollout's draws
    env_key, train_key = (mesh_lib.rows(g, mesh, num_envs) for g in (key_env, key_train))
    env = _wrapper_for(environment)(
        environment, episode_length=episode_length, action_repeat=action_repeat,
        randomization_fn=bind_randomization(randomization_fn, key_randomize, num_envs, mesh),
    )
    env_state = env.reset(env_key, local_envs)
    obs_size = env_state.obs.shape[-1]
    reference_obs_size = int(env_state.info.get("reference_obs_size", obs_size))
    proprioceptive_obs_size = int(env_state.info.get("proprioceptive_obs_size", 0))
    config_dict.setdefault("network_config", {}).update(
        {
            "observation_size": obs_size,
            "action_size": env.action_size,
            "normalize_observations": normalize_observations,
            "reference_obs_size": reference_obs_size,
            "proprioceptive_obs_size": proprioceptive_obs_size,
        }
    )

    normalize = running_statistics.normalize if normalize_observations else types.identity_observation_preprocessor
    ppo_network = network_factory(
        obs_size, reference_obs_size, env.action_size, preprocess_observations_fn=normalize,
        generator=key_init, device=device,
    )
    make_policy = ppo_networks.make_inference_fn(ppo_network)
    kl_schedule = None
    if use_kl_schedule:
        kl_schedule = losses.create_ramp_schedule(
            max_value=kl_weight, ramp_steps=int(num_evals * kl_ramp_up_frac), schedule="linear"
        )

    frozen_normalizer = None
    if freeze_decoder:
        if proprioceptive_obs_size == 0:
            raise ValueError("Proprioceptive observation size is 0, but decoder parameters are being frozen.")
        loaded_normalizer, loaded_policy = checkpointing.CheckpointStore(checkpoint_to_restore).policy(device=device)
        decoder = {k: v for k, v in loaded_policy.items() if network_masks.is_decoder(k)}
        missing, unexpected = ppo_network.policy_network.load_state_dict(decoder, strict=False)
        if unexpected or any(network_masks.is_decoder(k) for k in missing):
            raise ValueError(f"the checkpoint's decoder does not fit: missing {missing}, unexpected {unexpected}")
        logging.info("Restored decoder parameters from %s; freezing them", checkpoint_to_restore)
        frozen_normalizer = running_statistics.RunningStatisticsState(
            **{
                k: getattr(loaded_normalizer, k)[-proprioceptive_obs_size:]
                for k in ("mean", "summed_variance", "std")
            },
            count=torch.zeros((), device=device),
        )

    def make_learner(networks: ppo_networks.PPOImitationNetworks, one_process: bool = False) -> Learner:
        """The learning half over `networks`: the clipped Adam of both
        networks' parameters and the PPO loss at this call's settings (with
        `freeze_decoder`, the decoder frozen and the normalizer's
        proprioceptive slice pinned), data parallel over the mesh unless
        `one_process`."""
        optimizer = gradients.make_optimizer(
            [*networks.policy_network.parameters(), *networks.value_network.parameters()], learning_rate
        )
        loss_fn = functools.partial(
            losses.compute_ppo_loss,
            ppo_network=networks,
            entropy_cost=entropy_cost,
            kl_weight=kl_weight,
            discounting=discounting,
            reward_scaling=reward_scaling,
            gae_lambda=gae_lambda,
            clipping_epsilon=clipping_epsilon,
            normalize_advantage=normalize_advantage,
            kl_schedule=kl_schedule,
        )
        frozen = ()
        if freeze_decoder:
            frozen = [p for n, p in networks.policy_network.named_parameters() if network_masks.is_decoder(n)]
        dp = None if one_process else mesh
        return Learner(loss_fn, optimizer, num_minibatches, num_updates_per_batch, frozen=frozen,
                       pinned=frozen_normalizer, mesh=dp, num_envs=num_envs)

    learner = make_learner(ppo_network)
    normalizer = running_statistics.init_state(obs_size, device)
    if freeze_decoder:
        normalizer = running_statistics.pin_tail(normalizer, frozen_normalizer)
    training_state = TrainingState(ppo_network, learner.optimizer, normalizer, 0)
    if checkpoint_to_restore is not None and not freeze_decoder:
        training_state.load_state_dict(checkpointing.load_training_state(checkpoint_to_restore))
        logging.info("Restored latest checkpoint at %s", checkpoint_to_restore)
    mesh_lib.replicate(replicated_tensors(training_state), mesh)

    unrolls_per_step = batch_size * num_minibatches // num_envs
    epoch = EpochTimer(
        learner,
        steps_per_epoch(num_timesteps, num_evals, env_step_per_training_step, num_resets_per_eval, epoch_steps_per_call),
        env_step_per_training_step,
        num_resets_per_eval,
        profile_dir if main else None,
        mesh,
    )
    # the rollout's policy forward only: the loss, the normalizer and the
    # master parameters stay float32
    rollout_dtype = torch.bfloat16 if rollout_bf16 else None

    def training_step(it) -> List[Dict[str, torch.Tensor]]:
        nonlocal env_state
        policy = make_policy(training_state.normalizer_params, compute_dtype=rollout_dtype)
        t0 = time.perf_counter()
        with record_function("rollout"):
            unrolls = []
            for _ in range(unrolls_per_step):
                env_state, data = acting.generate_unroll(
                    env, env_state, policy, train_key, unroll_length, extra_fields=("truncation",)
                )
                unrolls.append(data)
            data = _stack_unrolls(unrolls)
        epoch.rollout_s += _clock(device) - t0
        assert data.discount.shape[1:] == (unroll_length,)
        if batch_callback is not None:
            batch_callback(training_state, data, make_learner)
        metrics = learner(training_state, data, it, generator=key_train)
        training_state.env_steps = next_env_steps(training_state.env_steps, env_step_per_training_step)
        return metrics

    # ---- evaluators ------------------------------------------------------
    def make_evaluator(env_: Env, key: torch.Generator) -> acting.Evaluator:
        return acting.Evaluator(
            _wrapper_for(env_)(env_, episode_length=episode_length, action_repeat=action_repeat,
                 randomization_fn=bind_randomization(randomization_fn, key_randomize_eval, num_eval_envs)),
            functools.partial(make_policy, deterministic=deterministic_eval),
            num_eval_envs=num_eval_envs,
            episode_length=episode_length,
            action_repeat=action_repeat,
            key=key,
        )

    evaluator = evaluator_test_set = None
    if main:  # rank 0 alone evaluates
        evaluator = make_evaluator(environment if eval_env is None else eval_env, key_eval)
        if eval_env_test_set is not None:
            evaluator_test_set = make_evaluator(eval_env_test_set, key_eval_test)

    def evaluate(training_metrics: Metrics) -> Metrics:
        metrics = evaluator.run_evaluation(training_state.normalizer_params, training_metrics)
        if evaluator_test_set is not None:
            metrics = evaluator_test_set.run_evaluation(
                training_state.normalizer_params, metrics, data_split="test_set"
            )
        return metrics

    def save(step: int) -> None:
        if ckpt_mgr is not None and main:
            wrote = ckpt_mgr.save(step, training_state.policy_params(), training_state.state_dict(), config_dict)
            call_checkpoint_callback(checkpoint_callback, step, wrote)

    start_it = 0
    logging.info("Starting at iteration %s with %s evals left", start_it, num_evals_after_init)

    # ---- initial eval + checkpoint ---------------------------------------
    metrics = {}
    if num_evals > 1 and main:
        metrics = evaluate({})
        logging.info(metrics)
        progress_fn(start_it, metrics)
        save(0)

    training_metrics = {}
    start_it += 1
    current_step = 0
    for it in range(start_it, num_evals_after_init + start_it):
        logging.info("starting iteration %s %s", it, time.time() - xt)
        for _ in range(max(num_resets_per_eval, 1)):
            training_metrics = epoch(functools.partial(training_step, it))
            current_step = training_state.env_steps
            if num_resets_per_eval > 0:
                env_state = env.reset(env_key, local_envs)

        if not main:
            continue
        metrics = evaluate(training_metrics)
        render_interval = config_dict.get("env_config", {}).get("render_interval", 1)
        policy_params_fn(
            current_step=it,
            jit_logging_inference_fn=make_policy(
                training_state.normalizer_params, deterministic=True, get_activation=get_activation
            ),
            params=training_state.policy_params(),
            policy_params_fn_key=key_eval,
            render_video=(it % render_interval == 0),
        )
        logging.info(metrics)
        progress_fn(current_step, metrics)
        save(it)

    mesh_lib.assert_is_replicated(
        replicated_tensors(training_state), mesh, debug=f"rank {mesh and mesh.rank}, {current_step} thousand env steps"
    )
    logging.info("total steps: %s", current_step)
    mesh_lib.synchronize_hosts(mesh)
    return make_policy, training_state.policy_params(), metrics
