"""PPO trainer of the LSTM intention pipeline, on one device or data
parallel over the ranks of a `parallel.mesh.Mesh`.

Port of track_mjx_tpu/agent/lstm_ppo/ppo.py. It shares the MLP trainer's
structure and pieces (agent/mlp_ppo/ppo.py: the batch layout, the Learner,
env_steps in thousands, the phases and their host ms, one device generator
for resets, rollout noise, permutations and loss noises, a second for the
evals) and keeps the reference's differences from it:

- the policy's LSTM carry (h, c) per env is threaded through the rollout
  (`acting.recurrent_generate_unroll`, which records each step's pre-step
  carry for the loss and reseeds a finished episode's carry with zeros)
  and kept in `TrainingState.hidden_state` from one training step to the
  next, across env resets too; it starts as the wrapper's zero carry, and
  a checkpoint stores it;
- the optimizer is plain adam, with no global-norm clip;
- no KL schedule: the loss's KL weight is fixed;
- the passes run on the normalizer the training step started with; the
  normalizer update from the batch comes after them;
- no test-split evaluator (`eval_env_test_set` is accepted and ignored,
  as in the reference);
- `freeze_decoder` raises: the recurrent policy has no module named
  `decoder` (its decoder is `lstm_decoder`), so the JAX package's mask
  would freeze nothing, and the JAX LSTM trainer drops the option without a
  word; a foreign env raises too, as the JAX LSTM trainer wraps only
  tracking envs.

`randomization_fn`, `rollout_bf16` and `profile_dir` work as in the MLP
trainer. The JAX LSTM trainer hands `randomization_fn` to the wrappers
unsplit, with no rng; the port binds one generator stream for the training
envs and one for the eval envs, as the MLP trainers do.

The widths of the carry come from `config_dict["network_config"]`
(hidden_state_size, hidden_layer_num), as in the reference.

Data parallel (`mesh`) as the MLP trainer (agent/mlp_ppo/ppo.py), with the
per-env carry sharded with its envs (the JAX trainer's `shard_batch` of
`hidden_state`): a rank keeps its envs' carry, the loss's re-unroll runs
over the rank's sequences, and a checkpoint stores the whole batch's
carry, gathered from every rank (a restore takes each rank's slice).
`max_devices_per_host` is honoured as in the MLP trainer; the JAX LSTM
trainer takes it and never reads it (its mesh spans every device).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from track_mjx_tpu_torch.agent import checkpointing, gradients, running_statistics, types
from track_mjx_tpu_torch.agent.lstm_ppo import acting
from track_mjx_tpu_torch.agent.lstm_ppo import losses, ppo_networks
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.envs.base import Env
from track_mjx_tpu_torch.parallel import mesh as mesh_lib

Metrics = types.Metrics
UpdateDraws = mlp_ppo.UpdateDraws
next_env_steps = mlp_ppo.next_env_steps


@dataclasses.dataclass
class TrainingState(mlp_ppo.TrainingState):
    """The MLP trainer's state and the per-env rollout carry (h, c), each
    [num_envs, hidden_layer_num, hidden_state_size]."""

    hidden_state: Tuple[torch.Tensor, torch.Tensor] = None

    def state_dict(self) -> dict:
        return {**super().state_dict(), "hidden_state": self.hidden_state}

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        device = self.normalizer_params.mean.device
        self.hidden_state = tuple(copy.deepcopy(s).to(device) for s in state["hidden_state"])


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
    get_activation: bool = False,
    use_lstm: bool = True,
    use_kl_schedule: bool = False,
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
    """Trains an LSTM intention PPO policy; returns (make_policy,
    (normalizer, policy state dict), metrics), `make_policy(normalizer,
    deterministic)` a recurrent policy. `batch_callback` as in the MLP
    trainer; its Learner runs plain adam and the normalizer update last.
    With `get_activation` the rollout's and the evaluator's policies carry
    the activation taps in their extras, as the JAX LSTM trainer's do (its
    logging policy never does). `mesh`: data parallel (module docstring)."""
    del use_kl_schedule, kl_ramp_up_frac, eval_env_test_set, use_lstm
    if batch_size * num_minibatches % num_envs:
        raise ValueError(f"batch_size * num_minibatches ({batch_size * num_minibatches}) is no multiple of num_envs")
    if freeze_decoder:
        raise NotImplementedError(
            "freeze_decoder with the LSTM pipeline: its policy has no `decoder` module to freeze "
            "(the JAX LSTM trainer ignores the option)"
        )
    if not isinstance(environment, Env):
        raise NotImplementedError("a foreign (non-tracking) env with the LSTM pipeline: use the MLP trainer")
    device = mlp_ppo.data_parallel_device(mesh, device, num_envs, max_devices_per_host)
    main = mesh_lib.is_main(mesh)
    local_envs = num_envs // (1 if mesh is None else mesh.world_size)
    xt = time.time()
    config_dict = config_dict if config_dict is not None else {
        "network_config": {"hidden_state_size": 128, "hidden_layer_num": 2},
        "env_config": {"render_interval": 1},
    }
    hidden_state_size = config_dict["network_config"]["hidden_state_size"]
    hidden_layer_num = config_dict["network_config"]["hidden_layer_num"]

    env_step_per_training_step = batch_size * unroll_length * num_minibatches * action_repeat
    key_init, key_env, key_train, key_eval, key_randomize, key_randomize_eval = mlp_ppo.seeded_generators(
        seed, device, 5
    )

    def wrap(env_: Env, generator: torch.Generator, n: int, mesh_=None):
        return wrappers.wrap(
            env_, episode_length=episode_length, action_repeat=action_repeat,
            randomization_fn=mlp_ppo.bind_randomization(randomization_fn, generator, n, mesh_),
            use_lstm=True, hidden_state_dim=hidden_state_size, hidden_layer_num=hidden_layer_num,
        )

    # this rank's rows of the resets' and the rollout's draws
    env_key, train_key = (mesh_lib.rows(g, mesh, num_envs) for g in (key_env, key_train))
    env = wrap(environment, key_randomize, num_envs, mesh)
    env_state = env.reset(env_key, local_envs)
    obs_size = env_state.obs.shape[-1]
    reference_obs_size = int(env_state.info["reference_obs_size"])
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

    def make_learner(networks: ppo_networks.PPOImitationNetworks, one_process: bool = False) -> mlp_ppo.Learner:
        """The learning half over `networks`: plain adam over both networks'
        parameters, the LSTM loss at this call's settings, the normalizer
        updated after the passes; data parallel over the mesh unless
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
        )
        return mlp_ppo.Learner(
            loss_fn, optimizer, num_minibatches, num_updates_per_batch, max_grad_norm=None, normalizer_after_sgd=True,
            mesh=None if one_process else mesh, num_envs=num_envs,
        )

    learner = make_learner(ppo_network)
    training_state = TrainingState(
        ppo_network, learner.optimizer, running_statistics.init_state(obs_size, device), 0,
        hidden_state=tuple(s.clone() for s in env_state.info["hidden_state"]),
    )
    if checkpoint_to_restore is not None:
        training_state.load_state_dict(checkpointing.load_training_state(checkpoint_to_restore))
        training_state.hidden_state = tuple(mesh_lib.shard_batch(training_state.hidden_state, mesh))
        logging.info("Restored latest checkpoint at %s", checkpoint_to_restore)
    mesh_lib.replicate(mlp_ppo.replicated_tensors(training_state), mesh)

    unrolls_per_step = batch_size * num_minibatches // num_envs
    epoch = mlp_ppo.EpochTimer(
        learner,
        mlp_ppo.steps_per_epoch(
            num_timesteps, num_evals, env_step_per_training_step, num_resets_per_eval, epoch_steps_per_call
        ),
        env_step_per_training_step,
        num_resets_per_eval,
        profile_dir if main else None,
        mesh,
    )
    rollout_dtype = torch.bfloat16 if rollout_bf16 else None  # the rollout's policy forward only

    def training_step() -> List[Dict[str, torch.Tensor]]:
        nonlocal env_state
        policy = make_policy(training_state.normalizer_params, compute_dtype=rollout_dtype,
                             get_activation=get_activation)
        carry = training_state.hidden_state
        t0 = time.perf_counter()
        with record_function("rollout"):
            unrolls = []
            for _ in range(unrolls_per_step):
                env_state, data, carry = acting.generate_unroll(
                    env, env_state, policy, train_key, carry, unroll_length, extra_fields=("truncation",)
                )
                unrolls.append(data)
            data = mlp_ppo._stack_unrolls(unrolls)
        epoch.rollout_s += mlp_ppo._clock(device) - t0
        assert data.discount.shape[1:] == (unroll_length,)
        if batch_callback is not None:
            batch_callback(training_state, data, make_learner)
        metrics = learner(training_state, data, 0, generator=key_train)  # step 0: no KL schedule
        training_state.hidden_state = carry
        training_state.env_steps = next_env_steps(training_state.env_steps, env_step_per_training_step)
        return metrics

    evaluator = None
    if main:  # rank 0 alone evaluates
        evaluator = acting.Evaluator(
            wrap(environment if eval_env is None else eval_env, key_randomize_eval, num_eval_envs),
            functools.partial(make_policy, deterministic=deterministic_eval, get_activation=get_activation),
            num_eval_envs=num_eval_envs,
            episode_length=episode_length,
            action_repeat=action_repeat,
            key=key_eval,
        )

    def save(step: int) -> None:
        """Rank 0 writes the checkpoint (where it has a manager), with the
        whole batch's carry, which every rank takes part in gathering."""
        hidden = tuple(mesh_lib.gather_batch(training_state.hidden_state, mesh))
        if ckpt_mgr is not None and main:
            state = dict(training_state.state_dict(), hidden_state=hidden)
            wrote = ckpt_mgr.save(step, training_state.policy_params(), state, config_dict)
            mlp_ppo.call_checkpoint_callback(checkpoint_callback, step, wrote)

    # ---- initial eval + checkpoint ---------------------------------------
    metrics = {}
    if num_evals > 1:
        if main:
            metrics = evaluator.run_evaluation(training_state.normalizer_params, {})
            logging.info(metrics)
            progress_fn(0, metrics)
        save(0)

    training_metrics = {}
    current_step = 0
    for it in range(1, max(num_evals - 1, 1) + 1):
        logging.info("starting iteration %s %s", it, time.time() - xt)
        for _ in range(max(num_resets_per_eval, 1)):
            training_metrics = epoch(training_step)
            current_step = training_state.env_steps
            if num_resets_per_eval > 0:
                env_state = env.reset(env_key, local_envs)  # the carry goes on (reference)

        if main:
            metrics = evaluator.run_evaluation(training_state.normalizer_params, training_metrics)
            logging.info(metrics)
            progress_fn(current_step, metrics)
            policy_params_fn(
                current_step=it,
                jit_logging_inference_fn=make_policy(training_state.normalizer_params, deterministic=True),
                params=training_state.policy_params(),
                policy_params_fn_key=key_eval,
            )
        save(it)

    mesh_lib.assert_is_replicated(  # the carry is per env, not replicated
        mlp_ppo.replicated_tensors(training_state), mesh,
        debug=f"rank {mesh and mesh.rank}, {current_step} thousand env steps",
    )
    logging.info("total steps: %s", current_step)
    mesh_lib.synchronize_hosts(mesh)
    return make_policy, training_state.policy_params(), metrics
