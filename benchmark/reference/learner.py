"""The reference's learning halves, following the program's first training
steps: from the initial state, each step's Welford normalizer update over
the batch's observations, then `num_updates_per_batch` passes of
`num_minibatches` clipped Adam steps over a permutation of the
trajectories, on the batches the program's rollouts produced and with the
trainer's own draws (the permutations and the loss's latent and entropy
noises, from the stream's state as the program's learning half found it)."""

from __future__ import annotations

import functools
from typing import Dict, List

import torch

from benchmark.reference import build
from benchmark.reference.plain.agent import gradients, running_statistics, types
from benchmark.reference.plain.agent.mlp_ppo import losses


def _minibatch(batch: Dict[str, torch.Tensor], rows: torch.Tensor) -> types.Transition:
    """The Transition of `rows` of a batch; next_observation holds the last
    step only, which is all the loss reads of it."""
    take = {k: v[rows] for k, v in batch.items()}
    return types.Transition(
        observation=take["observation"],
        action=take["raw_action"],
        reward=take["reward"],
        discount=take["discount"],
        next_observation=take["next_observation_last"][:, None],
        extras={"policy_extras": {"raw_action": take["raw_action"], "log_prob": take["log_prob"]},
                "state_extras": {"truncation": take["truncation"]}},
    )


def follow(nets, cfg: dict, params0: Dict[str, torch.Tensor], normalizer0: Dict[str, torch.Tensor],
           batches: List[Dict[str, torch.Tensor]], generator_states: List[torch.Tensor], device,
           num_evals: int = 1, it: int = 1, half_batch: bool = False, frozen_state: bool = False) -> dict:
    """Each step's mean total loss, the first gradient as Adam got it
    (by leaf), the parameters after the steps, and after each step the
    parameters and the normalizer it left (host copies: the next rollout's
    policy acts with them). `half_batch` and
    `frozen_state` plant faults: the loss over the first half of each
    minibatch only, or no update at all."""
    tc = cfg["train_setup"]["train_config"]
    net_cfg = cfg["network_config"]
    build.load_params(nets, {k: v.to(device) for k, v in params0.items()})
    named = [("policy." + n, p) for n, p in nets.policy_network.named_parameters()] + [
        ("value." + n, p) for n, p in nets.value_network.named_parameters()]
    optimizer = gradients.make_optimizer([p for _, p in named], tc["learning_rate"])
    kl_schedule = None
    if net_cfg["kl_schedule"]:
        kl_schedule = losses.create_ramp_schedule(max_value=net_cfg["kl_weight"], ramp_steps=int(num_evals * 0.25))
    loss_fn = functools.partial(
        losses.compute_ppo_loss, ppo_network=nets, entropy_cost=tc["entropy_cost"], kl_weight=net_cfg["kl_weight"],
        discounting=tc["discounting"], reward_scaling=tc["reward_scaling"], gae_lambda=0.95,
        clipping_epsilon=tc["clipping_epsilon"], normalize_advantage=True, kl_schedule=kl_schedule,
    )
    if half_batch:
        full = loss_fn

        def loss_fn(norm, data, latent, entropy, step):
            half = data.observation.shape[0] // 2
            return full(norm, type(data)(*(_rows(x, half) for x in data)), latent, entropy, step)
    update = gradients.gradient_update_fn(loss_fn, optimizer, gradients.MAX_GRAD_NORM)
    first = {}

    def first_step(opt, args, kwargs):
        if not first:
            for name, p in named:
                first[name] = opt.state[p]["exp_avg"].detach().clone() / (1 - opt.param_groups[0]["betas"][0])

    hook = optimizer.register_step_post_hook(first_step)
    normalizer = build.normalizer(normalizer0, device)
    step_losses, after = [], []
    num_minibatches, passes = int(tc["num_minibatches"]), int(tc["num_updates_per_batch"])
    for host_batch, gen_state in zip(batches, generator_states):
        batch = {k: v.to(device) for k, v in host_batch.items()}
        normalizer = running_statistics.update(normalizer, batch["observation"])
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        n = batch["observation"].shape[0]
        losses_k = []
        for _ in range(passes):
            perm = torch.randperm(n, generator=gen, device=device)
            for rows in perm.reshape(num_minibatches, -1):
                if frozen_state:
                    continue
                loss, _ = update(normalizer, _minibatch(batch, rows), gen, gen, it)
                losses_k.append(loss.detach())
        step_losses.append(torch.stack(losses_k).mean().item() if losses_k else float("nan"))
        after.append({"params": {k: v.detach().to("cpu", copy=True) for k, v in build.params(nets).items()},
                      "normalizer": {k: getattr(normalizer, k).detach().to("cpu", copy=True)
                                     for k in ("count", "mean", "summed_variance", "std")}})
        del batch
    hook.remove()
    return {"losses": step_losses, "first_grad": {k: v.cpu() for k, v in first.items()},
            "params": after[-1]["params"], "after": after}


def _rows(x, half):
    if isinstance(x, torch.Tensor):
        return x[:half]
    if isinstance(x, dict):
        return {k: _rows(v, half) for k, v in x.items()}
    return x
