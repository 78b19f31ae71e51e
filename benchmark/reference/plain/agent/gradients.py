"""Gradient update: optax's global-norm clip, then Adam.

Port of track_mjx_tpu/agent/gradients.py and of the optimizer chain of
track_mjx_tpu/agent/mlp_ppo/ppo.py (`optax.chain(clip_by_global_norm(10),
adam(lr))`; the LSTM trainer's is `adam(lr)` alone, no clip). The clip is optax's, not `torch.nn.utils.clip_grad_norm_`
(which scales by max_norm / (norm + 1e-6) and always rescales): gradients
whose global norm, over the policy and the value parameters together, is
below max_norm are left alone, the others become g / norm * max_norm. Adam
is `torch.optim.Adam` with optax's b1 = 0.9, b2 = 0.999, eps = 1e-8 (eps_root
0): the same update up to roundoff (torch divides sqrt(v) by sqrt(1 - b2^t)
where optax takes the root of v / (1 - b2^t)), one optimizer over both
networks' parameters, as `PPONetworkParams` is one optax tree.

Decoder transfer (`freeze_decoder`) is the JAX trainer's
`chain(chain(clip, adam), freeze(mask))`: the clip's global norm still
counts the frozen parameters' gradients, and then no update reaches them.
Here their gradients are dropped after the clip, so Adam skips them and
keeps no state for them; the other parameters' updates are the same, as
Adam works elementwise.

Data parallel (`mesh`): each rank's loss is its share of the minibatch's
mean (agent/ppo_math.py), so the gradients are summed over the ranks (one
all_reduce of every gradient and the loss terms in one flat buffer) before
the clip: every rank then clips the same gradient and takes the same Adam
step, and the parameters stay bitwise replicated.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch

from benchmark.reference.plain.parallel import mesh as mesh_lib

MAX_GRAD_NORM = 10.0


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float) -> torch.optim.Adam:
    """optax.adam(learning_rate) over `params` (policy first, then value)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of `grads`."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """optax.clip_by_global_norm, in place and without a host sync: each
    gradient stays as it is where the global norm is below `max_norm`, else
    becomes g / norm * max_norm. Returns the norm before the clip."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def gradient_update_fn(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    max_grad_norm: Optional[float] = MAX_GRAD_NORM,
    frozen: Iterable[torch.nn.Parameter] = (),
    mesh: Optional[mesh_lib.Mesh] = None,
    summed: Sequence[str] = (),
) -> Callable:
    """f(*args) -> (loss, aux): the gradient of `loss_fn(*args) -> (loss,
    aux)` in the optimizer's parameters, clipped by global norm (not with
    `max_grad_norm` None: the LSTM trainer's plain adam), then one optimizer
    step, in place, which leaves the `frozen` parameters as they are. With
    `mesh` the gradients and the `summed` entries of aux (each rank's
    share) are summed over the ranks first (module docstring)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    frozen = list(frozen)

    def f(*args, **kwargs):
        optimizer.zero_grad()
        loss, aux = loss_fn(*args, **kwargs)
        loss.backward()
        if mesh is not None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            reduced = mesh_lib.all_reduce_sum(grads + [aux[k] for k in summed], mesh)
            for p, g in zip(params, reduced):
                p.grad = g
            aux = dict(aux, **dict(zip(summed, reduced[len(params):])))
        if max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in params if p.grad is not None], max_grad_norm)
        for p in frozen:
            p.grad = None
        optimizer.step()
        return loss, aux

    return f
