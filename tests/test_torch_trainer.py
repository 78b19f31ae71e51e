"""The learning half of the port's PPO training step against the JAX
package's, at tiny widths on the CPU.

The JAX side composes losses.compute_ppo_loss, gradients.gradient_update_fn,
the optax chain (clip_by_global_norm(10), adam) and running_statistics.update
exactly as track_mjx_tpu/agent/mlp_ppo/ppo.py does (its minibatch_step,
sgd_step and the normalizer update of training_step), under one jit. The
port's `ppo.Learner` takes the same Transition batch, the same permutations
and the same latent and entropy noises (drawn from the JAX keys as the JAX
loss draws them), and the same parameters (`params_from_flax`), from a zero
state and from a JAX state after one learning half (Adam moments and count
carried by `optimizer_state_from_optax`, so Adam's bias correction is at
step > 0). Also: the batch layout of the rollout, env_steps' count in
thousands, and the optax-style clip on a batch whose gradient norm exceeds
10.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from track_mjx_tpu.agent import gradients as jgradients
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent import types as jtypes
from track_mjx_tpu.agent.mlp_ppo import losses as jlosses
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu_torch.agent import gradients, running_statistics, types
from track_mjx_tpu_torch.agent.mlp_ppo import losses, ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.agent.ppo_factory import optimizer_state_from_optax

torch.set_num_threads(1)

OBS, REF, ACT, LAT = 14, 9, 3, 4
N, T, M, U = 8, 5, 2, 2  # trajectories, unroll length, minibatches, passes
LR = 1e-3
KW = dict(entropy_cost=1e-2, kl_weight=0.1, discounting=0.98, gae_lambda=0.95, clipping_epsilon=0.2,
          normalize_advantage=True)
SCHEDULE = dict(max_value=0.1, ramp_steps=2, schedule="linear")
# Loss terms of every gradient step: the same float32 formulas, sums in
# another order; measured up to 1.7e-6 relative to max(1, |JAX|).
LOSS_REL = 1e-5
# Gradients of the first minibatch, relative to the largest element of the
# JAX gradient of the same tensor; measured up to 1.9e-6.
GRAD_REL = 1e-5
# Parameters after the learning half, in units of the learning rate: Adam
# moves each parameter by about lr per step whatever the gradient's size, so
# roundoff in a small gradient shows as a fraction of lr; measured up to
# 2.0e-3 lr after the 4 steps of a learning half.
PARAM_LR = 1e-2
# The normalizer after the update: Welford sums in another order (1.3e-7).
NORM_REL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _batch(seed, reward_scale=1.0):
    """A batch-major Transition [N, T, ...] of numpy arrays with
    terminations, truncations and random behavior log-probs."""
    rng = np.random.RandomState(seed)
    obs = (rng.randn(N, T + 1, OBS) * 2 + 0.5).astype(np.float32)
    raw = rng.randn(N, T, ACT).astype(np.float32)
    discount = (rng.uniform(size=(N, T)) > 0.1).astype(np.float32)
    truncation = ((rng.uniform(size=(N, T)) < 0.1) & (discount == 0)).astype(np.float32)
    return {
        "observation": obs[:, :-1],
        "action": np.tanh(raw),
        "reward": (rng.randn(N, T) * reward_scale).astype(np.float32),
        "discount": discount,
        "next_observation": obs[:, 1:],
        "extras": {
            "policy_extras": {
                "raw_action": raw,
                "log_prob": (rng.randn(N, T) * 0.3 - 3.0).astype(np.float32),
            },
            "state_extras": {"truncation": truncation},
        },
    }


def _jax_transition(b):
    return jtypes.Transition(**{k: jax.tree.map(jnp.asarray, v) for k, v in b.items()})


def _torch_transition(b):
    conv = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    return types.Transition(**{k: jax.tree.map(conv, v) for k, v in b.items()})


def _jax_draws(key_sgd):
    """The permutations and noises the JAX learning half draws from key_sgd
    (ppo.py sgd_step and minibatch_step, ppo_math.py's loss split and the
    intention policy's split of its forward key)."""
    draws = []
    key = key_sgd
    for _ in range(U):
        key, key_perm, key_grad = jax.random.split(key, 3)
        perm = np.asarray(jax.random.permutation(key_perm, N))
        noises = []
        for _ in range(M):
            key_grad, key_loss = jax.random.split(key_grad)
            _, forward_key, entropy_key = jax.random.split(key_loss, 3)
            _, sample_rng = jax.random.split(forward_key)
            noises.append((
                torch.as_tensor(np.array(jax.random.normal(sample_rng, (T, N // M, LAT)))),
                torch.as_tensor(np.array(jax.random.normal(entropy_key, (T, N // M, ACT)))),
            ))
        draws.append(ppo.UpdateDraws(torch.as_tensor(perm.astype(np.int64)), noises))
    return draws


@pytest.fixture(scope="module")
def jax_side():
    net = jpn.make_intention_ppo_networks(
        OBS, REF, ACT, preprocess_observations_fn=jrs.normalize, intention_latent_size=LAT,
        encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,), value_hidden_layer_sizes=(16, 16),
    )
    optimizer = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(learning_rate=LR))
    loss_fn = functools.partial(
        jlosses.compute_ppo_loss, ppo_network=net, reward_scaling=1.0,
        kl_schedule=jlosses.create_ramp_schedule(**SCHEDULE), **KW,
    )
    update = jgradients.gradient_update_fn(loss_fn, optimizer, pmap_axis_name=None, has_aux=True)

    @jax.jit
    def learn(params, opt_state, normalizer, data, key_sgd, it):
        normalizer = jrs.update(normalizer, data.observation)

        def minibatch_step(carry, mb):
            opt_state, params, key, it = carry
            key, key_loss = jax.random.split(key)
            (_, metrics), params, opt_state = update(params, normalizer, mb, key_loss, it, optimizer_state=opt_state)
            return (opt_state, params, key, it), metrics

        def sgd_step(carry, unused_t):
            opt_state, params, key, it = carry
            key, key_perm, key_grad = jax.random.split(key, 3)
            shuffled = jax.tree.map(
                lambda x: jnp.reshape(jax.random.permutation(key_perm, x), (M, -1) + x.shape[1:]), data
            )
            (opt_state, params, _, _), metrics = jax.lax.scan(
                minibatch_step, (opt_state, params, key_grad, it), shuffled, length=M
            )
            return (opt_state, params, key, it), metrics

        (opt_state, params, _, _), metrics = jax.lax.scan(
            sgd_step, (opt_state, params, key_sgd, it), (), length=U
        )
        return params, opt_state, normalizer, metrics

    grad_fn = jax.jit(jax.grad(lambda *a: loss_fn(*a)[0]))
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params = jlosses.PPONetworkParams(policy=net.policy_network.init(k1), value=net.value_network.init(k2))
    return net, optimizer, learn, grad_fn, params


def _port_state(params, normalizer, opt_state=None):
    """The port's TrainingState from JAX parameters (and optax state)."""
    networks = tpn.make_intention_ppo_networks(
        OBS, REF, ACT, preprocess_observations_fn=running_statistics.normalize, intention_latent_size=LAT,
        encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,), value_hidden_layer_sizes=(16, 16),
        generator=torch.Generator().manual_seed(0), device="cpu",
    )
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    carried = tpn.params_from_flax(as_np(params.policy), as_np(params.value), as_np(normalizer), device="cpu")
    networks.policy_network.load_state_dict(carried.policy)
    networks.value_network.load_state_dict(carried.value)
    optimizer = gradients.make_optimizer(
        [*networks.policy_network.parameters(), *networks.value_network.parameters()], LR
    )
    if opt_state is not None:
        adam = opt_state[1][0]
        optimizer.load_state_dict(
            optimizer_state_from_optax(adam.count, as_np(adam.mu), as_np(adam.nu), networks, optimizer)
        )
    return ppo.TrainingState(networks, optimizer, carried.normalizer, 0)


def _port_learner(state):
    loss_fn = functools.partial(
        losses.compute_ppo_loss, ppo_network=state.networks, reward_scaling=1.0,
        kl_schedule=losses.create_ramp_schedule(**SCHEDULE), **KW,
    )
    return ppo.Learner(loss_fn, state.optimizer, M, U), loss_fn


def _compare(state, jparams, jnormalizer, metrics, jmetrics):
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss", "kl_weight"):
        got = np.array([float(m[name]) for m in metrics])
        want = np.asarray(jmetrics[name]).reshape(-1)
        assert _rel(got, want) < LOSS_REL, f"{name}: {got} against {want}"
    carried = tpn.params_from_flax(
        jax.tree.map(np.asarray, jparams.policy), jax.tree.map(np.asarray, jparams.value),
        jax.tree.map(np.asarray, jnormalizer), device="cpu",
    )
    worst = 0.0
    for sd, want_sd in ((state.networks.policy_network.state_dict(), carried.policy),
                        (state.networks.value_network.state_dict(), carried.value)):
        assert set(sd) == set(want_sd)
        for k in sd:
            worst = max(worst, float((sd[k] - want_sd[k]).abs().max()) / LR)
    assert worst < PARAM_LR, f"parameters differ by {worst:.3e} lr"
    for k in ("count", "mean", "summed_variance", "std"):
        assert _rel(getattr(state.normalizer_params, k), getattr(carried.normalizer, k)) < NORM_REL, k
    return worst


@pytest.mark.parametrize("case", ["zero state", "converted state at step > 0", "gradient norm over 10"])
def test_learning_half_matches_jax(jax_side, case):
    net, optimizer, learn, grad_fn, params = jax_side
    normalizer = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jnp.float32))
    opt_state = optimizer.init(params)
    reward_scale = 300.0 if case == "gradient norm over 10" else 1.0
    it = 1
    if case == "converted state at step > 0":
        params, opt_state, normalizer, _ = learn(params, opt_state, normalizer, _jax_transition(_batch(1)),
                                                 jax.random.PRNGKey(5), jnp.float32(1))
        assert int(opt_state[1][0].count) == U * M
        it = 2
    batch = _batch(2, reward_scale)
    key_sgd = jax.random.PRNGKey(6)
    state = _port_state(params, normalizer, opt_state if case == "converted state at step > 0" else None)

    # the gradient of the first minibatch, from the updated normalizer
    draws = _jax_draws(key_sgd)
    jdata = _jax_transition(batch)
    jnorm1 = jrs.update(normalizer, jdata.observation)
    key = key_sgd
    key, key_perm, key_grad = jax.random.split(key, 3)
    _, key_loss = jax.random.split(key_grad)
    first = jax.tree.map(lambda x: jax.random.permutation(key_perm, x)[: N // M], jdata)
    jgrad = grad_fn(params, jnorm1, first, key_loss, jnp.float32(it))
    jgrad_sd = tpn.params_from_flax(jax.tree.map(np.asarray, jgrad.policy), jax.tree.map(np.asarray, jgrad.value),
                                    jax.tree.map(np.asarray, jnorm1), device="cpu")
    learner, loss_fn = _port_learner(state)
    tdata = _torch_transition(batch)
    tnorm1 = running_statistics.update(state.normalizer_params, tdata.observation)
    tfirst = types.Transition(*(jax.tree.map(lambda x: x[draws[0].permutation[: N // M]], f) for f in tdata))
    loss, _ = loss_fn(tnorm1, tfirst, *draws[0].noises[0], it)
    nets = state.networks
    loss.backward()
    for sd_grad, module in ((jgrad_sd.policy, nets.policy_network), (jgrad_sd.value, nets.value_network)):
        for k, p in module.named_parameters():
            want = sd_grad[k]
            err = float((p.grad - want).abs().max() / max(float(want.abs().max()), 1e-30))
            assert err < GRAD_REL, f"gradient of {k}: {err:.3e}"
    norm = float(gradients.global_norm([p.grad for p in (*nets.policy_network.parameters(),
                                                          *nets.value_network.parameters())]))
    want_norm = float(optax.global_norm(jgrad))
    assert norm == pytest.approx(want_norm, rel=1e-5)
    if case == "gradient norm over 10":
        assert norm > 10.0
    else:
        assert norm < 10.0
    state.optimizer.zero_grad()

    # the whole learning half from the same state and draws
    jparams, _, jnormalizer, jmetrics = learn(params, opt_state, normalizer, jdata, key_sgd, jnp.float32(it))
    metrics = learner(state, tdata, it, draws=draws)
    assert len(metrics) == U * M
    _compare(state, jparams, jnormalizer, metrics, jmetrics)


def test_batch_layout_matches_jax():
    """[unrolls][T, envs] -> [unrolls * envs, T], trajectory = unroll *
    num_envs + env, as ppo.py swaps and reshapes."""
    unrolls, envs = 3, 4
    x = np.arange(unrolls * T * envs * 2, dtype=np.float32).reshape(unrolls, T, envs, 2)
    want = np.reshape(np.swapaxes(x, 1, 2), (-1, T, 2))
    transitions = [types.Transition(*(torch.as_tensor(x[u]) for _ in range(5)), extras={}) for u in range(unrolls)]
    got = ppo._stack_unrolls(transitions)
    np.testing.assert_array_equal(got.observation.numpy(), want)
    np.testing.assert_array_equal(got.observation[1 * envs + 2].numpy(), x[1, :, 2])


@pytest.mark.parametrize("per_step", [81920, 327680, 16, 1500])
def test_env_steps_count_in_thousands_like_jax(per_step):
    jax_steps, port_steps = jnp.zeros((), jnp.int32), 0
    for _ in range(7):
        jax_steps = jnp.int32(jax_steps + per_step / ppo.STEPS_IN_THOUSANDS)
        port_steps = ppo.next_env_steps(port_steps, per_step)
        assert port_steps == int(jax_steps)


def test_loading_a_state_leaves_the_given_dict_alone(jax_side):
    """Two trainers loaded from one state dict step independently: the
    optimizer keeps a CPU step tensor as given, so the state is copied in."""
    _, _, _, _, params = jax_side
    normalizer = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jnp.float32))
    first = _port_state(params, normalizer)
    learner, _ = _port_learner(first)
    learner(first, _torch_transition(_batch(3)), 1, draws=_jax_draws(jax.random.PRNGKey(1)))
    saved = first.state_dict()
    steps = [float(s["step"]) for s in saved["optimizer_state"]["state"].values()]
    assert steps == [U * M] * len(steps)
    second = _port_state(params, normalizer)
    second.load_state_dict(saved)
    learner2, _ = _port_learner(second)
    learner2(second, _torch_transition(_batch(4)), 1, draws=_jax_draws(jax.random.PRNGKey(2)))
    assert [float(s["step"]) for s in saved["optimizer_state"]["state"].values()] == steps
    assert all(float(s["step"]) == 2 * U * M for s in second.optimizer.state.values())
