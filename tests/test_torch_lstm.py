"""The port's LSTM pipeline against the JAX package's, at widths 16 on the
CPU: the recurrent intention policy on carried flax weights (LSTM cells
included), the LSTM auto-reset wrapper and the recurrent actor on the toy
walker (the carry recorded before each step and reseeded with zeros where
an episode ended), the BPTT loss and its gradients on identical arrays with
episodes ending inside the sequences, and one learning half of the LSTM
trainer (plain adam, the passes on the pre-update normalizer, then the
normalizer update) fed the JAX permutations and noises. Also the JAX
package's LSTM trainer tests (tests/test_train.py) at widths 16: a smoke
run on the toy walker, and the bf16 rollout, which the port refuses."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import fed_reset, jax_policy_noise, jax_reset_draws, per_env_rel, toy_envs
from track_mjx_tpu.agent import acting as jacting
from track_mjx_tpu.agent import gradients as jgradients
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent import types as jtypes
from track_mjx_tpu.agent.lstm_ppo import losses as jlosses
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu_torch.agent import acting, gradients, running_statistics, types
from track_mjx_tpu_torch.agent.lstm_ppo import losses, ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.agent.mlp_ppo import ppo as mlp_ppo
from track_mjx_tpu_torch.agent.ppo_factory import optimizer_state_from_optax
from track_mjx_tpu_torch.envs import wrappers

torch.set_num_threads(1)

OBS, REF, ACT, LAT, HID, LAYERS = 14, 9, 3, 4, 16, 2
WIDTHS = dict(intention_latent_size=LAT, hidden_state_size=HID, hidden_layer_num=LAYERS,
              encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,), value_hidden_layer_sizes=(16, 16))
N, T, M, U = 8, 5, 2, 2  # trajectories, unroll length, minibatches, passes
LR = 1e-3
KW = dict(entropy_cost=1e-2, kl_weight=0.1, discounting=0.98, gae_lambda=0.95, clipping_epsilon=0.2,
          normalize_advantage=True)
# The policy's outputs and carry on carried weights: the same float32
# products (an LSTM cell's four gates in one product here, one per gate
# in flax), sums in another order; relative to max(1, max |JAX|); measured
# up to 3.2e-7.
POLICY_REL = 1e-5
# Loss terms of the BPTT loss and of every gradient step of a learning half
# (relative to max(1, |JAX|); measured up to 4.1e-7); the gradients
# relative to each tensor's largest element (1.0e-6); parameters after a
# learning half in units of the learning rate (Adam moves each by about lr
# per step whatever the gradient's size; 1.8e-4 lr); the normalizer's
# Welford sums.
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PARAM_LR = 2e-3
NORM_REL = 1e-5
# The toy walker's free-running steps (tests/test_torch_train_cli.py's
# evaluator bar): the env's roundoff and the policy's over 3 steps;
# measured up to 1.4e-6.
UNROLL_REL = 5e-5
B, EPISODE, NOISE = 6, 2, 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_networks(pp, vp, norm, obs=OBS, ref=REF, act=ACT):
    """The port's LSTM networks carrying the JAX parameters, and the
    carried normalizer."""
    nets = tpn.make_intention_ppo_networks(obs, ref, act, preprocess_observations_fn=running_statistics.normalize,
                                           generator=torch.Generator().manual_seed(0), device="cpu", **WIDTHS)
    carried = tpn.params_from_flax(_as_np(pp), _as_np(vp), _as_np(norm), device="cpu")
    nets.policy_network.load_state_dict(carried.policy)
    nets.value_network.load_state_dict(carried.value)
    return nets, carried.normalizer


def _jax_networks(obs=OBS, ref=REF, act=ACT, seed=4):
    net = jpn.make_intention_ppo_networks(obs, ref, act, preprocess_observations_fn=jrs.normalize, **WIDTHS)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    zero = jnp.zeros((1, LAYERS, HID))
    params = jlosses.PPONetworkParams(policy=net.policy_network.init(k1, hidden_state=(zero, zero)),
                                      value=net.value_network.init(k2))
    return net, params


def _normalizer(size, seed):
    rng = np.random.RandomState(seed)
    return jrs.init_state(jax.ShapeDtypeStruct((size,), jnp.float32)).replace(
        mean=np.asarray(0.1 * rng.normal(size=size), np.float32),
        std=np.asarray(rng.uniform(0.5, 2.0, size), np.float32),
    )


@pytest.fixture(scope="module")
def policy_side():
    net, params = _jax_networks()
    norm = _normalizer(OBS, 1)
    tnet, tnorm = _port_networks(params.policy, params.value, norm)
    return net, params, norm, tnet, tnorm


def test_lstm_cells_carry_the_flax_weights(policy_side):
    """Every flax parameter lands in the port's modules (the eight gate
    Dense layers of each cell stacked in flax's i, f, g, o order), and the
    port's cell has no input-side bias."""
    _, params, _, tnet, _ = policy_side
    cell = params.policy["params"]["lstm_decoder"]["lstm_0"]
    assert set(cell) == {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"} and "bias" not in cell["ii"]
    sd = tnet.policy_network.state_dict()
    w_ih = sd["module.lstm_decoder.lstm_0.weight_ih"].numpy()
    np.testing.assert_array_equal(w_ih[2 * HID:3 * HID], np.asarray(cell["ig"]["kernel"]).T)
    np.testing.assert_array_equal(sd["module.lstm_decoder.lstm_1.bias_hh"].numpy()[HID:2 * HID],
                                  np.asarray(params.policy["params"]["lstm_decoder"]["lstm_1"]["hf"]["bias"]))
    assert not any("bias_ih" in k for k in sd)
    n_flax = sum(np.asarray(x).size for x in jax.tree.leaves(params.policy))
    assert sum(p.numel() for p in tnet.policy_network.parameters()) == n_flax


def test_recurrent_policy_matches_jax(policy_side):
    """Three steps of the network, each from the carry the last one gave,
    from a random first carry; then the stochastic and the deterministic
    inference policies (the JAX action noise fed in)."""
    net, params, norm, tnet, tnorm = policy_side
    rng = np.random.RandomState(2)
    obs = (rng.randn(3, 5, OBS) * 2).astype(np.float32)
    carry = tuple((rng.randn(5, LAYERS, HID) * 0.5).astype(np.float32) for _ in range(2))
    apply = jax.jit(functools.partial(net.policy_network.apply, get_activation=False))
    jcarry, tcarry = carry, tuple(torch.as_tensor(c) for c in carry)
    for t in range(3):
        logits, mean, logvar, jcarry = apply(norm, params.policy, obs[t], jax.random.PRNGKey(t), jcarry)
        got = tnet.policy_network(tnorm, torch.as_tensor(obs[t]), tcarry)
        tcarry = got[3]
        for name, g, w in (("logits", got[0], logits), ("mean", got[1], mean), ("logvar", got[2], logvar),
                           ("h", tcarry[0], jcarry[0]), ("c", tcarry[1], jcarry[1])):
            assert _rel(g.detach().numpy(), w) < POLICY_REL, f"step {t} {name}"
    for deterministic in (False, True):
        jpolicy = jax.jit(jpn.make_inference_fn(net)((norm, params.policy), deterministic=deterministic))
        tpolicy = tpn.make_inference_fn(tnet)(tnorm, deterministic=deterministic)
        key = jax.random.PRNGKey(9)
        jaction, jextras, jnext = jpolicy(obs[0], key, carry)
        noise = types.PolicyNoise(*(torch.as_tensor(x) for x in jax_policy_noise(key, 5, LAT, ACT)))
        taction, textras, tnext = tpolicy(torch.as_tensor(obs[0]), noise, tuple(torch.as_tensor(c) for c in carry))
        assert _rel(taction.numpy(), jaction) < POLICY_REL
        assert set(textras) == set(jextras) - {"activations"}
        for k in textras:
            assert _rel(textras[k].numpy(), jextras[k]) < POLICY_REL, k
        for g, w in zip(tnext, jnext):
            assert _rel(g.numpy(), w) < POLICY_REL


@pytest.fixture(scope="module")
def toy_side():
    jenv, tenv = toy_envs(NOISE)
    obs_size, ref_size, nu = jenv.observation_size, tenv.reference_obs_size, jenv.plan.nu
    net, params = _jax_networks(obs_size, ref_size, nu, seed=5)
    norm = _normalizer(obs_size, 3)
    tnet, tnorm = _port_networks(params.policy, params.value, norm, obs_size, ref_size, nu)
    jwrapped = jwrappers.wrap(jenv, episode_length=EPISODE, use_lstm=True, hidden_state_dim=HID,
                              hidden_layer_num=LAYERS)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    draws = jax_reset_draws(jenv, keys, NOISE)
    twrapped = wrappers.wrap(fed_reset(tenv, draws), episode_length=EPISODE, use_lstm=True, hidden_state_dim=HID,
                             hidden_layer_num=LAYERS)
    return jwrapped, twrapped, keys, net, params, norm, tnet, tnorm


def test_lstm_auto_reset_wrapper_matches_jax(toy_side):
    """Reset puts zero carries [B, layers, hidden] in info; a step leaves
    them alone and swaps the first state back in where an episode ended."""
    jwrapped, twrapped, keys, *_ = toy_side
    jstate = jax.jit(jwrapped.reset)(keys)
    tstate = twrapped.reset(None, B)
    for g, w in zip(tstate.info["hidden_state"], jstate.info["hidden_state"]):
        assert tuple(g.shape) == w.shape == (B, LAYERS, HID)
        assert not g.any() and not np.asarray(w).any()
    assert per_env_rel(tstate.obs, np.asarray(jstate.obs)).max() < UNROLL_REL
    action = np.random.RandomState(3).uniform(-0.3, 0.3, (B, twrapped.action_size)).astype(np.float32)
    jstep = jax.jit(jwrapped.step)
    for t in range(EPISODE):
        jstate = jstep(jstate, action)
        tstate = twrapped.step(tstate, torch.as_tensor(action))
        np.testing.assert_array_equal(tstate.done.numpy(), np.asarray(jstate.done))
        assert per_env_rel(tstate.obs, np.asarray(jstate.obs)).max() < UNROLL_REL, f"step {t}"
        assert not any(s.any() for s in tstate.info["hidden_state"])
    assert (tstate.done == 1).all()  # the episode of EPISODE steps ended: first obs swapped back in
    assert torch.equal(tstate.obs, tstate.info["first_obs"])


def test_recurrent_unroll_matches_jax(toy_side):
    """Three steps of the recurrent actor, stochastic, the JAX action noise
    fed in: every Transition field, the pre-step carries it records, and
    the carry after each step, which is zero exactly where an episode ended
    and the policy's own elsewhere."""
    jwrapped, twrapped, keys, net, params, norm, tnet, tnorm = toy_side
    jpolicy = jpn.make_inference_fn(net)((norm, params.policy))
    jstate = jax.jit(jwrapped.reset)(keys)
    carry0 = tuple(np.asarray(np.random.RandomState(8).randn(B, LAYERS, HID) * 0.5, np.float32) for _ in range(2))
    key = jax.random.PRNGKey(12)
    unroll = jax.jit(functools.partial(jacting.recurrent_generate_unroll, jwrapped, policy=jpolicy, unroll_length=3,
                                       extra_fields=("truncation",)))
    jfinal, jdata, jcarry = unroll(env_state=jstate, key=key, carry=carry0)
    step_keys, k = [], key
    for _ in range(3):
        k, nxt = jax.random.split(k)
        step_keys.append(k)
        k = nxt
    noises = [types.PolicyNoise(*(torch.as_tensor(x) for x in jax_policy_noise(sk, B, LAT, twrapped.action_size)))
              for sk in step_keys]
    tpolicy = tpn.make_inference_fn(tnet)(tnorm)

    # the reseed, step by step: zero where done, the policy's own carry elsewhere
    state, carry = twrapped.reset(None, B), tuple(torch.as_tensor(c) for c in carry0)
    for noise in noises:
        _, _, own = tpolicy(state.obs, noise, carry)
        state, _, carry = acting.recurrent_actor_step(twrapped, state, tpolicy, noise, carry)
        done = state.done > 0
        for c, o in zip(carry, own):
            assert not c[done].any() and torch.equal(c[~done], o[~done])
            assert not c.requires_grad
    assert 0 < int((jdata.discount == 0).sum()) < 3 * B  # episodes of 2 steps end inside the unroll

    tstate = twrapped.reset(None, B)
    tfinal, tdata, tcarry = acting.recurrent_generate_unroll(
        twrapped, tstate, tpolicy, noises, tuple(torch.as_tensor(c) for c in carry0), 3, extra_fields=("truncation",))
    for f in ("observation", "action", "reward", "discount", "next_observation"):
        assert _rel(getattr(tdata, f).numpy(), getattr(jdata, f)) < UNROLL_REL, f
    for k in ("hidden_state", "cell_state"):
        assert _rel(tdata.extras[k].numpy(), jdata.extras[k]) < UNROLL_REL, k
    np.testing.assert_array_equal(tdata.extras["hidden_state"][0].numpy(), carry0[0])  # the carry before step 0
    for k in ("log_prob", "raw_action", "logits", "latent_mean", "latent_logvar"):
        assert _rel(tdata.extras["policy_extras"][k].numpy(), jdata.extras["policy_extras"][k]) < UNROLL_REL, k
    np.testing.assert_array_equal(tdata.extras["state_extras"]["truncation"].numpy(),
                                  np.asarray(jdata.extras["state_extras"]["truncation"]))
    for g, w in zip(tcarry, jcarry):
        assert _rel(g.numpy(), w) < UNROLL_REL
    np.testing.assert_array_equal(tfinal.done.numpy(), np.asarray(jfinal.done))


# ---------------------------------------------------------------------------
# the loss and a learning half
# ---------------------------------------------------------------------------


def _batch(seed):
    """A batch-major Transition [N, T, ...] of numpy arrays: terminations
    inside the sequences (so the re-unroll zeroes the carry mid-sequence),
    truncations, random stored first carries and behavior log-probs."""
    rng = np.random.RandomState(seed)
    obs = (rng.randn(N, T + 1, OBS) * 2 + 0.5).astype(np.float32)
    raw = rng.randn(N, T, ACT).astype(np.float32)
    discount = (rng.uniform(size=(N, T)) > 0.2).astype(np.float32)
    discount[0, 1] = discount[1, 2] = 0.0
    truncation = ((rng.uniform(size=(N, T)) < 0.3) & (discount == 0)).astype(np.float32)
    carry = (rng.randn(2, N, T, LAYERS, HID) * 0.5).astype(np.float32)
    return {
        "observation": obs[:, :-1],
        "action": np.tanh(raw),
        "reward": rng.randn(N, T).astype(np.float32),
        "discount": discount,
        "next_observation": obs[:, 1:],
        "extras": {
            "policy_extras": {"raw_action": raw, "log_prob": (rng.randn(N, T) * 0.3 - 3.0).astype(np.float32)},
            "state_extras": {"truncation": truncation},
            "hidden_state": carry[0],
            "cell_state": carry[1],
        },
    }


def _jax_transition(b):
    return jtypes.Transition(**{k: jax.tree.map(jnp.asarray, v) for k, v in b.items()})


def _torch_transition(b):
    return types.Transition(**{k: jax.tree.map(lambda x: torch.as_tensor(np.array(x)), v) for k, v in b.items()})


def _entropy_noise(key_loss, batch):
    """The entropy noise the JAX loss draws from its key (ppo_math.py's
    split); the LSTM forward draws nothing (z = latent_mean)."""
    _, _, entropy_key = jax.random.split(key_loss, 3)
    return torch.as_tensor(np.array(jax.random.normal(entropy_key, (T, batch, ACT))))


def _jax_draws(key_sgd):
    """The permutations and noises the JAX LSTM learning half draws from
    key_sgd (lstm_ppo/ppo.py sgd_step and minibatch_step)."""
    draws, key = [], key_sgd
    for _ in range(U):
        key, key_perm, key_grad = jax.random.split(key, 3)
        perm = np.asarray(jax.random.permutation(key_perm, N))
        noises = []
        for _ in range(M):
            key_grad, key_loss = jax.random.split(key_grad)
            noises.append((None, _entropy_noise(key_loss, N // M)))
        draws.append(ppo.UpdateDraws(torch.as_tensor(perm.astype(np.int64)), noises))
    return draws


@pytest.fixture(scope="module")
def learning_side():
    net, params = _jax_networks()
    loss_fn = functools.partial(jlosses.compute_ppo_loss, ppo_network=net, reward_scaling=1.0, **KW)
    optimizer = optax.adam(learning_rate=LR)
    update = jgradients.gradient_update_fn(loss_fn, optimizer, pmap_axis_name=None, has_aux=True)

    @jax.jit
    def learn(params, opt_state, normalizer, data, key_sgd):
        """lstm_ppo/ppo.py's training_step after the rollout: the passes on
        the pre-update normalizer, then the normalizer update."""

        def minibatch_step(carry, mb):
            opt_state, params, key = carry
            key, key_loss = jax.random.split(key)
            (_, metrics), params, opt_state = update(params, normalizer, mb, key_loss, 0, optimizer_state=opt_state)
            return (opt_state, params, key), metrics

        def sgd_step(carry, unused_t):
            opt_state, params, key = carry
            key, key_perm, key_grad = jax.random.split(key, 3)
            shuffled = jax.tree.map(
                lambda x: jnp.reshape(jax.random.permutation(key_perm, x), (M, -1) + x.shape[1:]), data)
            (opt_state, params, _), metrics = jax.lax.scan(minibatch_step, (opt_state, params, key_grad), shuffled,
                                                           length=M)
            return (opt_state, params, key), metrics

        (opt_state, params, _), metrics = jax.lax.scan(sgd_step, (opt_state, params, key_sgd), (), length=U)
        return params, opt_state, jrs.update(normalizer, data.observation), metrics

    loss_and_grad = jax.jit(jax.value_and_grad(lambda *a: loss_fn(*a), has_aux=True))
    return net, params, optimizer, learn, loss_and_grad


def _port_loss_fn(nets):
    return functools.partial(losses.compute_ppo_loss, ppo_network=nets, reward_scaling=1.0, **KW)


def test_bptt_loss_and_gradients_match_jax(learning_side):
    """The loss terms and every gradient on one minibatch, the re-unroll
    from the stored first carry zeroing it after the terminations."""
    net, params, _, _, loss_and_grad = learning_side
    norm = _normalizer(OBS, 6)
    batch = _batch(2)
    key = jax.random.PRNGKey(3)
    (jtotal, jmetrics), jgrad = loss_and_grad(params, norm, _jax_transition(batch), key, 0)
    nets, tnorm = _port_networks(params.policy, params.value, norm)
    total, metrics = _port_loss_fn(nets)(tnorm, _torch_transition(batch), None, _entropy_noise(key, N), 0)
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss"):
        assert _rel(float(metrics[name].detach()), float(jmetrics[name])) < LOSS_REL, name
    total.backward()
    jgrad_sd = tpn.params_from_flax(_as_np(jgrad.policy), _as_np(jgrad.value), _as_np(norm), device="cpu")
    lstm_grads = 0
    for sd_grad, module in ((jgrad_sd.policy, nets.policy_network), (jgrad_sd.value, nets.value_network)):
        for k, p in module.named_parameters():
            want = sd_grad[k]
            err = float((p.grad - want).abs().max() / max(float(want.abs().max()), 1e-30))
            assert err < GRAD_REL, f"gradient of {k}: {err:.3e}"
            lstm_grads += "lstm_decoder" in k and bool(want.abs().max() > 0)
    assert lstm_grads == 2 * 3 + 2  # each cell's weight_ih, weight_hh and bias_hh, the projection's two
    # the zeroed carry matters: without it the loss differs
    kept = dict(batch, discount=np.ones_like(batch["discount"]))
    other, _ = _port_loss_fn(nets)(tnorm, _torch_transition(kept), None, _entropy_noise(key, N), 0)
    assert float(other.detach()) != float(total.detach())


@pytest.mark.parametrize("case", ["zero state", "converted state at step > 0"])
def test_learning_half_matches_jax(learning_side, case):
    """The learning half of lstm_ppo/ppo.py (plain adam, no clip, step 0 for
    the loss, the normalizer updated after the passes) against the port's
    Learner as the LSTM trainer builds it, on the JAX draws; from a zero
    optimizer state and from a JAX state one half later (the optax adam
    moments and count carried by optimizer_state_from_optax)."""
    net, params, optimizer, learn, _ = learning_side
    normalizer = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jnp.float32))
    opt_state = optimizer.init(params)
    if case == "converted state at step > 0":
        params, opt_state, normalizer, _ = learn(params, opt_state, normalizer, _jax_transition(_batch(1)),
                                                 jax.random.PRNGKey(5))
        assert int(opt_state[0].count) == U * M
    key_sgd = jax.random.PRNGKey(6)
    jparams, _, jnormalizer, jmetrics = learn(params, opt_state, normalizer, _jax_transition(_batch(2)), key_sgd)

    nets, tnorm = _port_networks(params.policy, params.value, normalizer)
    opt = gradients.make_optimizer([*nets.policy_network.parameters(), *nets.value_network.parameters()], LR)
    if case == "converted state at step > 0":
        adam = opt_state[0]
        opt.load_state_dict(optimizer_state_from_optax(adam.count, _as_np(adam.mu), _as_np(adam.nu), nets, opt))
    state = ppo.TrainingState(nets, opt, tnorm, 0)
    learner = mlp_ppo.Learner(_port_loss_fn(nets), opt, M, U, max_grad_norm=None, normalizer_after_sgd=True)
    metrics = learner(state, _torch_transition(_batch(2)), 0, draws=_jax_draws(key_sgd))
    assert len(metrics) == U * M
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss"):
        got = np.array([float(m[name]) for m in metrics])
        assert _rel(got, np.asarray(jmetrics[name]).reshape(-1)) < LOSS_REL, name
    want, want_norm = _port_networks(jparams.policy, jparams.value, jnormalizer)
    worst = 0.0
    for module, want_module in ((nets.policy_network, want.policy_network), (nets.value_network, want.value_network)):
        want_sd = want_module.state_dict()
        for k, v in module.state_dict().items():
            worst = max(worst, float((v - want_sd[k]).abs().max()) / LR)
    assert worst < PARAM_LR, f"parameters differ by {worst:.3e} lr"
    for k in ("count", "mean", "summed_variance", "std"):
        assert _rel(getattr(state.normalizer_params, k), getattr(want_norm, k)) < NORM_REL, k


# ---------------------------------------------------------------------------
# the JAX package's LSTM trainer tests (tests/test_train.py) at widths 16
# ---------------------------------------------------------------------------


def _toy_train(**kw):
    _, tenv = toy_envs()
    factory = functools.partial(tpn.make_intention_ppo_networks, **{**WIDTHS, "intention_latent_size": 8})
    return ppo.train(
        environment=tenv, num_timesteps=128, episode_length=16, ckpt_mgr=None,
        config_dict={"network_config": {"hidden_state_size": HID, "hidden_layer_num": LAYERS},
                     "env_config": {"render_interval": 10}},
        num_envs=8, num_eval_envs=4, seed=0, unroll_length=4, batch_size=8, num_minibatches=2,
        num_updates_per_batch=1, num_evals=2, normalize_observations=True, network_factory=factory, device="cpu",
        **kw,
    )


def test_lstm_smoke():
    batches = []
    make_policy, params, metrics = _toy_train(batch_callback=lambda s, d, _: batches.append((s.hidden_state, d)))
    assert "training/sps" in metrics and np.isfinite(metrics["training/total_loss"])
    assert all(torch.isfinite(v).all() for v in params[1].values())
    # the rollout carry goes on from one training step to the next
    (h0, _), data0 = batches[0]
    (h1, _), data1 = batches[1]
    assert not h0.any() and h1.any()
    # trajectory = unroll * num_envs + env: the first unroll's first carry is the step's
    assert torch.equal(data1.extras["hidden_state"][:8, 0], h1)
    action, _, carry = make_policy(params[0], deterministic=True)(data1.observation[:8, 0], None,
                                                                  (h1, batches[1][0][1]))
    assert torch.isfinite(action).all() and carry[0].shape == (8, LAYERS, HID)
