"""Decoder transfer (`freeze_decoder`) and the high-level wrapper of the
port against the JAX package, at tiny widths on the CPU.

- `agent/network_masks.create_decoder_mask` against the JAX mask, carried
  onto the port's parameter names by `params_from_flax` (a float copy of
  the JAX mask: every carried tensor is all ones or all zeros);
- one learning half with the decoder frozen and the proprioceptive slice of
  the normalizer pinned, from carried parameters and the JAX draws, against
  the JAX learning half under `chain(chain(clip, adam), freeze(mask))` with
  the JAX trainer's pinning (track_mjx_tpu/agent/mlp_ppo/ppo.py): the
  decoder bitwise as it was in both, the rest within the bars of
  tests/test_torch_trainer.py, with a gradient norm below and above the
  clip (whose norm counts the decoder's gradients, as optax's does);
- the full flow on the toy walker, as tests/test_transfer.py: train,
  checkpoint, train again with freeze_decoder from the checkpoint; and
  through the CLI, where the transfer is a new run;
- `HighLevelWrapper` against the JAX one on the toy walker.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax.transforms import freeze

import torch_parity
from test_torch_trainer import (
    ACT,
    KW,
    LAT,
    LR,
    LOSS_REL,
    M,
    N,
    NORM_REL,
    OBS,
    PARAM_LR,
    REF,
    SCHEDULE,
    U,
    _batch,
    _jax_draws,
    _jax_transition,
    _rel,
    _torch_transition,
)
from track_mjx_tpu.agent import gradients as jgradients
from track_mjx_tpu.agent import network_masks as jmasks
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.lstm_ppo import ppo_networks as jlstm_networks
from track_mjx_tpu.agent.mlp_ppo import losses as jlosses
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu.envs import wrappers as jwrappers
from track_mjx_tpu_torch import train
from track_mjx_tpu_torch.agent import checkpointing, gradients, network_masks, running_statistics
from track_mjx_tpu_torch.agent.lstm_ppo import ppo as lstm_ppo
from track_mjx_tpu_torch.agent.lstm_ppo import ppo_networks as tlstm_networks
from track_mjx_tpu_torch.agent.mlp_ppo import losses, ppo
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.envs import wrappers
from track_mjx_tpu_torch.io import load
from track_mjx_tpu_torch.io.synthetic import synthesize_clips
from track_mjx_tpu_torch.physics import forward as tf
from track_mjx_tpu_torch.physics import model as tm
from track_mjx_tpu_torch.testing import PointMassEnv
from track_mjx_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)
PROPRIO = OBS - REF  # the tail of the observation, as the tracking env lays it out
WIDTHS = dict(intention_latent_size=LAT, encoder_hidden_layer_sizes=(16, 16), decoder_hidden_layer_sizes=(16,),
              value_hidden_layer_sizes=(16, 16))


def _as_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("pipeline", ["mlp", "lstm"])
def test_decoder_mask_matches_jax(pipeline):
    if pipeline == "mlp":
        jnet = jpn.make_intention_ppo_networks(OBS, REF, ACT, **WIDTHS)
        policy = jnet.policy_network.init(jax.random.PRNGKey(0))
        tnet = tpn.make_intention_ppo_networks(OBS, REF, ACT, **WIDTHS, device="cpu")
    else:
        jnet = jlstm_networks.make_intention_ppo_networks(OBS, REF, ACT, hidden_state_size=8, hidden_layer_num=2,
                                                          **WIDTHS)
        carry = (jnp.zeros((1, 2, 8)), jnp.zeros((1, 2, 8)))
        policy = jnet.policy_network.init(jax.random.PRNGKey(0), carry)
        tnet = tlstm_networks.make_intention_ppo_networks(OBS, REF, ACT, hidden_state_size=8, hidden_layer_num=2,
                                                          **WIDTHS, device="cpu")
    value = jnet.value_network.init(jax.random.PRNGKey(1))
    jmask = jmasks.create_decoder_mask(jlosses.PPONetworkParams(policy=policy, value=value))
    as_float = lambda tree: jax.tree.map(lambda flag: np.full((1,), float(flag)), tree)  # noqa: E731
    carried = tpn.params_from_flax(_as_np(jax.tree.map(lambda leaf, flag: np.full(np.shape(leaf), float(flag)),
                                                       policy, jmask.policy)),
                                   as_float(jmask.value), {k: 0.0 for k in ("count", "mean", "summed_variance", "std")},
                                   device="cpu")
    mask = network_masks.create_decoder_mask(
        losses.PPONetworkParams(tnet.policy_network.state_dict(), tnet.value_network.state_dict())
    )
    assert set(mask.policy) == set(carried.policy)
    for name, frozen in mask.policy.items():
        flags = carried.policy[name].unique().tolist()
        assert flags == [float(frozen)], name
    assert not any(mask.value.values())
    assert any(mask.policy.values()) == (pipeline == "mlp")  # the LSTM decoder is `lstm_decoder`, unmatched


@pytest.fixture(scope="module")
def jax_frozen():
    """The JAX learning half of the decoder-transfer trainer: freeze-masked
    clipped Adam, the proprioceptive normalizer slice pinned after the
    update (ppo.py's training_step), one jit."""
    net = jpn.make_intention_ppo_networks(OBS, REF, ACT, preprocess_observations_fn=jrs.normalize, **WIDTHS)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    params = jlosses.PPONetworkParams(policy=net.policy_network.init(k1), value=net.value_network.init(k2))
    optimizer = optax.chain(
        optax.chain(optax.clip_by_global_norm(10.0), optax.adam(learning_rate=LR)),
        freeze(jmasks.create_decoder_mask(params)),
    )
    loss_fn = functools.partial(jlosses.compute_ppo_loss, ppo_network=net, reward_scaling=1.0,
                                kl_schedule=jlosses.create_ramp_schedule(**SCHEDULE), **KW)
    update = jgradients.gradient_update_fn(loss_fn, optimizer, pmap_axis_name=None, has_aux=True)

    @jax.jit
    def learn(params, opt_state, normalizer, frozen, data, key_sgd, it):
        normalizer = jrs.update(normalizer, data.observation)
        normalizer = normalizer.replace(**{k: getattr(normalizer, k).at[-PROPRIO:].set(getattr(frozen, k))
                                           for k in ("mean", "std", "summed_variance")})

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

        (opt_state, params, _, _), metrics = jax.lax.scan(sgd_step, (opt_state, params, key_sgd, it), (), length=U)
        return params, normalizer, metrics

    return optimizer, learn, params


@pytest.mark.parametrize("reward_scale", [1.0, 300.0], ids=["norm under 10", "norm over 10"])
def test_frozen_learning_half_matches_jax(jax_frozen, reward_scale):
    optimizer, learn, params = jax_frozen
    rng = np.random.RandomState(7)
    frozen = jrs.RunningStatisticsState(
        count=jnp.zeros(()), mean=jnp.asarray(rng.randn(PROPRIO), jnp.float32),
        summed_variance=jnp.asarray(rng.uniform(1, 2, PROPRIO), jnp.float32),
        std=jnp.asarray(rng.uniform(0.5, 1.5, PROPRIO), jnp.float32),
    )
    normalizer = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jnp.float32))
    normalizer = normalizer.replace(**{k: getattr(normalizer, k).at[-PROPRIO:].set(getattr(frozen, k))
                                       for k in ("mean", "std", "summed_variance")})
    batch = _batch(2, reward_scale)
    key_sgd = jax.random.PRNGKey(6)
    jparams, jnormalizer, jmetrics = learn(params, optimizer.init(params), normalizer, frozen, _jax_transition(batch),
                                           key_sgd, jnp.float32(1))

    networks = tpn.make_intention_ppo_networks(OBS, REF, ACT, preprocess_observations_fn=running_statistics.normalize,
                                               **WIDTHS, device="cpu")
    carried = tpn.params_from_flax(_as_np(params.policy), _as_np(params.value), _as_np(normalizer), device="cpu")
    networks.policy_network.load_state_dict(carried.policy)
    networks.value_network.load_state_dict(carried.value)
    opt = gradients.make_optimizer([*networks.policy_network.parameters(), *networks.value_network.parameters()], LR)
    decoder = [p for n, p in networks.policy_network.named_parameters() if network_masks.is_decoder(n)]
    pinned = running_statistics.RunningStatisticsState(**{k: torch.as_tensor(np.asarray(getattr(frozen, k)))
                                                          for k in ("count", "mean", "summed_variance", "std")})
    loss_fn = functools.partial(losses.compute_ppo_loss, ppo_network=networks, reward_scaling=1.0,
                                kl_schedule=losses.create_ramp_schedule(**SCHEDULE), **KW)
    learner = ppo.Learner(loss_fn, opt, M, U, frozen=decoder, pinned=pinned)
    state = ppo.TrainingState(networks, opt, carried.normalizer, 0)
    before = {k: v.clone() for k, v in networks.policy_network.state_dict().items()}
    draws = _jax_draws(key_sgd)

    # the first minibatch's gradient: the decoder's part weighs in the global norm
    tdata = _torch_transition(batch)
    first = jax.tree.map(lambda x: x[draws[0].permutation[: N // M]], tdata)
    norm1 = running_statistics.pin_tail(running_statistics.update(state.normalizer_params, tdata.observation), pinned)
    loss_fn(norm1, first, *draws[0].noises[0], 1)[0].backward()
    grads = [p.grad for p in (*networks.policy_network.parameters(), *networks.value_network.parameters())]
    full = float(gradients.global_norm(grads))
    without = float(gradients.global_norm([p.grad for n, p in networks.policy_network.named_parameters()
                                           if not network_masks.is_decoder(n)]
                                          + [p.grad for p in networks.value_network.parameters()]))
    assert full > without  # the decoder's gradients exist, and the clip's norm counts them
    assert (full > 10.0) == (reward_scale > 1)
    opt.zero_grad()

    metrics = learner(state, tdata, 1, draws=draws)
    for name in ("total_loss", "policy_loss", "v_loss", "kl_latent_loss", "entropy_loss"):
        got = np.array([float(m[name]) for m in metrics])
        assert _rel(got, np.asarray(jmetrics[name]).reshape(-1)) < LOSS_REL, name
    want = tpn.params_from_flax(_as_np(jparams.policy), _as_np(jparams.value), _as_np(jnormalizer), device="cpu")
    worst, moved = 0.0, 0.0
    for name, v in networks.policy_network.state_dict().items():
        if network_masks.is_decoder(name):
            assert torch.equal(v, before[name]) and torch.equal(want.policy[name], before[name]), name
        else:
            worst = max(worst, float((v - want.policy[name]).abs().max()) / LR)
            moved = max(moved, float((v - before[name]).abs().max()) / LR)
    for name, v in networks.value_network.state_dict().items():
        worst = max(worst, float((v - want.value[name]).abs().max()) / LR)
    assert worst < PARAM_LR, f"parameters differ by {worst:.3e} lr"
    assert moved > 1.0  # the encoder trained
    assert not any(p in opt.state for p in decoder)  # Adam keeps no state for the decoder
    for k in ("mean", "summed_variance", "std"):
        got = getattr(state.normalizer_params, k)
        assert torch.equal(got[-PROPRIO:], getattr(pinned, k)), k
        assert _rel(got, getattr(want.normalizer, k)) < NORM_REL, k
    assert float(state.normalizer_params.count) == float(jnormalizer.count) == N * 5  # the update counted the batch


def test_pin_tail_keeps_the_count():
    state = running_statistics.init_state(6, device="cpu").replace(count=torch.tensor(5.0))
    pinned = running_statistics.RunningStatisticsState(
        count=torch.tensor(0.0), mean=torch.ones(2), summed_variance=torch.full((2,), 3.0), std=torch.full((2,), 2.0)
    )
    out = running_statistics.pin_tail(state, pinned)
    assert float(out.count) == 5.0
    assert out.mean.tolist() == [0, 0, 0, 0, 1, 1] and out.std.tolist() == [1, 1, 1, 1, 2, 2]
    assert out.summed_variance.tolist() == [0, 0, 0, 0, 3, 3]


# ---------------------------------------------------------------------------
# the full flow
# ---------------------------------------------------------------------------


def _tiny_factory(*args, **kwargs):
    kwargs.update(intention_latent_size=8, encoder_hidden_layer_sizes=(32,), decoder_hidden_layer_sizes=(32,),
                  value_hidden_layer_sizes=(32,))
    return tpn.make_intention_ppo_networks(*args, **kwargs)


COMMON = dict(
    num_timesteps=128, episode_length=16, num_envs=8, num_eval_envs=4, seed=0, unroll_length=4, batch_size=8,
    num_minibatches=2, num_updates_per_batch=1, num_evals=2, normalize_observations=True,
    network_factory=_tiny_factory, device="cpu",
)


@pytest.fixture(scope="module")
def toy():
    return torch_parity.toy_envs()


@pytest.fixture(scope="module")
def source_run(toy, tmp_path_factory):
    """tests/test_transfer.py's first half: train the toy walker and
    checkpoint it."""
    path = tmp_path_factory.mktemp("transfer") / "src"
    _, params, _ = ppo.train(environment=toy[1], ckpt_mgr=checkpointing.CheckpointManager(str(path)), **COMMON)
    return str(path), params


def test_freeze_decoder_full_flow(toy, source_run):
    """train -> checkpoint -> restore with freeze_decoder -> train: the
    decoder as the checkpoint's, bit for bit; the encoder trained from a
    fresh start; the proprioceptive normalizer slice the checkpoint's."""
    path, (src_normalizer, src_policy) = source_run
    _, (normalizer, policy), metrics = ppo.train(environment=toy[1], checkpoint_to_restore=path, freeze_decoder=True,
                                                 **COMMON)
    assert np.isfinite(metrics["training/total_loss"])
    decoder = [k for k in policy if network_masks.is_decoder(k)]
    encoder = [k for k in policy if ".encoder." in f".{k}"]
    assert decoder and encoder
    for k in decoder:
        assert torch.equal(policy[k], src_policy[k]), k
    assert any(not torch.equal(policy[k], src_policy[k]) for k in encoder)
    proprio = toy[1].proprioceptive_obs_size
    for k in ("mean", "std", "summed_variance"):
        assert torch.equal(getattr(normalizer, k)[-proprio:], getattr(src_normalizer, k)[-proprio:]), k
        assert not torch.equal(getattr(normalizer, k)[:-proprio], getattr(src_normalizer, k)[:-proprio]), k


def test_freeze_decoder_refusals(source_run):
    path, _ = source_run
    with pytest.raises(ValueError, match="Proprioceptive observation size is 0"):  # the JAX trainer's check
        ppo.train(environment=PointMassEnv("cpu"), checkpoint_to_restore=path, freeze_decoder=True, **COMMON)
    with pytest.raises(ValueError, match="checkpoint_to_restore"):
        ppo.train(environment=PointMassEnv("cpu"), freeze_decoder=True, **COMMON)
    with pytest.raises(NotImplementedError, match="LSTM"):
        lstm_ppo.train(environment=PointMassEnv("cpu"), checkpoint_to_restore=path, freeze_decoder=True,
                       **{**COMMON, "network_factory": tlstm_networks.make_intention_ppo_networks})


TINY = [
    "device=cpu",
    "reference_config.clip_length=20",
    "reference_config.random_init_range=10",
    "train_setup.train_subset_ratio=null",
    "train_setup.eval_every=16",
    "train_setup.reset_every=16",
    "train_setup.train_config.num_envs=4",
    "train_setup.train_config.num_timesteps=16",  # one training step, one eval
    "train_setup.train_config.batch_size=4",
    "train_setup.train_config.num_eval_envs=4",
    "train_setup.train_config.num_minibatches=2",
    "train_setup.train_config.num_updates_per_batch=1",
    "train_setup.train_config.unroll_length=2",
    "network_config.encoder_layer_sizes=[16]",
    "network_config.decoder_layer_sizes=[16]",
    "network_config.critic_layer_sizes=[16]",
    "network_config.intention_size=4",
]


def test_cli_transfer_is_a_new_run(tmp_path):
    """train.main with freeze_decoder and checkpoint_to_restore: the given
    config runs as a new run beside the source, whose steps stay as they
    are; the decoder is the source's, bit for bit."""
    tf.set_full_f32()
    clips = synthesize_clips(tm.load_snapshot("rodent-full-clips"), n_clips=2, n_frames=20, mocap_hz=50, seed=0,
                             device="cpu")
    load.save_npz(clips, tmp_path / "clips.npz")
    base = [f"data_path={tmp_path / 'clips.npz'}", f"logging_config.model_path={tmp_path / 'ckpts'}", *TINY]
    train.main(tconfig.load_config("rodent-full-clips", base))
    (src,) = [p for p in (tmp_path / "ckpts").iterdir() if p.name != "wandb_local"]
    src_steps = sorted(p.name for p in src.iterdir())
    _, (_, policy) = train.main(tconfig.load_config("rodent-full-clips", [
        *base, f"train_setup.checkpoint_to_restore={src}", "train_setup.freeze_decoder=true",
        "train_setup.train_config.num_updates_per_batch=2",  # the given config holds, not the stored one
    ]))
    runs = sorted(p for p in (tmp_path / "ckpts").iterdir() if p.name != "wandb_local")
    assert len(runs) == 2 and sorted(p.name for p in src.iterdir()) == src_steps
    (new,) = [r for r in runs if r != src]
    store = checkpointing.CheckpointStore(str(new))
    assert store.config()["train_setup"]["freeze_decoder"] is True
    assert int(store.training_state()["optimizer_state"]["state"][0]["step"]) == 2 * 2  # 1 step, 2 passes of 2
    _, src_policy = checkpointing.CheckpointStore(str(src)).policy(device="cpu")
    for k, v in policy.items():
        if network_masks.is_decoder(k):
            assert torch.equal(v, src_policy[k]), k


# ---------------------------------------------------------------------------
# HighLevelWrapper
# ---------------------------------------------------------------------------


def test_high_level_wrapper_matches_jax(toy):
    """Latent actions through a frozen decoder (carried from the JAX
    policy's) into the toy walker's step, from the JAX reset's draws."""
    jenv, tenv = toy
    nu, ref = tenv.action_size, tenv.reference_obs_size
    jnet = jpn.make_intention_ppo_networks(tenv.observation_size, ref, nu, intention_latent_size=LAT,
                                           encoder_hidden_layer_sizes=(16,), decoder_hidden_layer_sizes=(16,),
                                           value_hidden_layer_sizes=(16,))
    jpolicy = jnet.policy_network.init(jax.random.PRNGKey(3))
    tnet = tpn.make_intention_ppo_networks(tenv.observation_size, ref, nu, intention_latent_size=LAT,
                                           encoder_hidden_layer_sizes=(16,), decoder_hidden_layer_sizes=(16,),
                                           value_hidden_layer_sizes=(16,), device="cpu")
    tnet.policy_network.load_state_dict(tpn.params_from_flax(_as_np(jpolicy), _as_np(jnet.value_network.init(
        jax.random.PRNGKey(4))), {k: 0.0 for k in ("count", "mean", "summed_variance", "std")}, device="cpu").policy)
    from track_mjx_tpu.agent.intention import Decoder

    jdecoder = Decoder(layer_sizes=(16, 2 * nu))
    dec_params = {"params": jpolicy["params"]["decoder"]}

    def jax_decode(x):
        return jnp.tanh(jdecoder.apply(dec_params, x)[0][..., :nu]), {}

    def port_decode(x):
        with torch.no_grad():
            return torch.tanh(tnet.policy_network.module.decoder(x)[..., :nu]), {}

    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    draws = torch_parity.jax_reset_draws(jenv, keys, tenv._reset_noise_scale)
    jreset = jax.jit(jax.vmap(jenv.reset))(keys)
    treset = torch_parity.fed_reset(tenv, draws).reset(None, 3)
    latents = np.asarray(np.random.RandomState(0).randn(3, LAT), np.float32)
    jstep = jax.jit(jax.vmap(jwrappers.HighLevelWrapper(jenv, jax_decode, ref).step))(jreset, latents)
    tstep = wrappers.HighLevelWrapper(tenv, port_decode, ref).step(treset, torch.as_tensor(latents))
    want_action = jax.vmap(jax_decode)(jnp.concatenate([latents, jreset.obs[:, ref:]], -1))[0]
    assert torch_parity.rel_err(tstep.info["prev_ctrl"], want_action) < 1e-5  # the decoded action was stepped
    for name in ("obs", "reward"):
        assert torch_parity.per_env_rel(getattr(tstep, name), np.asarray(getattr(jstep, name))).max() < 1e-4, name
