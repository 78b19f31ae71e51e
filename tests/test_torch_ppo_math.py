"""The port's PPO math against the JAX package's on the same numpy inputs:
the λ-return targets with terminations and truncations, each loss term, both
latent KLs, the three KL schedules, the entropy term's gradient through its
reparameterized sample, the optax-style gradient clip, and the Welford
normalizer update (weights, mask, a constant dim, several batch dims)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from track_mjx_tpu.agent import ppo_math as jpm
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.distribution import NormalTanhDistribution as JaxNormalTanh
from track_mjx_tpu.agent.mlp_ppo import losses as jlosses
from track_mjx_tpu_torch.agent import gradients
from track_mjx_tpu_torch.agent import ppo_math as tpm
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent.distribution import NormalTanhDistribution
from track_mjx_tpu_torch.agent.mlp_ppo import losses as tlosses

torch.set_num_threads(1)
# The same float32 formulas in both packages; only the order of sums differs
# (torch against XLA reductions, torch's backward against jax.grad).
# Relative to max(1, max |JAX|); measured up to 1.4e-6 on these inputs, and
# up to 8e-8 where the bar is 1e-6.
REL = 1e-5


def close(got, want, rel=REL):
    got = np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max()) if want.size else 0.0
    assert err < rel, f"rel err {err:.3e} >= {rel:.0e}"


def t(x):
    return torch.as_tensor(np.array(x))


def _episode_flags(rng, T, B):
    termination = (rng.uniform(size=(T, B)) < 0.15).astype(np.float32)
    truncation = ((rng.uniform(size=(T, B)) < 0.15) & (termination == 0)).astype(np.float32)
    return termination, truncation


@pytest.mark.parametrize("T,B,lam,gamma", [(5, 3, 0.95, 0.99), (20, 16, 0.95, 0.98), (7, 1, 1.0, 0.9)])
def test_gae_matches_jax(T, B, lam, gamma):
    rng = np.random.RandomState(T * 100 + B)
    rewards, values = (rng.randn(T, B).astype(np.float32) for _ in range(2))
    bootstrap = rng.randn(B).astype(np.float32)
    termination, truncation = _episode_flags(rng, T, B)
    termination[T // 2, 0] = 1.0
    truncation[T // 3, -1] = 1.0 if termination[T // 3, -1] == 0 else 0.0
    want = jlosses.compute_gae(*map(jnp.asarray, (truncation, termination, rewards, values, bootstrap)),
                               lambda_=lam, discount=gamma)
    got = tlosses.compute_gae(*map(t, (truncation, termination, rewards, values, bootstrap)),
                              lambda_=lam, discount=gamma)
    for g, w in zip(got, want):
        close(g, w)
    # a truncated step carries no advantage
    assert (got[1].numpy()[truncation > 0] == 0).all()


def test_gae_targets_are_detached():
    values = torch.randn(4, 2, requires_grad=True)
    bootstrap = torch.randn(2, requires_grad=True)
    ones = torch.ones(4, 2)
    targets, advantages = tpm.gae_targets(torch.randn(4, 2), values, bootstrap, continuation=ones, valid=ones,
                                          lambda_=0.95, discount=0.9)
    assert not targets.requires_grad and not advantages.requires_grad


@pytest.mark.parametrize("epsilon", [0.2, 0.3])
def test_clipped_surrogate_and_value_objective(epsilon):
    rng = np.random.RandomState(1)
    target, behavior = (rng.randn(6, 5).astype(np.float32) * 0.5 for _ in range(2))
    adv, baseline = (rng.randn(6, 5).astype(np.float32) for _ in range(2))
    close(tpm.clipped_surrogate(t(target), t(behavior), t(adv), epsilon),
          jpm.clipped_surrogate(target, behavior, adv, epsilon))
    close(tpm.value_objective(t(adv), t(baseline)), jpm.value_objective(adv, baseline))


@pytest.mark.parametrize("shape", [(1, 4, 3), (6, 4, 3), (20, 8, 60)])
def test_latent_kls_match_jax(shape):
    rng = np.random.RandomState(shape[0])
    mean = rng.randn(*shape).astype(np.float32)
    logvar = (0.3 * rng.randn(*shape)).astype(np.float32)
    close(tpm.gaussian_kl_ar1(t(mean), t(logvar)), jpm.gaussian_kl_ar1(mean, logvar))
    close(tpm.gaussian_kl_ar1(t(mean), t(logvar), alpha=0.5), jpm.gaussian_kl_ar1(mean, logvar, alpha=0.5))
    close(tpm.gaussian_kl_standard(t(mean), t(logvar)), jpm.gaussian_kl_standard(mean, logvar))


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(max_value=0.1, ramp_steps=10, schedule="linear"),
        dict(max_value=0.1, ramp_steps=10, warmup_steps=3, schedule="linear"),
        dict(max_value=0.1, ramp_steps=0, schedule="linear"),  # int(num_evals * frac) == 0
        dict(max_value=0.5, min_value=0.01, schedule="cosine", period=7),
        dict(max_value=0.5, min_value=0.01, schedule="sine", period=7),
    ],
)
def test_ramp_schedules_match_jax(kwargs):
    jfn, tfn = jpm.create_ramp_schedule(**kwargs), tpm.create_ramp_schedule(**kwargs)
    for step in [1, 2, 5, 9, 10, 11, 30]:
        close(tfn(step), jfn(step), rel=1e-6)
    with pytest.raises(ValueError):
        tpm.create_ramp_schedule(schedule="square")


def test_entropy_gradient_flows_through_its_sample():
    """The entropy term's sample stays reparameterized: its gradient in the
    logits equals jax.grad's through the same draw."""
    rng = np.random.RandomState(3)
    logits = rng.randn(5, 4, 6).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (5, 4, 3)))
    jdist, tdist = JaxNormalTanh(event_size=3), NormalTanhDistribution(event_size=3)
    want_val, want_grad = jax.value_and_grad(lambda x: jnp.mean(jdist.entropy(x, key)))(jnp.asarray(logits))
    x = t(logits).requires_grad_()
    got = torch.mean(tdist.entropy(x, t(noise)))
    got.backward()
    close(got, want_val)
    close(x.grad, want_grad)
    # the sample's own path is part of it: detaching it changes the gradient
    y = t(logits).requires_grad_()
    base = tdist.create_dist(y)
    torch.mean((base.entropy() + tdist._postprocessor.forward_log_det_jacobian(
        base.sample(t(noise)).detach())).sum(-1)).backward()
    assert np.abs(y.grad.numpy() - x.grad.numpy()).max() > 1e-3


@pytest.mark.parametrize("scale", [0.01, 1.0, 50.0])
def test_global_norm_clip_matches_optax(scale):
    rng = np.random.RandomState(5)
    grads = [rng.randn(7, 3).astype(np.float32) * scale, rng.randn(4).astype(np.float32) * scale]
    want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    tgrads = [t(g).clone() for g in grads]
    norm = gradients.clip_by_global_norm_(tgrads, 10.0)
    close(norm, optax.global_norm([jnp.asarray(g) for g in grads]), rel=1e-6)
    for g, w in zip(tgrads, want):
        close(g, w, rel=1e-6)
    if scale == 50.0:  # clipped: torch's clip_grad_norm_ is another function
        assert float(gradients.global_norm(tgrads)) == pytest.approx(10.0, rel=1e-5)
    else:
        for g, x in zip(tgrads, grads):
            np.testing.assert_array_equal(g.numpy(), x)


def _welford_cases():
    rng = np.random.RandomState(11)
    size = 6
    batches = [rng.randn(8, size).astype(np.float32) * 3 + 1, rng.randn(2, 5, size).astype(np.float32)]
    for b in batches:
        b[..., 2] = 0.7  # a constant dim
    return size, batches


@pytest.mark.parametrize("variant", ["plain", "weights", "mask", "bounds"])
def test_welford_update_matches_jax(variant):
    size, batches = _welford_cases()
    jstate, tstate = jrs.init_state(jnp.zeros((size,))), trs.init_state(size, device="cpu")
    mask = np.array([0, 1, 0, 0, 1, 0], np.float32)
    for i, batch in enumerate(batches):
        kw_j, kw_t = {}, {}
        if variant == "weights":
            w = np.random.RandomState(i).uniform(0.2, 1.0, batch.shape[:-1]).astype(np.float32)
            kw_j["weights"], kw_t["weights"] = jnp.asarray(w), t(w)
        elif variant == "mask":
            kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), t(mask)
        elif variant == "bounds":
            kw_j = kw_t = dict(std_min_value=0.5, std_max_value=1.5)
        jstate = jrs.update(jstate, jnp.asarray(batch), **kw_j)
        tstate = trs.update(tstate, t(batch), **kw_t)
        for k in ("count", "mean", "summed_variance", "std"):
            close(getattr(tstate, k), getattr(jstate, k), rel=1e-6)
    assert torch.isfinite(tstate.std).all() and (tstate.summed_variance >= 0).all()
    if variant == "mask":
        assert (tstate.mean[mask > 0] == 0).all() and (tstate.std[mask > 0] == 1).all()
    x = batches[0]
    close(trs.normalize(t(x), tstate), jrs.normalize(jnp.asarray(x), jstate), rel=1e-5)


def test_welford_update_rejects_a_wrong_event_shape():
    with pytest.raises(ValueError):
        trs.update(trs.init_state(4, device="cpu"), torch.zeros(3, 5))
