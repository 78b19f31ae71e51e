"""The port's policy against the JAX package's: the NormalTanh
distribution, the normalizer, and the intention policy and value MLP with
the JAX package's flax weights carried across by params_from_flax, at
narrow widths and at the full rodent-full-clips widths (encoder
[1024, 512, 512, 512, 512], decoder [512, 512, 512, 256, 256] + 2 x 38,
critic [512 x 5, 256], intention 60) on observations of the rodent's size.
The stochastic policy is fed the noise that the JAX policy draws from its
key. The port's own initializers are held to flax's distributions."""

import math

import jax
import jax.numpy as jp
import numpy as np
import pytest
import torch

from torch_parity import jax_policy_noise, per_env_rel
from track_mjx_tpu.agent import distribution as jd
from track_mjx_tpu.agent import running_statistics as jrs
from track_mjx_tpu.agent.mlp_ppo import ppo_networks as jpn
from track_mjx_tpu_torch.agent import distribution as td
from track_mjx_tpu_torch.agent import running_statistics as trs
from track_mjx_tpu_torch.agent import types as tt
from track_mjx_tpu_torch.agent.mlp_ppo import ppo_networks as tpn
from track_mjx_tpu_torch.physics import forward as tf

torch.set_num_threads(1)
OBS, REF, NU, LATENT = 696, 470, 38, 60  # the rodent-full-clips sizes
WIDTHS = {
    "full": ([1024, 512, 512, 512, 512], [512, 512, 512, 256, 256], [512] * 5 + [256]),
    "narrow": ([32, 16], [16, 16], [16, 8]),
}
B = 16
# The same float32 products in both packages, with sums over up to 1024
# terms in another order: per env, relative to max(1, max |JAX|). Measured
# up to 2.0e-6 (logits, latents, value, raw action) and 3.8e-6 (action,
# through tanh); log_prob 1.5e-5 (a sum of 38 terms up to 28 in size, whose
# (x - loc) / scale carries the raw action's roundoff over scales down to
# min_std); the distribution's elementwise formulas 2.0e-7.
REL = {"net": 1e-5, "action": 2e-5, "log_prob": 1e-4, "dist": 1e-6}


def _t(a):
    return torch.as_tensor(np.array(a))


def test_normal_tanh_distribution_matches_jax():
    rng = np.random.RandomState(0)
    params = rng.normal(scale=2.0, size=(B, 2 * NU)).astype(np.float32)
    raw = rng.normal(scale=1.5, size=(B, NU)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, (B, NU)))
    jdist, tdist = jd.NormalTanhDistribution(NU), td.NormalTanhDistribution(NU)
    cases = {
        "mode": (jdist.mode(params), tdist.mode(_t(params))),
        "log_prob": (jdist.log_prob(params, raw), tdist.log_prob(_t(params), _t(raw))),
        "postprocess": (jdist.postprocess(raw), tdist.postprocess(_t(raw))),
        "sample_no_postprocessing": (
            jdist.sample_no_postprocessing(params, key),
            tdist.sample_no_postprocessing(_t(params), _t(noise)),
        ),
        "entropy": (jdist.entropy(params, key), tdist.entropy(_t(params), _t(noise))),
    }
    for name, (want, got) in cases.items():
        assert got.shape == want.shape, name
        err = per_env_rel(got, want).max()
        assert err < REL["dist"], f"{name}: {err:.3e}"
    # a generator draws standard normals shaped like the loc
    gen = torch.Generator().manual_seed(0)
    s = tdist.sample_no_postprocessing(_t(params), gen)
    assert s.shape == (B, NU) and torch.isfinite(s).all()


def test_normalize_matches_jax():
    rng = np.random.RandomState(1)
    mean = rng.normal(size=OBS).astype(np.float32)
    std = rng.uniform(0.1, 3.0, OBS).astype(np.float32)
    x = rng.normal(scale=5.0, size=(B, OBS)).astype(np.float32)
    jstate = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jp.float32)).replace(mean=mean, std=std)
    tstate = trs.init_state(OBS, device="cpu").replace(mean=_t(mean), std=_t(std))
    for clip in (None, 5.0):
        want = jrs.normalize(x, jstate, max_abs_value=clip)
        got = trs.normalize(_t(x), tstate, max_abs_value=clip)
        assert per_env_rel(got, want).max() < REL["dist"]
    np.testing.assert_allclose(trs.denormalize(got, tstate).numpy(), np.asarray(jrs.denormalize(want, jstate)), rtol=1e-6)
    fresh = trs.init_state(OBS, device="cpu")
    assert float(fresh.count) == 0 and torch.equal(fresh.std, torch.ones(OBS))


def _networks(width: str, seed: int):
    enc, dec, crit = WIDTHS[width]
    kw = dict(
        intention_latent_size=LATENT,
        encoder_hidden_layer_sizes=enc,
        decoder_hidden_layer_sizes=dec,
        value_hidden_layer_sizes=crit,
    )
    jnet = jpn.make_intention_ppo_networks(OBS, REF, NU, preprocess_observations_fn=jrs.normalize, **kw)
    kp, kv = jax.random.split(jax.random.PRNGKey(seed))
    jparams = (jnet.policy_network.init(kp), jnet.value_network.init(kv))
    tnet = tpn.make_intention_ppo_networks(
        OBS, REF, NU, preprocess_observations_fn=trs.normalize,
        generator=torch.Generator().manual_seed(seed), device="cpu", **kw
    )
    return jnet, jparams, tnet


@pytest.fixture(scope="module", params=["narrow", "full"])
def carried(request):
    """JAX networks with flax-initialized weights, and the port's networks
    with those weights loaded by params_from_flax."""
    tf.set_full_f32()
    jnet, (pp, vp), tnet = _networks(request.param, seed=3)
    rng = np.random.RandomState(2)
    norm = jrs.init_state(jax.ShapeDtypeStruct((OBS,), jp.float32)).replace(
        mean=jp.asarray(rng.normal(size=OBS), jp.float32),
        std=jp.asarray(rng.uniform(0.5, 2.0, OBS), jp.float32),
    )
    tonp = lambda t: jax.tree.map(np.asarray, t)
    params = tpn.params_from_flax(tonp(pp), tonp(vp), tonp(norm), device="cpu")
    tnet.policy_network.load_state_dict(params.policy, strict=True)
    tnet.value_network.load_state_dict(params.value, strict=True)
    obs = rng.normal(scale=2.0, size=(B, OBS)).astype(np.float32)
    return jnet, (norm, pp, vp), tnet, params, obs


def test_policy_and_value_match_jax(carried):
    jnet, (norm, pp, vp), tnet, params, obs = carried
    logits, mean, logvar = jnet.policy_network.apply(norm, pp, obs, jax.random.PRNGKey(0), deterministic=True)
    got = tnet.policy_network(params.normalizer, _t(obs), None)
    for name, want, g in zip(("logits", "latent_mean", "latent_logvar"), (logits, mean, logvar), got):
        assert g.shape == want.shape, name
        assert per_env_rel(g.detach(), want).max() < REL["net"], name
    value = jnet.value_network.apply(norm, vp, obs)
    tvalue = tnet.value_network(params.normalizer, _t(obs))
    assert tvalue.shape == value.shape == (B,)
    assert per_env_rel(tvalue.detach()[:, None], np.asarray(value)[:, None]).max() < REL["net"]
    assert np.abs(np.asarray(logits)).max() > 0.1


@pytest.mark.parametrize("deterministic", [False, True])
def test_inference_fn_matches_jax(carried, deterministic):
    jnet, (norm, pp, vp), tnet, params, obs = carried
    key = jax.random.PRNGKey(11)
    jaction, jextras = jpn.make_inference_fn(jnet)((norm, pp), deterministic=deterministic)(obs, key)
    policy = tpn.make_inference_fn(tnet)(params.normalizer, deterministic=deterministic)
    noise = tt.PolicyNoise(*(_t(n) for n in jax_policy_noise(key, B, LATENT, NU)))
    action, extras = policy(_t(obs), None if deterministic else noise)
    assert per_env_rel(action, jaction).max() < REL["action"]
    expected = {"latent_mean", "latent_logvar"}
    if not deterministic:
        expected |= {"log_prob", "raw_action", "logits"}
    assert set(extras) == expected
    for k in expected:
        want = np.asarray(jextras[k])
        got = extras[k].reshape(want.shape[0], -1)
        bar = REL["log_prob"] if k == "log_prob" else REL["net"]
        assert per_env_rel(got, want.reshape(len(want), -1)).max() < bar, k
    if not deterministic:  # a generator gives the same draws in the same order
        gen = torch.Generator().manual_seed(5)
        a1, _ = policy(_t(obs), gen)
        gen = torch.Generator().manual_seed(5)
        z = torch.randn(B, LATENT, generator=gen)
        a2, _ = policy(_t(obs), tt.PolicyNoise(z, torch.randn(B, NU, generator=gen)))
        assert torch.equal(a1, a2)


def _layers(tree, path=""):
    """{path: kernel or scale array} of a flax parameter tree."""
    out = {}
    for name, child in tree.items():
        p = f"{path}/{name}" if path else name
        if "kernel" in child:
            out[p] = (np.asarray(child["kernel"]), np.asarray(child["bias"]))
        elif "scale" in child:
            out[p] = (np.asarray(child["scale"]), np.asarray(child["bias"]))
        else:
            out.update(_layers(child, p))
    return out


def test_initializers_match_flax():
    """At the full widths, every layer of the port starts as flax starts
    it: lecun_uniform kernels in +-sqrt(3 / fan_in) with variance 1 /
    fan_in; fc2_mean and fc2_logvar (flax's default lecun_normal) within
    two truncated stds, variance 1 / fan_in; LayerNorm scales one; biases
    zero. Each sample variance (and mean) lies within five of its standard
    errors of 1 / fan_in (and 0): for n entries at most 1.2 / sqrt(n) of
    the variance (0.9 for the uniform, 1.2 for the truncated normal), 7.5%
    for the critic's 256-entry output layer, under 0.9% for the others."""
    jnet, (pp, vp), tnet = _networks("full", seed=0)
    jl = {f"policy/{k}": v for k, v in _layers(pp["params"]).items()}
    jl.update({f"value/{k}": v for k, v in _layers(vp["params"]).items()})
    tstate = {f"policy.{k[len('module.'):]}": v for k, v in tnet.policy_network.state_dict().items()}
    tstate.update({f"value.{k[len('mlp.'):]}": v for k, v in tnet.value_network.state_dict().items()})
    checked = 0
    for path, (jw, jb) in jl.items():
        key = path.replace("/", ".")
        w, b = tstate[key + ".weight"].numpy(), tstate[key + ".bias"].numpy()
        assert not b.any() and not jb.any(), path
        if "LayerNorm" in path:
            assert (w == 1).all() and (jw == 1).all(), path
            continue
        w = w.T  # (in, out) like the flax kernel
        assert w.shape == jw.shape, path
        fan_in = w.shape[0]
        if path.endswith("fc2_mean") or path.endswith("fc2_logvar"):
            bound = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
        else:
            bound = math.sqrt(3.0 / fan_in)
        for arr in (w, jw):
            assert np.abs(arr).max() <= bound * (1 + 1e-6), path
            assert np.abs(arr).max() > 0.95 * bound, path
            assert abs(arr.var() * fan_in - 1.0) < 5 * 1.2 / math.sqrt(arr.size), (path, arr.var() * fan_in)
            assert abs(arr.mean()) < 5 * math.sqrt(arr.var() / arr.size), path
        checked += 1
    # encoder 5 + 2 heads, decoder 6, value 7 dense layers
    assert checked == 20
    # the same seed gives the same weights; another seed others
    _, _, again = _networks("narrow", seed=1)
    _, _, same = _networks("narrow", seed=1)
    _, _, other = _networks("narrow", seed=2)
    sd = again.policy_network.state_dict()
    assert all(torch.equal(v, same.policy_network.state_dict()[k]) for k, v in sd.items())
    assert not torch.equal(sd["module.encoder.trunk.hidden_0.weight"],
                           other.policy_network.state_dict()["module.encoder.trunk.hidden_0.weight"])
