"""Intention-bottleneck (CoMic-style VAE) policy, with a feed-forward or a
recurrent decoder.

Port of track_mjx_tpu/agent/intention.py. The observation is split into its
reference slice (what to do) and its egocentric slice (body state); the
reference slice is compressed into a diagonal-Gaussian intention (encoder),
and the decoder maps [intention, egocentric] to action-distribution
parameters.

- trunks are Dense -> silu -> LayerNorm blocks; the decoder's last Dense
  is left raw. LayerNorm uses flax's epsilon, 1e-6 (torch's default is
  1e-5);
- trunk layers and the decoder output start lecun_uniform, the encoder's
  `fc2_mean` and `fc2_logvar` flax's default `lecun_normal`, biases zero;
- the latent is mean + exp(logvar / 2) * noise, with the noise given or
  drawn from a generator, or the mean itself when deterministic;
- the recurrent decoder (the LSTM pipeline) is a stack of flax
  `nn.LSTMCell`s and a Dense projection, and its latent is always the mean
  (the reference turns the reparameterization off there). Its carry is
  (h, c), each [B, layers, hidden]; a flax cell's own carry is (c, h).
  A cell keeps flax's gates (i, f, g, o) in torch's layout: `weight_ih`
  [4 hidden, in] holds the input-side kernels, which have no bias,
  `weight_hh` [4 hidden, hidden] and `bias_hh` the hidden-side ones; the
  input kernels start lecun_uniform, the hidden ones orthogonal (per gate),
  the bias zero.

With `get_activation` a policy also returns its activation taps, the JAX
package's tree with its key names (so an analysis script written for the
JAX output reads the port's): per trunk the normalized output of each
block, `layer_{i}` (the decoder's raw last layer is not one); the encoder's
`mean` and `logvar`; the recurrent decoder's `lstm_projection`. The
feed-forward policy's tree is {encoder, decoder, egocentric_obs, traj_obs,
intention} (the two observation slices after the normalizer, the latent
used), the recurrent one's {encoder, decoder, intention, hidden_state}
(the carry after the step). A module records into the `taps` dict it is
given.

`make_decoder_only_policy` is the decoder alone for a frozen decoder
driven by latents (`ppo_factory.make_decoder_policy_fn`): its input is
[latent, egocentric obs], and the normalizer it is given covers the
egocentric slice only (the latents were never normalized in training).

A `compute_dtype` (the trainers' `rollout_bf16`) runs the network body of
the rollout's policy forward in that dtype, as the JAX package's apply does:
the normalizer stays float32, the parameters are cast per apply (the
modules' own stay float32 for the loss and the optimizer) and every output
comes back float32. Where flax promotes, so does the port: the latent noise
is drawn in float32, so a sampled latent, and the decoder after it, are
float32 over the bf16-rounded weights; the mean latent and the recurrent
decoder stay in the compute dtype. These are explicit bf16 matmuls, not
TF32: `physics.forward.set_full_f32` turns TF32 off, which they do not
touch, and the physics stays float32.

Module names follow the flax parameter tree: `encoder.trunk.hidden_i`,
`encoder.trunk.LayerNorm_i`, `encoder.fc2_mean`, `encoder.fc2_logvar`,
`decoder.trunk.hidden_i`; `lstm_decoder.lstm_i` (a cell, whose flax gates
`ii`, `if`, ..., `ho` `ppo_factory.params_from_flax` stacks) and
`lstm_decoder.lstm_projection`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from track_mjx_tpu_torch.agent import types
from track_mjx_tpu_torch.agent.distribution import Noise, standard_normal
from track_mjx_tpu_torch.agent.networks import ActivationFn, dense, lecun_normal_, lecun_uniform_
from track_mjx_tpu_torch.physics.model import _device

LAYER_NORM_EPS = 1e-6  # flax.linen.LayerNorm's default


class NormedTrunk(nn.Module):
    """Stack of Dense -> activation -> LayerNorm blocks; with
    `skip_final_norm` the last Dense is left raw."""

    def __init__(
        self,
        in_size: int,
        widths: Sequence[int],
        activation: ActivationFn = F.silu,
        skip_final_norm: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.skip_final_norm = skip_final_norm
        sizes = [in_size, *widths]
        self.blocks = []  # (Dense, LayerNorm or None), registered by flax's names
        for i, width in enumerate(widths):
            self.add_module(f"hidden_{i}", dense(sizes[i], width, generator))
            norm = None
            if not (skip_final_norm and i == len(widths) - 1):
                norm = nn.LayerNorm(width, eps=LAYER_NORM_EPS)
                self.add_module(f"LayerNorm_{i}", norm)
            self.blocks.append((getattr(self, f"hidden_{i}"), norm))

    def forward(self, x: torch.Tensor, taps: Optional[dict] = None) -> torch.Tensor:
        for i, (layer, norm) in enumerate(self.blocks):
            x = layer(x)
            if norm is not None:
                x = norm(self.activation(x))
                if taps is not None:
                    taps[f"layer_{i}"] = x
        return x


class Encoder(nn.Module):
    """Reference observations -> diagonal-Gaussian intention (mean, logvar)."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        latents: int,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.trunk = NormedTrunk(in_size, layer_sizes, generator=generator)
        self.fc2_mean = dense(layer_sizes[-1], latents, generator, init=lecun_normal_)
        self.fc2_logvar = dense(layer_sizes[-1], latents, generator, init=lecun_normal_)

    def forward(self, x: torch.Tensor, taps: Optional[dict] = None):
        x = self.trunk(x, taps)
        mean, logvar = self.fc2_mean(x), self.fc2_logvar(x)
        if taps is not None:
            taps.update(mean=mean, logvar=logvar)
        return mean, logvar


class Decoder(nn.Module):
    """[intention, egocentric obs] -> action-distribution parameters."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.trunk = NormedTrunk(in_size, layer_sizes, skip_final_norm=True, generator=generator)

    def forward(self, x: torch.Tensor, taps: Optional[dict] = None) -> torch.Tensor:
        return self.trunk(x, taps)


Carry = Tuple[torch.Tensor, torch.Tensor]  # (h, c), each [B, layers, hidden]


class LSTMCell(nn.Module):
    """flax `nn.LSTMCell`: i, f, o = sigmoid, g = tanh of W_i x + W_h h + b_h;
    c' = f c + i g, h' = o tanh(c'). `forward(x, h, c)` returns (h', c')."""

    def __init__(self, in_size: int, hidden_size: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, in_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden_size))
        with torch.no_grad():
            for gate in range(4):
                rows = slice(gate * hidden_size, (gate + 1) * hidden_size)
                lecun_uniform_(self.weight_ih[rows], generator)
                # flax's orthogonal on a (hidden, hidden) kernel; torch's on
                # its transpose is as orthogonal
                nn.init.orthogonal_(self.weight_hh[rows], generator=generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor) -> Carry:
        gates = F.linear(x, self.weight_ih) + F.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class RecurrentDecoder(nn.Module):
    """Stacked LSTM cells, then a Dense projection to the distribution's
    parameters. `forward(x, carry)` returns (parameters, carry')."""

    def __init__(
        self,
        in_size: int,
        out_size: int,
        hidden_size: int = 128,
        num_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.cells = []  # registered by flax's names, lstm_i
        for layer in range(num_layers):
            self.add_module(f"lstm_{layer}", LSTMCell(in_size if layer == 0 else hidden_size, hidden_size, generator))
            self.cells.append(getattr(self, f"lstm_{layer}"))
        self.lstm_projection = dense(hidden_size, out_size, generator)

    def forward(self, x: torch.Tensor, carry: Carry, taps: Optional[dict] = None):
        h_stack, c_stack = carry
        next_h, next_c = [], []
        for layer, cell in enumerate(self.cells):
            x, c = cell(x, h_stack[:, layer], c_stack[:, layer])
            next_h.append(x)
            next_c.append(c)
        x = self.lstm_projection(x)
        if taps is not None:
            taps["lstm_projection"] = x
        return x, (torch.stack(next_h, dim=1), torch.stack(next_c, dim=1))


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: Noise) -> torch.Tensor:
    """Reparameterized draw from N(mean, exp(logvar))."""
    return mean + torch.exp(0.5 * logvar) * standard_normal(noise, logvar)


class IntentionPolicy(nn.Module):
    """Encoder + feed-forward decoder with the intention bottleneck between
    them. `forward(obs, noise)` returns (logits, latent_mean,
    latent_logvar), and with `get_activation` the taps after them; the
    latent is the mean when `noise` is None."""

    def __init__(
        self,
        total_obs_size: int,
        encoder_layers: Sequence[int],
        decoder_layers: Sequence[int],
        reference_obs_size: int,
        latents: int = 60,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.reference_obs_size = reference_obs_size
        self.encoder = Encoder(reference_obs_size, encoder_layers, latents, generator)
        egocentric = total_obs_size - reference_obs_size
        self.decoder = Decoder(latents + egocentric, decoder_layers, generator)

    def forward(self, obs: torch.Tensor, noise: Optional[Noise] = None, get_activation: bool = False):
        reference = obs[..., : self.reference_obs_size]
        egocentric = obs[..., self.reference_obs_size :]
        enc, dec = ({}, {}) if get_activation else (None, None)
        mean, logvar = self.encoder(reference, enc)
        z = mean if noise is None else sample_latent(mean, logvar, noise)
        logits = self.decoder(torch.cat([z, egocentric], dim=-1), dec)
        if get_activation:
            taps = {"encoder": enc, "decoder": dec, "egocentric_obs": egocentric, "traj_obs": reference, "intention": z}
            return logits, mean, logvar, taps
        return logits, mean, logvar


class RecurrentIntentionPolicy(nn.Module):
    """Encoder + recurrent decoder; the latent is the encoder's mean.
    `forward(obs, carry)` returns (logits, latent_mean, latent_logvar,
    carry'), and with `get_activation` the taps after them."""

    def __init__(
        self,
        total_obs_size: int,
        encoder_layers: Sequence[int],
        out_size: int,
        reference_obs_size: int,
        latents: int = 60,
        hidden_size: int = 128,
        num_lstm_layers: int = 2,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.reference_obs_size = reference_obs_size
        self.encoder = Encoder(reference_obs_size, encoder_layers, latents, generator)
        egocentric = total_obs_size - reference_obs_size
        self.lstm_decoder = RecurrentDecoder(latents + egocentric, out_size, hidden_size, num_lstm_layers, generator)

    def forward(self, obs: torch.Tensor, carry: Carry, get_activation: bool = False):
        enc, dec = ({}, {}) if get_activation else (None, None)
        mean, logvar = self.encoder(obs[..., : self.reference_obs_size], enc)
        logits, carry = self.lstm_decoder(torch.cat([mean, obs[..., self.reference_obs_size :]], dim=-1), carry, dec)
        if get_activation:
            return logits, mean, logvar, carry, {"encoder": enc, "decoder": dec, "intention": mean, "hidden_state": carry}
        return logits, mean, logvar, carry


def _cast_params(module: nn.Module, *dtypes: torch.dtype) -> dict:
    """The module's parameters cast through `dtypes` in turn (copies)."""
    out = {}
    for name, p in module.named_parameters():
        for dtype in dtypes:
            p = p.to(dtype)
        out[name] = p
    return out


def _float(tree):
    """Every tensor of a nest of dicts and tuples as float32."""
    if isinstance(tree, torch.Tensor):
        return tree.float()
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tuple(_float(v) for v in tree)


def _apply_in(module: nn.Module, obs: torch.Tensor, arg, dtype: torch.dtype, get_activation: bool = False):
    """`module(obs, arg)` with its body in `dtype`, flax's promotions kept
    (module docstring); outputs float32."""
    if isinstance(module, RecurrentIntentionPolicy):
        carry = tuple(c.to(dtype) for c in arg)
        out = functional_call(module, _cast_params(module, dtype), (obs.to(dtype), carry),
                              {"get_activation": get_activation})
        return _float(out)
    obs = obs.to(dtype)
    enc, dec = ({}, {}) if get_activation else (None, None)
    reference, egocentric = obs[..., : module.reference_obs_size], obs[..., module.reference_obs_size :]
    mean, logvar = functional_call(module.encoder, _cast_params(module.encoder, dtype), (reference, enc))
    # float32 noise: bf16 * float32 promotes, as under jax
    z = mean if arg is None else mean + torch.exp(0.5 * logvar) * standard_normal(arg, logvar.float())
    decoder_in = torch.cat([z, egocentric], dim=-1)
    logits = functional_call(module.decoder, _cast_params(module.decoder, dtype, decoder_in.dtype), (decoder_in, dec))
    if get_activation:
        taps = {"encoder": enc, "decoder": dec, "egocentric_obs": egocentric, "traj_obs": reference, "intention": z}
        return _float((logits, mean, logvar, taps))
    return logits.float(), mean.float(), logvar.float()


class NormalizedIntentionPolicy(nn.Module):
    """An intention policy behind the observation normalizer:
    `forward(processor_params, obs, arg, compute_dtype=None,
    get_activation=False)`, `arg` the feed-forward policy's noise or the
    recurrent policy's carry; with `compute_dtype` the body runs in that
    dtype, with `get_activation` the taps come last (module docstring)."""

    def __init__(self, module: nn.Module, preprocess_observations_fn: types.PreprocessObservationFn):
        super().__init__()
        self.module = module
        self.preprocess_observations_fn = preprocess_observations_fn

    def forward(
        self,
        processor_params,
        obs: torch.Tensor,
        arg=None,
        compute_dtype: Optional[torch.dtype] = None,
        get_activation: bool = False,
    ):
        obs = self.preprocess_observations_fn(obs, processor_params)
        if compute_dtype is None:
            return self.module(obs, arg, get_activation=get_activation)
        return _apply_in(self.module, obs, arg, compute_dtype, get_activation)


def make_feedforward_intention_policy(
    action_param_size: int,
    latent_size: int,
    total_obs_size: int,
    reference_obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    encoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    decoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> NormalizedIntentionPolicy:
    """Feed-forward intention policy with normalizer preprocessing, its
    weights drawn on the CPU from `generator`, then moved to `device`."""
    module = IntentionPolicy(
        total_obs_size,
        tuple(encoder_hidden_layer_sizes),
        tuple(decoder_hidden_layer_sizes) + (action_param_size,),
        reference_obs_size,
        latent_size,
        generator,
    )
    return NormalizedIntentionPolicy(module, preprocess_observations_fn).to(_device(device))


def make_recurrent_intention_policy(
    action_param_size: int,
    latent_size: int,
    hidden_state_size: int,
    hidden_layer_num: int,
    total_obs_size: int,
    reference_obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    encoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    decoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> NormalizedIntentionPolicy:
    """Recurrent intention policy with normalizer preprocessing. As in the
    reference, the decoder's hidden widths are not used: only the output
    width, the action parameters, is."""
    del decoder_hidden_layer_sizes
    module = RecurrentIntentionPolicy(
        total_obs_size,
        tuple(encoder_hidden_layer_sizes),
        action_param_size,
        reference_obs_size,
        latent_size,
        hidden_state_size,
        hidden_layer_num,
        generator,
    )
    return NormalizedIntentionPolicy(module, preprocess_observations_fn).to(_device(device))


class DecoderOnlyPolicy(nn.Module):
    """The decoder alone behind the normalizer of its egocentric slice:
    `forward(processor_params, obs)` with obs [latent, egocentric] returns
    (logits, {}); the normalizer's width n says how many trailing features
    it normalizes."""

    def __init__(self, decoder: Decoder, preprocess_observations_fn: types.PreprocessObservationFn):
        super().__init__()
        self.decoder = decoder
        self.preprocess_observations_fn = preprocess_observations_fn

    def forward(self, processor_params, obs: torch.Tensor):
        n_norm = processor_params.mean.shape[-1]
        tail = self.preprocess_observations_fn(obs[..., -n_norm:], processor_params)
        return self.decoder(torch.cat([obs[..., :-n_norm], tail], dim=-1)), {}


def make_decoder_only_policy(
    param_size: int,
    decoder_obs_size: int,
    preprocess_observations_fn: types.PreprocessObservationFn = types.identity_observation_preprocessor,
    decoder_hidden_layer_sizes: Sequence[int] = (1024, 1024),
    generator: Optional[torch.Generator] = None,
    device: torch.device | str = "cuda",
) -> DecoderOnlyPolicy:
    """The standalone decoder of [latent, egocentric obs] (decoder_obs_size
    features) to `param_size` distribution parameters; its state dict is
    the intention policy's `decoder.*`."""
    decoder = Decoder(decoder_obs_size, tuple(decoder_hidden_layer_sizes) + (param_size,), generator)
    return DecoderOnlyPolicy(decoder, preprocess_observations_fn).to(_device(device))
