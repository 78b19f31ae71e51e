"""Parameter-freeze masks for decoder-transfer training.

Port of track_mjx_tpu/agent/network_masks.py. The JAX mask is a pytree of
bools over the flax parameters, True on every leaf under a module named
`decoder`, for `optax.transforms.freeze`. Here it is the same flag per
entry of the networks' state dicts: True where a component of the dotted
name is `decoder` (`module.decoder.trunk.hidden_0.weight`), False elsewhere
(the encoder, the value network, and `lstm_decoder`, which the JAX mask does
not match either).
"""

from __future__ import annotations

from typing import Mapping

DECODER = "decoder"


def is_decoder(name: str) -> bool:
    """Whether the dotted parameter name lies under a `decoder` module."""
    return DECODER in name.split(".")


def create_decoder_mask(params):
    """The mask of `params` (a `losses.PPONetworkParams` of state dicts, or
    one state dict): the same structure with a bool per entry, True =
    frozen (decoder), False = trainable."""
    if isinstance(params, Mapping):
        return {name: is_decoder(name) for name in params}
    return type(params)(*(create_decoder_mask(p) for p in params))
