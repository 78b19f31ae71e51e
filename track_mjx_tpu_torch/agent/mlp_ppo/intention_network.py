"""MLP-pipeline bindings for the intention-policy architecture.

Port of track_mjx_tpu/agent/mlp_ppo/intention_network.py: the
implementation lives in agent/intention.py; this module keeps the MLP
pipeline's names.
"""

from __future__ import annotations

from track_mjx_tpu_torch.agent.intention import (  # noqa: F401  (public API)
    Decoder,
    Encoder,
    IntentionPolicy as IntentionNetwork,
    make_decoder_only_policy as make_decoder_policy,
    make_feedforward_intention_policy as make_intention_policy,
    sample_latent as reparameterize,
)
