"""LSTM-pipeline bindings for the intention-policy architecture.

Port of track_mjx_tpu/agent/lstm_ppo/intention_network.py: the
implementation lives in agent/intention.py; this module keeps the LSTM
pipeline's names. Its latent is the encoder's mean (z = latent_mean): the
reference turns the reparameterization off in this pipeline.
"""

from __future__ import annotations

from track_mjx_tpu_torch.agent.intention import (  # noqa: F401  (public API)
    Encoder,
    RecurrentDecoder as LSTMDecoder,
    RecurrentIntentionPolicy as IntentionNetwork,
    make_recurrent_intention_policy as make_intention_policy,
    sample_latent as reparameterize,
)
