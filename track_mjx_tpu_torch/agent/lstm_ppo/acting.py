"""LSTM-pipeline names over the shared rollout and eval code.

Port of track_mjx_tpu/agent/lstm_ppo/acting.py: the recurrent actor step,
unroll and evaluator live in agent/acting.py.
"""

from __future__ import annotations

import functools

from track_mjx_tpu_torch.agent.acting import (  # noqa: F401  (public API)
    Evaluator as _Evaluator,
    recurrent_actor_step as actor_step,
    recurrent_generate_unroll as generate_unroll,
)

Evaluator = functools.partial(_Evaluator, recurrent=True)
