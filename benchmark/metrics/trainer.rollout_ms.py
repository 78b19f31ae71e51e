"""trainer.rollout_ms: mean host ms per training step of the rollout inside
the window, from the end of a learning half (the trainer's synchronize) to
the next batch callback (after the rollout's own synchronize)."""


def read(run):
    return run["phase_ms"].get("rollout_ms")
