"""trainer.sgd_ms: mean host ms per training step of the learning half
inside the window (the normalizer update and the SGD passes, from the
learner's call to its closing synchronize)."""


def read(run):
    return run["phase_ms"].get("sgd_ms")
