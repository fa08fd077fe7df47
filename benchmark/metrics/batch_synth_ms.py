"""Milliseconds of one batch's synthesis (``training.data.make_batch`` on
the card) by CUDA events around each call of the window, averaged."""

LAYER = "training.data"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(trace):
    ms = trace.get("batch_ms") if trace.get("kind") == "training" else None
    return sum(ms) / len(ms) if ms else None
