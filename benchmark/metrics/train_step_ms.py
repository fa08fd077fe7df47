"""Milliseconds of one GAN step (``make_train_step``'s call: two
discriminator updates and one generator update) on the card, by CUDA
events around each step of the window, averaged."""

LAYER = "training.gan"
UNIT = "ms"
MOVES = "train_samples_per_s"


def read(trace):
    ms = trace.get("step_ms") if trace.get("kind") == "training" else None
    return sum(ms) / len(ms) if ms else None
