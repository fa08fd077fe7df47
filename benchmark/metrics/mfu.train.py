"""The training step's work as a share of the card's float32 peak: the
benchmark's analytic operations of one GAN step (fakes' pass, two
discriminator updates, one generator update) times the steps of the
window, over the window, over 67 TFLOP/s."""

from benchmark.flops import PEAK_FP32

LAYER = "model step"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(trace):
    if trace.get("kind") != "training" or not trace.get("flops"):
        return None
    return 100.0 * trace["flops"] / trace["window_s"] / PEAK_FP32
