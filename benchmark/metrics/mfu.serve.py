"""The served generator work as a share of the card's float32 peak: the
benchmark's analytic operations of the crops that the window's answered
frames' detections need (one stage-1 and one stage-2 crop per outlier
threshold; padded slots not counted), over the window, over 67 TFLOP/s."""

from benchmark.flops import PEAK_FP32

LAYER = "model step"
UNIT = "%"
MOVES = "frames_per_s"


def read(trace):
    if trace.get("kind") != "serving" or not trace.get("flops"):
        return None
    return 100.0 * trace["flops"] / trace["window_s"] / PEAK_FP32
