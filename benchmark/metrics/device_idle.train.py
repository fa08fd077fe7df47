"""Share of the profiled sub-window (the last seconds of the measured
window) in which no operation ran on the card: 1 - the union of the
device operations' intervals over the sub-window (torch.profiler)."""

LAYER = "device"
UNIT = "%"
MOVES = "train_samples_per_s"


def read(trace):
    prof = trace.get("profile") if trace.get("kind") == "training" else None
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
