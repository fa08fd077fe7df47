"""Milliseconds of the engine per served frame: the benchmark's span
around ``Pix2PoseEstimator.estimate_objects_images`` (ending in a
synchronize), summed over the window, over the frames the service
processed in it."""

LAYER = "inference.engine"
UNIT = "ms"
MOVES = "frames_per_s"


def read(trace):
    if trace.get("kind") != "serving":
        return None
    spans, t0, t1 = trace["spans"], trace["t_go_ns"], trace["t_end_ns"]
    frames = spans.items("serving.service", t0, t1)
    if not frames:
        return None
    return spans.total_s("inference.engine", t0, t1) * 1e3 / frames
