"""Milliseconds per served frame in ``PoseService.process_many`` outside
the engine: detections to slots, sensor prep, the ICP refiner and its
renders, host post-processing. The span around ``process_many`` less the
engine's span, over the window's frames."""

LAYER = "serving.service"
UNIT = "ms"
MOVES = "frames_per_s"


def read(trace):
    if trace.get("kind") != "serving":
        return None
    spans, t0, t1 = trace["spans"], trace["t_go_ns"], trace["t_end_ns"]
    frames = spans.items("serving.service", t0, t1)
    if not frames:
        return None
    rest = (spans.total_s("serving.service", t0, t1)
            - spans.total_s("inference.engine", t0, t1))
    return rest * 1e3 / frames
