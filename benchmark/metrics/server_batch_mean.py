"""Frames per server batch, from each response's ``server_batch``: the
window's answered frames over the batches they came in."""

LAYER = "serving.server (BatchingFrontend)"
UNIT = "frames/batch"
MOVES = "frame_p90_ms"


def read(trace):
    sizes = trace.get("server_batch") if trace.get("kind") == "serving" \
        else None
    if not sizes:
        return None
    return len(sizes) / sum(1.0 / b for b in sizes)
