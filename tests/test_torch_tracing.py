"""pix2pose_torch's recorder (``utils/tracing.py``) and the spans and waits
the engine and the batching frontend record with it. The engine runs on
``tests/test_torch_engine.py``'s scene (oracle generator, two cube images
x two detections); the frontend over a stub service."""

import threading
import time

import numpy as np
import torch

from pix2pose_torch.serving.server import BatchingFrontend
from pix2pose_torch.utils import tracing
from test_torch_engine import OBJ_PARAM, scene  # noqa: F401 - fixture
from synthetic import CAM_K

STAGES = ["engine.stage1", "engine.generator", "engine.stage2_inputs",
          "engine.generator", "engine.correspondences", "engine.pnp",
          "engine.select"]


def _record(fn):
    """``fn()`` with the recorder on, from empty; its records."""
    tracing.take()
    tracing.enable()
    try:
        fn()
    finally:
        tracing.disable()
    return tracing.take()


def test_off_records_nothing():
    tracing.take()
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", items=5)
    assert a is tracing.OFF and b is tracing.OFF and a.id == 0
    with a:
        with b:
            pass
    tracing.wait("w", 1, 2, 3, 4)
    tracing.count("c", 7)
    assert tracing.take() == {"spans": [], "waits": [], "counts": {}}


def test_nested_spans_carry_parents_items_and_clock():
    box = {}

    def work():
        box["t0"] = time.time_ns()
        with tracing.span("outer", items=3) as outer:
            with tracing.span("inner", items=2) as inner:
                pass
            with tracing.span("inner"):
                pass
        box["t1"] = time.time_ns()
        box["ids"] = outer.id, inner.id

    rec = _record(work)
    outer_id, inner_id = box["ids"]
    spans = rec["spans"]
    assert [s[0] for s in spans] == ["inner", "inner", "outer"]
    (_, s0, e0, n0, i0, p0, th0), (*_, n1, _, p1, _), outer = spans
    assert (i0, p0, n0) == (inner_id, outer_id, 2)
    assert (n1, p1) == (1, outer_id)
    assert outer[3:6] == (3, outer_id, 0)
    assert th0 == outer[6] == threading.get_ident()
    assert box["t0"] <= outer[1] <= s0 <= e0 <= outer[2] <= box["t1"]


def test_waits_and_counts_stay_apart_from_spans():
    def work():
        with tracing.span("s") as sp:
            tracing.wait("q", 10, 20, 7, sp.id)
            tracing.count("n", 3)
            tracing.count("n", 4)

    rec = _record(work)
    assert [s[0] for s in rec["spans"]] == ["s"]
    assert rec["waits"] == [("q", 10, 20, 7, rec["spans"][0][4])]
    assert rec["counts"] == {"n": 7}


def test_engine_records_stage_spans_and_same_estimate(scene):  # noqa: F811
    _, _, est, rgbs, bbs, _ = scene
    n_obj = 2

    def run():
        return est.estimate_objects_images(
            {"dummy": torch.zeros(n_obj, 1)}, rgbs,
            np.repeat(bbs[:, None], n_obj, 1),
            np.ones((2, n_obj, 2), bool), np.stack([CAM_K] * 2),
            np.stack([OBJ_PARAM] * n_obj), torch.Generator().manual_seed(3))

    off = run()
    box = {}
    rec = _record(lambda: box.setdefault("on", run()))
    flat = lambda est: [x for f in est                    # noqa: E731
                        for x in (f if isinstance(f, tuple) else [f])]
    for x, y in zip(flat(off), flat(box["on"]), strict=True):
        assert torch.equal(x, y)
    spans = sorted(rec["spans"], key=lambda s: s[4])       # opening order
    assert [s[0] for s in spans] == STAGES * n_obj
    assert all(s[3] == 2 * 2 for s in spans)               # B x N slots
    for o in range(n_obj):
        block = spans[o * len(STAGES):(o + 1) * len(STAGES)]
        # the stage-1 generator pass nests in engine.stage1, nothing else
        assert [s[5] for s in block] == [0, block[0][4]] + [0] * 5
        assert block[0][1] <= block[1][1] <= block[1][2] <= block[0][2]


class _StubService:
    """Returns one result per frame after a short pause, as a batch of
    the engine would."""

    def process_many(self, rgbs, depths=None, want_images=False):
        time.sleep(0.02)
        return [object() for _ in rgbs]


def test_frontend_records_queue_waits_and_dispatch_spans():
    front = BatchingFrontend(_StubService(), max_batch=4)
    n_threads, n_each = 6, 3
    tickets, errors = [], []

    def client():
        try:
            for _ in range(n_each):
                tickets.append(front.submit(np.zeros((4, 4, 3), np.uint8)))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def work():
        threads = [threading.Thread(target=client)
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)

    try:
        rec = _record(work)
    finally:
        front.close()
    n = n_threads * n_each
    assert not errors and len(tickets) == n
    dispatch = {s[4]: s for s in rec["spans"] if s[0] == "server.dispatch"}
    waits = [w for w in rec["waits"] if w[0] == "server.queue"]
    assert sum(s[3] for s in dispatch.values()) == n
    assert len(waits) == n and len({w[3] for w in waits}) == n
    assert max(s[3] for s in dispatch.values()) >= 2
    for _, s, e, _, parent in waits:
        d = dispatch[parent]
        assert s <= e <= d[1]                  # waited, then dispatched
    assert {t.ident for t in tickets} == {w[3] for w in waits}
    assert all(0 < t.latency_s for t in tickets)
