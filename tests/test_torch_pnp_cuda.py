"""PnP-RANSAC's CUDA graph against its eager body on the card (skips
without a CUDA device). Imports no jax, so it runs where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pnp_cuda.py

Bar: at C = 12 and 24 candidates of N = 1 024 points and the serving
configuration's settings, the replay equals the eager body bit for bit in
all five fields; a result held from one call is unchanged after a call on
other inputs; one capture per key and one replay per call; a change of
the float32 matmul precision gets a capture of its own; threads that
share a stream and race a key's capture each get their own inputs'
result. Each test runs on a stream of its own, and the graph cache keys
on the stream, so its keys are new whatever ran before it in the
process."""

import numpy as np
import pytest
import torch

from pix2pose_torch.ops import pnp
from pnp_problem import CAM_K, KW, problem


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _batch(c, seed, dev):
    """C candidates of N = 1 024 points, the engine's per-candidate K and
    PROSAC quality, with every fourth candidate below ``min_pts``."""
    probs = [problem(seed + i, n_valid=5 if i % 4 == 3 else 300 + 50 * i)
             for i in range(c)]
    obj, img, valid, quality = (torch.from_numpy(np.stack(x)).to(dev)
                                for x in zip(*probs))
    k = torch.from_numpy(CAM_K).to(dev).expand(c, 3, 3).contiguous()
    return obj, img, valid, k, quality


def _settings():
    return {k: KW[k] for k in ("reproj_px", "min_pts", "refine_iters",
                               "hyp_polish_iters", "select_stride")}


def _counters():
    return (pnp.pnp_ransac_batch.graph_captures,
            pnp.pnp_ransac_batch.graph_replays)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [12, 24])
def test_replay_equals_eager_body(c):
    dev = _cuda()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        captures, replays = _counters()
        for call, seed in enumerate((100, 200)):
            obj, img, valid, k, q = _batch(c, seed, dev)
            idx = pnp._draw_index_sets(
                torch.Generator(device=dev).manual_seed(seed), valid, q,
                KW["iters"], 6, 12)
            eager = pnp._ransac_body(obj, img, valid, k, *idx,
                                     **_settings())
            got = pnp.pnp_ransac_batch(
                obj, img, valid, k,
                torch.Generator(device=dev).manual_seed(seed), q, **KW)
            torch.cuda.synchronize()
            assert _counters() == (captures + 1, replays + call + 1)
            assert bool(got.ok.any()) and not bool(got.ok.all())
            for g, e in zip(got, eager):
                assert torch.equal(g, e)


@pytest.mark.gpu
def test_held_result_survives_the_next_replay():
    dev = _cuda()
    with torch.cuda.stream(torch.cuda.Stream(dev)):
        one, two = _batch(12, 300, dev), _batch(12, 400, dev)
        first = pnp.pnp_ransac_batch(
            *one[:4], torch.Generator(device=dev).manual_seed(1), one[4],
            **KW)
        kept = [x.clone() for x in first]
        second = pnp.pnp_ransac_batch(
            *two[:4], torch.Generator(device=dev).manual_seed(2), two[4],
            **KW)
        torch.cuda.synchronize()
    assert not torch.equal(second.t, first.t)
    for x, y in zip(first, kept):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_tf32_gets_its_own_capture():
    """A graph captured in float32 is not replayed with TF32 on, nor the
    other way round: each precision captures once and replays the
    eager body's result at that precision, bit for bit."""
    dev = _cuda()
    obj, img, valid, k, q = _batch(12, 500, dev)
    idx = pnp._draw_index_sets(torch.Generator(device=dev).manual_seed(5),
                               valid, q, KW["iters"], 6, 12)
    args = (obj, img, valid, k) + tuple(idx)
    prev = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for tf32 in (False, True, False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                before = _counters()
                got = pnp._graphed_body(args, _settings())
                eager = pnp._ransac_body(*args, **_settings())
                torch.cuda.synchronize()
                new = tf32 not in out
                assert _counters() == (before[0] + new, before[1] + 1)
                for g, e in zip(got, eager):
                    assert torch.equal(g, e)
                out.setdefault(tf32, got)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert not torch.equal(out[True].R, out[False].R)


@pytest.mark.gpu
def test_threads_sharing_a_stream_get_their_own_results():
    """Four threads call the solve at once on one stream, three calls
    each on inputs of their own, the first of them racing the key's
    capture: every result equals the eager body on its inputs."""
    import sys
    import threading

    dev = _cuda()
    stream = torch.cuda.Stream(dev)
    inputs = {(t, i): _batch(12, 600 + 10 * t + i, dev)
              for t in range(4) for i in range(3)}
    got, errors = {}, []

    def work(t):
        try:
            with torch.cuda.stream(stream):
                for i in range(3):
                    obj, img, valid, k, q = inputs[(t, i)]
                    got[(t, i)] = pnp.pnp_ransac_batch(
                        obj, img, valid, k,
                        torch.Generator(device=dev).manual_seed(t * 3 + i),
                        q, **KW)
        except Exception as e:  # surfaced below
            errors.append(e)

    before = _counters()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    torch.cuda.synchronize()
    assert _counters() == (before[0] + 1, before[1] + 12)
    for (t, i), res in got.items():
        obj, img, valid, k, q = inputs[(t, i)]
        with torch.cuda.stream(stream):
            idx = pnp._draw_index_sets(
                torch.Generator(device=dev).manual_seed(t * 3 + i), valid,
                q, KW["iters"], 6, 12)
            eager = pnp._ransac_body(obj, img, valid, k, *idx,
                                     **_settings())
        torch.cuda.synchronize()
        for g, e in zip(res, eager):
            assert torch.equal(g, e)
    assert len(got) == 12
