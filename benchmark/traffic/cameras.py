"""Closed-loop cameras against the pose server.

Set-up makes the frame pool and the weights from the seed, builds the
program's ``PoseService`` behind a ``PoseServer`` on 127.0.0.1 (port 0),
warms every batch size the cameras can form, and starts the client process
(:mod:`benchmark.client`). The window is the client's: each camera sends
its next frame when the last reply came. A sample of the window's server
batches, drawn from the seed, keeps the engine's estimate; once the window
has closed, the plain reference works those detections out again.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark import common, flops, scene, trace, weights
from benchmark.reference.serve import ServeReference, compare_batches

FIELDS = ("R", "t", "valid", "frac_inlier", "n_inliers", "mask_pnp",
          "fg128", "xyz128")


class StampDetector:
    """The served detector: reads the request's stamp and hands on the
    detections the benchmark made for that pool frame (ground-truth boxes,
    jittered, with their visible masks), as ``PrecomputedDetector`` replays
    stored ones. Remembers the request ids of the batch being served."""

    def __init__(self, dets_by_pool: list):
        from pix2pose_torch.inference.detector import Detection

        self.dets = [[Detection(bbox=b, obj_id=o, score=s, mask=m)
                      for o, b, s, m in d] for d in dets_by_pool]
        self.batch_ids: list = []

    def detect(self, scene_id, im_id, rgb):
        req, pool = scene.read_stamp(rgb)
        self.batch_ids.append(req)
        return self.dets[pool]

    def take_batch_ids(self) -> list:
        ids, self.batch_ids = self.batch_ids, []
        return ids


class Capture:
    """Keeps the engine's estimate of ``keep`` server batches of the
    window, drawn from the seed uniformly over all of its batches
    (reservoir sampling: the window's length in batches is not known in
    advance, and a batch that drops out of the sample is freed)."""

    def __init__(self, est, detector, seed: int, keep: int):
        self.detector = detector
        self.active = False
        self.n_batches = 0
        self.rng = np.random.default_rng(seed)
        self.keep = keep
        self.kept: list = []
        orig = est.estimate_objects_images

        def capture(*a, **kw):
            out = orig(*a, **kw)
            ids = detector.take_batch_ids()
            if self.active:
                self.offer((self.n_batches, ids, out))
                self.n_batches += 1
            return out

        est.estimate_objects_images = capture

    def offer(self, item):
        i = item[0]
        if i < self.keep:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.keep:
                self.kept[j] = item

    def host(self) -> list:
        out = []
        for _, ids, est in sorted(self.kept, key=lambda k: k[0]):
            d = {f: getattr(est, f).cpu() for f in FIELDS}
            d["box1"] = {k: v.cpu() for k, v in est.box1._asdict().items()}
            d["box2"] = {k: v.cpu() for k, v in est.box2._asdict().items()}
            out.append((ids, d))
        return out


def build(cfg: dict, mix: dict, seed: int, device):
    """The inputs both sides get: the frame pool, each object's weights
    (seeded, then set to pass the coordinate colours through, the error
    map's logits about two spreads below ``inlier_th``'s) and the norm
    factors (``pool["served_norm"]``) that decode the generator's map to
    millimetres: the frames' codec scaled by 1 / code_scale."""
    from pix2pose_torch.models.ae import build_generator

    pool = scene.build_frames(cfg, mix, seed, device)
    obj_ids = [o["id"] for o in cfg["objects"]]
    template = build_generator(cfg["backbone"]).state_dict()
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    ws = weights.seeded_state(template, len(obj_ids), gen, device)
    gain, th = cfg["passthrough_gain"], cfg["estimator"]["inlier_th"]
    for w in ws:
        weights.passthrough(w, gain, math.log(th / (1.0 - th)) - 1.0)
    k = 1.0 / mix["code_scale"]
    pool["served_norm"] = [torch.cat([n[:3] * k, n[3:]])
                           for n in pool["norm"]]
    return pool, dict(zip(obj_ids, ws))


def make_service(cfg: dict, pool: dict, params: dict, device):
    from pix2pose_torch.models.ae import build_generator
    from pix2pose_torch.serving.service import PoseService, ServingConfig

    e = cfg["estimator"]
    obj_ids = [o["id"] for o in cfg["objects"]]
    cam = cfg["camera"]
    sc = ServingConfig(
        backbone=cfg["backbone"], inlier_th=e["inlier_th"],
        outlier_th=tuple(e["outlier_th"]),
        cam_K=pool["cam_k"].cpu().numpy(), im_width=cam["width"],
        im_height=cam["height"], obj_labels=tuple(obj_ids))
    norms = {o: pool["served_norm"][i].cpu().numpy()
             for i, o in enumerate(obj_ids)}
    corners = {}
    for i, o in enumerate(obj_ids):
        v = pool["meshes"][i]["verts"]
        lo, hi = v.amin(0).cpu().numpy(), v.amax(0).cpu().numpy()
        corners[o] = np.array([[x, y, z] for x in (lo[0], hi[0])
                               for y in (lo[1], hi[1])
                               for z in (lo[2], hi[2])], np.float32)
    detector = StampDetector(pool["dets"])
    service = PoseService(sc, detector, build_generator(cfg["backbone"]),
                          params, norms, corners, max_det=cfg["max_det"],
                          device=device)
    # every estimator and solver setting as the configuration states it,
    # not as the program's defaults have it
    fields = {f.name for f in dataclasses.fields(service.est.cfg)}
    pinned = {k: tuple(v) if isinstance(v, list) else v
              for k, v in e.items() if k in fields}
    service.est.cfg = dataclasses.replace(service.est.cfg, **pinned)
    service.est.pnp_stride = service.est.cfg.pnp_stride
    return service, detector


def run(ctx) -> dict:
    from pix2pose_torch.serving.server import PoseServer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    pool, params = build(cfg, mix, ctx.seed, dev)
    service, detector = make_service(cfg, pool, params, dev)
    if ctx.program_hook is not None:
        ctx.program_hook(service)
    n_cam, n_pool = mix["cameras"], len(pool["rgb"])
    capture = Capture(service.est, detector, ctx.seed + 2,
                      mix["sampled_batches"])

    # warm every batch size the cameras can form, each twice, on the last
    # frames of the cameras' ranges, which the window does not reach
    span = n_pool // n_cam
    tail = [c * span + span - 1 - j for j in range(mix["warmup_per_camera"])
            for c in range(n_cam)]
    warm_id, k = 4_000_000_000, 0
    for b in list(range(1, min(n_cam, mix["max_batch"]) + 1)) * 2:
        pools = [tail[(k + j) % len(tail)] for j in range(b)]
        rgb = [scene.stamp(pool["rgb"][p], r, p)
               for r, p in zip(range(warm_id, warm_id + b), pools)]
        warm_id += b
        k += b
        service.process_many(rgb)
    detector.take_batch_ids()

    spans = trace.Spans()
    prof = None
    if ctx.trace:
        spans.wrap(service.est, "estimate_objects_images",
                   "inference.engine")
        spans.wrap(service, "process_many", "serving.service",
                   items=lambda a: len(a[0]))
        # profiled from the dispatcher's thread, over the window's end
        prof = trace.Profile()
        service.process_many = prof.around(service.process_many)
    with ctx.precision():
        server = PoseServer(service, "127.0.0.1", 0,
                            max_batch=mix["max_batch"])
        try:
            out = _drive(ctx, server, pool, cfg, mix, capture, spans, prof)
        finally:
            server.close()
    memory_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        memory_peak = torch.cuda.max_memory_allocated(dev)
    kept = capture.host()
    del service, server, capture
    torch.cuda.empty_cache()

    reqs = out["client"]["requests"]
    t_go, t_end = out["client"]["t_go"], out["client"]["t_end"]
    seconds = t_end - t_go
    failed = [r for r in reqs if r["error"] is not None]
    answered = [r for r in reqs if r["error"] is None and r["t_recv"] <= t_end]
    lat = sorted((r["t_recv"] - r["t_send"]) * 1e3 if r["error"] is None
                 else math.inf for r in reqs)
    p90 = float(np.percentile(lat, 90)) if lat else math.inf
    e2e = {"frames_per_s": len(answered) / seconds, "frame_p90_ms": p90,
           "setup_s": out["setup_s"]}

    # the plain reference, once the program is freed
    t_ref = time.monotonic()
    frames, dets, truth, wire = {}, {}, {}, {}
    for r in reqs:
        wire[r["req"]] = None if r["error"] else r["poses"]
    for ids, _ in kept:
        for rid in ids:
            p = next(r["pool"] for r in reqs if r["req"] == rid)
            frames[rid] = scene.stamp(pool["rgb"][p], rid, p)
            dets[rid] = pool["dets"][p]
            truth[rid] = pool["truth"][p]
    norms = {o["id"]: pool["served_norm"][i]
             for i, o in enumerate(cfg["objects"])}
    ref = ServeReference(cfg, params, norms, pool["cam_k"], dev,
                         seed=ctx.seed + 3)
    obj_ids = [o["id"] for o in cfg["objects"]]
    readings = compare_batches(
        ref, [(ids, est, obj_ids) for ids, est in kept], wire, frames, dets,
        truth)
    readings["failed"] = len(failed)
    common.log(f"reference: {readings['compared']} detections of "
               f"{sum(len(i) for i, _ in kept)} requests in "
               f"{time.monotonic() - t_ref:.1f} s")

    needed = 0
    g = flops.forward(flops.GENERATORS[cfg["backbone"]]())
    n_th = len(cfg["estimator"]["outlier_th"])
    for r in answered:
        n_det = min(len(pool["dets"][r["pool"]]), len(obj_ids)
                    * cfg["max_det"])
        needed += n_det * (1 + n_th) * g
    tr = {"kind": "serving", "window_s": seconds, "frames": len(answered),
          "server_batch": [r["server_batch"] for r in answered],
          "spans": spans, "t_go_ns": out["t_go_ns"],
          "t_end_ns": out["t_go_ns"] + int(seconds * 1e9),
          "flops": needed, "profile": out.get("profile")}
    return {"e2e": e2e, "trace": tr, "readings": readings,
            "attempted": len(reqs), "failed": len(failed),
            "memory_peak": memory_peak,
            "client_modules": out["client"]["modules"],
            "breakdown": (None if out.get("profile") is None else
                          {k: out["profile"][k]
                           for k in ("device_ops", "idle_gaps")})}


def _drive(ctx, server, pool, cfg, mix, capture, spans, prof) -> dict:
    host, port = server.address
    proc = subprocess.Popen([sys.executable, "-m", "benchmark.client"],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            cwd=str(common.ROOT.parent))
    if ctx.client_cores:
        os.sched_setaffinity(proc.pid, ctx.client_cores)
    try:
        h, w = pool["rgb"].shape[1:3]
        spec = {"host": host, "port": port, "cameras": mix["cameras"],
                "seconds": ctx.seconds,
                "warmup_per_camera": mix["warmup_per_camera"],
                "first_request_id": 0,
                "frames": [{"h": h, "w": w}
                           for _ in range(len(pool["rgb"]))]}
        proc.stdin.write((json.dumps(spec) + "\n").encode())
        for i in range(len(pool["rgb"])):
            proc.stdin.write(np.ascontiguousarray(pool["rgb"][i]).tobytes())
        proc.stdin.flush()
        if proc.stdout.readline().strip() != b"ready":
            raise RuntimeError("the client did not warm up")
        capture.detector.take_batch_ids()
        capture.active = True
        t_go_ns = time.time_ns()
        setup_s = time.monotonic() - ctx.t_start
        if prof is not None:
            prof.start_ns = t_go_ns + int(
                max(ctx.seconds - mix["profile_seconds"], 0.0) * 1e9)
            prof.stop_ns = t_go_ns + int(ctx.seconds * 1e9)
        proc.stdin.write(b"go\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = {"client": json.loads(line), "setup_s": setup_s, "t_go_ns": t_go_ns}
    if prof is not None and prof.done:
        out["profile"] = trace.reduce_profile(prof, spans)
    return out
