"""Rasterizer microbenchmark: the chunked scan, the exhaustive kernel entry
(K2) and the binned kernel entry (K1) on one mesh at several densities
(port of the JAX package's ``tools/bench_rasterizer.py``).

    python -m pix2pose_torch.tools.bench_rasterizer [--faces 2400 40000 99000]
        [--windows 3] [--k 2] [--core-runs 200] [--device cuda]

Each row renders a UV sphere of about that many faces at 480x640, one
frame per call (projection, face set-up, z-buffer and attribute epilogue;
attributes are the vertex positions): ``scan`` is
:func:`~pix2pose_torch.ops.rasterizer.rasterize`, ``exhaustive``
:func:`~pix2pose_torch.ops.rasterizer_cuda.rasterize_exhaustive` and
``binned`` :func:`~pix2pose_torch.ops.rasterizer_cuda.rasterize_binned`.
After one warm-up frame, ``windows`` windows of ``k`` frames are timed
(CUDA events on a CUDA device, the host clock on the CPU) and the median
milliseconds per frame is printed. The warm-up frames' depth sums must
agree within 1e-2 relative: the scan decides coverage and depth with
per-pixel divisions, the kernels with affine forms, so silhouette-edge
pixels may differ between them.

Two more rows time the z-buffer core alone, without projection, face
set-up or epilogue: ``exhaustive_core`` and ``binned_core`` launch the
kernel's two entries on face coefficients built once per mesh (on the CPU
both run the plain version, as the wrappers do for CPU tensors). Each of
``core_runs`` launches is timed on its own; the median and the spread
(min, 10th and 90th percentile, max) are printed. Their 1/z buffers must
be equal. Before them, the binned entry's work list for the mesh is
printed (``rasterizer_cuda.work_list_stats``: (tile, chunk) items, tiles
with work, the longest tile list). Exits 1 when any check fails.
"""

from __future__ import annotations

import sys
import time
from typing import Sequence

import numpy as np
import torch

H, W = 480, 640
CAM_K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]],
                 np.float32)
AGREE_RTOL = 1e-2


def uv_sphere(n_faces, r=0.05):
    """Latitude-longitude sphere of about ``n_faces`` faces, radius ``r``
    (the same mesh as the JAX tool's)."""
    n = max(int(np.sqrt(n_faces / 2)), 4)
    lat = np.linspace(0.12, np.pi - 0.12, n)
    lon = np.linspace(0, 2 * np.pi, n, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([r * np.sin(la) * np.cos(lo),
                      r * np.sin(la) * np.sin(lo),
                      r * np.cos(la)], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    i = np.repeat(np.arange(n - 1), n)
    j = np.tile(np.arange(n), n - 1)
    j2 = (j + 1) % n
    f1 = np.stack([idx[i, j], idx[i + 1, j], idx[i, j2]], -1)
    f2 = np.stack([idx[i, j2], idx[i + 1, j], idx[i + 1, j2]], -1)
    return verts, np.concatenate([f1, f2]).astype(np.int32)


def _paths():
    from pix2pose_torch.ops.rasterizer import rasterize
    from pix2pose_torch.ops.rasterizer_cuda import (rasterize_binned,
                                                    rasterize_exhaustive)

    return [
        ("scan", lambda uv, z, f, a: rasterize(uv, z, f, a, H, W).depth),
        ("exhaustive",
         lambda uv, z, f, a: rasterize_exhaustive(uv, z, f, a, H, W).depth),
        ("binned", lambda uv, z, f, a: rasterize_binned(
            uv[None], z[None], f[None], a[None], H, W).depth[0]),
    ]


def _time_ms(frame, dev, windows: int, k: int) -> list[float]:
    """Milliseconds per frame of each of ``windows`` windows of ``k``
    frames."""
    per_frame = []
    for _ in range(windows):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(k):
                frame()
            b.record()
            torch.cuda.synchronize(dev)
            per_frame.append(a.elapsed_time(b) / k)
        else:
            t0 = time.perf_counter()
            for _ in range(k):
                frame()
            per_frame.append((time.perf_counter() - t0) * 1e3 / k)
    return per_frame


def _cores(dev):
    from pix2pose_torch.ops import rasterizer_cuda as rc

    if dev.type == "cuda":
        return [("exhaustive_core", rc._exhaustive_core_cuda),
                ("binned_core", rc._binned_core_cuda)]
    return [("exhaustive_core", rc._binned_core_plain),
            ("binned_core", rc._binned_core_plain)]


def _time_launches_ms(launch, dev, runs: int) -> list[float]:
    """Milliseconds of each of ``runs`` calls of ``launch``, one at a
    time, after one untimed call."""
    launch()
    out = []
    for _ in range(runs):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            launch()
            b.record()
            torch.cuda.synchronize(dev)
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            launch()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def run(faces: Sequence[int] = (2400, 40000, 99000), windows: int = 3,
        k: int = 2, core_runs: int = 200, device="cuda", log=print) -> dict:
    """Time every row at every mesh size; returns {"rows": [{faces, row,
    ms, windows_ms, depth_sum} for the frame rows, {faces, row, ms,
    spread_ms (min, p10, p90, max)} for the core rows, {faces, row:
    "work_list", items, tiles, longest}], "agree": bool}."""
    from pix2pose_torch.ops import rasterizer_cuda as rc
    from pix2pose_torch.ops.rasterizer import project_vertices

    dev = torch.device(device)
    K = torch.as_tensor(CAM_K, device=dev)
    R = torch.eye(3, device=dev)
    t = torch.tensor([0.02, -0.01, 0.5], device=dev)
    rows, agree = [], True
    for nf in faces:
        verts, fcs = uv_sphere(nf)
        v = torch.as_tensor(verts, device=dev)
        f = torch.as_tensor(fcs, device=dev)
        log(f"--- {len(fcs)} faces, {H}x{W}, {dev.type} ---")
        sums = {}
        for name, fn in _paths():
            def frame(fn=fn):
                uv, z = project_vertices(v, R, t, K)
                return fn(uv, z, f, v)

            sums[name] = float(frame().sum())       # warm-up + agreement
            per = _time_ms(frame, dev, windows, k)
            med = sorted(per)[len(per) // 2]
            rows.append({"faces": len(fcs), "row": name, "ms": med,
                         "windows_ms": per, "depth_sum": sums[name]})
            log(f"{name:10s}: {med:10.3f} ms/frame (windows "
                f"{[round(p, 3) for p in per]})")
        ref = sums["scan"]
        rel = max(abs(s - ref) / max(abs(ref), 1e-30) for s in sums.values())
        ok = all(abs(s - ref) <= AGREE_RTOL * abs(ref) + 1e-3
                 for s in sums.values())
        uv, z = project_vertices(v, R, t, K)
        packed, _, bounds = rc._sorted_tris(uv[None], z[None], f[None], H, W)
        work = rc.work_list_stats(bounds, H, W)
        rows.append({"faces": len(fcs), "row": "work_list", **work})
        log(f"work list: {work['items']} (tile, chunk) items at "
            f"{rc.KERNEL_TILE_V}x{rc.KERNEL_TILE_U} tiles over "
            f"{work['tiles']} tiles, longest tile list {work['longest']} "
            f"chunks")
        izbs = []
        for name, core in _cores(dev):
            izbs.append(core(packed, bounds, H, W)[0])
            per = sorted(_time_launches_ms(
                lambda core=core: core(packed, bounds, H, W), dev,
                core_runs))
            q = lambda x: per[min(int(x * len(per)), len(per) - 1)]  # noqa
            spread = [per[0], q(0.1), q(0.9), per[-1]]
            rows.append({"faces": len(fcs), "row": name, "ms": q(0.5),
                         "spread_ms": spread})
            log(f"{name:15s}: {q(0.5):10.4f} ms/launch, median of "
                f"{core_runs} (min {spread[0]:.4f}, p10 {spread[1]:.4f}, "
                f"p90 {spread[2]:.4f}, max {spread[3]:.4f})")
        ok = ok and torch.equal(izbs[0], izbs[1])
        agree = agree and ok
        log(f"outputs agree: {ok} (depth sums {sums}; max relative "
            f"difference {rel:.3e}, bar {AGREE_RTOL}; core 1/z buffers "
            f"equal: {torch.equal(izbs[0], izbs[1])})")
    return {"rows": rows, "agree": agree}


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--faces", type=int, nargs="+",
                    default=[2400, 40000, 99000])
    ap.add_argument("--windows", type=int, default=3,
                    help="timed windows; the median is reported")
    ap.add_argument("--k", type=int, default=2,
                    help="frames per timed window")
    ap.add_argument("--core-runs", type=int, default=200,
                    help="launches timed one by one for each core row")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.faces, args.windows, args.k, args.core_runs, args.device)
    return 0 if res["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
