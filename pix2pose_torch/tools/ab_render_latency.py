"""Per-call latency of one render: this tree's rasterizer against another
checkout's, interleaved in one process.

    python -m pix2pose_torch.tools.ab_render_latency OTHER_ROOT
        [--faces 24 40000] [--calls 500] [--device cuda]

Loads ``OTHER_ROOT/pix2pose_torch/ops/rasterizer_cuda.py`` beside this
tree's module. Its kernel is built from OTHER_ROOT's sources into
OTHER_ROOT's build directory; its imports of the rest of the package
resolve to this tree's. Both render the benchmark tool's UV sphere of
about each ``--faces`` count at P=1, 480x640, one pose per call, as
training-data synthesis does: projection, face set-up, z-buffer, epilogue,
and the depth copied to the host, timed on the host clock. The two
alternate call by call (which goes first alternates too), so a host that
slows down or speeds up during the run weighs on both alike. Prints, per
mesh, the median and the 10th and 90th percentiles of each and the median
of the paired differences (this tree minus the other). Exits 1 if the two
depth maps differ.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path
from typing import Sequence

import torch

from pix2pose_torch.tools.bench_rasterizer import CAM_K, H, W, uv_sphere


def load_other(root) -> object:
    """``rasterizer_cuda`` of the checkout at ``root``, as its own module."""
    path = Path(root).resolve() / "pix2pose_torch" / "ops" / \
        "rasterizer_cuda.py"
    spec = importlib.util.spec_from_file_location("other_rasterizer_cuda",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pct(xs: list[float], q: float) -> float:
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def run(other_root, faces: Sequence[int] = (24, 40000), calls: int = 500,
        device="cuda", log=print) -> dict:
    """Returns {"rows": [{faces, this_ms, other_ms, diff_ms}], "agree"}:
    each *_ms is (median, p10, p90); ``diff_ms`` the median paired
    difference."""
    from pix2pose_torch.ops import rasterizer_cuda as this
    from pix2pose_torch.ops.rasterizer import project_vertices

    other = load_other(other_root)
    dev = torch.device(device)
    K = torch.as_tensor(CAM_K, device=dev)
    R = torch.eye(3, device=dev)
    t = torch.tensor([0.02, -0.01, 0.5], device=dev)
    rows, agree = [], True
    for nf in faces:
        verts, fcs = uv_sphere(nf)
        v = torch.as_tensor(verts, device=dev)
        f = torch.as_tensor(fcs, device=dev)

        def render(mod):
            uv, z = project_vertices(v, R, t, K)
            return mod.rasterize_binned(uv[None], z[None], f[None], v[None],
                                        H, W).depth.cpu()

        same = torch.equal(render(this), render(other))  # builds, warms up
        agree = agree and same
        ms = {"this": [], "other": []}
        for i in range(calls):
            pair = [("this", this), ("other", other)]
            for name, mod in (pair if i % 2 == 0 else pair[::-1]):
                t0 = time.perf_counter()
                render(mod)
                ms[name].append((time.perf_counter() - t0) * 1e3)
        diff = [a - b for a, b in zip(ms["this"], ms["other"])]
        row = {"faces": len(fcs),
               **{f"{k}_ms": [_pct(x, 0.5), _pct(x, 0.1), _pct(x, 0.9)]
                  for k, x in ms.items()},
               "diff_ms": _pct(diff, 0.5)}
        rows.append(row)
        log(f"{len(fcs)} faces, P=1 {H}x{W}, {calls} calls each, "
            f"interleaved: this {row['this_ms'][0]:.3f} ms (p10 "
            f"{row['this_ms'][1]:.3f}, p90 {row['this_ms'][2]:.3f}), other "
            f"{row['other_ms'][0]:.3f} ms (p10 {row['other_ms'][1]:.3f}, p90 "
            f"{row['other_ms'][2]:.3f}); median paired difference "
            f"{row['diff_ms']:+.3f} ms; depth equal: {same}")
    return {"rows": rows, "agree": agree}


def main(argv: Sequence[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("other_root", help="root of the other checkout")
    ap.add_argument("--faces", type=int, nargs="+", default=[24, 40000])
    ap.add_argument("--calls", type=int, default=500,
                    help="timed calls of each tree per mesh")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.other_root, args.faces, args.calls, args.device)
    return 0 if res["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
