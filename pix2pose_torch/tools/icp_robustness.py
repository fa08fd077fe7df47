"""Analytic ICP robustness sweep (port of
:mod:`pix2pose_tpu.tools.icp_robustness`).

The reference refines with ``cv2.ppf_match_3d_ICP`` (``tools/
5_evaluation_bop_icp3d.py:88-89``: iterations=100, tol=0.005,
rejectionScale=2.5, numLevels=2); the port's refiner is held to ANALYTIC
ground truth instead: known rigid perturbations x depth noise x outlier
fraction x partial overlap, with convergence measured as ADD (mean vertex
distance) against the true pose. The sensor frame is rendered at the true
pose by :func:`pix2pose_torch.ops.rasterizer.render_depth` (the z-buffer
kernel on a CUDA device), perturbed, despeckled and lifted to a cloud as
the evaluators do, then refined by the evaluators' refiner
(:func:`pix2pose_torch.eval.icp_refine.make_icp_refiner`).

Every draw comes from ``numpy.random.RandomState(seed)`` in the JAX tool's
order, so both packages see the same poses, perturbations, noise and
outliers.

    python -m pix2pose_torch icp-robustness [--seeds 3] [--device cuda]

prints the convergence table of the fixed :data:`SWEEP` (markdown).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pix2pose_torch.eval.icp_refine import make_icp_refiner
from pix2pose_torch.ops import geometry, rasterizer

IM_H, IM_W = 240, 320
K = np.array([[286.2, 0.0, 162.65], [0.0, 286.8, 121.0], [0.0, 0.0, 1.0]],
             np.float32)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    th = np.radians(deg)
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(th) * kx
            + (1 - np.cos(th)) * kx @ kx).astype(np.float32)


def prism_mesh(hx=30.0, hy=40.0, hz=60.0):
    """Asymmetric rectangular prism: three distinct extents make every
    rotation observable from the surface."""
    v = np.array([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                  for z in (-hz, hz)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return v, f


def octa_mesh(half=38.0, subdiv=2):
    """Subdivided octahedron pushed towards a sphere of radius ``half``:
    a curved silhouette with well-conditioned normals."""
    v = np.array([[half, 0, 0], [-half, 0, 0], [0, half, 0],
                  [0, -half, 0], [0, 0, half], [0, 0, -half]], np.float32)
    f = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    for _ in range(subdiv):
        nv, nf, cache = list(v), [], {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (v[a] + v[b]) / 2.0
                cache[key] = len(nv)
                nv.append(m / np.linalg.norm(m) * half)
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(nv, np.float32)
        f = np.asarray(nf, np.int32)
    return v, f


def sensor_frame(verts_mm, faces, R_gt, t_gt, noise_mm, outlier_frac,
                 overlap, rng, device):
    """The true pose's depth (metres) with noise and outliers drawn from
    ``rng``, the union mask cut to ``overlap`` of the silhouette columns,
    and the despeckled depth, cloud and normals the evaluators use."""
    dev = torch.device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device=dev)
    d_gt, m_gt = rasterizer.render_depth(
        f32(verts_mm) / 1000.0, torch.as_tensor(faces, device=dev),
        f32(R_gt), f32(t_gt) / 1000.0, f32(K), IM_H, IM_W)
    depth = d_gt.cpu().numpy()
    mask = m_gt.cpu().numpy()
    if noise_mm > 0:
        depth = depth + rng.normal(0, noise_mm / 1000.0,
                                   depth.shape).astype(np.float32) * mask
    if outlier_frac > 0:
        out_px = mask & (rng.rand(*mask.shape) < outlier_frac)
        depth = np.where(out_px, rng.uniform(0.3, 1.2, depth.shape)
                         .astype(np.float32), depth)
    union = mask.copy()
    if overlap < 1.0:
        # occlude the left fraction of the silhouette columns
        cols = np.where(mask.any(0))[0]
        if cols.size:
            cut = cols[0] + int((1.0 - overlap) * (cols[-1] - cols[0]))
            union[:, :cut] = False
    dj = geometry.despeckle_depth(f32(depth * mask))
    return (torch.as_tensor(union, device=dev), dj,
            geometry.backproject(dj, f32(K)),
            geometry.normals_from_depth(dj, f32(K)))


def _case_frame(verts_mm, faces, case, seed: int, device):
    """A sweep point's draws, in the JAX tool's order: the true pose, its
    sensor frame (:func:`sensor_frame`) and the perturbed start pose."""
    rot_deg, trans_mm, noise_mm, outlier_frac, overlap = case
    rng = np.random.RandomState(seed)
    R_gt = _rot(rng.normal(size=3), rng.uniform(0, 180))
    t_gt = np.array([rng.uniform(-15, 15), rng.uniform(-10, 10),
                     rng.uniform(450, 600)], np.float32)
    frame = sensor_frame(verts_mm, faces, R_gt, t_gt, noise_mm,
                         outlier_frac, overlap, rng, device)
    R0 = _rot(rng.normal(size=3), rot_deg) @ R_gt
    dirn = rng.normal(size=3)
    t0 = t_gt + (dirn / np.linalg.norm(dirn) * trans_mm).astype(np.float32)
    return R_gt, t_gt, R0, t0, frame


def run_case(verts_mm, faces, rot_deg: float, trans_mm: float,
             noise_mm: float, outlier_frac: float, overlap: float,
             seed: int = 0, refiner=None, device="cuda"):
    """One sweep point; returns its initial and final ADD (mm)."""
    R_gt, t_gt, R0, t0, (union, dj, tgt_pts, tgt_normals) = _case_frame(
        verts_mm, faces, (rot_deg, trans_mm, noise_mm, outlier_frac,
                          overlap), seed, device)
    if refiner is None:
        refiner = make_icp_refiner(np.asarray(verts_mm) / 1000.0, faces,
                                   IM_H, IM_W, device=device)
    dev = union.device
    out = refiner(torch.as_tensor(R0, device=dev),
                  torch.as_tensor(t0, device=dev),
                  torch.as_tensor(K, device=dev), union, dj, tgt_pts,
                  tgt_normals)

    def add_err(R, t):
        a = verts_mm @ np.asarray(R).T + np.asarray(t)
        b = verts_mm @ R_gt.T + t_gt
        return float(np.mean(np.linalg.norm(a - b, axis=1)))

    return {"rot_deg": rot_deg, "trans_mm": trans_mm,
            "noise_mm": noise_mm, "outliers": outlier_frac,
            "overlap": overlap, "add_init": add_err(R0, t0),
            "add_final": add_err(out.R.cpu().numpy(),
                                 out.t_mm.cpu().numpy()),
            "ok": bool(out.ok)}


SWEEP = [
    # (rot_deg, trans_mm, noise_mm, outlier_frac, overlap)
    (5.0, 10.0, 0.0, 0.0, 1.0),
    (10.0, 20.0, 0.0, 0.0, 1.0),
    (15.0, 40.0, 0.0, 0.0, 1.0),
    (10.0, 20.0, 2.0, 0.0, 1.0),
    (10.0, 20.0, 5.0, 0.0, 1.0),
    (10.0, 20.0, 0.0, 0.1, 1.0),
    (10.0, 20.0, 0.0, 0.3, 1.0),
    (10.0, 20.0, 2.0, 0.1, 0.6),
    (25.0, 60.0, 0.0, 0.0, 1.0),
    (45.0, 80.0, 0.0, 0.0, 1.0),
]


def sweep_table(n_seeds: int = 3, device="cuda"):
    """Every :data:`SWEEP` case over ``n_seeds`` seeds on the prism: the
    initial and final ADD medians, the final maximum and each seed's
    (initial, final) pair."""
    verts, faces = prism_mesh()
    refiner = make_icp_refiner(verts / 1000.0, faces, IM_H, IM_W,
                               device=device)
    rows = []
    for case in SWEEP:
        runs = [run_case(verts, faces, *case, seed=s, refiner=refiner,
                         device=device) for s in range(n_seeds)]
        adds_f = [r["add_final"] for r in runs]
        rows.append({"case": case,
                     "add_init_med": float(np.median(
                         [r["add_init"] for r in runs])),
                     "add_final_med": float(np.median(adds_f)),
                     "add_final_max": float(np.max(adds_f)),
                     "seeds": [(r["add_init"], r["add_final"])
                               for r in runs]})
    return rows


def format_table(rows) -> str:
    lines = ["| rot(deg) | trans(mm) | noise(mm) | outliers | overlap |"
             " ADD init (mm) | ADD final med (mm) | ADD final max (mm) |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        c = r["case"]
        lines.append(f"| {c[0]:g} | {c[1]:g} | {c[2]:g} | {c[3]:g} | "
                     f"{c[4]:g} | {r['add_init_med']:.1f} | "
                     f"{r['add_final_med']:.2f} | {r['add_final_max']:.2f} |")
    return "\n".join(lines)


def main(argv=None):
    from pix2pose_torch.utils.cli import require_device

    ap = argparse.ArgumentParser(prog="python -m pix2pose_torch "
                                      "icp-robustness",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = sweep_table(args.seeds, require_device(args.device))
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
