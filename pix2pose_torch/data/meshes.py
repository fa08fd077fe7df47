"""Host-side mesh processing: vertex-clustering decimation (a copy of
:mod:`pix2pose_tpu.data.meshes`).

Dense BOP reconstruction meshes (T-Less reconst / YCB-V scans run to
100k+ faces) set the rasterizer's cost through their face count, so the
ICP refiner decimates once at load time. Clustering with a ~1 mm grid
perturbs the rendered depth by well under the RGB-D evaluator's 20 mm
scoring band (``tools/5_evaluation_bop_icp3d.py:314-315``).

Pure numpy; runs once per mesh at refiner/service construction.
"""

from __future__ import annotations

import numpy as np


def cluster_decimate(verts: np.ndarray, faces: np.ndarray,
                     cell: float) -> tuple[np.ndarray, np.ndarray]:
    """One vertex-clustering pass with the given grid cell size (same
    units as ``verts``). Vertices snapping to one cell merge to their
    mean; degenerate and duplicate faces are dropped."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    vmin = verts.min(0)
    q = np.floor((verts - vmin) / max(cell, 1e-12)).astype(np.int64)
    uniq, inv = np.unique(q, axis=0, return_inverse=True)
    n = len(uniq)
    sums = np.zeros((n, 3), np.float64)
    np.add.at(sums, inv, verts)
    counts = np.bincount(inv, minlength=n).astype(np.float64)
    new_verts = (sums / counts[:, None]).astype(np.float32)

    nf = inv[faces]
    keep = ((nf[:, 0] != nf[:, 1]) & (nf[:, 1] != nf[:, 2])
            & (nf[:, 0] != nf[:, 2]))
    nf = nf[keep]
    # drop duplicate triangles regardless of winding/rotation
    key = np.sort(nf, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    nf = nf[np.sort(first)]
    return new_verts, nf.astype(np.int32)


def decimate_mesh(verts: np.ndarray, faces: np.ndarray,
                  target_faces: int,
                  iters: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Decimate to at most ``target_faces`` faces (no-op when already
    under). Binary-searches the clustering cell size; returns the result
    with the most faces that still meets the target."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    if faces.shape[0] <= target_faces:
        return verts, faces
    diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    lo, hi = diag / 2048.0, diag / 2.0
    best = None
    for _ in range(iters):
        cell = float(np.sqrt(lo * hi))
        v2, f2 = cluster_decimate(verts, faces, cell)
        if f2.shape[0] > target_faces:
            lo = cell
        else:
            if best is None or f2.shape[0] > best[1].shape[0]:
                best = (v2, f2)
            hi = cell
    if best is None:  # even the coarsest probe overshot — take it anyway
        best = cluster_decimate(verts, faces, hi)
    return best
