"""Batched per-hypothesis depth refinement + depth-consistency scoring
(port of :mod:`pix2pose_tpu.eval.icp_refine`).

Reference ``tools/5_evaluation_bop_icp3d.py:41-94,471-491``: render the
mesh at the hypothesis pose, lift rendered and sensor depth to clouds,
centroid pre-alignment, point-to-plane ICP, re-render, and score by
per-pixel depth agreement ``sum(max(0, 0.02 - |dz|)) / 0.02`` over the
detection mask. Every hypothesis of a batch is refined together: the
renders go through :func:`pix2pose_torch.ops.rasterizer.render_mesh` with
a leading hypothesis axis (one kernel launch per render round on a CUDA
device). Clouds are fixed-size, deterministic, evenly strided samples, so
the JAX version's per-hypothesis PRNG keys are gone.

Three entry points, all over :func:`_refine_body`:

- :func:`make_icp_refiner`: one object mesh, one hypothesis per call
  (the reference's serial loop; the RGB-D evaluator's serial path);
- :func:`make_batch_icp_refiner`: meshes stacked on an object axis
  (:func:`stack_meshes`), a batch of hypotheses of one sensor frame, each
  with its object index (the evaluator's batched path);
- :func:`make_multiframe_icp_refiner`: the same over several sensor
  frames, each hypothesis with a frame index (the serving path).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from pix2pose_torch.ops import geometry, icp, rasterizer


class RefineOut(NamedTuple):
    R: torch.Tensor            # (P, 3, 3) refined rotation
    t_mm: torch.Tensor         # (P, 3) refined translation, mm
    score: torch.Tensor        # (P,) depth-consistency score
    ratio: torch.Tensor        # (P,) inlier-pixel fraction of the union
    inlier_mask: torch.Tensor  # (P, H, W) bool, |dz| < 0.02 in the union
    ok: torch.Tensor           # (P,) bool
    # (P,) dropped rasterizer work pairs over the hypothesis' renders
    # (see RenderOut.overflow): 0 means the renders were exact
    overflow: torch.Tensor | int = 0


def _sample_masked(mask_flat, n_sample: int):
    """Indices (B, n_sample) of up to n_sample true entries of each row of
    mask_flat (B, N), evenly strided through the mask (cumsum + left-sided
    searchsorted), and their validity (duplicates, when a row has fewer
    than n_sample entries, keep the first occurrence only)."""
    cnt = torch.cumsum(mask_flat.to(torch.int64), dim=-1)
    total = cnt[:, -1:]
    ranks = (torch.arange(n_sample, device=mask_flat.device) * total) \
        // max(n_sample, 1) + 1
    idx = torch.searchsorted(cnt, ranks, right=False)
    idx = torch.clamp(idx, 0, mask_flat.shape[-1] - 1)
    valid = torch.gather(mask_flat, 1, idx)
    first = torch.cat([torch.ones_like(idx[:, :1], dtype=torch.bool),
                       idx[:, 1:] != idx[:, :-1]], dim=1)
    return idx, valid & first


def _masked_median3(pts, valid):
    """Per-axis median (B, 3) of (B, N, 3) points over (B, N) masks."""
    return icp._masked_quantile(pts.transpose(-1, -2), valid[:, None, :],
                                0.5)


def _gather_rows(x, idx):
    """x (B, N, C) gathered along N by idx (B, M) -> (B, M, C)."""
    return torch.take_along_dim(x, idx[..., None], dim=1)


def _refine_body(verts_m, faces, im_h: int, im_w: int, n_src: int,
                 n_tgt: int, icp_iters: int, icp_rounds: int, R, t_mm,
                 cam_k, union_mask, depth_m, tgt_pts, tgt_normals
                 ) -> RefineOut:
    """Refine+score P hypotheses. verts_m (P, V, 3) metres, faces
    (P, F, 3) (-1 = padding), R (P, 3, 3), t_mm (P, 3), cam_k (3, 3),
    union_mask (P, H, W) bool (detection mask and valid depth,
    ``icp3d:455-456``), depth_m (P, H, W) metres, tgt_pts/tgt_normals
    (P, H, W, 3) precomputed sensor cloud and normals (``icp3d:372-374``).
    """
    p_n = R.shape[0]
    dev = R.device
    tgt_flat = tgt_pts.reshape(p_n, -1, 3)
    um_flat = union_mask.reshape(p_n, -1)
    attrs = torch.zeros(verts_m.shape[:-1] + (1,), device=dev)

    # target sample first: the robust centroid below sorts n_tgt points
    tidx, tvalid = _sample_masked(um_flat & (depth_m.reshape(p_n, -1) > 0),
                                  n_tgt)
    tgt = _gather_rows(tgt_flat, tidx)
    tgt_n = _gather_rows(tgt_normals.reshape(p_n, -1, 3), tidx)

    # per-axis MEDIAN target centroid: mask pixels on background depth
    # would drag a mean by tens of mm
    centroid_tgt = _masked_median3(tgt, tvalid)
    bad_t = (t_mm[:, 2] < 300.0) | (t_mm[:, 2] > 5000.0)
    t_mm = torch.where(bad_t[:, None], centroid_tgt * 1000.0, t_mm)

    # rounds: render at the current pose -> sample source -> ICP ->
    # compose. Re-rendering shrinks the visibility mismatch of a source
    # cloud rendered at a wrong pose; centroid pre-alignment in round 0
    enough = torch.ones(p_n, dtype=torch.bool, device=dev)
    use = enough
    overflow = torch.zeros(p_n, dtype=torch.int32, device=dev)
    R_in, t_in_mm = R, t_mm
    depth_at_input = None
    for rnd in range(icp_rounds):
        rout = rasterizer.render_mesh(verts_m, faces, attrs, R,
                                      t_mm / 1000.0, cam_k, im_h, im_w)
        overflow = overflow + rout.overflow
        rmask = rout.mask & union_mask
        if rnd == 0:
            enough = rmask.reshape(p_n, -1).sum(-1) >= 10  # icp3d:73-76
            depth_at_input = rout.depth

        src_flat = geometry.backproject(rout.depth, cam_k).reshape(p_n, -1,
                                                                   3)
        sidx, svalid = _sample_masked(rmask.reshape(p_n, -1), n_src)
        src = _gather_rows(src_flat, sidx)
        if rnd == 0:
            shift = centroid_tgt - _masked_median3(src, svalid)
            src = src + shift[:, None, :]
            t_mm = t_mm + shift * 1000.0

        res = icp.icp_point_to_plane(src, tgt, tgt_n, src_valid=svalid,
                                     tgt_valid=tvalid, iters=icp_iters)
        # compose: x_tgt = dR (R x + t) + dt (icp3d:91-93)
        use = res.ok & enough
        R = torch.where(use[:, None, None], res.R @ R, R)
        t_new = ((res.R @ (t_mm / 1000.0)[..., None])[..., 0]
                 + res.t) * 1000.0
        t_mm = torch.where(use[:, None], t_new, t_mm)

    # re-render + depth-consistency score (icp3d:471-491)
    rout_ref = rasterizer.render_mesh(verts_m, faces, attrs, R,
                                      t_mm / 1000.0, cam_k, im_h, im_w)
    in_union = union_mask & (depth_m > 0)

    def score_depth(depth_ref):
        dz = torch.abs(depth_ref - depth_m)
        inlier = in_union & (dz < 0.02) & (depth_ref > 0)
        fcn = torch.where(in_union, torch.clamp(0.02 - dz, min=0.0),
                          0.0).sum((-2, -1)) / 0.02
        ratio = inlier.sum((-2, -1)) / torch.clamp(
            in_union.sum((-2, -1)), min=1)
        return fcn, ratio, inlier

    fcn, ratio, inlier = score_depth(rout_ref.depth)
    # score guard: never return a pose scoring worse than the input
    # pose's (round-0) render
    fcn0, ratio0, inlier0 = score_depth(depth_at_input)
    revert = fcn0 > fcn
    return RefineOut(
        R=torch.where(revert[:, None, None], R_in, R),
        t_mm=torch.where(revert[:, None], t_in_mm, t_mm),
        score=torch.where(revert, fcn0, fcn),
        ratio=torch.where(revert, ratio0, ratio),
        inlier_mask=torch.where(revert[:, None, None], inlier0, inlier),
        ok=use & enough,
        overflow=overflow + rout_ref.overflow)


def make_icp_refiner(verts_m, faces, im_h: int, im_w: int,
                     n_src: int = 1024, n_tgt: int = 4096,
                     icp_iters: int = 30, icp_rounds: int = 2,
                     device="cuda"):
    """Refine+score for one object mesh (vertices in metres), one
    hypothesis per call.

    Returns ``refine(R (3,3), t_mm (3,), cam_k, union_mask (H,W),
    depth_m (H,W), tgt_pts (H,W,3), tgt_normals (H,W,3)) -> RefineOut``
    with unbatched fields. The mesh lives on ``device``."""
    batch = make_batch_icp_refiner(
        np.asarray(verts_m, np.float32)[None], np.asarray(faces)[None],
        im_h, im_w, n_src, n_tgt, icp_iters, icp_rounds, device)

    def refine(R, t_mm, cam_k, union_mask, depth_m, tgt_pts,
               tgt_normals) -> RefineOut:
        out = batch([0], R[None], t_mm[None], cam_k, union_mask[None],
                    depth_m, tgt_pts, tgt_normals)
        return RefineOut(*(x[0] for x in out))

    return refine


def make_batch_icp_refiner(stacked_verts_m, stacked_faces, im_h: int,
                           im_w: int, n_src: int = 1024, n_tgt: int = 4096,
                           icp_iters: int = 30, icp_rounds: int = 2,
                           device="cuda"):
    """Refine+score a batch of hypotheses of ONE sensor frame, each with
    its object index into the stacked mesh bank (:func:`stack_meshes`).

    Returns ``refine_batch(obj_idx (P,), R (P,3,3), t_mm (P,3), cam_k,
    union_masks (P,H,W), depth_m (H,W), tgt_pts (H,W,3), tgt_normals
    (H,W,3)) -> RefineOut`` with a leading P axis: the multi-frame
    refiner with every hypothesis on frame 0."""
    multi = make_multiframe_icp_refiner(
        stacked_verts_m, stacked_faces, im_h, im_w, n_src, n_tgt,
        icp_iters, icp_rounds, device)

    def refine_batch(obj_idx, R, t_mm, cam_k, union_masks, depth_m,
                     tgt_pts, tgt_normals) -> RefineOut:
        frame_idx = torch.zeros(len(obj_idx), dtype=torch.int64)
        return multi(obj_idx, frame_idx, R, t_mm, cam_k, union_masks,
                     depth_m[None], tgt_pts[None], tgt_normals[None])

    return refine_batch


def stack_meshes(meshes_m: Sequence[tuple], max_faces: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pad and stack [(verts_m (V,3), faces (F,3)), ...] to
    ((O, Vmax, 3), (O, Fmax, 3)); face padding -1, vertex padding zeros.
    ``max_faces`` cluster-decimates dense meshes first (every hypothesis
    pays for the largest mesh in the bank)."""
    if max_faces is not None:
        from pix2pose_torch.data.meshes import decimate_mesh
        meshes_m = [decimate_mesh(v, f, max_faces) for v, f in meshes_m]
    v_max = max(np.asarray(v).shape[0] for v, _ in meshes_m)
    f_max = max(np.asarray(f).shape[0] for _, f in meshes_m)
    verts = np.zeros((len(meshes_m), v_max, 3), np.float32)
    faces = np.full((len(meshes_m), f_max, 3), -1, np.int32)
    for o, (v, f) in enumerate(meshes_m):
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int32)
        verts[o, :v.shape[0]] = v
        faces[o, :f.shape[0]] = f
    return verts, faces


def make_multiframe_icp_refiner(stacked_verts_m, stacked_faces, im_h: int,
                                im_w: int, n_src: int = 1024,
                                n_tgt: int = 4096, icp_iters: int = 30,
                                icp_rounds: int = 2, device="cuda"):
    """Refiner over hypotheses spanning several sensor frames: each has an
    object index into the stacked mesh bank and a frame index into the
    sensor stacks; one camera is shared.

    Returns ``refine(obj_idx (P,), frame_idx (P,), R (P,3,3), t_mm (P,3),
    cam_k (3,3), union_masks (P,H,W), depths_m (B,H,W), tgt_pts (B,H,W,3),
    tgt_normals (B,H,W,3)) -> RefineOut`` with a leading P axis. The mesh
    bank lives on ``device``."""
    sv = torch.as_tensor(np.asarray(stacked_verts_m, np.float32),
                         device=device)
    sf = torch.as_tensor(np.asarray(stacked_faces, np.int64), device=device)

    @torch.no_grad()
    def refine(obj_idx, frame_idx, R, t_mm, cam_k, union_masks, depths_m,
               tgt_pts, tgt_normals) -> RefineOut:
        obj_idx = torch.as_tensor(obj_idx, device=sv.device).long()
        frame_idx = torch.as_tensor(frame_idx, device=sv.device).long()
        cam_k = torch.as_tensor(cam_k, dtype=torch.float32,
                                device=sv.device)
        return _refine_body(sv[obj_idx], sf[obj_idx], im_h, im_w, n_src,
                            n_tgt, icp_iters, icp_rounds, R, t_mm, cam_k,
                            union_masks, depths_m[frame_idx],
                            tgt_pts[frame_idx], tgt_normals[frame_idx])

    return refine
