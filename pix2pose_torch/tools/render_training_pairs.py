"""Training-pair renderer (port of
:mod:`pix2pose_tpu.tools.render_training_pairs`; reference
``tools/2_2_render_pix2pose_training.py``).

For every GT-annotated train view of each object: render the XYZ-colored
model at the (symmetry-canonicalized) GT pose, crop to the rendered bbox,
and store an (h, w, 6) uint8 npy [RGB crop with gray background | rendered
XYZ colors], longest side <= 128 (``2_2:147-188``). Views whose visible
fraction is under 0.5 are dropped unless too few remain (``2_2:189-264``).
As in the JAX package, only the canonical view is stored (in-plane
rotations are sampled by the trainer) and the ``rotation_lock`` decision
and the visual-symmetry pool go to ``meta.json``.

Each object's mesh and XYZ colors are uploaded to ``device`` once; every
view renders there through :func:`pix2pose_torch.ops.rasterizer.render_mesh`
(full frames: the binned CUDA kernel on a CUDA device).

CLI: python -m pix2pose_torch.tools.render_training_pairs <cfg.json>
         <dataset> [--obj N] [--max-views N] [--device cuda]
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.data.ply import load_ply
from pix2pose_torch.ops import color as color_ops
from pix2pose_torch.ops import rasterizer
from pix2pose_torch.utils.symmetry import (canonicalize_discrete,
                                           canonicalize_sym_pose)


def _resize_to_128(data: np.ndarray) -> np.ndarray:
    """Downscale so the longest side is <= 128 (``2_2:85-95``)."""
    h, w = data.shape[:2]
    m = max(h, w)
    if m <= 128:
        return data
    scale = 128.0 / m
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    from PIL import Image

    out = np.zeros((nh, nw, data.shape[2]), data.dtype)
    for c0 in range(0, data.shape[2], 3):
        c1 = min(c0 + 3, data.shape[2])
        chunk = data[..., c0:c1]
        if chunk.shape[2] == 1:
            img = Image.fromarray(chunk[..., 0]).resize((nw, nh),
                                                        Image.BILINEAR)
            out[..., c0] = (np.asarray(img) > 127).astype(data.dtype) * (
                1 if data[..., c0].max() <= 1 else 255)
        else:
            img = Image.fromarray(chunk).resize((nw, nh), Image.BILINEAR)
            out[..., c0:c1] = np.asarray(img)
    return out


def _probe_visual_sym(ds: BopDataset, obj_id: int, mesh, sym_pool, render,
                      n_views: int = 6, n_verts: int = 1024,
                      seed: int = 0) -> list[int]:
    """Indices of ``sym_pool`` members that are VISUAL symmetries of the
    object as it appears in the training images.

    Back-projects the scene RGB of a few GT views onto sampled surface
    points (visibility-checked against the depth that ``render(R, t, K)``
    gives), then tests whether ``color(v) ~ color(T @ v)``. A member
    passes when its color mismatch is within noise of the observation
    scatter (or tiny in absolute terms). Identity (index 0) always passes.
    """
    rng = np.random.RandomState(seed)
    # sample SURFACE points (area-weighted barycentric): analytic meshes
    # can have single-digit vertex counts
    pts = np.asarray(mesh["pts"], np.float64)
    fcs = np.asarray(mesh["faces"])
    tri = pts[fcs]  # (F, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    fi = rng.choice(len(fcs), n_verts, p=area / area.sum())
    r1, r2 = rng.rand(n_verts, 1), rng.rand(n_verts, 1)
    s1 = np.sqrt(r1)
    verts = (tri[fi, 0] * (1 - s1) + tri[fi, 1] * (s1 * (1 - r2))
             + tri[fi, 2] * (s1 * r2))

    col_sum = np.zeros((verts.shape[0], 3))
    col_cnt = np.zeros(verts.shape[0])
    col_sq = np.zeros((verts.shape[0], 3))
    im_w, im_h = ds.im_size
    used = 0
    from PIL import Image

    for scene_id in ds.scene_ids():
        cams = ds.scene_camera(scene_id)
        for im_id, gt_list in sorted(ds.scene_gt(scene_id).items()):
            for gt_id, gt in enumerate(gt_list):
                if gt["obj_id"] != obj_id or used >= n_views:
                    continue
                R0 = np.asarray(gt["R"], np.float64)
                t0 = np.asarray(gt["t"], np.float64)
                K0 = np.asarray(cams[im_id]["cam_K"], np.float64)
                out = render(R0.astype(np.float32), t0.astype(np.float32),
                             K0.astype(np.float32))
                depth = torch.where(out.mask, out.depth, torch.inf) \
                    .cpu().numpy()
                rgb = ds.load_rgb(scene_id, im_id).astype(np.float64)
                cam = verts @ R0.T + t0
                uvz = cam @ K0.T
                z = uvz[:, 2]
                u = np.round(uvz[:, 0] / z).astype(int)
                v = np.round(uvz[:, 1] / z).astype(int)
                ok = ((z > 1e-6) & (u >= 0) & (u < im_w) & (v >= 0)
                      & (v < im_h))
                uu, vv = np.clip(u, 0, im_w - 1), np.clip(v, 0, im_h - 1)
                vis = ok & (np.abs(depth[vv, uu] - z) < 0.02 * z + 2.0)
                # scene-level occlusion: only pixels where THIS instance
                # is the visible one
                mv_p = ds.mask_path(scene_id, im_id, gt_id, visib=True)
                if os.path.exists(mv_p):
                    mv = np.asarray(Image.open(mv_p)) > 127
                    vis = vis & mv[vv, uu]
                c = rgb[vv, uu] / 255.0
                col_sum[vis] += c[vis]
                col_sq[vis] += c[vis] ** 2
                col_cnt[vis] += 1.0
                used += 1
        if used >= n_views:
            break
    seen = col_cnt > 0
    if seen.sum() < 32:
        # not enough observations to judge: keep the full pool
        # (reference behavior)
        return list(range(sym_pool.shape[0]))
    color = np.zeros_like(col_sum)
    color[seen] = col_sum[seen] / col_cnt[seen][:, None]
    spread = float(np.mean(np.abs(color[seen]
                                  - color[seen].mean(0))))
    out_idx = [0]
    for ti in range(1, sym_pool.shape[0]):
        T = np.asarray(sym_pool[ti], np.float64)
        tv = verts @ T.T
        # nearest observed vertex to each transformed observed vertex
        d2 = ((tv[seen][:, None, :] - verts[seen][None, :, :]) ** 2
              ).sum(-1)
        nn = np.argmin(d2, axis=1)
        close = np.sqrt(d2[np.arange(len(nn)), nn]) < 0.08 * np.ptp(
            verts, axis=0).max()
        if close.sum() < 16:
            continue
        err = float(np.mean(np.abs(color[seen][close]
                                   - color[seen][nn[close]])))
        if err <= max(0.05, 0.35 * spread):
            out_idx.append(ti)
    return out_idx


def render_object_pairs(ds: BopDataset, obj_id: int,
                        out_root: str | None = None,
                        max_views: int | None = None,
                        device="cuda") -> int:
    """Generate training pairs for one object, rendering on ``device``.
    Returns #views written."""
    out_root = out_root or os.path.join(ds.dir, "train_xyz")
    out_dir = os.path.join(out_root, f"{obj_id:02d}")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device(device)

    mesh = load_ply(ds.model_ply_path(obj_id))
    pts = torch.as_tensor(mesh["pts"], dtype=torch.float32, device=dev)
    faces = torch.as_tensor(mesh["faces"], device=dev)
    scale, ct = color_ops.norm_factor_from_vertices(pts)
    colors = color_ops.xyz_to_color01(pts, scale, ct) * 255.0

    info = ds.model_info(obj_id)
    sym_axis = None
    if "symmetries_continuous" in info:
        sym_axis = info["symmetries_continuous"][0].get("axis", [0, 0, 1])
    sym_pool = ds.symmetry_pool(obj_id)  # identity-first, (S, 3, 3)

    im_w, im_h = ds.im_size

    def render(R, t, K):
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=dev)
        return rasterizer.render_mesh(pts, faces, colors, as_t(R), as_t(t),
                                      as_t(K), im_h, im_w)

    # visual-symmetry probe: only pool members whose appearance matches
    # (visual symmetries) go into the training pool written to meta.json;
    # see the JAX package's render_object_pairs for the measurements
    # behind it. The full geometric pool still drives evaluation.
    visual_sym_idx = [0]
    if sym_pool.shape[0] > 1:
        visual_sym_idx = _probe_visual_sym(ds, obj_id, mesh, sym_pool,
                                           render)
    # canonicalize over VISUAL symmetries only
    canon_pool = sym_pool[visual_sym_idx]

    # pass 1: candidate views with visibility fractions; the reference
    # trains only on views with visib_fract >= 0.5 (``2_2:189-264``).
    # When fewer than ``min_kept`` views pass, the most-visible views fill
    # in.
    from PIL import Image as _Image

    min_visib, min_kept = 0.5, 8
    cands = []
    for scene_id in ds.scene_ids():
        gts = ds.scene_gt(scene_id)
        for im_id, gt_list in sorted(gts.items()):
            for gt_id, gt in enumerate(gt_list):
                if gt["obj_id"] != obj_id:
                    continue
                vfrac = 1.0
                mp = ds.mask_path(scene_id, im_id, gt_id, visib=True)
                fp = ds.mask_path(scene_id, im_id, gt_id, visib=False)
                if os.path.exists(mp):
                    mv = float((np.asarray(_Image.open(mp)) > 127).sum())
                    if os.path.exists(fp):
                        mf = float((np.asarray(_Image.open(fp))
                                    > 127).sum())
                    else:
                        # full-silhouette file absent (synthetic sets
                        # write only mask_visib): render it
                        cam_k = ds.scene_camera(scene_id)[im_id]["cam_K"]
                        mf = float(render(gt["R"], gt["t"], cam_k)
                                   .mask.sum())
                    vfrac = mv / mf if mf > 0 else -1.0
                cands.append((scene_id, im_id, gt_id, vfrac))
    passing = [c for c in cands if c[3] < 0 or c[3] >= min_visib]
    if len(passing) < min_kept:
        ranked = sorted(cands, key=lambda c: -c[3])
        passing = ranked[:min_kept]
    if len(passing) < len(cands):
        print(f"[pairs] obj {obj_id}: visib_fract>={min_visib} keeps "
              f"{len(passing)}/{len(cands)} views", flush=True)
    keep = {(c[0], c[1], c[2]) for c in passing}

    count = 0
    any_lock = False
    for scene_id in ds.scene_ids():
        cams = ds.scene_camera(scene_id)
        gts = ds.scene_gt(scene_id)
        for im_id, gt_list in sorted(gts.items()):
            for gt_id, gt in enumerate(gt_list):
                if gt["obj_id"] != obj_id:
                    continue
                if (scene_id, im_id, gt_id) not in keep:
                    continue
                R, lock = canonicalize_sym_pose(gt["R"], sym_axis)
                # discrete symmetry: deterministic pool representative so
                # every view supervises ONE frame
                R = canonicalize_discrete(R, canon_pool)
                any_lock = any_lock or lock
                out = render(R, gt["t"], cams[im_id]["cam_K"])
                mask = out.mask.cpu().numpy()
                if mask.sum() < 16:
                    continue
                vu = np.where(mask)
                v0, v1 = int(vu[0].min()), int(vu[0].max()) + 1
                u0, u1 = int(vu[1].min()), int(vu[1].max()) + 1
                rgb = ds.load_rgb(scene_id, im_id).copy()
                rgb[~mask] = 128  # gray background (``2_2:167``)
                data = np.zeros((v1 - v0, u1 - u0, 6), np.uint8)
                data[..., :3] = rgb[v0:v1, u0:u1]
                data[..., 3:6] = np.clip(
                    out.attr[v0:v1, u0:u1].cpu().numpy(), 0, 255)
                np.save(os.path.join(out_dir, f"{count:06d}.npy"),
                        _resize_to_128(data))
                count += 1
                if max_views is not None and count >= max_views:
                    break
            if max_views is not None and count >= max_views:
                break
        if max_views is not None and count >= max_views:
            break
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"rotation_lock": any_lock,
                   "continuous_sym": sym_axis is not None,
                   # pool indices (into BopDataset.symmetry_pool) that are
                   # VISUAL symmetries: the pool the trainer should use
                   "visual_sym_idx": visual_sym_idx}, f)
    if len(visual_sym_idx) < sym_pool.shape[0]:
        print(f"[pairs] obj {obj_id}: geometric sym pool "
              f"{sym_pool.shape[0]} -> training pool "
              f"{len(visual_sym_idx)} (appearance disambiguates; "
              f"see _probe_visual_sym)", flush=True)
    return count


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config

    p = argparse.ArgumentParser()
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("--obj", type=int, default=None)
    p.add_argument("--max-views", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset, train=True)
    objs = [args.obj] if args.obj else ds.model_ids
    for obj_id in objs:
        n = render_object_pairs(ds, obj_id, max_views=args.max_views,
                                device=args.device)
        print(f"obj {obj_id}: {n} pairs")


if __name__ == "__main__":
    main()
