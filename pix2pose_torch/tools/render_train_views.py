"""Render synthetic BOP-format train views for datasets without training
images (port of :mod:`pix2pose_tpu.tools.render_train_views`; reference
``tools/render_training_img.py``): render each model at poses copied from
a reference dataset's ``scene_gt.json`` and write a BOP-layout ``train/``
split (rgb + mask + scene_camera + scene_gt).

Shaded vertex-color images (Lambertian headlight, the reference's
diffuse+ambient look, ``rendering/renderer.py:13-81``), or, when the model
ships a sibling texture image + UVs (YCB-V style), UV-textured renders via
:func:`pix2pose_torch.ops.rasterizer.render_textured` (reference
``renderer.py:50-79``). Each model is uploaded to ``device`` once and every
view renders there.

CLI: python -m pix2pose_torch.tools.render_train_views <cfg.json> <dataset>
         <pose_source_dir> [--per-obj N] [--device cuda]
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.data.ply import find_texture, load_ply, load_texture
from pix2pose_torch.ops import rasterizer


def _shaded_colors(mesh):
    """Per-vertex base colors and unit normals for the headlight shading
    (numpy; area-weighted vertex normals from the faces when the mesh has
    none)."""
    pts = mesh["pts"]
    if "colors" in mesh:
        base = mesh["colors"].astype(np.float32)
    else:
        base = np.full((pts.shape[0], 3), 180.0, np.float32)
    if "normals" in mesh:
        n = mesh["normals"]
    else:
        f = mesh["faces"]
        fn = np.cross(pts[f[:, 1]] - pts[f[:, 0]],
                      pts[f[:, 2]] - pts[f[:, 0]])
        n = np.zeros_like(pts)
        for k in range(3):
            np.add.at(n, f[:, k], fn)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-9)
    return base, n


def render_train_split(ds: BopDataset, pose_source_dir: str,
                       per_obj: int | None = None, shade: bool = True,
                       device="cuda"):
    """Write ``train/{obj_id:06d}/`` scenes with poses from the source
    ``scene_gt.json`` files (reference ``render_training_img.py:32-89``),
    rendering on ``device``. Returns the number of views written."""
    from PIL import Image

    # gather poses from the source dataset
    poses = []
    for d in sorted(os.listdir(pose_source_dir)):
        gt_fn = os.path.join(pose_source_dir, d, "scene_gt.json")
        if not os.path.exists(gt_fn):
            continue
        with open(gt_fn) as f:
            for v in json.load(f).values():
                g = v[0]
                poses.append((np.asarray(g["cam_R_m2c"],
                                         np.float32).reshape(3, 3),
                              np.asarray(g["cam_t_m2c"], np.float32)))
    if per_obj:
        poses = poses[:per_obj]
    im_w, im_h = ds.im_size
    dev = torch.device(device)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    K = as_t(ds.cam_k)
    n_written = 0
    for obj_id in ds.model_ids:
        ply_path = ds.model_ply_path(obj_id)
        mesh = load_ply(ply_path)
        base, normals = _shaded_colors(mesh)
        # UV-textured models (YCB-V style) render through the textured
        # path, the reference's textured GL program
        # (``rendering/renderer.py:50-79``); vertex colors otherwise
        tex_path = find_texture(ply_path)
        textured = tex_path is not None and "texture_uv" in mesh
        pts, faces = as_t(mesh["pts"]), as_t(mesh["faces"])
        normals = as_t(normals.astype(np.float32))
        if textured:
            texture = as_t(load_texture(tex_path))
            uvs = as_t(mesh["texture_uv"].astype(np.float32))
        else:
            base = as_t(base)
        sdir = os.path.join(ds.dir, "train", f"{obj_id:06d}")
        os.makedirs(os.path.join(sdir, "rgb"), exist_ok=True)
        os.makedirs(os.path.join(sdir, "mask"), exist_ok=True)
        cam_json, gt_json = {}, {}
        for i, (R, t) in enumerate(poses):
            Rt, tt = as_t(R), as_t(t)
            if textured:
                out = rasterizer.render_textured(
                    pts, faces, uvs, texture, normals, Rt, tt, K, im_h, im_w,
                    diffuse=0.5 if shade else 0.0,
                    ambient=0.5 if shade else 1.0)
            else:
                if shade:
                    lam = torch.clamp(-(normals @ Rt.T)[:, 2], 0.0, 1.0)
                    cols = torch.clamp(base * (0.5 + 0.5 * lam[:, None]),
                                       0, 255)
                else:
                    cols = base
                out = rasterizer.render_mesh(pts, faces, cols, Rt, tt, K,
                                             im_h, im_w)
            rgb = torch.where(out.mask[..., None],
                              torch.clamp(out.attr, 0, 255).to(torch.uint8),
                              0)
            Image.fromarray(rgb.cpu().numpy()).save(
                os.path.join(sdir, "rgb", f"{i:06d}.png"))
            Image.fromarray(out.mask.to(torch.uint8).mul(255).cpu()
                            .numpy()).save(
                os.path.join(sdir, "mask", f"{i:06d}.png"))
            cam_json[str(i)] = {
                "cam_K": np.asarray(ds.cam_k).reshape(-1).tolist(),
                "depth_scale": 1.0}
            gt_json[str(i)] = [{
                "obj_id": int(obj_id),
                "cam_R_m2c": np.asarray(R).reshape(-1).tolist(),
                "cam_t_m2c": np.asarray(t).reshape(-1).tolist()}]
            n_written += 1
        with open(os.path.join(sdir, "scene_camera.json"), "w") as f:
            json.dump(cam_json, f)
        with open(os.path.join(sdir, "scene_gt.json"), "w") as f:
            json.dump(gt_json, f)
    return n_written


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config

    p = argparse.ArgumentParser()
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("pose_source_dir")
    p.add_argument("--per-obj", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset, train=True)
    n = render_train_split(ds, args.pose_source_dir, per_obj=args.per_obj,
                           device=args.device)
    print(f"rendered {n} train views")


if __name__ == "__main__":
    main()
