"""Synthetic closed-loop scenes for checking the port end to end without a
dataset: analytic ray-cast cube renders whose colours ARE the normalized
model coordinates (the ``models_xyz`` contract), an identity "generator"
that decodes those colours, and meshes made in code. The same scenes as
the JAX package's test fixtures (``tests/synthetic.py``), without flax.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

CAM_K = np.array([[572.4, 0.0, 325.3],
                  [0.0, 573.6, 242.0],
                  [0.0, 0.0, 1.0]], np.float32)


def pose_with_euler(yaw=0.4, pitch=-0.3, roll=0.2, tx=10.0, ty=-20.0,
                    tz=600.0):
    """(R (3, 3), t (3,) mm) from Z-Y-X Euler angles."""
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    R = (Rz @ Ry @ Rx).astype(np.float32)
    return R, np.array([tx, ty, tz], np.float32)


def raycast_cube(R, t, K, im_h=480, im_w=640, half=40.0):
    """Ray-cast the cube [-half, half]^3 under pose (R, t mm). Returns
    (hit (H, W) bool, pts (H, W, 3) model-frame intersection points)."""
    v, u = np.mgrid[0:im_h, 0:im_w].astype(np.float64)
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                  np.ones_like(u)], axis=-1)
    d_o = d @ R
    o_o = -t @ R
    inv = 1.0 / np.where(np.abs(d_o) < 1e-12, 1e-12, d_o)
    t1 = (-half - o_o) * inv
    t2 = (half - o_o) * inv
    tmin = np.minimum(t1, t2).max(axis=-1)
    tmax = np.maximum(t1, t2).min(axis=-1)
    hit = (tmax > tmin) & (tmax > 0)
    tcl = np.where(tmin > 0, tmin, tmax)
    pts = np.clip(o_o[None, None] + tcl[..., None] * d_o, -half, half)
    return hit, pts.astype(np.float32)


def xyz_scene(R, t, K=CAM_K, im_h=480, im_w=640, half=40.0):
    """RGB uint8 image whose colours are the normalized cube coordinates
    on a gray background. Returns (rgb, obj_param (6,), hit mask)."""
    hit, pts = raycast_cube(R, t, K, im_h, im_w, half)
    scale = np.array([half, half, half], np.float32)
    col = ((pts / scale) + 1.0) / 2.0
    rgb = np.full((im_h, im_w, 3), 128, np.uint8)
    rgb[hit] = np.clip(col[hit] * 255.0, 0, 255).astype(np.uint8)
    obj_param = np.concatenate([scale, np.zeros(3, np.float32)])
    return rgb, obj_param.astype(np.float32), hit


def cube_mesh(half=40.0):
    """12-face cube (V (8, 3), F (12, 3))."""
    v = np.array([[x, y, z] for x in (-half, half) for y in (-half, half)
                  for z in (-half, half)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def uv_sphere(n_lat=24, n_lon=30, r=40.0):
    """Latitude-longitude sphere without pole caps:
    2 * (n_lat - 1) * n_lon faces."""
    lat = np.linspace(0.12, np.pi - 0.12, n_lat)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    verts = np.stack([r * np.sin(la) * np.cos(lo),
                      r * np.sin(la) * np.sin(lo),
                      r * np.cos(la)], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n_lat * n_lon).reshape(n_lat, n_lon)
    i = np.repeat(np.arange(n_lat - 1), n_lon)
    j = np.tile(np.arange(n_lon), n_lat - 1)
    j2 = (j + 1) % n_lon
    f1 = np.stack([idx[i, j], idx[i + 1, j], idx[i, j2]], -1)
    f2 = np.stack([idx[i, j2], idx[i + 1, j], idx[i + 1, j2]], -1)
    return verts, np.concatenate([f1, f2]).astype(np.int32)


class OracleGenerator(nn.Module):
    """Identity "network": decodes input colours as coordinates with
    uniform high confidence (error 0.01). On an XYZ-coloured scene this
    closes the inference loop with analytic ground truth. NHWC in/out."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return (torch.clamp(x, -1.0, 1.0),
                torch.full(x.shape[:-1] + (1,), 0.01, dtype=x.dtype,
                           device=x.device))


class PerFrameDetector:
    """GT box from the frame itself: xyz scenes have a gray background,
    so foreground = non-gray pixels. ``n_det`` > 1 adds copies of the box
    shifted by a few pixels (several detections of one object)."""

    def __init__(self, n_det: int = 1, obj_id: int = 1):
        self.n_det = n_det
        self.obj_id = obj_id

    def detect(self, rgb):
        from pix2pose_torch.inference.detector import Detection

        fg = np.any(np.abs(rgb.astype(int) - 128) > 8, axis=-1)
        vu = np.where(fg)
        if vu[0].size < 10:
            return []
        bbox = np.array([vu[0].min(), vu[1].min(), vu[0].max(),
                         vu[1].max()], np.int32)
        return [Detection(bbox=bbox + np.int32(3 * k), obj_id=self.obj_id,
                          score=0.9, mask=fg) for k in range(self.n_det)]


def build_cube_dataset(root, n_scenes=1, ims_per_scene=2, half=40.0,
                       im_h=480, im_w=640, split="test", device="cuda"):
    """Write the BOP-layout dataset 'cubes' under ``root`` (the port of
    the JAX package's test fixture ``tests/bop_fixture.py:
    build_cube_dataset``, rendered on ``device``): one cube model with
    ``models_info.json`` and ``models_xyz/norm_factor.json``, and per
    image an unlit XYZ-coloured RGB render on a gray background (so
    :class:`OracleGenerator` yields exact correspondences), the depth in
    mm, the ``mask_visib`` PNG, ``scene_camera`` / ``scene_gt`` and the
    test targets. The poses are drawn from ``np.random.RandomState(7)``,
    as the fixture draws them. Returns [(scene_id, im_id, R, t), ...]."""
    import json
    import os

    from PIL import Image

    from pix2pose_torch.data.ply import save_ply
    from pix2pose_torch.ops import rasterizer

    ds_dir = os.path.join(root, "cubes")
    model_dir = os.path.join(ds_dir, "models")
    xyz_dir = os.path.join(ds_dir, "models_xyz")
    os.makedirs(model_dir, exist_ok=True)
    os.makedirs(xyz_dir, exist_ok=True)

    verts, faces = cube_mesh(half)
    diam = float(np.linalg.norm([2 * half] * 3))
    save_ply(os.path.join(model_dir, "obj_000001.ply"), verts, faces)
    with open(os.path.join(model_dir, "models_info.json"), "w") as f:
        json.dump({"1": {"diameter": diam,
                         "min_x": -half, "min_y": -half, "min_z": -half,
                         "size_x": 2 * half, "size_y": 2 * half,
                         "size_z": 2 * half}}, f)
    with open(os.path.join(ds_dir, "camera.json"), "w") as f:
        json.dump({"fx": float(CAM_K[0, 0]), "fy": float(CAM_K[1, 1]),
                   "cx": float(CAM_K[0, 2]), "cy": float(CAM_K[1, 2]),
                   "width": im_w, "height": im_h, "depth_scale": 1.0}, f)
    with open(os.path.join(xyz_dir, "norm_factor.json"), "w") as f:
        json.dump({"1": {"x_scale": half, "y_scale": half, "z_scale": half,
                         "x_ct": 0.0, "y_ct": 0.0, "z_ct": 0.0}}, f)

    dev = torch.device(device)
    colors = ((verts / half + 1.0) / 2.0 * 255.0).astype(np.float32)
    v_t, f_t, c_t = (torch.as_tensor(a, device=dev)
                     for a in (verts, faces, colors))
    K = torch.as_tensor(CAM_K, device=dev)
    entries, targets = [], []
    rng = np.random.RandomState(7)
    for s in range(n_scenes):
        sdir = os.path.join(ds_dir, split, f"{s:06d}")
        for sub in ("rgb", "depth", "mask_visib"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        cam, gt = {}, {}
        for i in range(ims_per_scene):
            R, t = pose_with_euler(
                yaw=rng.uniform(-1, 1), pitch=rng.uniform(-0.8, 0.8),
                roll=rng.uniform(-1, 1), tx=rng.uniform(-40, 40),
                ty=rng.uniform(-30, 30), tz=rng.uniform(500, 800))
            out = rasterizer.render_mesh(v_t, f_t, c_t,
                                         torch.as_tensor(R, device=dev),
                                         torch.as_tensor(t, device=dev), K,
                                         im_h, im_w)
            mask = out.mask.cpu().numpy()
            rgb = np.full((im_h, im_w, 3), 128, np.uint8)
            rgb[mask] = np.clip(out.attr.cpu().numpy()[mask], 0,
                                255).astype(np.uint8)
            Image.fromarray(rgb).save(
                os.path.join(sdir, "rgb", f"{i:06d}.png"))
            Image.fromarray(out.depth.cpu().numpy().astype(np.uint16)).save(
                os.path.join(sdir, "depth", f"{i:06d}.png"))
            Image.fromarray((mask * 255).astype(np.uint8)).save(
                os.path.join(sdir, "mask_visib", f"{i:06d}_000000.png"))
            cam[str(i)] = {"cam_K": CAM_K.reshape(-1).tolist(),
                           "depth_scale": 1.0}
            gt[str(i)] = [{"obj_id": 1, "cam_R_m2c": R.reshape(-1).tolist(),
                           "cam_t_m2c": t.tolist()}]
            entries.append((s, i, R, t))
            targets.append({"scene_id": s, "im_id": i, "obj_id": 1,
                            "inst_count": 1})
        with open(os.path.join(sdir, "scene_camera.json"), "w") as f:
            json.dump(cam, f)
        with open(os.path.join(sdir, "scene_gt.json"), "w") as f:
            json.dump(gt, f)
    with open(os.path.join(ds_dir, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    return entries
