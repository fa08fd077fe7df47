"""Synthetic BOP-format dataset generator, the parity-rehearsal data source
(port of :mod:`pix2pose_tpu.data.synthetic_bop`; same layout, meshes,
poses and seeds, so both packages write the same dataset).

Builds a complete on-disk BOP-layout dataset (models/ + models_info.json
with symmetry annotations, camera.json, train/ and test/ scenes with
rgb/depth/mask_visib/scene_gt/scene_camera, test_targets_bop19.json) that
covers the axes that make real BOP sets hard:

  * duplicate same-class instances occluding each other (IC-BIN/T-Less
    regime, ``5_evaluation_bop_basic.py:297-349``),
  * a discretely-symmetric object (square prism, z180),
  * a continuously-symmetric object (cylinder, z axis;
    ``2_2_render_pix2pose_training.py:26-52``),
  * a UV-textured object with a per-face atlas (YCB-V-style appearance,
    rendered with the lit textured rasterizer like the reference's GL
    program ``rendering/renderer.py:50-79``).

Non-textured objects are painted with per-object disjoint colour BANDS of
their compressed XYZ coordinates. Meshes and poses are numpy (numpy's
``RandomState`` draws the poses, as in the JAX package); every render and
the per-image compositing run on ``device`` with the port's rasterizer.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from pix2pose_torch.data.ply import save_ply
from pix2pose_torch.ops import rasterizer

# LineMOD-style camera
CAM_K = np.array([[572.4, 0.0, 325.3],
                  [0.0, 573.6, 242.0],
                  [0.0, 0.0, 1.0]], np.float32)


# ---------------------------------------------------------------------------
# analytic meshes
def cube_mesh(half=40.0):
    return box_mesh(half, half, half)


def box_mesh(hx, hy, hz):
    """Axis-aligned box [-hx,hx]x[-hy,hy]x[-hz,hz]."""
    v = np.array([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                  for z in (-hz, hz)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return v, f


def cylinder_mesh(radius=25.0, half_h=45.0, n_seg=48):
    """Closed z-axis cylinder: continuously symmetric about z."""
    ang = np.linspace(0.0, 2 * np.pi, n_seg, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    top = np.concatenate([ring, np.full((n_seg, 1), half_h)], axis=1)
    bot = np.concatenate([ring, np.full((n_seg, 1), -half_h)], axis=1)
    v = np.concatenate([top, bot,
                        [[0.0, 0.0, half_h]], [[0.0, 0.0, -half_h]]],
                       axis=0).astype(np.float32)
    ct, cb = 2 * n_seg, 2 * n_seg + 1
    f = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        f += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i],  # wall
              [ct, i, j], [cb, n_seg + j, n_seg + i]]        # caps
    return v, np.asarray(f, np.int32)


def uv_cube_mesh(half=35.0):
    """Cube with per-face vertices (24), a 3x2-tile UV atlas, and
    outward per-vertex normals — the shape a textured YCB-V-style model
    has after PLY load (uv + normals per vertex).

    Returns (verts (24,3), faces (12,3), uvs (24,2) GL convention
    (v up from the bottom), normals (24,3))."""
    h = half
    # (normal axis, sign) per face; verts wound CCW seen from outside
    faces_spec = [
        (np.array([0, 0, 1.0]), [[-h, -h, h], [h, -h, h], [h, h, h],
                                 [-h, h, h]]),
        (np.array([0, 0, -1.0]), [[-h, -h, -h], [-h, h, -h], [h, h, -h],
                                  [h, -h, -h]]),
        (np.array([1.0, 0, 0]), [[h, -h, -h], [h, h, -h], [h, h, h],
                                 [h, -h, h]]),
        (np.array([-1.0, 0, 0]), [[-h, -h, -h], [-h, -h, h], [-h, h, h],
                                  [-h, h, -h]]),
        (np.array([0, 1.0, 0]), [[-h, h, -h], [-h, h, h], [h, h, h],
                                 [h, h, -h]]),
        (np.array([0, -1.0, 0]), [[-h, -h, -h], [h, -h, -h], [h, -h, h],
                                  [-h, -h, h]]),
    ]
    verts, uvs, normals, faces = [], [], [], []
    for fi, (n, quad) in enumerate(faces_spec):
        ti, tj = fi % 3, fi // 3          # tile in the 3x2 atlas
        u0, v0 = ti / 3.0, tj / 2.0
        base = len(verts)
        tile_uv = [(u0 + 0.02, v0 + 0.02), (u0 + 1 / 3 - 0.02, v0 + 0.02),
                   (u0 + 1 / 3 - 0.02, v0 + 0.5 - 0.02),
                   (u0 + 0.02, v0 + 0.5 - 0.02)]
        for q, (uu, vv) in zip(quad, tile_uv):
            verts.append(q)
            uvs.append([uu, vv])
            normals.append(n)
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(uvs, np.float32), np.asarray(normals, np.float32))


def atlas_texture(size=192):
    """3x2-tile texture atlas: per-tile distinct base hue + u/v gradients,
    so every (face, uv) has unique appearance (no texture-induced
    symmetry). Image-row order (row 0 = TOP, GL v=1)."""
    hues = np.array([[200, 60, 60], [60, 200, 60], [60, 60, 200],
                     [200, 160, 40], [40, 180, 200], [180, 60, 200]],
                    np.float32)
    tex = np.zeros((size, size, 3), np.float32)
    th, tw = size // 2, size // 3
    for fi in range(6):
        ti, tj = fi % 3, fi // 3
        gu = np.linspace(0, 1, tw)[None, :, None]
        gv = np.linspace(0, 1, th)[:, None, None]
        tile = hues[fi] * (0.45 + 0.55 * gu) * (0.45 + 0.55 * gv)
        # tile row in IMAGE coords: GL v0 tile occupies the BOTTOM half
        r0 = size - (tj + 1) * th
        tex[r0:r0 + th, ti * tw:(ti + 1) * tw] = tile
    return np.clip(tex, 0, 255)


def _z180_4x4():
    m = np.eye(4)
    m[0, 0] = m[1, 1] = -1.0
    return m.reshape(-1).tolist()


# per-object compressed-XYZ color bands (objects 1-3); object 4 is the
# UV-textured cube. Background is white (in no band).
REHEARSAL_BANDS = {1: (0.0, 0.22), 2: (0.25, 0.47), 3: (0.50, 0.72)}


def rehearsal_objects():
    """{obj_id: dict(verts, faces, scale, sym, uv?, normals?, texture?)}"""
    cube_v, cube_f = cube_mesh(40.0)
    prism_v, prism_f = box_mesh(22.0, 22.0, 55.0)
    cyl_v, cyl_f = cylinder_mesh(25.0, 45.0)
    tv, tf, tuv, tn = uv_cube_mesh(35.0)
    return {
        1: dict(verts=cube_v, faces=cube_f,
                scale=np.array([40.0, 40.0, 40.0], np.float32), sym=None),
        2: dict(verts=prism_v, faces=prism_f,
                scale=np.array([22.0, 22.0, 55.0], np.float32),
                sym={"discrete": [_z180_4x4()]}),
        3: dict(verts=cyl_v, faces=cyl_f,
                scale=np.array([25.0, 25.0, 45.0], np.float32),
                sym={"continuous": [0, 0, 1]}),
        4: dict(verts=tv, faces=tf,
                scale=np.array([35.0, 35.0, 35.0], np.float32), sym=None,
                uv=tuv, normals=tn, texture=atlas_texture()),
    }


def _euler_pose(rng, tx, ty, tz):
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler(
        "zyx", [rng.uniform(-np.pi, np.pi), rng.uniform(-0.6, 0.6),
                rng.uniform(-1.0, 1.0)]).as_matrix().astype(np.float32)
    return R, np.array([tx, ty, tz], np.float32)


# instance layout: object 1 appears TWICE with the second instance offset
# behind the first so their silhouettes overlap (duplicate-instance
# occlusion); the rest are spread with room for pose jitter.
_BASE_PLACEMENT = [
    (1, (-45.0, 10.0, 620.0)),
    (1, (17.0, 18.0, 740.0)),       # behind + offset: occluded duplicate
    (2, (105.0, -45.0, 700.0)),
    (3, (-165.0, -50.0, 650.0)),
    (4, (150.0, 55.0, 660.0)),
]


def _upload(spec, obj_id, dev):
    """One object's render inputs as tensors on ``dev``, uploaded once."""
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = {"verts": t(spec["verts"]), "faces": t(spec["faces"])}
    if "uv" in spec:
        out.update(uv=t(spec["uv"]), texture=t(spec["texture"]),
                   normals=t(spec["normals"]))
    else:
        lo, hi = REHEARSAL_BANDS[obj_id]
        base01 = (spec["verts"] / spec["scale"] + 1.0) / 2.0
        out["colors"] = t(((lo + (hi - lo) * base01) * 255.0)
                          .astype(np.float32))
    return out


def _render_instance(mesh, R, t, K, im_h, im_w):
    """(depth with inf background, mask, rgb float) for one instance at pose
    (R, t), all on the mesh's device."""
    if "uv" in mesh:
        out = rasterizer.render_textured(
            mesh["verts"], mesh["faces"], mesh["uv"], mesh["texture"],
            mesh["normals"], R, t, K, im_h, im_w)
    else:
        out = rasterizer.render_mesh(mesh["verts"], mesh["faces"],
                                     mesh["colors"], R, t, K, im_h, im_w)
    return torch.where(out.mask, out.depth, torch.inf), out.mask, out.attr


def build_rehearsal_dataset(root, name="rehearsal", n_train=48, n_test=6,
                            im_h=480, im_w=640, seed=0, device="cuda"):
    """Write the full two-split dataset, rendering on ``device``. Returns
    {"train": entries, "test": entries} where each entry is
    (scene_id, im_id, [(obj_id, R, t), ...])."""
    ds_dir = os.path.join(root, name)
    model_dir = os.path.join(ds_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    dev = torch.device(device)

    objs = rehearsal_objects()
    minfo = {}
    for obj_id, spec in objs.items():
        v = spec["verts"]
        save_ply(os.path.join(model_dir, f"obj_{obj_id:06d}.ply"),
                 v, spec["faces"])
        ext = v.max(0) - v.min(0)
        info = {"diameter": float(np.linalg.norm(ext)),
                "min_x": float(v[:, 0].min()),
                "min_y": float(v[:, 1].min()),
                "min_z": float(v[:, 2].min()),
                "size_x": float(ext[0]), "size_y": float(ext[1]),
                "size_z": float(ext[2])}
        sym = spec.get("sym")
        if sym:
            if "discrete" in sym:
                info["symmetries_discrete"] = sym["discrete"]
            if "continuous" in sym:
                info["symmetries_continuous"] = [
                    {"axis": sym["continuous"], "offset": [0, 0, 0]}]
        minfo[str(obj_id)] = info
    with open(os.path.join(model_dir, "models_info.json"), "w") as f:
        json.dump(minfo, f)
    with open(os.path.join(ds_dir, "camera.json"), "w") as f:
        json.dump({"fx": float(CAM_K[0, 0]), "fy": float(CAM_K[1, 1]),
                   "cx": float(CAM_K[0, 2]), "cy": float(CAM_K[1, 2]),
                   "width": im_w, "height": im_h, "depth_scale": 1.0}, f)

    from PIL import Image

    meshes = {obj_id: _upload(spec, obj_id, dev)
              for obj_id, spec in objs.items()}
    K = torch.as_tensor(CAM_K, device=dev)
    out_entries = {}
    rng = np.random.RandomState(seed)
    targets = []
    for split, n_ims in (("train", n_train), ("test", n_test)):
        sdir = os.path.join(ds_dir, split, "000000")
        for sub in ("rgb", "depth", "mask_visib"):
            os.makedirs(os.path.join(sdir, sub), exist_ok=True)
        cam, gt = {}, {}
        entries = []
        for i in range(n_ims):
            depth_all = torch.full((im_h, im_w), torch.inf, device=dev)
            rgb = torch.full((im_h, im_w, 3), 255, dtype=torch.uint8,
                             device=dev)
            winner = torch.full((im_h, im_w), -1, dtype=torch.int32,
                                device=dev)
            insts = []
            for slot, (obj_id, base) in enumerate(_BASE_PLACEMENT):
                R, t = _euler_pose(
                    rng,
                    base[0] + rng.uniform(-15, 15),
                    base[1] + rng.uniform(-15, 15),
                    base[2] + rng.uniform(-30, 30))
                d, m, attr = _render_instance(
                    meshes[obj_id], torch.as_tensor(R, device=dev),
                    torch.as_tensor(t, device=dev), K, im_h, im_w)
                win = m & (d < depth_all)
                depth_all = torch.where(win, d, depth_all)
                rgb = torch.where(win[..., None],
                                  torch.clamp(attr, 0, 255).to(torch.uint8),
                                  rgb)
                winner = torch.where(win, slot, winner)
                insts.append((obj_id, R, t))
            depth_mm = torch.where(torch.isfinite(depth_all), depth_all, 0.0)
            rgb, depth_mm, winner = (x.cpu().numpy()
                                     for x in (rgb, depth_mm, winner))
            Image.fromarray(rgb).save(
                os.path.join(sdir, "rgb", f"{i:06d}.png"))
            Image.fromarray(depth_mm.astype(np.uint16)).save(
                os.path.join(sdir, "depth", f"{i:06d}.png"))
            gt_list = []
            for slot, (obj_id, R, t) in enumerate(insts):
                visib = winner == slot
                Image.fromarray((visib * 255).astype(np.uint8)).save(
                    os.path.join(sdir, "mask_visib",
                                 f"{i:06d}_{slot:06d}.png"))
                gt_list.append({"obj_id": obj_id,
                                "cam_R_m2c": R.reshape(-1).tolist(),
                                "cam_t_m2c": t.tolist()})
            cam[str(i)] = {
                "cam_K": np.asarray(CAM_K).reshape(-1).tolist(),
                "depth_scale": 1.0}
            gt[str(i)] = gt_list
            entries.append((0, i, insts))
            if split == "test":
                counts = {}
                for obj_id, _, _ in insts:
                    counts[obj_id] = counts.get(obj_id, 0) + 1
                for obj_id, c in sorted(counts.items()):
                    targets.append({"scene_id": 0, "im_id": i,
                                    "obj_id": obj_id, "inst_count": c})
        with open(os.path.join(sdir, "scene_camera.json"), "w") as f:
            json.dump(cam, f)
        with open(os.path.join(sdir, "scene_gt.json"), "w") as f:
            json.dump(gt, f)
        out_entries[split] = entries
    with open(os.path.join(ds_dir, "test_targets_bop19.json"), "w") as f:
        json.dump(targets, f)
    return out_entries
