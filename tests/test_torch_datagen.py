"""pix2pose_torch training-data synthesis against the JAX package on the
CPU: the synthetic BOP dataset, the XYZ training pairs and the rendered
train views. The JAX side renders with its scan (z-min with divisions),
the port with the binned plain version (affine 1/z max), so silhouette
edges may differ by a pixel.

Bars, per test:
- dataset: every JSON and PLY file byte-equal; RGB and ``mask_visib`` PNGs
  equal on >= 99.5% of the pixels that either package covers (the union
  of the two depth maps for RGB, of the two masks for a mask) and on
  >= 99.5% of the frame; depth within 1 mm where both are nonzero;
- training pairs (objects 1-4 of one JAX-written dataset): same pair
  count; ``meta.json`` equal; each pair's shape within 1 px per side of
  the crop; XYZ channels within 2 LSB on >= 99% of the overlapping pixels;
- train views (vertex-colour and textured models): same view count and
  JSON; masks equal, and RGB within 2 LSB, on >= 99.5% of the union of
  the two masks."""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from pix2pose_tpu.data.bop import BopDataset as JBopDataset
from pix2pose_tpu.data.synthetic_bop import \
    build_rehearsal_dataset as jax_build
from pix2pose_tpu.tools.render_train_views import \
    render_train_split as jax_views
from pix2pose_tpu.tools.render_training_pairs import \
    render_object_pairs as jax_pairs
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.data.ply import save_ply
from pix2pose_torch.data.synthetic_bop import (atlas_texture,
                                               build_rehearsal_dataset,
                                               cube_mesh, uv_cube_mesh)
from pix2pose_torch.tools.render_train_views import render_train_split
from pix2pose_torch.tools.render_training_pairs import render_object_pairs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same small dataset written by each package."""
    jroot = str(tmp_path_factory.mktemp("jax_ds"))
    troot = str(tmp_path_factory.mktemp("torch_ds"))
    jent = jax_build(jroot, n_train=3, n_test=2, seed=0)
    tent = build_rehearsal_dataset(troot, n_train=3, n_test=2, seed=0,
                                   device="cpu")
    return jroot, troot, jent, tent


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int64)


def test_rehearsal_dataset_matches_jax(roots):
    jroot, troot, jent, tent = roots
    for split in ("train", "test"):
        assert [(s, i, [o for o, _, _ in insts]) for s, i, insts in
                jent[split]] == [(s, i, [o for o, _, _ in insts])
                                 for s, i, insts in tent[split]]
    ja, ta = os.path.join(jroot, "rehearsal"), os.path.join(troot,
                                                            "rehearsal")
    n_png = 0
    for dp, _, files in os.walk(ja):
        for fn in files:
            pj = os.path.join(dp, fn)
            pt = os.path.join(ta, os.path.relpath(pj, ja))
            assert os.path.exists(pt), pt
            if fn.endswith((".json", ".ply")):
                assert filecmp.cmp(pj, pt, shallow=False), pj
                continue
            x, y = _png(pj), _png(pt)
            n_png += 1
            kind = os.path.basename(dp)
            if kind == "depth":
                both = (x > 0) & (y > 0)
                assert both.sum() > 10000
                assert np.abs(x - y)[both].max() <= 1
                assert ((x > 0) == (y > 0)).mean() >= 0.995
                continue
            if kind == "rgb":
                dj, dt = (_png(os.path.join(r, "..", "depth", fn))
                          for r in (dp, os.path.dirname(pt)))
                fg = (dj > 0) | (dt > 0)
            else:
                fg = (x > 0) | (y > 0)
            eq = (x == y) if x.ndim == 2 else (x == y).all(-1)
            assert eq.mean() >= 0.995, pj
            if fg.any():
                assert eq[fg].mean() >= 0.995, pj
    assert n_png == 5 * (1 + 1 + 5)      # rgb, depth, 5 masks per image


def test_training_pairs_match_jax(roots, tmp_path):
    jroot = roots[0]
    jds = JBopDataset(jroot, "rehearsal", train=True)
    tds = BopDataset(jroot, "rehearsal", train=True)
    for obj_id in (1, 2, 3, 4):
        jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
        nj = jax_pairs(jds, obj_id, out_root=jout)
        nt = render_object_pairs(tds, obj_id, out_root=tout, device="cpu")
        assert nt == nj and nt > 0, obj_id
        jd, td = (os.path.join(r, f"{obj_id:02d}") for r in (jout, tout))
        with open(os.path.join(jd, "meta.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(td, "meta.json")) as f:
            assert json.load(f) == jmeta
        for k in range(nt):
            a = np.load(os.path.join(jd, f"{k:06d}.npy")).astype(np.int64)
            b = np.load(os.path.join(td, f"{k:06d}.npy")).astype(np.int64)
            assert b.dtype == a.dtype and b.shape[2] == 6
            assert max(b.shape[:2]) <= 128
            assert all(abs(x - y) <= 2 for x, y in zip(a.shape[:2],
                                                       b.shape[:2]))
            hh, ww = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
            d = np.abs(a[:hh, :ww, 3:] - b[:hh, :ww, 3:]).max(-1)
            assert (d <= 2).mean() >= 0.99, (obj_id, k)


def _textured_model_dir(ds_dir):
    """models/ with a vertex-colour cube (obj 1) and a UV-textured cube
    with its atlas PNG (obj 4), and the rehearsal camera."""
    mdir = os.path.join(ds_dir, "models")
    os.makedirs(mdir)
    v, f = cube_mesh(40.0)
    save_ply(os.path.join(mdir, "obj_000001.ply"), v, f)
    tv, tf, tuv, tn = uv_cube_mesh(35.0)
    with open(os.path.join(mdir, "obj_000004.ply"), "w") as fh:
        fh.write("ply\nformat ascii 1.0\n"
                 f"element vertex {tv.shape[0]}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property float nx\nproperty float ny\nproperty float nz\n"
                 "property float texture_u\nproperty float texture_v\n"
                 f"element face {tf.shape[0]}\n"
                 "property list uchar int vertex_indices\nend_header\n")
        for i in range(tv.shape[0]):
            fh.write(" ".join(str(float(x)) for x in (*tv[i], *tn[i],
                                                      *tuv[i])) + "\n")
        for fc in tf:
            fh.write("3 " + " ".join(str(int(x)) for x in fc) + "\n")
    Image.fromarray(atlas_texture().astype(np.uint8)).save(
        os.path.join(mdir, "obj_000004.png"))
    with open(os.path.join(mdir, "models_info.json"), "w") as fh:
        json.dump({"1": {"diameter": 138.6}, "4": {"diameter": 121.2}}, fh)


def test_train_views_match_jax(roots, tmp_path):
    jroot = roots[0]
    src = os.path.join(jroot, "rehearsal", "train")
    dirs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name / "views"
        _textured_model_dir(str(d))
        shutil.copy(os.path.join(jroot, "rehearsal", "camera.json"), d)
        dirs[name] = d
    nj = jax_views(JBopDataset(str(tmp_path / "jax"), "views", train=True),
                   src, per_obj=1)
    nt = render_train_split(BopDataset(str(tmp_path / "torch"), "views",
                                       train=True), src, per_obj=1,
                            device="cpu")
    assert nj == nt == 2
    for obj in ("000001", "000004"):
        jd, td = (dirs[n] / "train" / obj for n in ("jax", "torch"))
        for fn in ("scene_gt.json", "scene_camera.json"):
            assert filecmp.cmp(jd / fn, td / fn, shallow=False)
        mj, mt = _png(jd / "mask" / "000000.png"), _png(td / "mask" /
                                                       "000000.png")
        fg = (mj > 0) | (mt > 0)
        assert (mj > 0).sum() > 1000
        assert (mj == mt)[fg].mean() >= 0.995
        rj, rt = _png(jd / "rgb" / "000000.png"), _png(td / "rgb" /
                                                      "000000.png")
        assert (np.abs(rj - rt).max(-1) <= 2)[fg].mean() >= 0.995
    # the textured model shows its atlas, not the vertex-colour fallback
    tex_rgb = _png(dirs["torch"] / "train" / "000004" / "rgb" / "000000.png")
    fg = tex_rgb.sum(-1) > 0
    assert np.ptp(tex_rgb[fg], axis=0).max() > 60
