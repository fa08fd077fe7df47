"""BOP dataset layout I/O — standalone (no bop_toolkit dependency). A copy
of :mod:`pix2pose_tpu.data.bop` whose images are decoded by PIL.

Mirrors the behavior of the reference's ``tools/bop_io.py`` +
``bop_toolkit_lib.inout``: per-dataset directory quirks (``bop_io.py:45-115``),
model enumeration, scene camera/gt parsing, per-image test-target grouping
(``bop_io.py:9-31``), and the BOP result CSV format
(``inout.save_bop_results``; consumed at ``5_evaluation_bop_basic.py:359``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np

# per-dataset quirks (reference bop_io.py:52-111)
_DATASET_SPECS = {
    "lm": dict(),
    "lmo": dict(),
    "ruapc": dict(),
    "hb": dict(model_scale=0.0001),
    "icbin": dict(),
    "itodd": dict(img_type="gray", img_ext="tif"),
    "tudl": dict(train_dir="train_real"),
    "tless": dict(test_dir="test_primesense", train_dir="train_primesense",
                  model_dir_train="models_cad", model_dir_vis="models_reconst"),
    "ycbv": dict(camera_json="camera_uw.json"),
}


def _load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class BopDataset:
    """Paths + metadata for one BOP dataset."""

    root: str
    name: str
    train: bool = True
    eval_model: bool = False

    def __post_init__(self):
        spec = _DATASET_SPECS.get(self.name, {})
        self.dir = os.path.join(self.root, self.name)
        self.img_type = spec.get("img_type", "rgb")
        self.img_ext = spec.get("img_ext", "png")
        self.model_scale = spec.get("model_scale", 0.001)
        self.test_dir = os.path.join(self.dir, spec.get("test_dir", "test"))
        self.train_dir = os.path.join(self.dir,
                                      spec.get("train_dir", "train"))
        if self.eval_model:
            model_sub = "models_eval"
        elif self.name == "tless":
            model_sub = spec["model_dir_train"] if self.train else \
                spec["model_dir_vis"]
        else:
            model_sub = "models"
        self.model_dir = os.path.join(self.dir, model_sub)
        cam_json = spec.get("camera_json", "camera.json")
        cam_path = os.path.join(self.dir, cam_json)
        if os.path.exists(cam_path):
            cam = _load_json(cam_path)
            self.cam_k = np.array([[cam["fx"], 0, cam["cx"]],
                                   [0, cam["fy"], cam["cy"]],
                                   [0, 0, 1]], np.float32)
            self.im_size = (int(cam["width"]), int(cam["height"]))
            self.depth_scale_global = float(cam.get("depth_scale", 1.0))
        else:
            self.cam_k = None
            self.im_size = None
            self.depth_scale_global = 1.0
        info_path = os.path.join(self.model_dir, "models_info.json")
        self.models_info = _load_json(info_path) if os.path.exists(
            info_path) else {}
        self.model_ids = self._find_model_ids()

    # ------------------------------------------------------------------
    def _find_model_ids(self):
        ids = []
        for mid in self.models_info.keys():
            if os.path.exists(self.model_ply_path(int(mid))):
                ids.append(int(mid))
        return sorted(ids)

    def model_ply_path(self, obj_id: int) -> str:
        return os.path.join(self.model_dir, f"obj_{obj_id:06d}.ply")

    def model_info(self, obj_id: int) -> dict:
        return self.models_info[str(obj_id)]

    def symmetry_pool(self, obj_id: int) -> np.ndarray:
        """(S, 3, 3) discrete-symmetry rotation pool, identity first
        (reference ``3_train_pix2pose.py:98-109``)."""
        info = self.model_info(obj_id)
        pool = [np.eye(3, dtype=np.float32)]
        for m in info.get("symmetries_discrete", []):
            pool.append(np.asarray(m, np.float32).reshape(4, 4)[:3, :3])
        return np.stack(pool)

    def symmetry_transforms(self, obj_id: int,
                            n_continuous: int = 36) -> tuple:
        """Full (R, t) symmetry pool for BOP scoring, identity first:
        discrete 4x4s keep their translation part (some T-LESS/HB/YCB-V
        symmetries carry non-zero t), continuous symmetries are densified
        into ``n_continuous`` rotations about the axis with
        t = offset - R @ offset (bop_toolkit convention).

        Returns (sym_R (S,3,3) float32, sym_t (S,3) float32).
        """
        info = self.model_info(obj_id)
        Rs = [np.eye(3, dtype=np.float32)]
        ts = [np.zeros(3, np.float32)]
        for m in info.get("symmetries_discrete", []):
            m = np.asarray(m, np.float32).reshape(4, 4)
            Rs.append(m[:3, :3])
            ts.append(m[:3, 3])
        for c in info.get("symmetries_continuous", []):
            axis = np.asarray(c["axis"], np.float64)
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            offset = np.asarray(c.get("offset", [0.0, 0.0, 0.0]),
                                np.float64)
            from scipy.spatial.transform import Rotation
            for a in np.linspace(0, 2 * np.pi, n_continuous,
                                 endpoint=False)[1:]:
                R = Rotation.from_rotvec(axis * a).as_matrix()
                Rs.append(R.astype(np.float32))
                ts.append((offset - R @ offset).astype(np.float32))
        return np.stack(Rs), np.stack(ts)

    def has_continuous_symmetry(self, obj_id: int) -> bool:
        return "symmetries_continuous" in self.model_info(obj_id)

    # ------------------------------------------------------------------
    def split_dir(self) -> str:
        return self.train_dir if self.train else self.test_dir

    def scene_ids(self) -> list[int]:
        base = self.split_dir()
        if not os.path.isdir(base):
            return []
        return sorted(int(d) for d in os.listdir(base)
                      if d.isdigit() and os.path.isdir(os.path.join(base, d)))

    def scene_camera(self, scene_id: int) -> dict:
        path = os.path.join(self.split_dir(), f"{scene_id:06d}",
                            "scene_camera.json")
        raw = _load_json(path)
        out = {}
        for k, v in raw.items():
            out[int(k)] = {
                "cam_K": np.asarray(v["cam_K"], np.float32).reshape(3, 3),
                "depth_scale": float(v.get("depth_scale", 1.0)),
            }
        return out

    def scene_gt(self, scene_id: int) -> dict:
        path = os.path.join(self.split_dir(), f"{scene_id:06d}",
                            "scene_gt.json")
        if not os.path.exists(path):
            return {}
        raw = _load_json(path)
        out = {}
        for k, v in raw.items():
            out[int(k)] = [
                {"obj_id": int(g["obj_id"]),
                 "R": np.asarray(g["cam_R_m2c"], np.float32).reshape(3, 3),
                 "t": np.asarray(g["cam_t_m2c"], np.float32).reshape(3)}
                for g in v]
        return out

    def scene_gt_info(self, scene_id: int) -> dict:
        path = os.path.join(self.split_dir(), f"{scene_id:06d}",
                            "scene_gt_info.json")
        if not os.path.exists(path):
            return {}
        raw = _load_json(path)
        return {int(k): v for k, v in raw.items()}

    # ------------------------------------------------------------------
    def rgb_path(self, scene_id: int, im_id: int) -> str:
        sub = self.img_type if not self.train else "rgb"
        ext = self.img_ext if not self.train else "png"
        return os.path.join(self.split_dir(), f"{scene_id:06d}", sub,
                            f"{im_id:06d}.{ext}")

    def depth_path(self, scene_id: int, im_id: int) -> str:
        ext = "tif" if self.name == "itodd" else "png"
        return os.path.join(self.split_dir(), f"{scene_id:06d}", "depth",
                            f"{im_id:06d}.{ext}")

    def mask_path(self, scene_id: int, im_id: int, gt_id: int = 0,
                  visib: bool = False) -> str:
        sub = "mask_visib" if visib else "mask"
        return os.path.join(self.split_dir(), f"{scene_id:06d}", sub,
                            f"{im_id:06d}_{gt_id:06d}.png")

    def load_rgb(self, scene_id: int, im_id: int) -> np.ndarray:
        """(H, W, 3) uint8; gray datasets are expanded to 3 channels
        (reference ``5_evaluation_bop_basic.py:260-270``)."""
        from PIL import Image

        img = np.asarray(Image.open(self.rgb_path(scene_id, im_id)))
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return img[..., :3]

    def load_depth(self, scene_id: int, im_id: int,
                   depth_scale: float = 1.0) -> np.ndarray:
        """(H, W) float32 depth in meters: raw/1000*depth_scale
        (reference ``5_evaluation_bop_icp3d.py:360``)."""
        from PIL import Image

        raw = np.asarray(Image.open(self.depth_path(scene_id, im_id)))
        return raw.astype(np.float32) / 1000.0 * depth_scale


def get_target_list(target_path: str):
    """Group a BOP test-target json into per-image entries
    [(scene_id, im_id, obj_ids, inst_counts), ...]
    (reference ``bop_io.py:9-31``)."""
    targets = _load_json(target_path)
    grouped = {}
    order = []
    for tgt in targets:
        k = (tgt["scene_id"], tgt["im_id"])
        if k not in grouped:
            grouped[k] = ([], [])
            order.append(k)
        grouped[k][0].append(tgt["obj_id"])
        grouped[k][1].append(tgt["inst_count"])
    return [(s, i, grouped[(s, i)][0], grouped[(s, i)][1])
            for (s, i) in order]


def target_list_from_linemod_split(split_path: str, obj_id: int,
                                   scene_id: int | None = None):
    """Build a target list from a LineMOD-style per-object split file, a
    plain text file of test image ids, one per line (the reference's
    checked-in ``linemod_splits/*.txt`` fixtures; SiSo task). The scene id
    defaults to the object id (LM's layout)."""
    scene = obj_id if scene_id is None else scene_id
    with open(split_path) as f:
        ids = [int(line.strip()) for line in f if line.strip()]
    return [(scene, im_id, [obj_id], [1]) for im_id in ids]


def save_bop_results(path: str, results: Sequence[dict]):
    """Write the BOP result CSV:
    ``scene_id,im_id,obj_id,score,R,t,time`` with R as 9 and t as 3
    space-separated floats (format of ``inout.save_bop_results``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = ["scene_id,im_id,obj_id,score,R,t,time"]
    for r in results:
        R = " ".join(f"{x:.8f}" for x in np.asarray(r["R"]).reshape(-1))
        t = " ".join(f"{x:.8f}" for x in np.asarray(r["t"]).reshape(-1))
        lines.append(f'{r["scene_id"]},{r["im_id"]},{r["obj_id"]},'
                     f'{r["score"]:.8f},{R},{t},{r.get("time", -1):.3f}')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_bop_results(path: str):
    """Parse a BOP result/detections CSV back into dicts."""
    out = []
    with open(path) as f:
        header = f.readline()
        assert header.startswith("scene_id"), header
        for line in f:
            if not line.strip():
                continue
            parts = line.strip().split(",")
            scene_id, im_id, obj_id = (int(parts[0]), int(parts[1]),
                                       int(parts[2]))
            score = float(parts[3])
            R = np.asarray([float(x) for x in parts[4].split()],
                           np.float32).reshape(3, 3)
            t = np.asarray([float(x) for x in parts[5].split()], np.float32)
            out.append({"scene_id": scene_id, "im_id": im_id,
                        "obj_id": obj_id, "score": score, "R": R, "t": t,
                        "time": float(parts[6]) if len(parts) > 6 else -1.0})
    return out
