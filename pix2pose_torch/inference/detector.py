"""Detector seam (port of :mod:`pix2pose_tpu.inference.detector`).

The reference treats 2D detection as a pluggable external (Mask-RCNN or
keras-retinanet loaded from other repos,
``5_evaluation_bop_basic.py:37-101``). A detector is any object with
``detect(scene_id, im_id, rgb)`` (or ``detect(rgb)``) returning a sequence
of :class:`Detection`. Two implementations live here, both host numpy, so
that their detections equal the JAX package's bit for bit:

- :class:`PrecomputedDetector` replays stored detections (JSON), the
  primary path for parity evaluations;
- :class:`GtDetector` derives detections from ``scene_gt`` and the
  ``mask_visib`` PNGs, the test fixture that makes the pose stage
  testable without a detection model.

The in-repo CenterNet detector is :mod:`pix2pose_torch.inference.
torch_detector`.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class Detection:
    bbox: np.ndarray  # (4,) [v_min, u_min, v_max, u_max]
    obj_id: int
    score: float
    mask: np.ndarray | None = None  # (H, W) bool


class PrecomputedDetector:
    """Replays per-image detections from a JSON file.

    Format: list of {"scene_id", "im_id", "obj_id", "score",
    "bbox": [v1, u1, v2, u2]} (optionally "mask_rle": {"size": [h, w],
    "counts": [...]} in uncompressed row-major RLE, the format
    :func:`pix2pose_torch.tools.run_detector.encode_rle` writes).
    """

    def __init__(self, path: str):
        with open(path) as f:
            entries = json.load(f)
        self._by_image: dict = {}
        for e in entries:
            self._by_image.setdefault(
                (int(e["scene_id"]), int(e["im_id"])), []).append(e)

    @staticmethod
    def _decode_rle(rle) -> np.ndarray:
        h, w = rle["size"]
        flat = np.zeros(h * w, bool)
        pos = 0
        val = False
        for run in rle["counts"]:
            if val:
                flat[pos:pos + run] = True
            pos += run
            val = not val
        return flat.reshape(h, w)

    def detect(self, scene_id, im_id, rgb):
        out = []
        for e in self._by_image.get((scene_id, im_id), []):
            mask = (self._decode_rle(e["mask_rle"])
                    if "mask_rle" in e else None)
            out.append(Detection(
                bbox=np.asarray(e["bbox"], np.int32),
                obj_id=int(e["obj_id"]), score=float(e["score"]),
                mask=mask))
        return out


class GtDetector:
    """Oracle detections from ground truth, optionally jittered. Stateful:
    each call advances the jitter draws of ``np.random.RandomState(seed)``,
    so two runs that must agree need two detectors with one seed."""

    def __init__(self, dataset, jitter: int = 0, score: float = 0.99,
                 seed: int = 0):
        self.ds = dataset
        self.jitter = jitter
        self.score = score
        self.rng = np.random.RandomState(seed)
        self._gt_cache: dict = {}

    def detect(self, scene_id, im_id, rgb):
        from PIL import Image

        if scene_id not in self._gt_cache:
            self._gt_cache[scene_id] = self.ds.scene_gt(scene_id)
        gts = self._gt_cache[scene_id].get(im_id, [])
        out = []
        for gt_id, gt in enumerate(gts):
            mpath = self.ds.mask_path(scene_id, im_id, gt_id, visib=True)
            if not os.path.exists(mpath):
                continue
            mask = np.asarray(Image.open(mpath)) > 0
            vu = np.where(mask)
            if len(vu[0]) < 4:
                continue
            j = (self.rng.randint(-self.jitter, self.jitter + 1, 4)
                 if self.jitter else np.zeros(4, np.int32))
            bbox = np.array([vu[0].min() + j[0], vu[1].min() + j[1],
                             vu[0].max() + j[2], vu[1].max() + j[3]],
                            np.int32)
            out.append(Detection(bbox=bbox, obj_id=gt["obj_id"],
                                 score=self.score, mask=mask))
        return out
