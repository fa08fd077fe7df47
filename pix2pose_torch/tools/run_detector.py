"""Run the in-repo detector over a test target list and export detections
as PrecomputedDetector JSON (bbox + uncompressed RLE masks); port of
:mod:`pix2pose_tpu.tools.run_detector`.

Splits detection from pose estimation, as the reference teams shipped
Mask-RCNN detection dumps for the BOP pose tasks: ``eval --detections``
replays the file.

    python -m pix2pose_torch run-detector <cfg.json> <dataset>
        [--out detections.json] [--score-th 0.3] [--device cuda]

The detector (``<dataset>/weight_detection/centernet/inference.npz``)
runs on ``--device`` (default ``cuda``); without a CUDA device the
command refuses to start unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np


def encode_rle(mask: np.ndarray) -> dict:
    """Uncompressed row-major RLE (PrecomputedDetector._decode_rle
    format): alternating run lengths starting with a 'False' run."""
    flat = np.asarray(mask, bool).reshape(-1)
    change = np.nonzero(np.diff(flat))[0] + 1
    idx = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(idx).tolist()
    if flat[0]:
        runs = [0] + runs
    return {"size": [int(mask.shape[0]), int(mask.shape[1])],
            "counts": [int(r) for r in runs]}


def export_detections(detector, dataset, target_list, out_path: str,
                      with_masks: bool = True) -> int:
    entries = []
    for scene_id, im_id, _, _ in target_list:
        rgb = dataset.load_rgb(scene_id, im_id)
        for d in detector.detect(scene_id, im_id, rgb):
            e = {"scene_id": int(scene_id), "im_id": int(im_id),
                 "obj_id": int(d.obj_id), "score": float(d.score),
                 "bbox": [int(x) for x in d.bbox]}
            if with_masks and d.mask is not None:
                e["mask_rle"] = encode_rle(d.mask)
            entries.append(e)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(entries, f)
    return len(entries)


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.bop import BopDataset, get_target_list
    from pix2pose_torch.utils.cli import load_torch_detector, require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch run-detector")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("--out", default=None)
    p.add_argument("--score-th", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector")
    args = p.parse_args(argv)
    device = require_device(args.device)

    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset, train=False)
    detector = load_torch_detector(ds, device, score_th=args.score_th)
    targets = get_target_list(
        os.path.join(ds.dir, cfg.test_target + ".json"))
    out = args.out or os.path.join(cfg.path_to_output,
                                   f"detections_{ds.name}.json")
    n = export_detections(detector, ds, targets, out)
    print(f"{n} detections -> {out}")


if __name__ == "__main__":
    main()
