"""Detector-quality harness (port of :mod:`pix2pose_tpu.tools.
eval_detector`): COCO-style mAP of the trained detectors, CenterNet by
default, ``--head retinanet`` for the anchor head.

- ``--split synthetic`` (default): held-out scenes composed on the device
  from the dataset's ``train_xyz`` patches (a generator seeded 777,
  disjoint from the trainers' streams), forward and decode on the device;
  per-class AP, mAP@0.5 / 0.75, COCO mAP.
- ``--split test``: the served detector (:class:`~pix2pose_torch.
  inference.torch_detector.TorchDetector` or :class:`~pix2pose_torch.
  inference.torch_detector.RetinaNetAdapter`) over the BOP test targets,
  scored against the visible-mask GT boxes.

With the CenterNet head the instance masks are scored too (mask mAP
beside box mAP, over the same detections and GT: on the stride grid for
synthetic scenes, on the frame for the test split); the RetinaNet head
has no mask head.

Repaired against the JAX tool: the GT of a test image is read from
``scene_gt`` by its integer image id (the JAX tool looks up ``str(im_id)``
in the int-keyed dict and finds no GT), and detection boxes are put on
the GT's half-open convention
(:func:`~pix2pose_torch.eval.detection_metrics.detection_boxes`).

CLI (``--device`` defaults to ``cuda``)::

    python -m pix2pose_torch eval-detector <cfg.json> <dataset> \\
        [--split synthetic|test] [--head centernet|retinanet] \\
        [--n-images 64] [--score-th 0.3] [--tune] [--json out.json] \\
        [--device cuda]
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from pix2pose_torch.eval.detection_metrics import (
    collect_synthetic_detections, detection_boxes, detection_masks,
    evaluate_detections, tune_score_threshold)
from pix2pose_torch.models import CenterNetDetector
from pix2pose_torch.models.retinanet import (RetinaNetDetector,
                                             anchor_boxes, decode_retinanet)


def gt_boxes_from_masks(dataset, scene_id: int, im_id: int,
                        hw: tuple | None = None) -> dict:
    """Visible-region GT boxes (half-open) of one image from scene_gt and
    mask_visib; class index = rank of obj_id in ``dataset.model_ids``
    (the detectors' convention). Instances under 8 visible pixels are
    skipped. With ``hw`` (the image's height and width) the visible masks
    come too, as "mask" (M, h, w) bool."""
    from PIL import Image

    cls_of = {obj_id: i for i, obj_id in enumerate(dataset.model_ids)}
    boxes, classes, masks = [], [], []
    for gt_id, rec in enumerate(dataset.scene_gt(scene_id).get(im_id, [])):
        obj_id = int(rec["obj_id"])
        mpath = dataset.mask_path(scene_id, im_id, gt_id, visib=True)
        if obj_id not in cls_of or not os.path.isfile(mpath):
            continue
        m = np.asarray(Image.open(mpath)) > 0
        ys, xs = np.nonzero(m)
        if ys.size < 8:
            continue
        boxes.append([ys.min(), xs.min(), ys.max() + 1, xs.max() + 1])
        classes.append(cls_of[obj_id])
        masks.append(m)
    gt = {"bbox": np.asarray(boxes, np.float64).reshape(-1, 4),
          "cls": np.asarray(classes, np.int64)}
    if hw is not None:
        gt["mask"] = (np.stack(masks) if masks
                      else np.zeros((0, *hw), bool))
    return gt


def collect_test_split(detector, dataset, target_list,
                       with_masks: bool = False):
    """Run any Detection-protocol object over the BOP test images of
    ``target_list``; returns (preds, gts) in
    :func:`~pix2pose_torch.eval.detection_metrics.evaluate_detections`'
    format, GT by :func:`gt_boxes_from_masks`. With ``with_masks`` both
    sides carry frame masks (a detection without a mask gets its box)."""
    cls_of = {obj_id: i for i, obj_id in enumerate(dataset.model_ids)}
    preds, gts = [], []
    for scene_id, im_id in sorted({(s, i) for s, i, _, _ in target_list}):
        rgb = dataset.load_rgb(scene_id, im_id)
        hw = rgb.shape[:2] if with_masks else None
        dets = detector.detect(scene_id, im_id, rgb)
        pred = {"bbox": detection_boxes(dets),
                "score": np.asarray([d.score for d in dets], np.float64),
                "cls": np.asarray([cls_of.get(d.obj_id, -1) for d in dets],
                                  np.int64)}
        if with_masks:
            pred["mask"] = detection_masks(dets, *hw)
        preds.append(pred)
        gts.append(gt_boxes_from_masks(dataset, scene_id, im_id, hw))
    return preds, gts


def evaluate_on_test_split(detector, dataset, target_list,
                           iou_ths=(0.5, 0.75)) -> dict:
    """Box mAP of any Detection-protocol object over BOP test images."""
    preds, gts = collect_test_split(detector, dataset, target_list)
    res = evaluate_detections(preds, gts, iou_ths=iou_ths)
    res["_preds"] = preds
    res["_gts"] = gts
    return res


def _fmt(res: dict, model_ids=None) -> str:
    lines = [f"mAP@0.50 = {res['mAP50']:.4f}",
             f"mAP@0.75 = {res['mAP75']:.4f}",
             f"mAP@[.5:.95] = {res['mAP']:.4f}"]
    for c, aps in sorted(res["per_class"].items()):
        if res["n_gt"].get(c, 0) == 0:
            continue
        name = (f"obj {model_ids[c]}" if model_ids is not None
                else f"class {c}")
        lines.append(f"  {name}: AP50={aps[0.5]:.4f} AP75={aps[0.75]:.4f}"
                     f" (n_gt={res['n_gt'][c]})")
    return "\n".join(lines)


def _jsonable(res: dict) -> dict:
    out = {k: v for k, v in res.items() if not k.startswith("_")}
    out["per_class"] = {str(c): {str(t): v for t, v in aps.items()}
                        for c, aps in out["per_class"].items()}
    out["n_gt"] = {str(c): int(n) for c, n in out["n_gt"].items()}
    return out


def main(argv: Sequence[str] | None = None):
    """Run the harness; returns the result dict (as written by
    ``--json``)."""
    import argparse

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch "
                                     "eval-detector")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("--split", choices=["synthetic", "test"],
                   default="synthetic")
    p.add_argument("--head", choices=["centernet", "retinanet"],
                   default="centernet")
    p.add_argument("--n-images", type=int, default=64)
    p.add_argument("--score-th", type=float, default=0.3,
                   help="detector threshold for --split test")
    p.add_argument("--tune", action="store_true",
                   help="also sweep the score threshold for best F1@0.5")
    p.add_argument("--json", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run the detector on")
    args = p.parse_args(argv)

    import torch

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.bop import BopDataset, get_target_list
    from pix2pose_torch.utils import checkpoint as ckpt_util
    from pix2pose_torch.utils.cli import require_device
    from pix2pose_torch.utils.convert import flax_to_state_dict

    device = require_device(args.device)
    with_masks = args.head == "centernet"
    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset,
                    train=(args.split == "synthetic"))
    det_vars = ckpt_util.load_inference_params(
        os.path.join(ds.dir, "weight_detection", args.head))
    if det_vars is None:
        raise SystemExit(
            f"no trained detector (weight_detection/{args.head})")
    n_cls = len(ds.model_ids)
    model = (RetinaNetDetector(num_classes=n_cls)
             if args.head == "retinanet"
             else CenterNetDetector(num_classes=n_cls))
    state = flax_to_state_dict(det_vars)

    if args.split == "synthetic":
        from pix2pose_torch.training.detector_train import load_store

        model.load_state_dict(state, strict=True)
        model.to(device)
        store = load_store(ds, None, device)
        decode_fn = None
        if args.head == "retinanet":
            anchors = torch.as_tensor(anchor_boxes(512), device=device)
            decode_fn = lambda out: decode_retinanet(out, anchors)  # noqa
        preds, gts = collect_synthetic_detections(
            model, store, args.n_images,
            torch.Generator(device=device).manual_seed(777),
            decode_fn=decode_fn, with_masks=with_masks)
    else:
        from pix2pose_torch.inference.torch_detector import (
            RetinaNetAdapter, TorchDetector)

        adapter = (RetinaNetAdapter if args.head == "retinanet"
                   else TorchDetector)
        detector = adapter(model, state, ds.model_ids,
                           score_th=args.score_th, device=device)
        targets = get_target_list(
            os.path.join(ds.dir, cfg.test_target + ".json"))
        preds, gts = collect_test_split(detector, ds, targets, with_masks)
    res = evaluate_detections(preds, gts)
    mask_res = (evaluate_detections(preds, gts, iou_type="mask")
                if with_masks else None)

    n_det = sum(len(pr["score"]) for pr in preds)
    n_gt = sum(len(g["cls"]) for g in gts)
    print(_fmt(res, ds.model_ids))
    print(f"{n_det} detections, {n_gt} GT instances over {len(gts)} "
          f"images ({args.split} split, {args.head})")
    res.update(n_det=n_det, n_gt_total=n_gt, n_images=len(gts))
    if mask_res is not None:
        print(f"mask mAP@0.50 = {mask_res['mAP50']:.4f}, mask mAP@0.75 = "
              f"{mask_res['mAP75']:.4f}")
        res["mask"] = _jsonable(mask_res)
    if args.tune:
        tuned = tune_score_threshold(preds, gts)
        print(f"tuned score threshold: {tuned['best_th']:.2f} "
              f"(F1@0.5 = {tuned['best_f1']:.4f})")
        res["tuned"] = {"best_th": tuned["best_th"],
                        "best_f1": tuned["best_f1"]}
    out = _jsonable(res)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
