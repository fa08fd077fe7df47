"""COCO-style detection metrics (mAP) for the trained detectors (port of
:mod:`pix2pose_tpu.eval.detection_metrics`, a copy of its host numpy
functions, with two of its defects repaired).

The reference delegates detection quality to externally trained
Mask-RCNN / keras-retinanet checkpoints with hand-tuned thresholds
(``tools/mask_rcnn_util.py:39-65``) and never measures mAP. Here the
detector is trained in the repo, so its quality is measured: per-class
average precision with COCO 101-point interpolation at configurable IoU
thresholds, and a score-threshold tuner. Matching is greedy per class in
score order, each GT matched at most once (the COCO protocol).

:func:`collect_synthetic_detections` composes held-out scenes, runs the
detector and decodes on the device; only the decoded top-k comes to the
host. :func:`collect_bop_split_detections` runs a Detection-protocol
detector over a BOP split. Repaired there, against the JAX module:

- a detection with ``mask=None`` gets a box-shaped mask (as the
  RetinaNet adapter makes), so the mask rows match the box rows (the
  JAX module leaves 0 mask rows, and mixed None / array masks break its
  ``np.stack``);
- the detectors' boxes are inclusive ([v1, v2] pixels, clipped to h -
  1) while the GT boxes are half-open (``v.max() + 1``): the evaluation
  boxes are put on the half-open convention (``v2 + 1``, ``u2 + 1``),
  which the JAX module does not do (its box IoU runs ~1 px per side
  low).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "box_iou_matrix", "mask_iou_matrix", "average_precision",
    "evaluate_detections", "tune_score_threshold",
    "collect_synthetic_detections", "collect_bop_split_detections",
    "detection_boxes", "COCO_IOU_THS",
]

# COCO primary-metric IoU sweep 0.50:0.05:0.95
COCO_IOU_THS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2).tolist())


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of boxes ``a`` (N,4) vs ``b`` (M,4), [v1,u1,v2,u2]."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def mask_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of boolean instance masks ``a`` (N,H,W) vs ``b``
    (M,H,W) — the quantity the reference's score_type-2 computes between
    the projected pose mask and the Mask-RCNN mask
    (``5_evaluation_bop_basic.py:307-316``); here also the matcher for
    mask mAP."""
    a = np.asarray(a, bool).reshape(a.shape[0], -1)
    b = np.asarray(b, bool).reshape(b.shape[0], -1)
    inter = (a[:, None, :] & b[None, :, :]).sum(-1).astype(np.float64)
    union = (a[:, None, :] | b[None, :, :]).sum(-1).astype(np.float64)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_class(dets, gts, iou_th, iou_type: str = "bbox"):
    """Greedy score-order matching for ONE class.

    dets: list of (img_idx, score, box(4,)[, mask(H,W)]); gts:
    {img_idx: (M,4)} for bbox matching or {img_idx: (boxes (M,4),
    masks (M,H,W))} for mask matching. Returns (scores (D,), tp (D,)
    bool, n_gt)."""
    def _n(g):
        return len(g[0] if iou_type == "mask" else g)

    n_gt = sum(_n(g) for g in gts.values())
    if not dets:
        return np.zeros(0), np.zeros(0, bool), n_gt
    order = np.argsort([-d[1] for d in dets], kind="stable")
    used = {img: np.zeros(_n(g), bool) for img, g in gts.items()}
    scores = np.zeros(len(dets))
    tp = np.zeros(len(dets), bool)
    for rank, di in enumerate(order):
        img = dets[di][0]
        score = dets[di][1]
        scores[rank] = score
        g = gts.get(img)
        if g is None or _n(g) == 0:
            continue
        if iou_type == "mask":
            ious = mask_iou_matrix(dets[di][3][None], g[1])[0]
        else:
            ious = box_iou_matrix(dets[di][2][None], g)[0]
        ious[used[img]] = -1.0
        j = int(np.argmax(ious))
        if ious[j] >= iou_th:
            used[img][j] = True
            tp[rank] = True
    return scores, tp, n_gt


def average_precision(tp_sorted: np.ndarray, n_gt: int) -> float:
    """AP with COCO 101-point interpolation. ``tp_sorted`` is the TP flag
    per detection in descending-score order."""
    if n_gt == 0:
        return float("nan")
    if tp_sorted.size == 0:
        return 0.0
    tp_cum = np.cumsum(tp_sorted.astype(np.float64))
    fp_cum = np.cumsum((~tp_sorted.astype(bool)).astype(np.float64))
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r_grid = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, r_grid, side="left")
    p_at_r = np.where(idx < precision.size,
                      precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(p_at_r.mean())


def evaluate_detections(preds, gts, iou_ths=(0.5, 0.75),
                        coco_sweep: bool = True,
                        iou_type: str = "bbox") -> dict:
    """mAP over images.

    ``preds``: per-image dict {"bbox": (N,4), "score": (N,), "cls": (N,)}
    (list indexed by image). ``gts``: per-image dict {"bbox": (M,4),
    "cls": (M,)}. With ``iou_type="mask"`` both sides also carry a
    "mask" key ((N,H,W) / (M,H,W) bool; any common grid — the harness
    uses the detector's stride grid) and matching runs on mask IoU
    instead of box IoU: instance-mask quality, the quantity the
    reference delegates to Mask-RCNN and that score_type-2 / ICP
    occupancy consume. Returns {"mAP50": ..., "mAP75": ..., "mAP": mean
    over the COCO 0.5:0.95 sweep, "per_class": {cls: {th: AP}},
    "n_gt": {cls: count}}. Classes with zero GT are excluded from means.
    """
    classes = set()
    for g in gts:
        classes.update(int(c) for c in np.asarray(g["cls"]).reshape(-1))
    classes = sorted(classes)

    by_class_dets = {c: [] for c in classes}
    by_class_gts = {c: {} for c in classes}
    for img, g in enumerate(gts):
        gb = np.asarray(g["bbox"], np.float64).reshape(-1, 4)
        gc = np.asarray(g["cls"]).reshape(-1)
        gm = (np.asarray(g["mask"], bool) if iou_type == "mask"
              else None)
        for c in classes:
            sel = gc == c
            if sel.any():
                by_class_gts[c][img] = ((gb[sel], gm[sel])
                                        if iou_type == "mask"
                                        else gb[sel])
    for img, p in enumerate(preds):
        pb = np.asarray(p["bbox"], np.float64).reshape(-1, 4)
        ps = np.asarray(p["score"], np.float64).reshape(-1)
        pc = np.asarray(p["cls"]).reshape(-1)
        pm = (np.asarray(p["mask"], bool) if iou_type == "mask"
              else None)
        for i in range(len(pb)):
            c = int(pc[i])
            if c in by_class_dets:
                by_class_dets[c].append(
                    (img, float(ps[i]), pb[i])
                    + ((pm[i],) if iou_type == "mask" else ()))

    all_ths = sorted(set(iou_ths) | (set(COCO_IOU_THS) if coco_sweep
                                     else set()))
    per_class = {c: {} for c in classes}
    n_gt_per_class = {}
    for c in classes:
        n_gt_per_class[c] = sum(
            len(g[0] if iou_type == "mask" else g)
            for g in by_class_gts[c].values())
        for th in all_ths:
            _, tp, n_gt = _match_class(by_class_dets[c], by_class_gts[c],
                                       th, iou_type)
            per_class[c][th] = average_precision(tp, n_gt)

    def _mean(ths):
        vals = [per_class[c][th] for c in classes for th in ths
                if n_gt_per_class[c] > 0]
        return float(np.mean(vals)) if vals else float("nan")

    out = {"per_class": per_class, "n_gt": n_gt_per_class}
    for th in iou_ths:
        out[f"mAP{int(round(th * 100))}"] = _mean([th])
    if coco_sweep:
        out["mAP"] = _mean(COCO_IOU_THS)
    return out


def tune_score_threshold(preds, gts, iou_th: float = 0.5,
                         grid=None) -> dict:
    """Sweep the detector score threshold for best micro-F1 at ``iou_th``.

    The in-repo analogue of the reference's hand-tuned
    DETECTION_MIN_CONFIDENCE (``mask_rcnn_util.py:63``). Returns
    {"best_th", "best_f1", "table": [(th, precision, recall, f1), ...]}.
    """
    if grid is None:
        grid = np.round(np.arange(0.05, 0.95, 0.05), 2)
    table = []
    best = (0.0, 0.0, 0.0, 0.0)
    for th in grid:
        tp = fp = n_gt = 0
        for p, g in zip(preds, gts):
            ps = np.asarray(p["score"]).reshape(-1)
            keep = ps >= th
            pb = np.asarray(p["bbox"], np.float64).reshape(-1, 4)[keep]
            pc = np.asarray(p["cls"]).reshape(-1)[keep]
            psc = ps[keep]
            gb = np.asarray(g["bbox"], np.float64).reshape(-1, 4)
            gc = np.asarray(g["cls"]).reshape(-1)
            n_gt += len(gb)
            order = np.argsort(-psc, kind="stable")
            used = np.zeros(len(gb), bool)
            for di in order:
                same = (gc == pc[di]) & ~used
                if not same.any():
                    fp += 1
                    continue
                ious = box_iou_matrix(pb[di][None], gb)[0]
                ious[~same] = -1.0
                j = int(np.argmax(ious))
                if ious[j] >= iou_th:
                    used[j] = True
                    tp += 1
                else:
                    fp += 1
        prec = tp / max(tp + fp, 1)
        rec = tp / max(n_gt, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        table.append((float(th), prec, rec, f1))
        if f1 > best[3]:
            best = (float(th), prec, rec, f1)
    return {"best_th": best[0], "best_f1": best[3], "table": table}


def detection_boxes(dets) -> np.ndarray:
    """(N, 4) float64 half-open [v1, u1, v2, u2) evaluation boxes of
    Detection records, whose boxes are inclusive pixel ranges: v2 and u2
    get + 1, the GT boxes' convention (``v.max() + 1``)."""
    boxes = np.asarray([d.bbox for d in dets], np.float64).reshape(-1, 4)
    return boxes + np.array([0.0, 0.0, 1.0, 1.0])


def detection_masks(dets, h: int, w: int) -> np.ndarray:
    """(N, h, w) bool masks of Detection records; a detection without a
    mask gets its (inclusive) box as its mask."""
    out = np.zeros((len(dets), h, w), bool)
    for i, d in enumerate(dets):
        if d.mask is not None:
            out[i] = d.mask
        else:
            v1, u1, v2, u2 = np.asarray(d.bbox, np.int64)
            out[i, v1:v2 + 1, u1:u2 + 1] = True
    return out


def collect_synthetic_detections(model, store, n_images: int,
                                 gen, im_size: int = 512, k_obj: int = 8,
                                 batch_size: int = 4, top_k: int = 32,
                                 score_floor: float = 0.01,
                                 decode_fn=None, with_masks: bool = False,
                                 scale_range: tuple = (0.6, 1.6)):
    """Run ``model`` (a module on the store's device) over freshly
    composed held-out scenes.

    Per batch: composition, forward and decode on the device; only the
    decoded top-k boxes come to the host. Scenes are drawn from ``gen``
    (a ``torch.Generator`` on the store's device): pass one disjoint from
    training to hold them out. ``decode_fn`` maps the model output to
    ``(bbox (B, K, 4), score (B, K), cls (B, K))``; the default is the
    CenterNet decode (for the RetinaNet head pass one built on
    :func:`pix2pose_torch.models.retinanet.decode_retinanet`). With
    ``with_masks`` (CenterNet decode only) preds and gts also carry
    per-instance "mask" arrays on the stride grid, for
    ``evaluate_detections(..., iou_type="mask")``. Returns (preds, gts)
    in :func:`evaluate_detections`' format."""
    import torch

    from pix2pose_torch.training.detector_data import make_detector_batch

    if decode_fn is None:
        from pix2pose_torch.models.detector import decode_detections

        def decode_fn(out):
            det = decode_detections(out, top_k=top_k, with_masks=with_masks)
            return det.bbox, det.score, det.cls, det.mask
    elif with_masks:
        raise ValueError("with_masks requires the default CenterNet "
                         "decode (CondInst mask head)")

    model.eval()
    preds, gts = [], []
    for _ in range((n_images + batch_size - 1) // batch_size):
        with torch.no_grad():
            batch = make_detector_batch(store, gen, batch_size, im_size,
                                        k_obj, scale_range=scale_range)
            decoded = decode_fn(model(batch["image"]))
        got = [t.cpu().numpy() for t in decoded[:3]] + [
            batch[k].cpu().numpy() for k in ("gt_bbox", "gt_cls",
                                             "gt_valid")]
        if with_masks:
            got += [decoded[3].cpu().numpy(),
                    (batch["gt_mask"] > 0.5).cpu().numpy()]
        bbox, score, cls, gt_bbox, gt_cls, gt_valid = got[:6]
        for b in range(batch_size):
            keep = score[b] >= score_floor
            pred = {"bbox": bbox[b][keep], "score": score[b][keep],
                    "cls": cls[b][keep]}
            v = gt_valid[b]
            gt = {"bbox": gt_bbox[b][v], "cls": gt_cls[b][v]}
            if with_masks:
                pred["mask"] = got[6][b][keep]
                gt["mask"] = got[7][b][v]
            preds.append(pred)
            gts.append(gt)
    return preds[:n_images], gts[:n_images]


def collect_bop_split_detections(detector, ds, target_list,
                                 min_px: int = 16):
    """Run a Detection-protocol detector over a real BOP split and format
    (preds, gts) for :func:`evaluate_detections`, classes = obj_ids.

    The deployment-domain metric the composed scenes cannot give. GT
    boxes and masks come from ``mask_visib``; instances under ``min_px``
    visible pixels are dropped from the GT (the evaluator's own skip
    rule). Detection boxes are half-open (:func:`detection_boxes`) and
    every detection has a mask (:func:`detection_masks`)."""
    from PIL import Image

    preds, gts = [], []
    seen = set()
    for scene_id, im_id, *_ in target_list:
        if (scene_id, im_id) in seen:
            continue
        seen.add((scene_id, im_id))
        rgb = ds.load_rgb(scene_id, im_id)
        h, w = rgb.shape[:2]
        dets = detector.detect(scene_id, im_id, rgb)
        pred = {"bbox": detection_boxes(dets),
                "score": np.asarray([d.score for d in dets]),
                "cls": np.asarray([d.obj_id for d in dets], np.int64),
                "mask": detection_masks(dets, h, w)}
        gt_list = ds.scene_gt(scene_id)[im_id]
        gb, gc, gm = [], [], []
        for gt_id, g in enumerate(gt_list):
            m = np.asarray(Image.open(
                ds.mask_path(scene_id, im_id, gt_id, visib=True))) > 127
            if m.sum() < min_px:
                continue
            v, u = np.where(m)
            gb.append([v.min(), u.min(), v.max() + 1, u.max() + 1])
            gc.append(g["obj_id"])
            gm.append(m)
        gt = {"bbox": np.asarray(gb, np.float64).reshape(-1, 4),
              "cls": np.asarray(gc, np.int64)}
        gt["mask"] = (np.stack(gm) if gm
                      else np.zeros((0, h, w), bool))
        preds.append(pred)
        gts.append(gt)
    return preds, gts
