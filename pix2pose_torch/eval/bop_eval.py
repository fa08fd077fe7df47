"""BOP RGB evaluation (port of :mod:`pix2pose_tpu.eval.bop_eval`).

Mirrors ``tools/5_evaluation_bop_basic.py``:

- per-image target filtering and candidate capping
  ``inst_counts * cand_factor`` (``basic:289-299``)
- score_type 1 (detector score) / 2 (det_score * frac_inlier * mask_iou *
  union, ``basic:307-316``)
- per-image score normalization by the max, descending sort
  (``basic:325-328``)
- task_type 2 (ViVo): keep at most inst_count results per object and at
  most sum(inst_counts) in all (``basic:335-349``)
- BOP CSV output with per-image wall time (``basic:329,345,353-359``)

All detections of one object in an image run through the engine in one
batch, and ``run(image_chunk=B)`` runs each object's detections of B
images in one :meth:`Pix2PoseEstimator.estimate_batch` call. The
score_type-2 mask IoU and union are a gather of the detector mask at the
stage-2 grid centres on the device, not full-resolution host numpy.

RANSAC draws: a CPU ``torch.Generator`` seeded by ``run(seed=...)`` draws
one integer per (image, object, detection chunk) of the serial plan; each
seeds the device generator of that plan entry, so the chunked drive
replays the serial one draw for draw.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.config import EvalConfig
from pix2pose_torch.data.bop import BopDataset, get_target_list, \
    save_bop_results
from pix2pose_torch.inference.engine import Pix2PoseEstimator
from pix2pose_torch.ops import crop as crop_ops


def _mask_scores(det_masks, box2, mask_pnp, stride: int = 2):
    """score_type-2 ingredients on the stage-2 grid, for any leading axes:
    det_masks (..., H, W) bool, box2 (...) boxes, mask_pnp (..., G, G).

    Reference (``basic:307-316``): mask_iou = |det & pred| / |det | pred|,
    union = |det | pred| in full-res pixels. The detector mask is sampled
    at the rounded stage-2 grid centres (integer math, as the JAX
    package's ``_mask_scores`` / ``_mask_scores_many``) and the union count
    is scaled by the window area per grid cell. Returns (iou, union)."""
    size = mask_pnp.shape[-1] * stride
    vv, uu, in_img = (x[..., ::stride, ::stride]
                      for x in crop_ops.crop_pixel_centers(box2, size))
    h, w = det_masks.shape[-2:]
    vi = torch.clamp(torch.round(vv).to(torch.int32), 0, h - 1)
    ui = torch.clamp(torch.round(uu).to(torch.int32), 0, w - 1)
    flat = (vi.to(torch.int64) * w + ui).reshape(vi.shape[:-2] + (-1,))
    det_g = torch.gather(det_masks.reshape(det_masks.shape[:-2] + (-1,)),
                         -1, flat).reshape(vi.shape) & in_img
    inter = (det_g & mask_pnp).sum((-2, -1))
    union = (det_g | mask_pnp).sum((-2, -1))
    iou = inter / torch.clamp(union, min=1)
    area = (box2.height * box2.width).to(torch.float32) / float(
        (size // stride) ** 2)
    return iou, union.to(torch.float32) * area


def _draw_seed(gen) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=gen))


class BopEvaluator:
    """Runs the full RGB evaluation loop over a target list."""

    def __init__(self, dataset: BopDataset, cfg: EvalConfig,
                 estimator: Pix2PoseEstimator, params_by_obj: dict,
                 obj_params: dict, detector, max_det: int = 8,
                 method_name: str = "pix2pose-torch",
                 use_instance_masks: bool = True):
        """Args:
          estimator: one shared :class:`Pix2PoseEstimator` OR a dict
            {obj_id: estimator} for per-object configs (the reference's
            per-object ``outlier_th`` resolution,
            ``5_evaluation_bop_basic.py:164-170``); build the dict with
            :func:`pix2pose_torch.inference.engine.estimators_for_objects`.
          params_by_obj: {obj_id: generator state dict on the device}.
          obj_params: {obj_id: (6,) norm-factor vector}.
          detector: object with ``detect(scene_id, im_id, rgb)``.
          use_instance_masks: feed detector instance masks into the
            engine (duplicate-instance disambiguation; see the engine
            module docstring). False = reference bbox-only behaviour.
        """
        self.ds = dataset
        self.cfg = cfg
        self.est = estimator
        self.params_by_obj = params_by_obj
        self.obj_params = obj_params
        self.detector = detector
        self.max_det = max_det
        self.method_name = method_name
        self.use_instance_masks = use_instance_masks

    # ------------------------------------------------------------------
    def _est_for(self, obj_id) -> Pix2PoseEstimator:
        if isinstance(self.est, dict):
            return self.est[obj_id]
        return self.est

    def warmup(self):
        """One pass of every distinct estimator on a zero image before the
        timed recognition, the reference's ``dummy_run``
        (``5_evaluation_bop_basic.py:235-242``): it keeps cuDNN's first-
        call cost out of the ``time`` column."""
        if not self.params_by_obj:
            return
        im_w, im_h = self.ds.im_size
        rgb = np.zeros((im_h, im_w, 3), np.uint8)
        bboxes = np.zeros((self.max_det, 4), np.int32)
        bboxes[0] = [0, 0, 128, 128]
        valid = np.zeros(self.max_det, bool)
        valid[0] = True
        cam_k = self.ds.cam_k if self.ds.cam_k is not None else np.eye(
            3, dtype=np.float32)
        seen = set()
        for obj_id in self.params_by_obj:
            est = self._est_for(obj_id)
            if id(est) in seen:
                continue
            seen.add(id(est))
            gen = torch.Generator(device=est.device).manual_seed(0)
            est(self.params_by_obj[obj_id], rgb, bboxes, valid, cam_k,
                self.obj_params[obj_id], gen).R.cpu()

    # ------------------------------------------------------------------
    def run(self, target_list=None, out_dir: str | None = None,
            seed: int = 0, image_chunk: int | None = None) -> list:
        """Drive the evaluation. ``image_chunk=None`` runs the engine per
        (image, object) like the reference loop; ``image_chunk=B`` runs
        each object's detections of B images in ONE ``estimate_batch``
        call. Candidate capping, RANSAC draws, scoring and ViVo ranking
        are the same in both modes (the chunked path replays the serial
        per-image plan); only the per-image ``time`` column differs
        (chunk wall-clock / images in the chunk)."""
        cfg = self.cfg
        ds = self.ds
        if target_list is None:
            target_list = get_target_list(
                os.path.join(ds.dir, cfg.test_target + ".json"))
        gen = torch.Generator().manual_seed(seed)

        results = []
        scene_cams = {}

        def cam_for(scene_id, im_id):
            if scene_id not in scene_cams:
                scene_cams[scene_id] = ds.scene_camera(scene_id)
            return scene_cams[scene_id][im_id]["cam_K"]

        if image_chunk:
            for c0 in range(0, len(target_list), image_chunk):
                chunk = target_list[c0:c0 + image_chunk]
                rows_per_img, dt = self._process_chunk(chunk, cam_for, gen)
                for (scene_id, im_id, obj_id_targets, inst_counts), rows \
                        in zip(chunk, rows_per_img):
                    _rank_rows(results, rows, scene_id, im_id,
                               obj_id_targets, inst_counts, dt,
                               cfg.task_type)
        else:
            for scene_id, im_id, obj_id_targets, inst_counts in \
                    target_list:
                cam_k = cam_for(scene_id, im_id)
                rgb = ds.load_rgb(scene_id, im_id)

                t1 = time.time()
                detections = self.detector.detect(scene_id, im_id, rgb)
                rows = []
                for obj_id, dets, s in self._image_plan(
                        detections, obj_id_targets, inst_counts, gen):
                    rows.extend(self._run_chunk(rgb, cam_k, obj_id, dets,
                                                s))
                _rank_rows(results, rows, scene_id, im_id, obj_id_targets,
                           inst_counts, time.time() - t1, cfg.task_type)

        if out_dir:
            suffix = ("-test-primesense.csv" if ds.name == "tless"
                      else "-test.csv")
            path = os.path.join(out_dir,
                                f"{self.method_name}_{ds.name}{suffix}")
            save_bop_results(path, results)
        return results

    # ------------------------------------------------------------------
    def _image_plan(self, detections, obj_id_targets, inst_counts,
                    gen) -> list:
        """Candidate capping (``basic:289-299``) and one seed drawn from
        ``gen`` per (object, detection chunk), in serial order. Shared by
        both drive modes so the chunked path replays the per-image plan.

        Returns [(obj_id, dets (<= max_det), seed), ...]."""
        cfg = self.cfg
        inst_count_pred = np.zeros(len(obj_id_targets))
        picked: dict[int, list] = {}
        for det in detections:
            if det.obj_id not in obj_id_targets:
                continue
            gt_no = obj_id_targets.index(det.obj_id)
            if inst_count_pred[gt_no] > inst_counts[gt_no] * cfg.cand_factor:
                continue
            inst_count_pred[gt_no] += 1
            picked.setdefault(det.obj_id, []).append(det)

        plan = []
        for obj_id, dets in picked.items():
            if obj_id not in self.params_by_obj:
                continue
            for chunk_start in range(0, len(dets), self.max_det):
                plan.append((obj_id,
                             dets[chunk_start:chunk_start + self.max_det],
                             _draw_seed(gen)))
        return plan

    def _slots(self, dets, im_hw):
        """Padded (max_det) boxes, validity and, when every detection has
        one, instance masks (else None)."""
        n = self.max_det
        bboxes = np.zeros((n, 4), np.int32)
        valid = np.zeros(n, bool)
        for i, d in enumerate(dets):
            bboxes[i] = d.bbox
            valid[i] = True
        masks = None
        if all(d.mask is not None for d in dets):
            masks = np.zeros((n,) + tuple(im_hw), bool)
            for i, d in enumerate(dets):
                masks[i] = d.mask
        return bboxes, valid, masks

    def _rows(self, obj_id, dets, out, iou, union) -> list:
        """Result rows of one (object, detection chunk) from its engine
        output (host arrays of (N,) / (N, 3, 3) / (N, 3)); iou is None
        unless score_type 2 applies."""
        rows = []
        for i, d in enumerate(dets):
            if not out["valid"][i]:
                continue  # frac_inlier == -1 (``basic:305-306``)
            if iou is not None:
                score = (d.score * float(out["frac"][i]) * float(iou[i])
                         * float(union[i]))  # ``basic:316``
            else:
                score = d.score  # ``basic:317-318``
            rows.append({"obj_id": obj_id, "score": score,
                         "R": out["R"][i], "t": out["t"][i]})
        return rows

    def _run_engine(self, obj_id, rgbs, bboxes, valid, cams, masks, seeds):
        """One ``estimate_batch`` call over B images (leading axis on every
        argument; ``masks`` (B, N, H, W) or None) with one generator per
        image. Returns (host outputs, iou, union), the latter two None
        unless score_type 2 applies."""
        est = self._est_for(obj_id)
        dev = est.device
        gens = [torch.Generator(device=dev).manual_seed(s) for s in seeds]
        dm = None if masks is None else torch.as_tensor(masks, device=dev)
        out = est.estimate_batch(
            self.params_by_obj[obj_id], rgbs, bboxes, valid, cams,
            self.obj_params[obj_id], gens,
            det_masks=dm if self.use_instance_masks else None)
        iou = union = None
        if self.cfg.score_type == 2 and dm is not None:
            iou, union = (x.cpu().numpy() for x in _mask_scores(
                dm, out.box2, out.mask_pnp, est.pnp_stride))
        host = {"valid": out.valid.cpu().numpy(),
                "frac": out.frac_inlier.cpu().numpy(),
                "R": out.R.cpu().numpy(), "t": out.t.cpu().numpy()}
        return host, iou, union

    def _run_chunk(self, rgb, cam_k, obj_id, dets, seed) -> list:
        """One (image, object, detection chunk) through the engine."""
        bboxes, valid, masks = self._slots(dets, rgb.shape[:2])
        out, iou, union = self._run_engine(
            obj_id, rgb[None], bboxes[None], valid[None],
            np.asarray(cam_k, np.float32)[None],
            None if masks is None else masks[None], [seed])
        return self._rows(obj_id, dets, {k: v[0] for k, v in out.items()},
                          None if iou is None else iou[0],
                          None if union is None else union[0])

    # ------------------------------------------------------------------
    # image-chunked drive: one estimate_batch call per (object, masks
    # available) group of a chunk of images
    def _process_chunk(self, chunk, cam_for, gen):
        t1 = time.time()
        per_img = []
        for scene_id, im_id, obj_id_targets, inst_counts in chunk:
            cam_k = cam_for(scene_id, im_id)
            rgb = self.ds.load_rgb(scene_id, im_id)
            detections = self.detector.detect(scene_id, im_id, rgb)
            per_img.append((rgb, cam_k, self._image_plan(
                detections, obj_id_targets, inst_counts, gen)))

        # group plan entries by (object, masks available); remember each
        # entry's position in its image plan so the row order (and so
        # the tie order in _rank_rows) matches the serial path
        groups: dict = {}
        for img_idx, (_, _, plan) in enumerate(per_img):
            for pos, (obj_id, dets, s) in enumerate(plan):
                have_masks = all(d.mask is not None for d in dets)
                groups.setdefault((obj_id, have_masks), []).append(
                    (img_idx, pos, dets, s))

        by_slot: dict = {}
        for (obj_id, _), entries in groups.items():
            for (img_idx, pos), rows in self._run_group(per_img, obj_id,
                                                        entries):
                by_slot[(img_idx, pos)] = rows
        rows_per_img = []
        for img_idx, (_, _, plan) in enumerate(per_img):
            rows = []
            for pos in range(len(plan)):
                rows.extend(by_slot.get((img_idx, pos), []))
            rows_per_img.append(rows)
        dt = (time.time() - t1) / max(len(chunk), 1)
        return rows_per_img, dt

    def _run_group(self, per_img, obj_id, entries):
        """One batched engine call for every (image, detection chunk)
        entry of one object: B = the number of entries (no padding).
        Returns [((img_idx, plan_pos), rows), ...]."""
        slots = [self._slots(dets, per_img[img_idx][0].shape[:2])
                 for img_idx, _, dets, _ in entries]
        have_masks = all(s[2] is not None for s in slots)
        out, iou, union = self._run_engine(
            obj_id, np.stack([per_img[e[0]][0] for e in entries]),
            np.stack([s[0] for s in slots]), np.stack([s[1] for s in slots]),
            np.stack([np.asarray(per_img[e[0]][1], np.float32)
                      for e in entries]),
            np.stack([s[2] for s in slots]) if have_masks else None,
            [e[3] for e in entries])
        return [((img_idx, pos), self._rows(
                    obj_id, dets, {k: v[e] for k, v in out.items()},
                    None if iou is None else iou[e],
                    None if union is None else union[e]))
                for e, (img_idx, pos, dets, _) in enumerate(entries)]


def _rank_rows(results, rows, scene_id, im_id, obj_id_targets, inst_counts,
              time_spend, task_type) -> None:
    """Per-image score normalization + ViVo capping (``basic:325-349``;
    the same in the RGB-D evaluator, ``icp3d``); appends the accepted rows
    to ``results``. The numpy ``argsort`` of ``1 - scores`` is the JAX
    package's call, so ties fall in the same order."""
    if not rows:
        return
    scores = np.array([r["score"] for r in rows])
    scores = scores / max(scores.max(), 1e-12)  # ``basic:327``
    order = np.argsort(1 - scores)
    inst_count_est = np.zeros(len(inst_counts))
    total_inst = 0
    n_inst = int(np.sum(inst_counts))
    for ridx in order:
        row = rows[ridx]
        gt_no = obj_id_targets.index(row["obj_id"])
        inst_count_est[gt_no] += 1
        if task_type == 2 and inst_count_est[gt_no] > inst_counts[gt_no]:
            continue  # ``basic:342-344``
        results.append({
            "scene_id": scene_id, "im_id": im_id,
            "obj_id": row["obj_id"], "score": float(scores[ridx]),
            "R": row["R"], "t": row["t"], "time": time_spend})
        total_inst += 1
        if task_type == 2 and total_inst > n_inst:
            break  # ``basic:348-349``


def main(argv: Sequence[str] | None = None):
    """CLI mirroring ``python3 tools/5_evaluation_bop_basic.py <gpu> <cfg>
    <dataset>``; ``--device`` (default ``cuda``) replaces the gpu
    argument, and without a CUDA device the command refuses to start
    unless ``--device cpu`` is given."""
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.inference.detector import (GtDetector,
                                                   PrecomputedDetector)
    from pix2pose_torch.inference.engine import estimators_for_objects
    from pix2pose_torch.models import build_generator
    from pix2pose_torch.utils.cli import (load_generators, load_norm_params,
                                          load_torch_detector,
                                          require_device)

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch eval")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("--detections", default=None,
                   help="precomputed detections json; default: GT detector")
    p.add_argument("--detector", choices=["gt", "centernet"], default="gt",
                   help="gt masks or the trained in-repo detector")
    p.add_argument("--max-det", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models")
    args = p.parse_args(argv)
    device = require_device(args.device)

    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset, train=False)
    model = build_generator(cfg.backbone)
    # one estimator per object: per-object outlier_th configs resolve like
    # the reference (``5_evaluation_bop_basic.py:164-170,206-225``)
    est = estimators_for_objects(model, cfg, ds.model_ids, device=device)
    params_by_obj = load_generators(
        ds, model, [o for o in ds.model_ids
                    if not cfg.target_obj or o in cfg.target_obj], device)
    obj_params = load_norm_params(ds, params_by_obj, cfg.norm_factor_fn)

    if args.detections:
        detector = PrecomputedDetector(args.detections)
    elif args.detector == "centernet":
        detector = load_torch_detector(ds, device)
    else:
        detector = GtDetector(ds)
    ev = BopEvaluator(ds, cfg, est, params_by_obj, obj_params, detector,
                      max_det=args.max_det)
    ev.warmup()  # reference dummy_run (``basic:235-242``)
    results = ev.run(out_dir=cfg.path_to_output)
    print(f"{len(results)} results written to {cfg.path_to_output}")


if __name__ == "__main__":
    main()
