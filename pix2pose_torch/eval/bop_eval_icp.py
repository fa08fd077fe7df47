"""BOP RGB-D evaluation with ICP refinement (port of
:mod:`pix2pose_tpu.eval.bop_eval_icp`).

Mirrors ``tools/5_evaluation_bop_icp3d.py``:

- per-image sensor cloud on the device: despeckle, backprojection and
  normals (``icp3d:372-374``), and the valid-depth band 0.2-2.2 m
  (``icp3d:367``)
- per-hypothesis ICP refinement + depth-consistency scoring
  (:mod:`pix2pose_torch.eval.icp_refine`; its renders are the z-buffer
  kernel on a CUDA device)
- TWO-ROUND missing-object recovery (``icp3d:394-433``): round 0 runs the
  targeted detections with occupancy-IoU gating (skip ROIs > 0.7
  covered); round 1 re-tests unused ROIs against objects whose instance
  count is still unfilled, scored 0.001 * fcn and accepted only when the
  depth-inlier ratio exceeds 0.5 (``icp3d:489,502``)
- the occupancy map of accepted inlier pixels drives the gating
  (``icp3d:392,506``)

The host orchestrates rounds and occupancy (sequential, small); the
engine, PnP, renders, ICP and scoring run on the device. The batched path
runs, per round, one :meth:`Pix2PoseEstimator.estimate_objects` call for
every (ROI, object) pair and one batched ICP refine over every surviving
hypothesis, then replays the serial gating on the host. Batches are
padded to their real size: the JAX package's power-of-two ``_bucket``,
which bounds XLA recompiles, is a TPU workaround left behind.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from pix2pose_torch.config import EvalConfig
from pix2pose_torch.data.bop import BopDataset, get_target_list, \
    save_bop_results
from pix2pose_torch.eval.bop_eval import _draw_seed, _rank_rows
from pix2pose_torch.eval.icp_refine import (make_batch_icp_refiner,
                                            make_icp_refiner, stack_meshes)
from pix2pose_torch.inference.engine import (Pix2PoseEstimator,
                                             stack_object_params)
from pix2pose_torch.ops import geometry


class BopEvaluatorICP:
    def __init__(self, dataset: BopDataset, cfg: EvalConfig,
                 estimator: Pix2PoseEstimator, params_by_obj: dict,
                 obj_params: dict, meshes_mm: dict, detector,
                 max_det: int = 8, method_name: str = "pix2pose-torch-icp",
                 batched: bool = True, icp_max_faces: int | None = 40000,
                 use_instance_masks: bool = True, icp_iters: int = 30):
        """Args:
          estimator: one shared :class:`Pix2PoseEstimator` OR a dict
            {obj_id: estimator} (per-object ``outlier_th``; see
            :func:`pix2pose_torch.inference.engine.estimators_for_objects`).
            The evaluator runs on the estimator's device.
          meshes_mm: {obj_id: (verts_mm (V,3), faces (F,3))}.
          icp_max_faces: cluster-decimate denser meshes to this many
            faces for the ICP renders (None = full meshes).
          batched: run all hypotheses of an image per round through one
            engine call and one batched ICP refine instead of the
            reference's per-ROI serial loop
            (``5_evaluation_bop_icp3d.py:58-94,392-433``). The gating is
            the serial path's, replayed on the host; the RANSAC draws
            differ.
        """
        self.ds = dataset
        self.cfg = cfg
        self.est = estimator
        self.params_by_obj = params_by_obj
        self.obj_params = obj_params
        self.detector = detector
        self.max_det = max_det
        self.method_name = method_name
        # feed detector instance masks into the engine (duplicate-instance
        # disambiguation; engine module docstring); False = reference
        # bbox-only est_pose behaviour
        self.use_instance_masks = use_instance_masks
        first = (next(iter(estimator.values())) if isinstance(estimator, dict)
                 else estimator)
        self.device = first.device
        im_w, im_h = dataset.im_size
        self.im_h, self.im_w = im_h, im_w
        if icp_max_faces is not None:
            from pix2pose_torch.data.meshes import decimate_mesh
            meshes_mm = {o: decimate_mesh(v, f, icp_max_faces)
                         for o, (v, f) in meshes_mm.items()}
        self.refiners = {
            obj_id: make_icp_refiner(np.asarray(v) / 1000.0, f, im_h, im_w,
                                     icp_iters=icp_iters, device=self.device)
            for obj_id, (v, f) in meshes_mm.items()}
        # dropped rasterizer work pairs across all refines (the port's
        # kernel has none; kept as the JAX package reports it)
        self.render_overflow = 0

        # ---- batched-path object bank ----
        self._obj_list = sorted(set(params_by_obj) & set(meshes_mm))
        self.batched = batched and bool(self._obj_list)
        if self.batched:
            self._obj_index = {o: i for i, o in enumerate(self._obj_list)}
            self._stacked_params = stack_object_params(
                [params_by_obj[o] for o in self._obj_list])
            self._obj_params_stack = np.stack(
                [np.asarray(obj_params[o], np.float32)
                 for o in self._obj_list])
            sv, sf = stack_meshes(
                [(np.asarray(meshes_mm[o][0]) / 1000.0, meshes_mm[o][1])
                 for o in self._obj_list])
            self._refine_batch = make_batch_icp_refiner(
                sv, sf, im_h, im_w, icp_iters=icp_iters, device=self.device)
            # one engine instance + runtime per-object thresholds
            if isinstance(estimator, dict):
                ests = [estimator[o] for o in self._obj_list]
                ths = [e.cfg.outlier_th for e in ests]
                if len({len(t) for t in ths}) != 1:
                    self.batched = False  # ragged T: keep the serial path
                else:
                    self._batch_est = ests[0]
                    self._outlier_th_stack = np.asarray(ths, np.float32)
            else:
                self._batch_est = estimator
                self._outlier_th_stack = np.tile(np.asarray(
                    estimator.cfg.outlier_th, np.float32)[None],
                    (len(self._obj_list), 1))

    # ------------------------------------------------------------------
    def run(self, target_list=None, out_dir: str | None = None,
            seed: int = 0):
        cfg, ds = self.cfg, self.ds
        if target_list is None:
            target_list = get_target_list(
                os.path.join(ds.dir, cfg.test_target + ".json"))
        gen = torch.Generator().manual_seed(seed)
        results = []
        scene_cams = {}
        for scene_id, im_id, obj_id_targets, inst_counts in target_list:
            if scene_id not in scene_cams:
                scene_cams[scene_id] = ds.scene_camera(scene_id)
            cam = scene_cams[scene_id][im_id]
            rgb = ds.load_rgb(scene_id, im_id)
            depth = ds.load_depth(scene_id, im_id, cam["depth_scale"])
            t1 = time.time()
            rows = self._process_image(rgb, depth, cam["cam_K"],
                                       scene_id, im_id, obj_id_targets,
                                       inst_counts, gen)
            _rank_rows(results, rows, scene_id, im_id, obj_id_targets,
                       inst_counts, time.time() - t1, cfg.task_type)
        if self.render_overflow:
            warnings.warn(
                f"{self.render_overflow} rasterizer work pairs dropped "
                "during ICP renders: depth scores may be computed on "
                "truncated renders", RuntimeWarning)
        if out_dir:
            suffix = ("-test-primesense.csv" if ds.name == "tless"
                      else "-test.csv")
            save_bop_results(
                os.path.join(out_dir, f"{self.method_name}_{ds.name}"
                             f"{suffix}"), results)
        return results

    # ------------------------------------------------------------------
    def _process_image(self, rgb, depth, cam_k, scene_id, im_id,
                       obj_id_targets, inst_counts, gen):
        fn = (self._process_image_batched if self.batched
              else self._process_image_serial)
        return fn(rgb, depth, cam_k, scene_id, im_id, obj_id_targets,
                  inst_counts, gen)

    def _sensor(self, depth, cam_k):
        """Despeckled depth (metres), camera, sensor cloud and normals on
        the device, and the valid-depth band on the host. Despeckling
        first: isolated gross depth outliers would otherwise corrupt the
        gradient normals over their whole smoothing neighbourhood."""
        d = geometry.despeckle_depth(torch.as_tensor(
            np.asarray(depth, np.float32), device=self.device))
        K = torch.as_tensor(np.asarray(cam_k, np.float32),
                            device=self.device)
        depth_valid = ((d > 0.2) & (d < 2.2)).cpu().numpy()  # icp3d:367
        return (d, K, geometry.backproject(d, K),
                geometry.normals_from_depth(d, K, refine=True), depth_valid)

    # ------------------------------------------------------------------
    # Serial path: one engine call and one refine per hypothesis, as the
    # reference's per-ROI loop. Kept as the behavioural oracle of the
    # batched path.
    def _process_image_serial(self, rgb, depth, cam_k, scene_id, im_id,
                              obj_id_targets, inst_counts, gen):
        d, K, tgt_pts, tgt_normals, depth_valid = self._sensor(depth, cam_k)
        detections = self.detector.detect(scene_id, im_id, rgb)
        rows = []
        occupancy = np.zeros(rgb.shape[:2], np.int32)
        roi_used: set[int] = set()
        inst_pred = np.zeros(len(obj_id_targets))

        for rounds in range(2):
            for r_id, det in enumerate(detections):
                if rounds == 1 and r_id in roi_used:
                    continue
                det_mask = det.mask
                if det_mask is None:
                    continue
                if rounds == 0:
                    if det.obj_id not in obj_id_targets:
                        continue
                    if _iou(occupancy == det.obj_id, det_mask) > 0.7:
                        continue  # ``icp3d:409-411``
                    candidates = [det.obj_id]
                else:
                    candidates = [
                        obj for gt_no, obj in enumerate(obj_id_targets)
                        if inst_pred[gt_no] < inst_counts[gt_no]]
                    if not candidates:
                        break
                    if _iou(occupancy != 0, det_mask) > 0.7:
                        continue  # ``icp3d:431-433``

                best = None
                for obj_id in candidates:
                    if obj_id not in self.params_by_obj:
                        continue
                    pose = self._est_pose_single(rgb, cam_k, obj_id,
                                                 det.bbox, _draw_seed(gen),
                                                 mask=det_mask)
                    if pose is None:
                        continue
                    R0, t0 = pose
                    if t0[2] / 1000.0 < 0.2:  # ``icp3d:451-452``
                        continue
                    union = det_mask & depth_valid
                    if union.sum() <= 30:  # ``icp3d:457-460``
                        continue
                    dev = self.device
                    ref = self.refiners[obj_id](
                        torch.as_tensor(R0, device=dev),
                        torch.as_tensor(t0, device=dev), K,
                        torch.as_tensor(union, device=dev), d, tgt_pts,
                        tgt_normals)
                    fcn = float(ref.score)
                    self.render_overflow += int(ref.overflow)
                    score = (det.score * fcn if rounds == 0
                             else 0.001 * fcn)  # ``icp3d:487-489``
                    if best is None or score > best["score"]:
                        best = {"obj_id": obj_id, "score": score,
                                "R": ref.R.cpu().numpy(),
                                "t": ref.t_mm.cpu().numpy(),
                                "ratio": float(ref.ratio),
                                "inlier": ref.inlier_mask.cpu().numpy()}
                self._accept(best, rounds, r_id, obj_id_targets, inst_pred,
                             occupancy, roi_used, rows)
        return rows

    @staticmethod
    def _accept(best, rounds, r_id, obj_id_targets, inst_pred, occupancy,
                roi_used, rows):
        """The reference's acceptance of a ROI's best hypothesis
        (``icp3d:494-510``): a positive score is a row; it fills an
        instance and the occupancy map in round 0, or in round 1 when the
        depth-inlier ratio exceeds 0.5."""
        if best is None or best["score"] <= 0:
            return
        if rounds == 0 or best["ratio"] > 0.5:  # ``icp3d:502``
            gt_no = obj_id_targets.index(best["obj_id"])
            inst_pred[gt_no] += 1
            occupancy[best["inlier"]] = best["obj_id"]
            roi_used.add(r_id)
        rows.append({"obj_id": best["obj_id"], "score": best["score"],
                     "R": best["R"], "t": best["t"]})

    # ------------------------------------------------------------------
    # Batched path: per round, ONE engine call for every (ROI,
    # candidate-object) pair plus ONE batched ICP refine; the reference's
    # sequential gating (occupancy IoU, instance fill, round-1 acceptance)
    # is replayed on the host from the batched outputs. Gating decides
    # only which results are USED: hypothesis computation does not depend
    # on it, so the rows match the serial path's.
    def _process_image_batched(self, rgb, depth, cam_k, scene_id, im_id,
                               obj_id_targets, inst_counts, gen):
        d, K, tgt_pts, tgt_normals, depth_valid = self._sensor(depth, cam_k)
        detections = self.detector.detect(scene_id, im_id, rgb)
        rows = []
        occupancy = np.zeros(rgb.shape[:2], np.int32)
        roi_used: set[int] = set()
        inst_pred = np.zeros(len(obj_id_targets))

        for rounds in range(2):
            # 1. candidate (r_id, obj_id) pairs: a superset of what the
            # gating replay will use (the round-1 unfilled set only
            # shrinks)
            if rounds == 0:
                pairs = [
                    (r_id, det.obj_id)
                    for r_id, det in enumerate(detections)
                    if det.mask is not None
                    and det.obj_id in obj_id_targets
                    and det.obj_id in self._obj_index]
            else:
                unfilled = [
                    obj for gt_no, obj in enumerate(obj_id_targets)
                    if inst_pred[gt_no] < inst_counts[gt_no]
                    and obj in self._obj_index]
                if not unfilled:
                    break
                pairs = [
                    (r_id, obj) for r_id, det in enumerate(detections)
                    if r_id not in roi_used and det.mask is not None
                    for obj in unfilled]
            if not pairs:
                continue

            poses = self._estimate_pairs(rgb, cam_k, detections, pairs,
                                         _draw_seed(gen))
            refined = self._refine_pairs(detections, pairs, poses,
                                         depth_valid, K, d, tgt_pts,
                                         tgt_normals)

            # 2. replay the serial gating in detection order
            for r_id, det in enumerate(detections):
                if rounds == 1 and r_id in roi_used:
                    continue
                if det.mask is None:
                    continue
                if rounds == 0:
                    if det.obj_id not in obj_id_targets:
                        continue
                    if _iou(occupancy == det.obj_id, det.mask) > 0.7:
                        continue  # ``icp3d:409-411``
                    candidates = [det.obj_id]
                else:
                    candidates = [
                        obj for gt_no, obj in enumerate(obj_id_targets)
                        if inst_pred[gt_no] < inst_counts[gt_no]]
                    if not candidates:
                        break
                    if _iou(occupancy != 0, det.mask) > 0.7:
                        continue  # ``icp3d:431-433``

                best = None
                for obj_id in candidates:
                    r = refined.get((r_id, obj_id))
                    if r is None:
                        continue
                    score = (det.score * r["fcn"] if rounds == 0
                             else 0.001 * r["fcn"])  # ``icp3d:487-489``
                    if best is None or score > best["score"]:
                        best = dict(r, obj_id=obj_id, score=score)
                self._accept(best, rounds, r_id, obj_id_targets, inst_pred,
                             occupancy, roi_used, rows)
        return rows

    def _estimate_pairs(self, rgb, cam_k, detections, pairs, seed):
        """One engine call for every (ROI, object) pair: pairs are packed
        into per-object detection slots of an (O, N) grid, N the largest
        number of pairs of one object. Returns {(r_id, obj_id): (R, t)}
        for pairs with a valid pose."""
        n_obj = len(self._obj_list)
        per_obj: dict[int, list[int]] = {}
        for r_id, obj in pairs:
            per_obj.setdefault(self._obj_index[obj], []).append(r_id)
        n_pad = max(len(v) for v in per_obj.values())
        bboxes = np.zeros((n_obj, n_pad, 4), np.int32)
        valid = np.zeros((n_obj, n_pad), bool)
        have_masks = self.use_instance_masks and all(
            detections[r_id].mask is not None for r_id, _ in pairs)
        det_masks = (np.zeros((n_obj, n_pad) + rgb.shape[:2], bool)
                     if have_masks else None)
        slots = {}
        for o_idx, r_ids in per_obj.items():
            for s, r_id in enumerate(r_ids):
                bboxes[o_idx, s] = detections[r_id].bbox
                valid[o_idx, s] = True
                if have_masks:
                    det_masks[o_idx, s] = detections[r_id].mask
                slots[(r_id, self._obj_list[o_idx])] = (o_idx, s)

        out = self._batch_est.estimate_objects(
            self._stacked_params, rgb, bboxes, valid, cam_k,
            self._obj_params_stack,
            torch.Generator(device=self.device).manual_seed(seed),
            self._outlier_th_stack, det_masks=det_masks)
        ok = out.valid.cpu().numpy()
        R = out.R.cpu().numpy()
        t = out.t.cpu().numpy()
        return {pair: (R[o, s], t[o, s])
                for pair, (o, s) in slots.items() if ok[o, s]}

    def _refine_pairs(self, detections, pairs, poses, depth_valid, K, d,
                      tgt_pts, tgt_normals):
        """One batched ICP refine over all surviving hypotheses. Applies
        the serial path's pre-filters (pose found, t_z >= 200 mm
        ``icp3d:451-452``, union > 30 px ``icp3d:457-460``) and returns
        {(r_id, obj_id): {fcn, ratio, R, t, inlier}}."""
        unions = {}
        hyps = []
        for r_id, obj_id in pairs:
            pose = poses.get((r_id, obj_id))
            if pose is None:
                continue
            R0, t0 = pose
            if t0[2] / 1000.0 < 0.2:
                continue
            if r_id not in unions:
                unions[r_id] = detections[r_id].mask & depth_valid
            if unions[r_id].sum() <= 30:
                continue
            hyps.append((r_id, obj_id, R0, t0))
        if not hyps:
            return {}

        dev = self.device
        ref = self._refine_batch(
            [self._obj_index[o] for _, o, _, _ in hyps],
            torch.as_tensor(np.stack([h[2] for h in hyps]), device=dev),
            torch.as_tensor(np.stack([h[3] for h in hyps]), device=dev), K,
            torch.as_tensor(np.stack([unions[h[0]] for h in hyps]),
                            device=dev), d, tgt_pts, tgt_normals)
        fcn = ref.score.cpu().numpy()
        ratio = ref.ratio.cpu().numpy()
        self.render_overflow += int(torch.as_tensor(ref.overflow).sum())
        R_ref = ref.R.cpu().numpy()
        t_ref = ref.t_mm.cpu().numpy()
        inlier = ref.inlier_mask.cpu().numpy()
        return {(r_id, obj_id): {
                    "fcn": float(fcn[i]), "ratio": float(ratio[i]),
                    "R": R_ref[i], "t": t_ref[i], "inlier": inlier[i]}
                for i, (r_id, obj_id, _, _) in enumerate(hyps)}

    def _est_for(self, obj_id) -> Pix2PoseEstimator:
        if isinstance(self.est, dict):
            return self.est[obj_id]
        return self.est

    def _est_pose_single(self, rgb, cam_k, obj_id, bbox, seed, mask=None):
        n = self.max_det
        bboxes = np.zeros((n, 4), np.int32)
        bboxes[0] = bbox
        valid = np.zeros(n, bool)
        valid[0] = True
        det_masks = None
        if mask is not None and self.use_instance_masks:
            det_masks = np.zeros((n,) + rgb.shape[:2], bool)
            det_masks[0] = mask
        out = self._est_for(obj_id)(
            self.params_by_obj[obj_id], rgb, bboxes, valid, cam_k,
            self.obj_params[obj_id],
            torch.Generator(device=self.device).manual_seed(seed),
            det_masks=det_masks)
        if not bool(out.valid[0]):
            return None
        return out.R[0].cpu().numpy(), out.t[0].cpu().numpy()


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return np.logical_and(a, b).sum() / union


def main(argv=None):
    """CLI mirroring ``python3 tools/5_evaluation_bop_icp3d.py <gpu> <cfg>
    <dataset>``; ``--device`` (default ``cuda``) replaces the gpu
    argument, and without a CUDA device the command refuses to start
    unless ``--device cpu`` is given."""
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.ply import load_ply
    from pix2pose_torch.inference.detector import (GtDetector,
                                                   PrecomputedDetector)
    from pix2pose_torch.inference.engine import estimators_for_objects
    from pix2pose_torch.models import build_generator
    from pix2pose_torch.utils.cli import (load_generators, load_norm_params,
                                          require_device)

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch eval-icp")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("--detections", default=None)
    p.add_argument("--max-det", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device of the models and kernels")
    args = p.parse_args(argv)
    device = require_device(args.device)

    cfg = load_eval_config(args.cfg)
    ds = BopDataset(cfg.dataset_dir, args.dataset, train=False)
    model = build_generator(cfg.backbone)
    # per-object estimator configs (``5_evaluation_bop_basic.py:164-170``)
    est = estimators_for_objects(model, cfg, ds.model_ids, device=device)
    params_by_obj = load_generators(
        ds, model, [o for o in ds.model_ids
                    if not cfg.target_obj or o in cfg.target_obj], device)
    obj_params = load_norm_params(ds, params_by_obj, cfg.norm_factor_fn)
    meshes = {}
    for obj_id in params_by_obj:
        mesh = load_ply(ds.model_ply_path(obj_id))
        meshes[obj_id] = (mesh["pts"], mesh["faces"])

    detector = (PrecomputedDetector(args.detections) if args.detections
                else GtDetector(ds))
    ev = BopEvaluatorICP(ds, cfg, est, params_by_obj, obj_params, meshes,
                         detector, max_det=args.max_det)
    results = ev.run(out_dir=cfg.path_to_output)
    print(f"{len(results)} results written to {cfg.path_to_output}")


if __name__ == "__main__":
    main()
