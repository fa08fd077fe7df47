"""The whole reference flow in one command (port of
:mod:`pix2pose_tpu.tools.rehearsal`).

Runs ``README.md:96-115`` end to end on the synthetic BOP-format dataset
(:mod:`pix2pose_torch.data.synthetic_bop`: duplicate same-class
instances, discrete and continuous symmetry, a UV-textured object), with
no ground truth at inference: scene generation, colorize, training pairs,
the four generators (:mod:`pix2pose_torch.training.multi`) and the
CenterNet detector, then ``eval`` and ``eval-icp`` over both detector
transports, the in-process :class:`TorchDetector` and the reference's
file interchange (detections dumped to JSON and replayed through
:class:`PrecomputedDetector`, ``tools/mask_rcnn_util.py:67-133``)::

    python -m pix2pose_torch rehearsal [--gan-steps 6000 --det-steps 3000]
        [--root DIR] [--no-icp] [--device cuda]

Everything runs on ``--device`` (default ``cuda``); without a CUDA device
the command refuses to start unless ``--device cpu`` is given. It writes
the AR per evaluator and transport, box and mask mAP, the BOP CSVs, the
trained weights (``weights.pt``, for ``torch.load``: generator and
detector state dicts, ``obj_params`` as (6,) tensors, ``locks``; written
before any evaluation) and ``rehearsal_summary.json`` under
``<root>/out``. The summary has the JAX
tool's keys, and ``stage_s``: each stage's wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from pix2pose_torch.config import EvalConfig, TrainConfig
from pix2pose_torch.data.bop import BopDataset, get_target_list
from pix2pose_torch.data.ply import load_ply
from pix2pose_torch.data.synthetic_bop import build_rehearsal_dataset
from pix2pose_torch.eval.bop_eval import BopEvaluator
from pix2pose_torch.eval.bop_eval_icp import BopEvaluatorICP
from pix2pose_torch.eval.detection_metrics import (
    collect_bop_split_detections, collect_synthetic_detections,
    evaluate_detections)
from pix2pose_torch.eval.metrics import evaluate_bop
from pix2pose_torch.inference.detector import PrecomputedDetector
from pix2pose_torch.inference.engine import Pix2PoseEstimator
from pix2pose_torch.inference.torch_detector import TorchDetector
from pix2pose_torch.models import AutoEncoder
from pix2pose_torch.models.detector import CenterNetDetector
from pix2pose_torch.ops.color import obj_param_from_norm_factor
from pix2pose_torch.tools.colorize_models import colorize_dataset
from pix2pose_torch.tools.render_training_pairs import render_object_pairs
from pix2pose_torch.tools.run_detector import encode_rle, export_detections
from pix2pose_torch.training.data import PatchStore
from pix2pose_torch.training.detector_data import (DetectorStore,
                                                   make_detector_batch)
from pix2pose_torch.training.detector_train import (create_detector_state,
                                                    make_detector_step)
from pix2pose_torch.training.multi import make_multi_step, new_object_run
from pix2pose_torch.utils.symmetry import training_sym_pool

# the JAX tool's names for run-detector's RLE and JSON writer, which
# write the same format (row-major runs from a False run; boxes, scores,
# RLE instance masks)
_rle_encode = encode_rle
dump_detections = export_detections


def _detector_scale_range(ds, det_im, patch_px=128, margin=1.3):
    """Patch-placement scale range matched to the split's apparent
    instance sizes in the detector's (det_im, det_im) input frame: the
    5th and 95th percentiles of the visible masks' longest side after the
    anisotropic resize, over the first 12 images of each scene, divided
    and multiplied by ``margin``. The composer's default (0.6, 1.6) trains
    on 77-205 px instances while these objects appear at ~30-65 px, and
    the detector then merges adjacent duplicates into one box."""
    from PIL import Image

    im_w, im_h = ds.im_size
    sizes = []
    for scene_id in ds.scene_ids():
        for im_id, gt_list in sorted(ds.scene_gt(scene_id).items())[:12]:
            for gt_id in range(len(gt_list)):
                p = ds.mask_path(scene_id, im_id, gt_id, visib=True)
                if not os.path.exists(p):
                    continue
                m = np.asarray(Image.open(p)) > 127
                if m.sum() < 64:
                    continue
                v, u = np.where(m)
                sizes.append(max((v.max() - v.min() + 1) * det_im / im_h,
                                 (u.max() - u.min() + 1) * det_im / im_w))
    if not sizes:
        return (0.6, 1.6)
    lo = float(np.percentile(sizes, 5)) / patch_px / margin
    hi = float(np.percentile(sizes, 95)) / patch_px * margin
    return (max(round(lo, 2), 0.08), min(round(hi, 2), 1.6))


def rehearsal_backs(back_dir):
    """The seeded backgrounds: 5 noise images and 3 solid ones (the solid
    ones keep the test split's plain white frame in the detector's
    domain; the composer's flat-background branch covers only mid-gray
    values)."""
    from PIL import Image

    os.makedirs(back_dir, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(5):
        Image.fromarray(rng.randint(0, 255, (120, 160, 3)).astype(
            np.uint8)).save(os.path.join(back_dir, f"b{i}.png"))
    for i, val in enumerate((255, 230, 160)):
        Image.fromarray(np.full((120, 160, 3), val, np.uint8)).save(
            os.path.join(back_dir, f"s{i}.png"))


def _gan_lr(it, steps):
    return 1e-3 if it < steps // 2 else (
        3e-4 if it < steps * 4 // 5 else 1e-4)


def _det_lr(it, steps):
    return 1e-4 if it > steps * 0.8 else 3e-4 * min(1.0, (it + 1) / 200)


def run_rehearsal(out_root=None, gan_steps=6000, det_steps=3000,
                  n_train=48, n_test=6, det_batch=8, det_im=384,
                  det_k_obj=8, map_images=32, icp=True, seed=0,
                  det_score_th=0.2, device="cuda"):
    """The full pipeline on ``device``; returns the summary dict."""
    dev = torch.device(device)
    root = out_root or tempfile.mkdtemp(prefix="rehearsal_")
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir, exist_ok=True)
    summary = {"root": root}
    stage_s = {}
    t_all = t_stage = time.time()

    def stage(name):
        nonlocal t_stage
        now = time.time()
        stage_s[name] = round(now - t_stage, 2)
        t_stage = now

    # ---- 1. dataset (scene generation, ``1_1``, and the test split) ----
    print(f"[rehearsal] building dataset under {root}", flush=True)
    build_rehearsal_dataset(root, n_train=n_train, n_test=n_test, seed=seed,
                            device=dev)
    ds_train = BopDataset(root, "rehearsal", train=True)
    ds_test = BopDataset(root, "rehearsal", train=False)
    obj_ids = list(ds_train.model_ids)
    stage("dataset")

    # ---- 2. colorize (``2_1``) ----
    norm = colorize_dataset(ds_train)
    stage("colorize")

    # ---- 3. training pairs (``2_2``: symmetry canonicalization, locks) ----
    locks = {}
    for o in obj_ids:
        n = render_object_pairs(ds_train, o, device=dev)
        with open(os.path.join(ds_train.dir, "train_xyz", f"{o:02d}",
                               "meta.json")) as f:
            locks[o] = json.load(f)["rotation_lock"]
        print(f"[rehearsal] obj {o}: {n} pairs (lock={locks[o]})",
              flush=True)
    back_dir = os.path.join(root, "backs")
    rehearsal_backs(back_dir)
    stores = {o: PatchStore.load(
        os.path.join(ds_train.dir, "train_xyz", f"{o:02d}"), back_dir,
        device=dev) for o in obj_ids}
    stage("pairs")

    # ---- 4. the generators (``3_train`` x objects) ----
    cfg = TrainConfig(batch_size=32)
    runs = [new_object_run(o, stores[o], training_sym_pool(ds_train, o),
                           not locks[o], cfg, 1 + o, dev) for o in obj_ids]
    step_fn = make_multi_step(cfg)
    recon = []
    for it in range(gan_steps):
        m = step_fn(runs, it, _gan_lr(it, gan_steps))
        if (it + 1) % 100 == 0 or it == gan_steps - 1:
            recon.append(m["recon_loss"])
    if recon:
        print(f"[rehearsal] {gan_steps} GAN steps x {len(obj_ids)} objects;"
              f" last recon {np.round(recon[-1].cpu().numpy(), 4).tolist()}"
              f" ({time.time() - t_stage:.0f}s)", flush=True)
    params_by_obj = {r.obj_id: r.state.gen.state_dict() for r in runs}
    obj_params = {o: np.asarray(obj_param_from_norm_factor(norm[o]),
                                np.float32) for o in obj_ids}
    stage("gan")

    # ---- 5. the detector (``1_2`` equivalent) ----
    dstore = DetectorStore.from_patch_stores(stores, stores[obj_ids[0]].backs)
    det_model = CenterNetDetector(num_classes=len(obj_ids))
    dstate = create_detector_state(det_model, 2, dev)
    raw_dstep = make_detector_step(det_model)
    det_scale = _detector_scale_range(ds_train, det_im)
    summary["det_scale_range"] = det_scale
    print(f"[rehearsal] detector scale_range={det_scale}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    for it in range(det_steps):
        batch = make_detector_batch(dstore, gen, det_batch, det_im,
                                    k_obj=det_k_obj, scale_range=det_scale)
        raw_dstep(dstate, batch, _det_lr(it, det_steps))
    det_state = det_model.state_dict()
    stage("detector")

    # the trained weights before any evaluation leg can fail
    torch.save({"gen": {o: _cpu(p) for o, p in params_by_obj.items()},
                "det": _cpu(det_state),
                "obj_params": {o: torch.from_numpy(p)
                               for o, p in obj_params.items()},
                "locks": locks}, os.path.join(out_dir, "weights.pt"))

    # ---- 6. detection quality: box and mask mAP on composed scenes ----
    preds, gts = collect_synthetic_detections(
        det_model, dstore, map_images,
        torch.Generator(device=dev).manual_seed(11), im_size=det_im,
        k_obj=det_k_obj, batch_size=4, score_floor=0.05, with_masks=True,
        scale_range=det_scale)
    res_box = evaluate_detections(preds, gts)
    res_mask = evaluate_detections(preds, gts, iou_type="mask")
    summary["det_box_mAP50"] = round(res_box["mAP50"], 4)
    summary["det_box_mAP75"] = round(res_box["mAP75"], 4)
    summary["det_mask_mAP50"] = round(res_mask["mAP50"], 4)
    summary["det_mask_mAP75"] = round(res_mask["mAP75"], 4)
    print(f"[rehearsal] box mAP50={res_box['mAP50']:.3f} "
          f"mask mAP50={res_mask['mAP50']:.3f} (composed domain)",
          flush=True)

    # ---- 7/8. both evaluators x both detector transports ----
    td = TorchDetector(det_model, det_state, obj_ids, score_th=det_score_th,
                       input_size=det_im, device=dev)
    target_list = get_target_list(
        os.path.join(ds_test.dir, "test_targets_bop19.json"))
    # the deployment domain's detection quality: the test images
    tp, tg = collect_bop_split_detections(td, ds_test, target_list)
    res_tbox = evaluate_detections(tp, tg)
    res_tmask = evaluate_detections(tp, tg, iou_type="mask")
    summary["det_test_box_mAP50"] = round(res_tbox["mAP50"], 4)
    summary["det_test_mask_mAP50"] = round(res_tmask["mAP50"], 4)
    summary["det_test_n_gt"] = n_tgt = sum(len(g["cls"]) for g in tg)
    summary["det_test_n_det"] = n_det = sum(len(p["cls"]) for p in tp)
    print(f"[rehearsal] TEST-split box mAP50={res_tbox['mAP50']:.3f} "
          f"mask mAP50={res_tmask['mAP50']:.3f} "
          f"({n_det} dets / {n_tgt} gt)", flush=True)
    det_json = os.path.join(out_dir, "detections.json")
    n_dumped = dump_detections(td, ds_test, target_list, det_json)
    print(f"[rehearsal] dumped {n_dumped} detections -> {det_json}",
          flush=True)
    pre = PrecomputedDetector(det_json)
    stage("detection_metrics")

    ecfg = EvalConfig(dataset_dir=root, score_type=2, task_type=2,
                      cand_factor=1.0, outlier_th=(0.1, 0.2, 0.3),
                      inlier_th=0.3)
    est = Pix2PoseEstimator(AutoEncoder(), ecfg.estimator(0), device=dev)
    meshes = {}
    if icp:
        for o in obj_ids:
            m = load_ply(ds_test.model_ply_path(o))
            meshes[o] = (m["pts"], m["faces"])

    def _ar(results):
        sc = evaluate_bop(results, ds_test, device=dev)
        return {k: round(v, 4) for k, v in sc.items()
                if k.startswith("AR")}, sc.get("per_object", {})

    for tag, detector in (("centernet", td), ("precomputed", pre)):
        ev = BopEvaluator(ds_test, ecfg, est, params_by_obj, obj_params,
                          detector, max_det=4,
                          method_name=f"rehearsal-{tag}")
        res = ev.run(target_list=target_list, out_dir=out_dir, seed=7)
        ar, per_obj = _ar(res)
        summary[f"AR_rgb_{tag}"] = ar
        summary[f"AR_rgb_{tag}_per_object"] = {
            str(o): {m: round(v, 4) for m, v in rec.items()}
            for o, rec in per_obj.items()}
        print(f"[rehearsal] RGB  {tag:12s} {ar}", flush=True)
        stage(f"eval_rgb_{tag}")
        if icp:
            evi = BopEvaluatorICP(ds_test, ecfg, est, params_by_obj,
                                  obj_params, meshes, detector, max_det=4,
                                  batched=True,
                                  method_name=f"rehearsal-{tag}-icp")
            resi = evi.run(target_list=target_list, out_dir=out_dir, seed=7)
            ari, _ = _ar(resi)
            summary[f"AR_rgbd_{tag}"] = ari
            print(f"[rehearsal] RGBD {tag:12s} {ari}", flush=True)
            stage(f"eval_rgbd_{tag}")

    summary["stage_s"] = stage_s
    summary["wall_s"] = round(time.time() - t_all, 1)
    with open(os.path.join(out_dir, "rehearsal_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[rehearsal] done in {summary['wall_s']}s; summary + CSVs in "
          f"{out_dir}", flush=True)
    return summary


def _cpu(state_dict) -> dict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def main(argv=None):
    from pix2pose_torch.utils.cli import require_device

    ap = argparse.ArgumentParser(prog="python -m pix2pose_torch rehearsal",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="dataset/output root (default: mkdtemp)")
    ap.add_argument("--gan-steps", type=int, default=6000)
    ap.add_argument("--det-steps", type=int, default=3000)
    ap.add_argument("--train-views", type=int, default=48)
    ap.add_argument("--test-views", type=int, default=6)
    ap.add_argument("--no-icp", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole run")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    return run_rehearsal(out_root=args.root, gan_steps=args.gan_steps,
                         det_steps=args.det_steps, n_train=args.train_views,
                         n_test=args.test_views, icp=not args.no_icp,
                         device=device)


if __name__ == "__main__":
    main()
