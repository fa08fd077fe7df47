"""Real-dataset parity runner (port of :mod:`pix2pose_tpu.tools.
parity_lmo`): reference weights -> the port's evaluators -> AR against the
reference's BOP'20 tables.

The tool is gated: it probes for a BOP dataset, prints what is missing
and exits 2, and otherwise runs

  weights (``inference.npz``, or a reference Keras ``inference*.hdf5``
  read by ``utils/hdf5_import``) -> RGB evaluator (``eval/bop_eval``,
  reference ``5_evaluation_bop_basic.py`` semantics) -> BOP'19 AR
  (``eval/metrics``) -> the difference to the reference's RGB table.

With ``--icp`` the same weights, targets and detections also run through
the RGB-D evaluator (``eval/bop_eval_icp``, reference
``5_evaluation_bop_icp3d.py``, whose renders run the z-buffer kernel on
a CUDA device) against the reference's RGB-D table.

Expected layout (BOP default and the reference release's weights)::

  <bop_root>/<dataset>/{models, models_xyz/norm_factor.json, test/,
                        test_targets_bop19.json}
  weights: <ds>/pix2pose_weights/<obj:02d>/ in the dataset tree, or
           --weights pointing at a directory with <obj:02d>/,
           <dataset>/<obj:02d>/ or <dataset>/pix2pose_weights/<obj:02d>/

Detections: ``--detections`` (a ``PrecomputedDetector`` JSON, e.g. the
BOP'20 Mask-RCNN dumps, the reference's detection source); without it
the GT detector is used and the AR is an upper bound.

CLI (``--device`` defaults to ``cuda``; without a CUDA device the command
refuses to start unless ``--device cpu`` is given)::

    python -m pix2pose_torch parity-lmo --bop-root <dir> [--dataset lmo] \\
        [--weights <dir>] [--detections det.json] [--cfg cfg.json] \\
        [--icp] [--max-images N] [--json out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Sequence

# BOP'20 AR of the reference (its README's tables): RGB only, and RGB with
# depth ICP
BASELINE_RGB_AR = {"lmo": 0.363, "tless": 0.344, "tudl": 0.420,
                   "icbin": 0.226, "itodd": 0.134, "hb": 0.446,
                   "ycbv": 0.457}
BASELINE_ICP_AR = {"lmo": 0.588, "tless": 0.512, "tudl": 0.820,
                   "icbin": 0.390, "itodd": 0.351, "hb": 0.695,
                   "ycbv": 0.780}
DEFAULT_ROOTS = ("/data/bop", "/mnt/bop", "~/bop")


def find_bop_dataset(bop_root: str | None, dataset: str):
    """``(root, missing)``: the first of ``bop_root`` (or the default
    mount points) holding ``<dataset>/``, with the files it lacks of the
    two the run needs; ``(None, [reason])`` when none holds it."""
    roots = [bop_root] if bop_root else [os.path.expanduser(r)
                                         for r in DEFAULT_ROOTS]
    needed = ["models_xyz/norm_factor.json", "test_targets_bop19.json"]
    for root in roots:
        d = os.path.join(root, dataset)
        if not os.path.isdir(d):
            continue
        return root, [n for n in needed
                      if not os.path.exists(os.path.join(d, n))]
    return None, [f"no '{dataset}' dataset under any of: "
                  + ", ".join(str(r) for r in roots)]


def resolve_weight_dir(ds_dir: str, weights_root: str | None,
                       dataset: str, obj_id: int) -> str | None:
    """The first per-object weight directory, among the known layouts,
    that holds ``inference.npz``, an orbax ``inference/`` directory or a
    Keras ``inference*.hdf5``."""
    cands = [os.path.join(ds_dir, "pix2pose_weights", f"{obj_id:02d}")]
    if weights_root:
        cands += [os.path.join(weights_root, f"{obj_id:02d}"),
                  os.path.join(weights_root, dataset, f"{obj_id:02d}"),
                  os.path.join(weights_root, dataset, "pix2pose_weights",
                               f"{obj_id:02d}")]
    for c in cands:
        if os.path.isdir(c) and (
                os.path.isdir(os.path.join(c, "inference"))
                or any(fn == "inference.npz" or (
                    fn.startswith("inference") and fn.endswith(".hdf5"))
                    for fn in os.listdir(c))):
            return c
    return None


def run_parity(bop_root: str, dataset: str, weights_root=None,
               detections=None, cfg_path=None, max_images=None,
               out_dir=None, with_icp: bool = False,
               device="cuda") -> dict:
    """The RGB evaluator's AR over the dataset's test targets and its
    difference to the reference's table; with ``with_icp`` also the RGB-D
    evaluator's over the same targets, weights and detections.
    ``cfg_path`` is a reference-schema config file or dict (default: the
    BOP'20 settings, ResNet-50, score_type 2, task_type 2)."""
    import torch

    from pix2pose_torch.config import EvalConfig, load_eval_config
    from pix2pose_torch.data.bop import BopDataset, get_target_list
    from pix2pose_torch.data.ply import load_ply
    from pix2pose_torch.eval.bop_eval import BopEvaluator
    from pix2pose_torch.eval.bop_eval_icp import BopEvaluatorICP
    from pix2pose_torch.eval.metrics import evaluate_bop
    from pix2pose_torch.inference.detector import (GtDetector,
                                                   PrecomputedDetector)
    from pix2pose_torch.inference.engine import estimators_for_objects
    from pix2pose_torch.models import build_generator
    from pix2pose_torch.ops.color import obj_param_from_norm_factor
    from pix2pose_torch.utils import checkpoint as ckpt_util
    from pix2pose_torch.utils.convert import flax_to_state_dict

    dev = torch.device(device)
    out_dir = out_dir or tempfile.mkdtemp(prefix="parity_")
    cfg = (load_eval_config(cfg_path) if cfg_path else EvalConfig(
        backbone="resnet50", score_type=2, task_type=2, cand_factor=2.0,
        inlier_th=0.15))
    cfg = dataclasses.replace(cfg, dataset_dir=bop_root,
                              path_to_output=out_dir)

    ds = BopDataset(bop_root, dataset, train=False)
    with open(os.path.join(ds.dir, "models_xyz", cfg.norm_factor_fn)) as f:
        norm = json.load(f)

    model = build_generator(cfg.backbone)
    est = estimators_for_objects(model, cfg, ds.model_ids, device=dev)
    params_by_obj, obj_params, missing_w = {}, {}, []
    for obj_id in ds.model_ids:
        wdir = resolve_weight_dir(ds.dir, weights_root, dataset, obj_id)
        v = ckpt_util.load_inference_params(wdir) if wdir else None
        if v is None:
            missing_w.append(obj_id)
            continue
        state = flax_to_state_dict(v)
        model.load_state_dict(state, strict=True)
        params_by_obj[obj_id] = {k: t.to(dev) for k, t in state.items()}
        obj_params[obj_id] = obj_param_from_norm_factor(norm[str(obj_id)])
    if not params_by_obj:
        raise SystemExit(f"no reference weights found for any of "
                         f"{ds.model_ids}; mount them or pass --weights")
    if missing_w:
        print(f"WARNING: no weights for objects {missing_w} — "
              f"parity AR only covers {sorted(params_by_obj)}")

    detector = (PrecomputedDetector(detections) if detections
                else GtDetector(ds))
    if not detections:
        print("WARNING: GT detector in use (no --detections): AR is an "
              "upper bound w.r.t. the reference's Mask-RCNN pipeline")

    targets = get_target_list(os.path.join(ds.dir,
                                           cfg.test_target + ".json"))
    if max_images:
        keep = set(sorted({(s, i) for s, i, _, _ in targets})[:max_images])
        targets = [t for t in targets if (t[0], t[1]) in keep]

    ev = BopEvaluator(ds, cfg, est, params_by_obj, obj_params, detector)
    ev.warmup()
    results = ev.run(target_list=targets, out_dir=out_dir)
    scores = evaluate_bop(results, ds, target_list=targets, device=dev)

    base = BASELINE_RGB_AR.get(dataset)
    report = {"dataset": dataset, "n_results": len(results),
              "AR": scores["AR"], "AR_vsd": scores["AR_vsd"],
              "AR_mssd": scores["AR_mssd"], "AR_mspd": scores["AR_mspd"],
              "baseline_rgb": base,
              "diff": (scores["AR"] - base) if base is not None else None,
              "subset": bool(max_images) or bool(missing_w),
              "gt_detector": not detections}

    if with_icp:
        if not any(os.path.isdir(os.path.join(ds.split_dir(), f"{s:06d}",
                                              "depth"))
                   for s in ds.scene_ids()):
            report["icp"] = "skipped: no depth/ images in the test split"
            return report
        meshes = {}
        for obj_id in params_by_obj:
            mesh = load_ply(ds.model_ply_path(obj_id))
            meshes[obj_id] = (mesh["pts"], mesh["faces"])
        ev_icp = BopEvaluatorICP(ds, cfg, est, params_by_obj, obj_params,
                                 meshes, detector)
        results_icp = ev_icp.run(target_list=targets,
                                 out_dir=os.path.join(out_dir, "icp"))
        scores_icp = evaluate_bop(results_icp, ds, target_list=targets,
                                  device=dev)
        base_icp = BASELINE_ICP_AR.get(dataset)
        report.update({
            "AR_icp": scores_icp["AR"], "AR_icp_vsd": scores_icp["AR_vsd"],
            "AR_icp_mssd": scores_icp["AR_mssd"],
            "AR_icp_mspd": scores_icp["AR_mspd"],
            "baseline_icp": base_icp,
            "diff_icp": (scores_icp["AR"] - base_icp)
            if base_icp is not None else None,
            "icp_render_overflow": int(ev_icp.render_overflow)})
    return report


def verdict(report: dict) -> list:
    """The lines that hold each AR against its reference table: PARITY
    within 0.005 or above, else BELOW BASELINE; a subset or the GT
    detector marks the setup as not comparable."""
    lines = []
    for key, base_key, label in (("AR", "baseline_rgb", "RGB"),
                                 ("AR_icp", "baseline_icp", "RGB-D/ICP")):
        base = report.get(base_key)
        if base is None or key not in report:
            continue
        ar = report[key]
        tag = "PARITY" if abs(ar - base) <= 0.005 or ar > base else \
            "BELOW BASELINE"
        if report["subset"] or report["gt_detector"]:
            tag += " (non-comparable setup: subset or GT detector)"
        lines.append(f"AR {ar:.4f} vs reference {label} {base:.3f} -> {tag}")
    return lines


def main(argv: Sequence[str] | None = None):
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch parity-lmo",
                                description=__doc__.split("\n")[0])
    p.add_argument("--bop-root", default=None)
    p.add_argument("--dataset", default="lmo")
    p.add_argument("--weights", default=None,
                   help="root of per-object weights (inference.npz or the "
                        "reference's inference*.hdf5)")
    p.add_argument("--detections", default=None,
                   help="PrecomputedDetector JSON (BOP'20 det dumps)")
    p.add_argument("--cfg", default=None,
                   help="reference-schema eval config (default: BOP'20 "
                        "settings, ResNet-50)")
    p.add_argument("--icp", action="store_true",
                   help="also run the RGB-D/ICP evaluator against the "
                        "reference's RGB-D table")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--json", default=None)
    p.add_argument("--out-dir", default=None,
                   help="where the evaluators' CSVs go (default: a new "
                        "temporary directory)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    root, missing = find_bop_dataset(args.bop_root, args.dataset)
    if missing:
        print(f"parity run gated OFF — data not available: {missing}")
        print("mount the BOP dataset (and reference weights) and rerun; "
              "see the module docstring for the expected layout")
        raise SystemExit(2)
    device = require_device(args.device)

    report = run_parity(root, args.dataset, weights_root=args.weights,
                        detections=args.detections, cfg_path=args.cfg,
                        max_images=args.max_images, out_dir=args.out_dir,
                        with_icp=args.icp, device=device)
    print(json.dumps(report, indent=1))
    for line in verdict(report):
        print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
