"""Typed configuration (a copy of :mod:`pix2pose_tpu.config`, so that the
port imports nothing of the JAX package).

One dataclass-based config system replaces the reference's positional
``sys.argv`` + JSON-in-``cfg/`` scheme (reference: ``cfg/cfg_bop2020.json``,
consumed at ``tools/5_evaluation_bop_basic.py:34-110,164-170``). Every knob of
the reference is preserved under the same name so reference configs load
unchanged via :func:`load_eval_config`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    """Per-object pose-estimator knobs.

    Mirrors the constructor arguments of the reference estimator
    (``pix2pose_model/recognition.py:10-26``).
    """

    # Outlier thresholds applied to the stage-1 error map to build stage-2
    # candidate crops (reference ``recognition.py:93``). A flat list means the
    # same dynamic set for every object; per-object overrides are handled at
    # evaluator level (``5_evaluation_bop_basic.py:164-170``).
    outlier_th: tuple[float, ...] = (0.1, 0.2, 0.3)
    # Inlier threshold on the stage-2 error map gating PnP correspondences
    # (reference ``recognition.py:203``).
    inlier_th: float = 0.1
    # Square-crop expansion factor around the detector box
    # (reference ``recognition.py:19,38``).
    box_size: float = 1.5
    # RANSAC reprojection error in pixels (reference ``recognition.py:217``
    # hard-codes 5 via reprojectionError=5; th_ransac=3 is passed but unused).
    ransac_reproj_px: float = 5.0
    # RANSAC hypothesis count. The reference uses 100 uniform samples
    # (``recognition.py:217`` iterationsCount); the DEFAULT here is 32
    # confidence-ordered samples (prosac=True below), measured
    # equal-or-better in accuracy at 1.54x engine throughput — set
    # (ransac_iters=100, prosac=False) to restore exact reference
    # sampling semantics.
    ransac_iters: int = 32
    # Norm of the decoded XYZ below which a pixel counts as background "gray"
    # (reference ``recognition.py:89,137``).
    gray_norm_th: float = 0.3
    # Minimum stage-1 foreground pixels to emit a candidate
    # (reference ``recognition.py:96``).
    min_stage1_px: int = 10
    # Minimum valid correspondences for PnP (reference ``recognition.py:214``).
    min_pnp_px: int = 6
    # PROSAC-style progressive hypothesis sampling ordered by the
    # generator's own predicted-error map (``ops/pnp.py:
    # _sample_minimal_sets``). NOT a reference behavior (OpenCV RANSAC
    # samples uniformly), but measured equal-or-better on every
    # validation surface: synthetic corruption sweeps (median rot 0.48
    # deg vs 38.6 at 50% outliers), paired same-weights cube e2e
    # (AR 0.833/ADD 1.0 vs 0.806/0.5), and 1.54x engine throughput at
    # 32 hypotheses (1275 vs 827 crops/s). prosac=False + 100 iters
    # restores reference sampling exactly.
    prosac: bool = True
    # Consensus-stage Gauss-Newton iteration budget (``ops/pnp.py``
    # refine_iters; the progressive-tightening pass runs iters//2+1 on
    # top). KEEP 8: halving to 4 ("gn-half") saves ~9 ms per 8x16 engine
    # launch and a 6k-step same-weights cube e2e A/B showed no loss
    # (2026-08-18), but the solver-level corruption sweep does — at
    # 1 px noise / 25% outliers median error degrades 0.50 deg/2.3 mm ->
    # 1.52 deg/6.6 mm (3x). Trained-generator correspondences on clean
    # synthetic data mask it; real-data crops won't. Not worth the risk
    # against the 0.5-pt AR parity target.
    gn_refine_iters: int = 8
    # Hypothesis selection-scoring pixel stride (None = solver auto:
    # 2 at >=1024 points). 4 scores every 4th correspondence when
    # ranking RANSAC hypotheses, saving ~4 ms per launch; consensus and
    # refit still use every pixel. Validated free on BOTH surfaces
    # (2026-08-18): solver corruption sweep identical to stride-auto
    # (0.500 deg/2.34 mm at 1 px/25% outliers), cube e2e A/B equal
    # (AR 0.88 vs 0.882).
    select_stride: int | None = 4
    # Per-hypothesis GN polish iterations before scoring (0 disables).
    hyp_polish_iters: int = 3
    # Correspondence-grid stride over the 128 stage-2 crop (grid =
    # (128/pnp_stride)^2 slots). DEFAULT FLIPPED 2 -> 4 (2026-08-20):
    # zero-overhead static slicing that cuts every point-proportional
    # PnP stage 4x — engine launch 95.9 -> 72.5 ms (1334 -> 1765
    # crops/s). Gates passed: solver sweep (tools/pnp_sweep.py
    # --n-slots 1024: ~2x median error vs the 4096-grid but absolutes
    # stay sub-mm/sub-0.2deg through 1 px noise / 25% outliers — a
    # VARIANCE cost from fewer points, unlike the rejected
    # gn_refine_iters=4 which was 1.52deg/6.6mm) and the 3-seed paired
    # cube e2e (ab_e2e --b pnp_stride=4: deltas +0.040/-0.030/-0.024,
    # mean -0.005 — seed-noise level). KNOWN TAIL: at 2 px noise + 50%
    # outliers the p90 rotation error is 38deg vs the 4096-grid's 9.7deg
    # — for heavily blurred/low-texture real data set pnp_stride=2 (one
    # config line restores the validated dense grid).
    pnp_stride: int = 4
    # Cap on correspondences fed to PnP: valid grid points are compacted
    # (order-preserving uniform subsample, ``ops/pnp.py:
    # compact_correspondences``) into a (max_pnp_points,) layout, scaling
    # down EVERY PnP stage (sampling argsort, hypothesis DLT, selection
    # scoring, consensus GN) by n_grid/max_pnp_points. Inlier counts are
    # rescaled back to full-grid units so score_type-2 ranking is
    # unchanged. None = feed the full stride-2 grid (4096 points).
    max_pnp_points: int | None = None
    # Network input resolution (reference ``ae_model.py:71``).
    im_size: int = 128
    backbone: str = "paper"  # "paper" | "resnet50"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluator configuration.

    Field names follow the reference JSON keys one-to-one
    (``cfg/cfg_bop2020.json``; consumed at ``5_evaluation_bop_basic.py``).
    """

    dataset_dir: str = ""
    dataset_names: tuple[str, ...] = ()
    detection_pipeline: str = "extern"  # "rcnn" | "retinanet" | "extern"
    path_to_detection_pipeline: str = ""
    detection_weight: str = ""
    path_to_output: str = "output"
    # Flat list -> dynamic multi-threshold for all objects; list of lists ->
    # fixed per-object threshold (``5_evaluation_bop_basic.py:164-170``).
    outlier_th: tuple = (0.15, 0.25, 0.35)
    inlier_th: float = 0.1
    norm_factor_fn: str = "norm_factor.json"
    background_imgs_for_training: str = ""
    # 1 = detector score; 2 = det_score * frac_inlier * mask_iou * union
    # (``5_evaluation_bop_basic.py:103-105,307-316``).
    score_type: int = 1
    # 1 = SiSo (all results); 2 = ViVo top-n (``basic:107-109,342-349``).
    task_type: int = 1
    cand_factor: float = 1.0
    test_target: str = "test_targets_bop19"
    backbone: str = "paper"
    target_obj: tuple[int, ...] | None = None

    def estimator(self, obj_index: int | None = None) -> EstimatorConfig:
        """Build the per-object estimator config, resolving per-object
        outlier thresholds when ``outlier_th`` is a list-of-lists."""
        th = self.outlier_th
        if len(th) > 0 and isinstance(th[0], (list, tuple)):
            if obj_index is None:
                raise ValueError("per-object outlier_th requires obj_index")
            th = tuple(float(t) for t in th[obj_index])
        else:
            th = tuple(float(t) for t in th)
        return EstimatorConfig(
            outlier_th=th,
            inlier_th=float(self.inlier_th),
            backbone=self.backbone,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """GAN training configuration (reference ``tools/3_train_pix2pose.py``)."""

    batch_size: int = 50  # reference ``3_train:93``
    max_epoch: int = 10  # reference ``3_train:168``
    # Loss weights [reconstruction, adversarial] (reference ``3_train:73``).
    loss_weight_recon: float = 100.0
    loss_weight_gan: float = 1.0
    # BOP-challenge lr schedule (reference ``3_train:169-173``).
    lr_schedule: tuple[float, ...] = (
        1e-3, 1e-3, 1e-3, 1e-3, 1e-3,
        1e-3, 1e-3, 1e-4, 1e-4, 1e-4,
        1e-5, 1e-5, 1e-5, 1e-5, 1e-6,
        1e-6, 1e-6, 1e-6, 1e-6, 1e-7,
    )
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    label_smoothing: bool = True  # reference ``3_train:212``
    label_flipping: float = 0.2  # reference ``3_train:212``
    im_size: int = 128
    backbone: str = "paper"
    # epoch = min(n_data/batch*10, 3000) batches (reference ``3_train:191``).
    max_batches_per_epoch: int = 3000
    # Conv/matmul compute dtype ("float32" | "bfloat16"). Params, optimizer
    # state and losses stay float32 (standard mixed precision); bfloat16
    # roughly halves the MXU time of the conv stack. The reference trains
    # pure fp32 (TF1 Keras default).
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}")

    def batches_per_epoch(self, n_data: int) -> int:
        return int(min(n_data / self.batch_size * 10, self.max_batches_per_epoch))

    @property
    def torch_dtype(self):
        import torch

        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]


def _tuplify(v: Any) -> Any:
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def load_eval_config(path_or_dict: str | dict) -> EvalConfig:
    """Load an :class:`EvalConfig` from a reference-format JSON config file.

    Accepts the exact JSON schema of the reference ``cfg/*.json`` files
    (e.g. ``cfg/cfg_bop2020.json``). Unknown keys are ignored.
    """
    if isinstance(path_or_dict, dict):
        raw = path_or_dict
    else:
        with open(path_or_dict) as f:
            raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(EvalConfig)}
    kwargs = {k: _tuplify(v) for k, v in raw.items() if k in fields}
    if "task_type" in kwargs:
        kwargs["task_type"] = int(kwargs["task_type"])  # ref stores "2" or 2
    if "score_type" in kwargs:
        kwargs["score_type"] = int(kwargs["score_type"])
    if "cand_factor" in kwargs:
        kwargs["cand_factor"] = float(kwargs["cand_factor"])
    return EvalConfig(**kwargs)
