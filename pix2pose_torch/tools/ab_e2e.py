"""Paired-seed A/B adjudication of end-to-end accuracy changes (port of
:mod:`pix2pose_tpu.tools.ab_e2e`).

A single trained run's AR is noisy, so one run mis-adjudicates a change.
This tool runs baseline (A) against candidate (B) on identical data
streams over N seeds: per seed it trains the paper generator on the cube
set (once when only estimator fields differ, else once per variant with
the same draws), evaluates both with the same jittered GT detections, and
reports the per-seed AR deltas (``--retrain`` trains B on its own even
with A's train fields: an A = A run then checks that training repeats)::

    # an estimator field (trains once per seed)
    python -m pix2pose_torch ab-e2e --b select_stride=4 --seeds 3
    # a training field (trains both variants per seed)
    python -m pix2pose_torch ab-e2e --b train.compute_dtype=bfloat16

Pass rule: mean(AR_B - AR_A) >= -margin and every per-seed delta >=
-2 * margin (default margin 0.03). It prints one JSON line; ``main``
returns 0 on pass and exits with status 1 on fail. Everything runs on ``--device`` (default ``cuda``);
without a CUDA device the tool refuses to start unless ``--device cpu``
is given.

The generator's train config carries ``--backbone`` (the JAX tool builds
its generator with it but leaves the config's ``paper``, which skips the
ResNet-50 trunk decay that ``train`` applies).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from pix2pose_torch.config import EstimatorConfig, EvalConfig, TrainConfig


def _coerce(cls, name, raw):
    """Parse a CLI string into the declared type of field ``name``."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    if name not in fields:
        raise SystemExit(
            f"unknown {cls.__name__} field {name!r}; have "
            f"{sorted(fields)}")
    cur = getattr(cls(), name, fields[name].default)
    if cur is None:
        # Optional fields (max_pnp_points: int | None): "none" stays None,
        # else a number when it parses as one, else the string
        if raw.lower() == "none":
            return None
        for cast in (int, float):
            try:
                return cast(raw)
            except ValueError:
                pass
        return raw
    if isinstance(cur, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(cur, int):
        return int(raw)
    if isinstance(cur, float):
        return float(raw)
    if isinstance(cur, tuple):
        return tuple(float(x) for x in raw.split(","))
    if raw.lower() == "none":
        return None
    return raw


def parse_overrides(pairs):
    """Split ``k=v`` CLI pairs into (train_overrides, est_overrides)."""
    train_o, est_o = {}, {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        if not v:
            raise SystemExit(f"override {p!r} is not k=v")
        if k.startswith("train."):
            k = k[len("train."):]
            train_o[k] = _coerce(TrainConfig, k, v)
        else:
            est_o[k] = _coerce(EstimatorConfig, k, v)
    return train_o, est_o


def _build_dataset(root, train_views, device):
    """The cube train set (``train_views`` images, object 1's pairs), the
    4-image test set at ``root + "_test"`` and 8 noise backgrounds."""
    from PIL import Image

    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.tools.render_training_pairs import \
        render_object_pairs
    from pix2pose_torch.utils.synthetic import build_cube_dataset

    build_cube_dataset(root, n_scenes=1, ims_per_scene=train_views,
                       split="train", device=device)
    build_cube_dataset(root + "_test", n_scenes=1, ims_per_scene=4,
                       split="test", device=device)
    render_object_pairs(BopDataset(root, "cubes", train=True), 1,
                        device=device)
    os.makedirs(root + "/backs", exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (120, 160, 3)).astype(
            np.uint8)).save(f"{root}/backs/b{i}.png")


def _train(store, seed, steps, train_overrides, backbone, device) -> dict:
    """One GAN training run; returns the generator's state dict. The
    initialization and the data stream are keyed by ``seed`` only, so two
    calls with the same seed consume identical batches."""
    from pix2pose_torch.models import AutoEncoder, Discriminator
    from pix2pose_torch.training.data import make_batch
    from pix2pose_torch.training.gan import (create_train_state,
                                             draw_labels, init_like_flax,
                                             make_train_step)

    dev = torch.device(device)
    cfg = TrainConfig(**{"batch_size": 32, "backbone": backbone,
                         **train_overrides})
    init = torch.Generator().manual_seed(seed)
    gen = init_like_flax(AutoEncoder(backbone=cfg.backbone), init).to(dev)
    disc = init_like_flax(Discriminator(cfg.im_size), init).to(dev)
    state = create_train_state(gen, disc, cfg)
    step_fn = make_train_step(cfg)
    sym = torch.eye(3, device=dev)[None]
    rng = torch.Generator(device=dev).manual_seed(1000 + seed)
    for it in range(steps):
        lr = 1e-3 if it < steps // 2 else (
            3e-4 if it < steps * 4 // 5 else 1e-4)
        batch = make_batch(store, rng, it, cfg.batch_size)
        labels = draw_labels(rng, cfg.batch_size, cfg.label_flipping)
        step_fn(state, batch, sym, lr, labels)
    return gen.state_dict()


def _eval_config(root):
    return EvalConfig(dataset_dir=root + "_test", score_type=2, task_type=2,
                      cand_factor=1.0, outlier_th=(0.1, 0.2, 0.3),
                      inlier_th=0.3)


def _estimator(est_overrides, backbone, device):
    """The engine with the overrides."""
    from pix2pose_torch.inference.engine import Pix2PoseEstimator
    from pix2pose_torch.models import AutoEncoder

    est_cfg = dataclasses.replace(_eval_config("").estimator(0),
                                  **est_overrides)
    return Pix2PoseEstimator(AutoEncoder(backbone=backbone), est_cfg,
                             device=device)


def _evaluate(root, params, est, seed, device) -> float:
    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.eval.bop_eval import BopEvaluator
    from pix2pose_torch.eval.metrics import evaluate_bop
    from pix2pose_torch.inference.detector import GtDetector

    ds_test = BopDataset(root + "_test", "cubes", train=False)
    obj_param = np.array([40., 40., 40., 0, 0, 0], np.float32)
    # detector jitter keyed by seed so A and B see the same boxes
    ev = BopEvaluator(ds_test, _eval_config(root), est, {1: params},
                      {1: obj_param}, GtDetector(ds_test, jitter=5,
                                                 seed=seed), max_det=2)
    return evaluate_bop(ev.run(), ds_test, device=device)["AR"]


def run_ab(seeds, steps, a_pairs, b_pairs, backbone="paper",
           train_views=48, margin=0.03, root=None, device="cuda",
           retrain=False):
    """Returns the result dict (also printed as one JSON line).
    ``retrain``: train B on its own even when its train overrides are
    A's (A = A then checks that training repeats)."""
    from pix2pose_torch.training.data import PatchStore

    dev = torch.device(device)
    train_a, est_a = parse_overrides(a_pairs)
    train_b, est_b = parse_overrides(b_pairs)
    retrain = retrain or train_a != train_b
    # both engines before any training: an override the engine refuses
    # fails here
    ests = (_estimator(est_a, backbone, dev), _estimator(est_b, backbone,
                                                         dev))

    root = root or tempfile.mkdtemp(prefix="ab_e2e_")
    if not os.path.isdir(os.path.join(root, "cubes")):
        _build_dataset(root, train_views, dev)
    store = PatchStore.load(os.path.join(root, "cubes", "train_xyz", "01"),
                            root + "/backs", device=dev)
    rows = []
    for seed in range(seeds):
        t0 = time.time()
        params_a = _train(store, seed, steps, train_a, backbone, dev)
        params_b = (_train(store, seed, steps, train_b, backbone, dev)
                    if retrain else params_a)
        ar_a = _evaluate(root, params_a, ests[0], seed, dev)
        ar_b = _evaluate(root, params_b, ests[1], seed, dev)
        rows.append({"seed": seed, "ar_a": round(ar_a, 4),
                     "ar_b": round(ar_b, 4),
                     "delta": round(ar_b - ar_a, 4)})
        print(f"seed {seed}: A={ar_a:.3f} B={ar_b:.3f} "
              f"delta={ar_b - ar_a:+.3f} ({time.time() - t0:.0f}s)",
              flush=True)

    deltas = [r["delta"] for r in rows]
    mean_d, min_d = float(np.mean(deltas)), float(np.min(deltas))
    ok = mean_d >= -margin and min_d >= -2 * margin
    out = {"metric": "ab_delta_AR", "rows": rows,
           "mean_delta": round(mean_d, 4), "min_delta": round(min_d, 4),
           "margin": margin, "pass": ok,
           "a": list(a_pairs or ()), "b": list(b_pairs or ()),
           "steps": steps, "retrained": retrain}
    print(json.dumps(out))
    return out


def main(argv=None):
    from pix2pose_torch.utils.cli import require_device

    ap = argparse.ArgumentParser(prog="python -m pix2pose_torch ab-e2e",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--a", action="append", default=[], metavar="K=V",
                    help="baseline overrides (estimator field, or "
                         "train.<field>)")
    ap.add_argument("--b", action="append", default=[], metavar="K=V",
                    help="candidate overrides")
    ap.add_argument("--backbone", choices=["paper", "resnet50"],
                    default="paper")
    ap.add_argument("--margin", type=float, default=0.03)
    ap.add_argument("--root", default=None,
                    help="reuse a dataset root across invocations")
    ap.add_argument("--retrain", action="store_true",
                    help="train B on its own even with A's train "
                         "overrides (checks that training repeats)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole run")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    out = run_ab(args.seeds, args.steps, args.a, args.b, args.backbone,
                 margin=args.margin, root=args.root, device=device,
                 retrain=args.retrain)
    if not out["pass"]:
        raise SystemExit(1)
    return 0


if __name__ == "__main__":
    main()
