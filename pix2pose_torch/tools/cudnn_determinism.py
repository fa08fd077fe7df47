"""What cuDNN's deterministic algorithms cost and buy on the card, for
each network the port trains, with the setting off and on in one process.

    python -m pix2pose_torch.tools.cudnn_determinism [--steps 150]
        [--warmup 20] [--root DIR] [--device cuda]

The generator's training step and its inference pass and the detectors'
training steps run under the setting (``models/ae.py:
deterministic_cudnn``); "off" runs them outside it. On ``ab-e2e``'s cube
set (48 train views, object 1's pairs, 4 test images) this tool runs
each measurement four times, off, on, on, off (so a drift of the card's
clock weighs on both alike):

- the generator, paper and ResNet-50 backbones, trained from one seed
  for ``--steps`` steps at the ``train`` CLI's batch 50 in float32
  (``make_train_step(deterministic=...)``): steps/s after ``--warmup``
  steps (CUDA events), and whether the two runs of each setting end with
  bit-identical weights;
- the evaluation of the first deterministic run's weights with
  ``ab-e2e``'s estimator and jittered GT detector (off: the engine with
  its generator pass outside the setting): seconds per image (host
  clock, synchronized), and whether both evaluations give the same poses;
- the CenterNet detector's training step (``make_detector_step``;
  ResNet-50, 512 px, batch 4, k_obj 8, the detector trainer's defaults)
  for ``--steps`` steps on one composed batch from one seed, off, on, in
  channels-last memory format with the setting on (twice), on, off:
  steps/s and whether the weights repeat.

Prints the card's name and power limit, a line per network, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.inference.engine import Pix2PoseEstimator

ORDER = ("off", "on", "on", "off")
DETECTOR_ORDER = ("off", "on", "channels_last", "channels_last", "on", "off")


class _UnpinnedEstimator(Pix2PoseEstimator):
    """The engine with its generator pass outside the setting."""

    def _apply(self, params, x):
        if params is None:
            return self.model(x)
        return torch.func.functional_call(self.model, params, (x,))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _rate(run_step, steps, warmup) -> float:
    """Steps/s of ``run_step(it)`` after ``warmup`` steps (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for it in range(steps):
        if it == warmup:
            start.record()
        run_step(it)
    end.record()
    torch.cuda.synchronize()
    return (steps - warmup) * 1e3 / start.elapsed_time(end)


def _weights(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_generator(store, backbone, steps, warmup, deterministic, dev,
                    seed=0):
    """(steps/s, generator state dict) of one run from ``seed`` at batch
    50, float32, lr 1e-3."""
    from pix2pose_torch.config import TrainConfig
    from pix2pose_torch.models import AutoEncoder, Discriminator
    from pix2pose_torch.training.data import make_batch
    from pix2pose_torch.training.gan import (create_train_state,
                                             draw_labels, init_like_flax,
                                             make_train_step)

    cfg = TrainConfig(backbone=backbone)
    init = torch.Generator().manual_seed(seed)
    gen = init_like_flax(AutoEncoder(backbone=backbone), init).to(dev)
    disc = init_like_flax(Discriminator(cfg.im_size), init).to(dev)
    state = create_train_state(gen, disc, cfg)
    step_fn = make_train_step(cfg, deterministic=deterministic)
    sym = torch.eye(3, device=dev)[None]
    rng = torch.Generator(device=dev).manual_seed(1000 + seed)

    def run_step(it):
        batch = make_batch(store, rng, it, cfg.batch_size)
        labels = draw_labels(rng, cfg.batch_size, cfg.label_flipping)
        step_fn(state, batch, sym, 1e-3, labels)

    return _rate(run_step, steps, warmup), _weights(gen)


def evaluate(root, params, backbone, deterministic, dev, seed=0):
    """(seconds per image, poses) of ``ab-e2e``'s evaluation."""
    from pix2pose_torch.data.bop import BopDataset, get_target_list
    from pix2pose_torch.eval.bop_eval import BopEvaluator
    from pix2pose_torch.inference.detector import GtDetector
    from pix2pose_torch.models import AutoEncoder
    from pix2pose_torch.tools.ab_e2e import _eval_config

    ds = BopDataset(root + "_test", "cubes", train=False)
    cfg = _eval_config(root)
    cls = Pix2PoseEstimator if deterministic else _UnpinnedEstimator
    est = cls(AutoEncoder(backbone=backbone), cfg.estimator(0), device=dev)
    ev = BopEvaluator(ds, cfg, est, {1: params},
                      {1: np.array([40., 40., 40., 0, 0, 0], np.float32)},
                      GtDetector(ds, jitter=5, seed=seed), max_det=2)
    targets = get_target_list(os.path.join(ds.dir,
                                           "test_targets_bop19.json"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = ev.run(target_list=targets)
    torch.cuda.synchronize()
    poses = [(np.asarray(r["R"]).tobytes(), np.asarray(r["t"]).tobytes())
             for r in rows]
    return (time.perf_counter() - t0) / len(targets), poses


def train_detector_steps(store, steps, warmup, variant, dev, seed=0):
    """(steps/s, detector state dict) of ``steps`` steps of the
    detector trainer's own CenterNet step (``make_detector_step``) from
    ``seed`` on one composed batch (batch 4, 512 px, k_obj 8). ``variant``
    "on" is the step as it ships; "off" the same step with the setting
    it enters turned off (its ``deterministic_cudnn`` patched to
    ``deterministic_cudnn(False)``); "channels_last" the shipped step on
    the network's weights in channels-last memory format."""
    from unittest import mock

    from pix2pose_torch.models import CenterNetDetector
    from pix2pose_torch.models.ae import deterministic_cudnn
    from pix2pose_torch.training import detector_train
    from pix2pose_torch.training.detector_data import make_detector_batch

    batch = make_detector_batch(
        store, torch.Generator(device=dev).manual_seed(seed), 4, 512, 8)
    state = detector_train.create_detector_state(
        CenterNetDetector(store.num_classes), seed, dev)
    if variant == "channels_last":  # the parameters keep their identity
        # (the NHWC image enters the trunk channels-last already)
        state.model.to(memory_format=torch.channels_last)
    step_fn = detector_train.make_detector_step(state.model)
    with mock.patch.object(detector_train, "deterministic_cudnn",
                           lambda: deterministic_cudnn(variant != "off")):
        rate = _rate(lambda it: step_fn(state, batch, 2.5e-4), steps,
                     warmup)
    return rate, _weights(state.model)


def _summary(rates, weights, secs=None, poses=None) -> dict:
    """Each setting's steps/s and whether its two runs repeat; the cost of
    each setting other than "off" in steps/s (and of "on" in seconds per
    image)."""
    res = {}
    for name in rates:
        a, b = weights[name]
        res[name] = {"train_steps_per_s": rates[name],
                     "train_repeats": all(torch.equal(a[k], b[k])
                                          for k in a)}
        if secs is not None:
            res[name].update(eval_s_per_image=secs[name],
                             eval_repeats=poses[name][0] == poses[name][1],
                             eval_poses=len(poses[name][0]))
        if name != "off":
            res[f"train_cost_{name}"] = float(
                1.0 - np.mean(rates[name]) / np.mean(rates["off"]))
    if secs is not None:
        res["eval_cost"] = float(np.mean(secs["on"]) / np.mean(secs["off"])
                                 - 1.0)
    return res


def measure(steps: int, warmup: int, root=None, device="cuda") -> dict:
    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.tools.ab_e2e import _build_dataset
    from pix2pose_torch.training.data import PatchStore
    from pix2pose_torch.training.detector_train import load_store

    dev = torch.device(device)
    root = root or tempfile.mkdtemp(prefix="cudnn_det_")
    if not os.path.isdir(os.path.join(root, "cubes")):
        _build_dataset(root, 48, dev)
    store = PatchStore.load(os.path.join(root, "cubes", "train_xyz", "01"),
                            root + "/backs", device=dev)
    out = {}
    for backbone in ("paper", "resnet50"):
        rates, weights = {"off": [], "on": []}, {"off": [], "on": []}
        for name in ORDER:
            r, w = train_generator(store, backbone, steps, warmup,
                                   name == "on", dev)
            rates[name].append(r)
            weights[name].append(w)
        secs, poses = {"off": [], "on": []}, {"off": [], "on": []}
        for name in ORDER:
            s, p = evaluate(root, weights["on"][0], backbone, name == "on",
                            dev)
            secs[name].append(s)
            poses[name].append(p)
        out[f"generator_{backbone}"] = _summary(rates, weights, secs, poses)
        print(f"generator {backbone}: {json.dumps(out[f'generator_{backbone}'])}",
              flush=True)
    det_store = load_store(BopDataset(root, "cubes", train=True),
                           root + "/backs", dev)
    rates = {name: [] for name in DETECTOR_ORDER}
    weights = {name: [] for name in DETECTOR_ORDER}
    for name in DETECTOR_ORDER:
        r, w = train_detector_steps(det_store, steps, warmup, name, dev)
        rates[name].append(r)
        weights[name].append(w)
    out["detector_centernet"] = _summary(rates, weights)
    print(f"detector centernet: {json.dumps(out['detector_centernet'])}",
          flush=True)
    return out


def main(argv: Sequence[str] | None = None):
    from pix2pose_torch.utils.cli import require_device

    ap = argparse.ArgumentParser(
        prog="python -m pix2pose_torch.tools.cudnn_determinism",
        description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--root", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("cudnn_determinism times cuDNN: CUDA only")
    card = _card()
    print(card, flush=True)
    out = measure(args.steps, args.warmup, args.root, dev)
    print(json.dumps({"card": card, "steps": args.steps,
                      "warmup": args.warmup, "results": out}))
    return out


if __name__ == "__main__":
    main()
