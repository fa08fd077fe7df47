"""RetinaNet training (port of :mod:`pix2pose_tpu.training.retinanet_train`;
the reference trains fizyr keras-retinanet externally for its T-Less
results, ``5_evaluation_bop_basic.py:64-97``).

The same scene composer as the CenterNet trainer; the anchor targets are
assigned on the device from the composer's full-resolution GT boxes, so
composition, assignment, forward and backward are one chain of device
work per step.

CLI (``--device`` defaults to ``cuda``)::

    python -m pix2pose_torch.training.retinanet_train <cfg.json> \\
        <dataset> <background_dir> [--steps N] [--batch B] \\
        [--anchor-base A] [--device cuda]

States and ``inference.npz`` go to ``<dataset>/weight_detection/
retinanet/``, which ``eval-detector --head retinanet`` loads. Adam at lr
1e-4 with the 200-step warmup, as the JAX trainer.
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import torch
from torch import nn

from pix2pose_torch.models.ae import deterministic_cudnn
from pix2pose_torch.models.retinanet import (RetinaNetDetector,
                                             anchor_boxes, retinanet_loss)
from pix2pose_torch.training.detector_data import (DetectorStore,
                                                   make_detector_batch)
from pix2pose_torch.training.detector_train import (WARMUP, DetTrainState,
                                                    adam_update,
                                                    create_detector_state,
                                                    load_store)
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import state_dict_to_flax


def create_retinanet_state(model: RetinaNetDetector, seed: int = 0,
                           device="cuda") -> DetTrainState:
    """flax's initialization (the classifier's bias at -log(99)) and
    Adam, as :func:`~pix2pose_torch.training.detector_train.
    create_detector_state`."""
    return create_detector_state(model, seed, device)


def make_retinanet_step(model: nn.Module, anchors, pos_iou: float = 0.5,
                        neg_iou: float = 0.4):
    """``step(state, batch, lr) -> parts`` (``total``, ``cls``, ``box``;
    0-d device tensors): the train-mode forward, the anchor assignment
    from ``gt_bbox`` / ``gt_cls`` / ``gt_valid``, the focal + smooth-L1
    loss and one Adam update, in place, under cuDNN's deterministic
    algorithms (as the CenterNet step)."""

    def step(state: DetTrainState, batch: dict, lr: float) -> dict:
        model.train()
        with deterministic_cudnn():
            total, parts = retinanet_loss(
                model(batch["image"]), torch.as_tensor(
                    anchors, device=batch["image"].device),
                batch["gt_bbox"], batch["gt_cls"], batch["gt_valid"],
                model.num_classes, pos_iou=pos_iou, neg_iou=neg_iou)
            adam_update(state, total, lr)
        parts = {k: v.detach() for k, v in parts.items()}
        parts["total"] = total.detach()
        return parts

    return step


def train_retinanet(store: DetectorStore, steps: int = 2000,
                    batch_size: int = 4, im_size: int = 512,
                    lr: float = 1e-4, ckpt_dir: str | None = None,
                    log_every: int = 50, seed: int = 0,
                    save_every: int = 1000, anchor_base: float = 4.0,
                    device="cuda") -> DetTrainState:
    """Train the RetinaNet detector (ResNet-50 trunk) on scenes composed
    from ``store``, resuming from ``ckpt_dir``; returns the final
    state."""
    dev = torch.device(device)
    model = RetinaNetDetector(num_classes=store.num_classes)
    anchors = torch.as_tensor(anchor_boxes(im_size, base=anchor_base),
                              device=dev)
    state = create_retinanet_state(model, seed, dev)
    if ckpt_dir:
        restored, ep = ckpt.restore_train_state(ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed retinanet from checkpoint {ep}")
    raw_step = make_retinanet_step(model, anchors)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.time()
    for it in range(steps):
        batch = make_detector_batch(store, gen, batch_size, im_size)
        parts = raw_step(state, batch, lr * min(1.0, (it + 1) / WARMUP))
        if (it + 1) % log_every == 0 or it == steps - 1:
            m = {k: float(v) for k, v in parts.items()}
            print(f"it{it:05d} total={m['total']:.4f} cls={m['cls']:.4f} "
                  f"box={m['box']:.4f} ({time.time() - t0:.1f}s)",
                  flush=True)
        if ckpt_dir and it > 0 and it % save_every == 0:
            ckpt.save_train_state(ckpt_dir, state, it // save_every)
    print(f"{steps} steps in {time.time() - t0:.1f}s")
    if ckpt_dir:
        if steps:
            ckpt.save_train_state(ckpt_dir, state,
                                  max(steps - 1, 1) // save_every + 1)
        ckpt.export_inference(ckpt_dir,
                              state_dict_to_flax(model.state_dict()))
    return state


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(
        prog="python -m pix2pose_torch.training.retinanet_train")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("back_dir")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--anchor-base", type=float, default=4.0,
                   help="anchor level size = base * stride; drop toward "
                        "3.0 when the scene's small objects fall under "
                        "the base * stride_min anchor")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = require_device(args.device)

    ecfg = load_eval_config(args.cfg)
    ds = BopDataset(ecfg.dataset_dir, args.dataset, train=True)
    store = load_store(ds, args.back_dir, device)
    return train_retinanet(
        store, steps=args.steps, batch_size=args.batch,
        anchor_base=args.anchor_base,
        ckpt_dir=os.path.join(ds.dir, "weight_detection", "retinanet"),
        device=device)


if __name__ == "__main__":
    main()
