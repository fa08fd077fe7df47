"""Detection-training scene generator, disk format (port of
:mod:`pix2pose_tpu.tools.scene_gen_detection`; the reference's
``tools/1_1_scene_gen_for_detection_maskrcnn.py``).

Writes cluttered composites and annotations in the reference's on-disk
format under ``<dataset>/train_detect/``: ``{i:06d}.jpg`` (PIL quality
92), a class-id instance map ``mask/{i:06d}.npy`` (uint8, S x S,
Mask-RCNN style, ``1_1:62-66,256``) and RetinaNet ``gt.csv`` /
``label.csv`` (``1_1:67-70,311``). The scenes are composed on the device
(:func:`~pix2pose_torch.training.detector_data.make_detector_batch`, 8 per
batch); the port's own trainers need no files, this is for external
detector trainers.

CLI (``--device`` defaults to ``cuda``)::

    python -m pix2pose_torch scene-gen <cfg.json> <dataset> \\
        <background_dir> [--num N] [--device cuda]
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.training.detector_data import (DetectorStore,
                                                   make_detector_batch)

BATCH = 8


def generate_scenes(store: DetectorStore, out_dir: str, num: int = 1000,
                    im_size: int = 512, k_obj: int = 10, seed: int = 0,
                    class_to_obj_id=None, draws=None) -> int:
    """Write ``num`` composites and their annotations to ``out_dir``;
    returns the count. The scenes come from a generator on the store's
    device seeded ``seed``, or from ``draws`` (a sequence with one
    :func:`~pix2pose_torch.training.detector_data.draw_detector_batch`
    dict per batch of 8)."""
    from PIL import Image

    os.makedirs(os.path.join(out_dir, "mask"), exist_ok=True)
    gen = torch.Generator(device=store.rgb.device).manual_seed(seed)
    gt_rows = []
    img_id = 0
    while img_id < num:
        b = make_detector_batch(
            store, gen, BATCH, im_size, k_obj,
            draws=None if draws is None else draws[img_id // BATCH])
        imgs, segs, heats, whs, regs = (
            b[k].cpu().numpy() for k in ("image", "seg", "heat", "wh",
                                         "reg_mask"))
        for bi in range(BATCH):
            if img_id >= num:
                break
            fn = f"{img_id:06d}"
            Image.fromarray(
                (np.clip(imgs[bi], 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(out_dir, fn + ".jpg"), quality=92)
            # class-id map at full resolution (like 1_1's object-index
            # map), upsampled from the stride-4 seg
            seg_up = np.array(Image.fromarray(
                segs[bi].argmax(-1).astype(np.uint8) + 1).resize(
                (im_size, im_size), Image.NEAREST))
            any_obj = np.array(Image.fromarray(
                (segs[bi].max(-1) > 0.5).astype(np.uint8)).resize(
                (im_size, im_size), Image.NEAREST)) > 0
            np.save(os.path.join(out_dir, "mask", fn + ".npy"),
                    np.where(any_obj, seg_up, 0).astype(np.uint8))
            # retinanet-style rows from the center targets
            for cv, cu in np.argwhere(regs[bi] > 0):
                hh, ww = whs[bi, cv, cu] * 4
                cls = int(heats[bi, cv, cu].argmax())
                obj = class_to_obj_id[cls] if class_to_obj_id else cls + 1
                v1 = max(int(cv * 4 - hh / 2), 0)
                u1 = max(int(cu * 4 - ww / 2), 0)
                v2 = min(int(cv * 4 + hh / 2), im_size - 1)
                u2 = min(int(cu * 4 + ww / 2), im_size - 1)
                gt_rows.append(f"{fn}.jpg,{u1},{v1},{u2},{v2},obj_{obj}")
            img_id += 1
    with open(os.path.join(out_dir, "gt.csv"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    ids = (class_to_obj_id if class_to_obj_id
           else [c + 1 for c in range(store.num_classes)])
    with open(os.path.join(out_dir, "label.csv"), "w") as f:
        f.write("\n".join(f"obj_{o},{c}" for c, o in enumerate(ids)) + "\n")
    return img_id


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.training.detector_train import load_store
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch scene-gen")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("back_dir")
    p.add_argument("--num", type=int, default=20000)
    p.add_argument("--device", default="cuda",
                   help="torch device to compose the scenes on")
    args = p.parse_args(argv)
    device = require_device(args.device)
    ecfg = load_eval_config(args.cfg)
    ds = BopDataset(ecfg.dataset_dir, args.dataset, train=True)
    store = load_store(ds, args.back_dir, device)
    obj_ids = [o for o in ds.model_ids if os.path.isdir(
        os.path.join(ds.dir, "train_xyz", f"{o:02d}"))]
    out = os.path.join(ds.dir, "train_detect")
    n = generate_scenes(store, out, num=args.num, class_to_obj_id=obj_ids)
    print(f"wrote {n} scenes to {out}")
    return n


if __name__ == "__main__":
    main()
