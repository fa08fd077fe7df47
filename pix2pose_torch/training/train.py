"""Per-object GAN training of the generator (port of
:mod:`pix2pose_tpu.training.train`).

CLI mirror of ``python3 tools/3_train_pix2pose.py <gpu> <cfg> <dataset>
<obj_id> <background_dir>``; ``--device`` (default ``cuda``) replaces the
gpu argument, and without a CUDA device the command refuses to start
unless ``--device cpu`` is given::

    python -m pix2pose_torch train <cfg.json> <dataset> <obj_id> \\
        <background_dir> [--epochs N] [--batch B] [--max-steps S] \\
        [--imagenet-h5 F] [--dtype float32|bfloat16] [--device cuda]

Reference semantics kept: the symmetry pool from models_info filtered by
the pair renderer's probe (``3_train:96-111``), epoch = min(n_data /
batch * 10, 3000) batches (``3_train:191``), the BOP lr schedule
(``3_train:169-173``), a checkpoint per epoch with resume from the newest
(``3_train:139-167,247-250``), a validation montage per epoch
(``3_train:252-264``), and the generator-only inference export at the end
(``3_train:271-277``), here ``inference.npz``, which the port's
``eval`` / ``serve`` read.

One difference from the JAX trainer, on purpose: with a custom
``data_dir`` the symmetry pool's ``meta.json`` is read from that
directory's parent, the data being trained on (the JAX trainer reads the
dataset's ``train_xyz`` whatever ``data_dir`` is).
"""

from __future__ import annotations

import json
import os
import time
from typing import Sequence

import numpy as np
import torch

from pix2pose_torch.config import TrainConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.models import AutoEncoder, Discriminator
from pix2pose_torch.training.data import PatchStore, make_batch
from pix2pose_torch.training.gan import (compute_autocast,
                                         create_train_state, draw_labels,
                                         init_like_flax, make_train_step)
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)
from pix2pose_torch.utils.symmetry import training_sym_pool


def save_val_montage(path, src, tgt, gen, n: int = 10):
    """(input | GT xyz | prediction) grid png (``3_train:252-264``); the
    images are (B, S, S, 3) tensors or arrays in [-1, 1]."""
    from PIL import Image

    def host(x):
        return x.detach().float().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    src, tgt, gen = host(src), host(tgt), host(gen)
    n = min(n, src.shape[0])
    rows = [np.concatenate([(src[i] + 1) / 2, (tgt[i] + 1) / 2,
                            (gen[i] + 1) / 2], axis=1) for i in range(n)]
    img = (np.clip(np.concatenate(rows, axis=0), 0, 1) * 255).astype(
        np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def train_object(dataset: BopDataset, obj_id: int, back_dir: str,
                 cfg: TrainConfig = TrainConfig(),
                 weight_root: str | None = None,
                 data_dir: str | None = None,
                 log_every: int = 10, max_steps: int | None = None,
                 imagenet_h5: str | None = None, device="cuda"):
    """Train one object's generator on ``device``; returns the final
    :class:`~pix2pose_torch.training.gan.GanTrainState`.

    ``imagenet_h5``: the keras-applications notop ResNet-50 ImageNet file;
    with the resnet50 backbone a FRESH run initializes the encoder trunk
    from it (the reference's pretrained init, ``resnet50_mod.py:246-258``).
    Ignored when resuming from a checkpoint.
    """
    dev = torch.device(device)
    weight_root = weight_root or os.path.join(dataset.dir,
                                              "pix2pose_weights")
    weight_dir = os.path.join(weight_root, f"{obj_id:02d}")
    data_dir = data_dir or os.path.join(dataset.dir, "train_xyz",
                                        f"{obj_id:02d}")
    store = PatchStore.load(data_dir, back_dir, device=dev)
    print(f"obj {obj_id}: {store.n_data} training views")
    # rotation_lock set by the training-pair renderer for continuous-sym
    # objects with a camera-parallel axis (reference ``2_2:46-50``)
    full_rot = True
    meta_fn = os.path.join(data_dir, "meta.json")
    if os.path.exists(meta_fn):
        with open(meta_fn) as f:
            full_rot = not json.load(f).get("rotation_lock", False)

    sym_pool = torch.as_tensor(
        training_sym_pool(dataset, obj_id,
                          out_root=os.path.dirname(os.path.abspath(
                              data_dir))),
        dtype=torch.float32, device=dev)
    init = torch.Generator().manual_seed(obj_id)
    gen = init_like_flax(AutoEncoder(backbone=cfg.backbone), init).to(dev)
    disc = init_like_flax(Discriminator(cfg.im_size), init).to(dev)
    state = create_train_state(gen, disc, cfg)
    state, epoch = _maybe_resume(weight_dir, state)
    if imagenet_h5 and epoch == 0:
        if cfg.backbone != "resnet50":
            raise ValueError("--imagenet-h5 requires backbone=resnet50")
        from pix2pose_torch.utils.hdf5_import import \
            init_generator_trunk_from_imagenet
        variables = init_generator_trunk_from_imagenet(
            state_dict_to_flax(gen.state_dict()), imagenet_h5)
        gen.load_state_dict(flax_to_state_dict(variables), strict=True)
        print(f"initialized resnet50 trunk from {imagenet_h5}")
    step_fn = make_train_step(cfg)
    n_batch = cfg.batches_per_epoch(store.n_data)
    rng = torch.Generator(device=dev).manual_seed(1234 + obj_id)
    total_steps = 0
    while epoch < cfg.max_epoch:
        lr = cfg.lr_schedule[min(epoch, len(cfg.lr_schedule) - 1)]
        recon_hist = []
        t0 = time.time()
        for it in range(n_batch):
            batch = make_batch(store, rng, total_steps, cfg.batch_size,
                               full_rotation=full_rot)
            labels = draw_labels(rng, cfg.batch_size, cfg.label_flipping)
            metrics = step_fn(state, batch, sym_pool, lr, labels)
            total_steps += 1
            if (it + 1) % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                recon_hist.append(m["recon_loss"])
                print(f"E{epoch:02d} it{it:04d}/{n_batch} "
                      f"recon={m['recon_loss']:.4f} "
                      f"disc={m['disc_loss']:.4f} "
                      f"gen={m['gen_adv_loss']:.4f} lr={lr:g}")
            if max_steps is not None and total_steps >= max_steps:
                break
        epoch += 1
        ckpt.save_train_state(weight_dir, state, epoch)
        # validation montage
        vb = make_batch(store, rng, 1, cfg.batch_size)
        gen.eval()
        with torch.no_grad(), compute_autocast(cfg, dev.type):
            gen_img = gen(vb["src"])[0]
        save_val_montage(os.path.join(weight_dir, "val_img",
                                      f"epoch_{epoch:02d}.png"),
                         vb["src"], vb["tgt"], gen_img)
        print(f"epoch {epoch} done in {time.time() - t0:.1f}s "
              f"mean_recon={np.mean(recon_hist or [np.nan]):.4f}")
        if max_steps is not None and total_steps >= max_steps:
            break

    path = ckpt.export_inference(weight_dir,
                                 state_dict_to_flax(gen.state_dict()))
    print(f"exported inference params to {path}")
    return state


def _maybe_resume(weight_dir, state):
    restored, epoch = ckpt.restore_train_state(weight_dir, state)
    if restored is None:
        return state, 0
    print(f"resumed from epoch {epoch}")
    return restored, epoch


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(prog="python -m pix2pose_torch train")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("obj_id", type=int)
    p.add_argument("back_dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--imagenet-h5", default=None,
                   help="keras-applications notop resnet50 h5: pretrained "
                        "trunk init for fresh resnet50-backbone runs "
                        "(reference resnet50_mod.py:246-258)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="conv compute dtype (mixed precision; params fp32)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = require_device(args.device)

    ecfg = load_eval_config(args.cfg)
    ds = BopDataset(ecfg.dataset_dir, args.dataset, train=True)
    kw = {"backbone": ecfg.backbone, "compute_dtype": args.dtype}
    if args.epochs:
        kw.update(max_epoch=args.epochs, batch_size=args.batch or 50)
    elif args.batch:
        kw.update(batch_size=args.batch)
    tcfg = TrainConfig(**kw)
    return train_object(ds, args.obj_id, args.back_dir, tcfg,
                        max_steps=args.max_steps,
                        imagenet_h5=args.imagenet_h5, device=device)


if __name__ == "__main__":
    main()
