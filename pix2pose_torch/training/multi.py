"""Multi-object GAN training in one process (port of
:mod:`pix2pose_tpu.training.multi`; the reference's ``train.sh`` loop of
one ``3_train_pix2pose.py`` job per object)::

    python -m pix2pose_torch train-multi <cfg.json> <dataset> 1,5,6 \\
        <background_dir> [--epochs N] [--batch B] [--max-steps S] \\
        [--imagenet-h5 F] [--dtype float32|bfloat16] [--device cuda]

Without a CUDA device the command refuses to start unless ``--device
cpu`` is given.

One iteration (:func:`make_multi_step`) runs the K objects' single-object
steps in turn: each object keeps its own
:class:`~pix2pose_torch.training.gan.GanTrainState`, patch store,
symmetry pool, rotation-lock flag and ``torch.Generator``, and its batch,
label draws and update are :mod:`training.train`'s (``make_batch``,
``draw_labels``, ``make_train_step``). Per object that is what the JAX
package's vmapped step computes: its tile-padded stores are sampled below
each object's ``n_valid``, and its symmetry pools are padded with copies
of entry 0, which the transformer loss's argmin never prefers. The
stacking itself widens K small convolutions for the TPU's MXU; it is not
ported (``_tile_pad``, ``stack_stores``, ``stack_sym_pools``).

``train`` (:func:`pix2pose_torch.training.train.train_object`) is this
trainer with one object, so the per-object semantics are its: the epoch
length is the largest of the objects' ``batches_per_epoch``, training
resumes from the smallest checkpointed epoch, and every epoch writes each
object's ``epoch_XXXX.pt`` and montage (so a fused run resumes object by
object under ``train`` and the reverse); the end exports each object's
``inference.npz``. Losses are fetched from the device once per epoch.

One difference from the JAX trainer, on purpose: with a custom
``data_root`` each object's symmetry pool is read from that root's
``meta.json``, the data being trained on (the JAX trainer reads the
dataset's ``train_xyz`` whatever ``data_root`` is), as ``train`` does.
"""

from __future__ import annotations

import dataclasses
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
from pix2pose_torch.training.gan import (GanTrainState, compute_autocast,
                                         create_train_state, draw_labels,
                                         init_like_flax, make_train_step)
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)
from pix2pose_torch.utils.symmetry import training_sym_pool


@dataclasses.dataclass
class ObjectRun:
    """One object's share of a multi-object run."""

    obj_id: int
    state: GanTrainState
    store: PatchStore
    sym_pool: torch.Tensor      # (n_sym, 3, 3) on the store's device
    full_rotation: bool         # False: the pair renderer's rotation lock
    rng: torch.Generator        # the object's batches and label draws


def new_object_run(obj_id: int, store: PatchStore, sym_pool,
                   full_rotation: bool, cfg: TrainConfig, data_seed: int,
                   device="cuda") -> ObjectRun:
    """An object's fresh run, initialized as ``train`` initializes it
    (flax's defaults from a CPU generator seeded ``obj_id``, the
    generator first), its data stream seeded ``data_seed``."""
    dev = torch.device(device)
    init = torch.Generator().manual_seed(obj_id)
    gen = init_like_flax(AutoEncoder(backbone=cfg.backbone), init).to(dev)
    disc = init_like_flax(Discriminator(cfg.im_size), init).to(dev)
    return ObjectRun(
        obj_id=obj_id, state=create_train_state(gen, disc, cfg), store=store,
        sym_pool=torch.as_tensor(np.asarray(sym_pool), dtype=torch.float32,
                                 device=dev),
        full_rotation=full_rotation,
        rng=torch.Generator(device=dev).manual_seed(data_seed))


def make_multi_step(cfg: TrainConfig, train_step=None):
    """``step(runs, step_idx, lr, batches=None, labels=None) -> metrics``:
    one iteration for K objects, updating each run's state in place.
    Object k draws its batch (``make_batch`` at ``step_idx``) and then its
    labels (``draw_labels``) from its own generator unless ``batches[k]``
    / ``labels[k]`` are given (the tests inject the JAX package's), and
    takes ``train_step`` on them (default ``make_train_step(cfg)``; the
    data-parallel one of :mod:`pix2pose_torch.parallel.mesh`).
    Returns each metric as a (K,) device tensor: no host sync."""
    raw_step = train_step or make_train_step(cfg)

    def step(runs: Sequence[ObjectRun], step_idx: int, lr: float,
             batches=None, labels=None) -> dict:
        out = []
        for k, run in enumerate(runs):
            batch = batches[k] if batches is not None else make_batch(
                run.store, run.rng, step_idx, cfg.batch_size,
                full_rotation=run.full_rotation)
            lab = labels[k] if labels is not None else draw_labels(
                run.rng, cfg.batch_size, cfg.label_flipping)
            out.append(raw_step(run.state, batch, run.sym_pool, lr, lab))
        return {name: torch.stack([m[name] for m in out]) for name in out[0]}

    return step


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


def _load_object(dataset, obj_id, data_dir, back_dir, cfg, weight_root,
                 imagenet_h5, dev):
    """(run, resumed epoch) of one object trained on ``data_dir``."""
    store = PatchStore.load(data_dir, back_dir, device=dev)
    print(f"obj {obj_id}: {store.n_data} training views")
    # rotation_lock set by the training-pair renderer for continuous-sym
    # objects with a camera-parallel axis (reference ``2_2:46-50``)
    full_rot = True
    meta_fn = os.path.join(data_dir, "meta.json")
    if os.path.exists(meta_fn):
        with open(meta_fn) as f:
            full_rot = not json.load(f).get("rotation_lock", False)
    pool = training_sym_pool(
        dataset, obj_id, out_root=os.path.dirname(os.path.abspath(data_dir)))
    run = new_object_run(obj_id, store, pool, full_rot, cfg, 1234 + obj_id,
                         dev)
    restored, epoch = ckpt.restore_train_state(
        os.path.join(weight_root, f"{obj_id:02d}"), run.state)
    if restored is None:
        epoch = 0
    else:
        print(f"resumed from epoch {epoch}")
        run.state = restored
    if imagenet_h5 and epoch == 0:
        if cfg.backbone != "resnet50":
            raise ValueError("--imagenet-h5 requires backbone=resnet50")
        from pix2pose_torch.utils.hdf5_import import \
            init_generator_trunk_from_imagenet
        gen = run.state.gen
        variables = init_generator_trunk_from_imagenet(
            state_dict_to_flax(gen.state_dict()), imagenet_h5)
        gen.load_state_dict(flax_to_state_dict(variables), strict=True)
        print(f"obj {obj_id}: initialized resnet50 trunk from {imagenet_h5}")
    return run, epoch


def train_objects(dataset: BopDataset, obj_ids: Sequence[int],
                  back_dir: str, cfg: TrainConfig = TrainConfig(),
                  weight_root: str | None = None,
                  data_root: str | None = None,
                  log_every: int = 10, max_steps: int | None = None,
                  imagenet_h5: str | None = None, device="cuda",
                  data_dirs: Sequence[str] | None = None
                  ) -> list[ObjectRun]:
    """Train K objects' generators on ``device`` in one process; returns
    the final :class:`ObjectRun` of each object. Checkpoints, montages and
    exports go to ``<weight_root>/<obj:02d>/`` (``train``'s layout). Each
    object's pairs are read from ``<data_root>/<obj:02d>``
    (``data_root`` defaults to ``<dataset>/train_xyz``), or from
    ``data_dirs[k]`` when those are given.

    ``imagenet_h5``: the keras-applications notop ResNet-50 ImageNet file;
    with the resnet50 backbone a FRESH run initializes the encoder trunk
    from it (the reference's pretrained init, ``resnet50_mod.py:246-258``).
    Ignored when resuming from a checkpoint.
    """
    dev = torch.device(device)
    weight_root = weight_root or os.path.join(dataset.dir,
                                              "pix2pose_weights")
    if data_dirs is None:
        base = data_root or os.path.join(dataset.dir, "train_xyz")
        data_dirs = [os.path.join(base, f"{o:02d}") for o in obj_ids]
    runs, epochs = [], []
    for obj_id, data_dir in zip(obj_ids, data_dirs, strict=True):
        run, epoch = _load_object(dataset, obj_id, data_dir, back_dir, cfg,
                                  weight_root, imagenet_h5, dev)
        runs.append(run)
        epochs.append(epoch)
    if len(set(epochs)) != 1:
        print(f"WARNING: resume epochs differ per object ({epochs}); "
              f"training all from min = {min(epochs)}")
    epoch = min(epochs)

    step_fn = make_multi_step(cfg)
    n_batch = max(cfg.batches_per_epoch(r.store.n_data) for r in runs)
    total_steps = 0
    while epoch < cfg.max_epoch:
        lr = cfg.lr_schedule[min(epoch, len(cfg.lr_schedule) - 1)]
        t0 = time.time()
        pending = []  # (it, metrics of (K,)) on the device, fetched per epoch
        for it in range(n_batch):
            metrics = step_fn(runs, total_steps, lr)
            total_steps += 1
            if (it + 1) % log_every == 0:
                pending.append((it, metrics))
            if max_steps is not None and total_steps >= max_steps:
                break
        logged = {k: (torch.stack([m[k] for _, m in pending]).cpu().numpy()
                      if pending else np.full((1, len(runs)), np.nan))
                  for k in ("recon_loss", "disc_loss", "gen_adv_loss")}
        for i, (it, _) in enumerate(pending):
            print(f"E{epoch:02d} it{it:04d}/{n_batch} "
                  f"recon={_fmt(logged['recon_loss'][i])} "
                  f"disc={_fmt(logged['disc_loss'][i])} "
                  f"gen={_fmt(logged['gen_adv_loss'][i])} lr={lr:g}")
        epoch += 1
        _save_epoch(weight_root, runs, epoch, cfg)
        print(f"epoch {epoch} ({len(runs)} objects) done in "
              f"{time.time() - t0:.1f}s mean_recon="
              f"{_fmt(logged['recon_loss'].mean(0))}")
        if max_steps is not None and total_steps >= max_steps:
            break

    for run in runs:
        wdir = os.path.join(weight_root, f"{run.obj_id:02d}")
        path = ckpt.export_inference(
            wdir, state_dict_to_flax(run.state.gen.state_dict()))
        print(f"obj {run.obj_id}: exported inference params to {path}")
    return runs


def _fmt(values) -> str:
    return "[" + " ".join(f"{v:.4f}" for v in values) + "]"


def _save_epoch(weight_root, runs, epoch, cfg):
    """Each object's train state and validation montage."""
    for run in runs:
        wdir = os.path.join(weight_root, f"{run.obj_id:02d}")
        ckpt.save_train_state(wdir, run.state, epoch)
        vb = make_batch(run.store, run.rng, 1, cfg.batch_size,
                        full_rotation=run.full_rotation)
        gen = run.state.gen
        gen.eval()
        with torch.no_grad(), compute_autocast(cfg, vb["src"].device.type):
            gen_img = gen(vb["src"])[0]
        save_val_montage(os.path.join(wdir, "val_img",
                                      f"epoch_{epoch:02d}.png"),
                         vb["src"], vb["tgt"], gen_img)


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(
        prog="python -m pix2pose_torch train-multi",
        description="Multi-object GAN training in one process: the "
                    "reference's train.sh loop as one command.")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("obj_ids", help="comma-separated object ids, e.g. 1,5,6")
    p.add_argument("back_dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--imagenet-h5", default=None)
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
        kw["max_epoch"] = args.epochs
    if args.batch:
        kw["batch_size"] = args.batch
    obj_ids = [int(x) for x in args.obj_ids.split(",")]
    return train_objects(ds, obj_ids, args.back_dir, TrainConfig(**kw),
                         max_steps=args.max_steps,
                         imagenet_h5=args.imagenet_h5, device=device)


if __name__ == "__main__":
    main()
