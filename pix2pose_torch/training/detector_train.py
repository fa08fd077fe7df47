"""Detector training (port of :mod:`pix2pose_tpu.training.detector_train`;
the reference's Mask-RCNN trainer shim, ``tools/1_2_train_maskrcnn.py``):
Adam steps on the CenterNet / CondInst losses over scenes synthesized on
the device, with per-epoch train states and the inference export.

CLI (``--device`` defaults to ``cuda``; without a CUDA device the command
refuses to start unless ``--device cpu`` is given)::

    python -m pix2pose_torch.training.detector_train <cfg.json> <dataset> \\
        <background_dir> [--steps N] [--batch B] [--device cuda]

It trains on ``<dataset>/train_xyz/<obj:02d>/`` of every object that has
pairs (class index = rank of obj_id), writes ``epoch_XXXX.pt`` train
states and ``inference.npz`` under ``<dataset>/weight_detection/
centernet/`` (which ``serve``, ``run-detector`` and ``eval-detector``
load strictly), and a rerun resumes from the newest state.

JAX semantics kept: flax's initialization (LeCun-normal kernels, zero
biases, the heat and seg outputs at -2.19), ``optax.scale_by_adam`` then
``-lr`` (``torch.optim.Adam``, no weight decay) with the warmup ``lr *
min(1, (it + 1) / 200)``, states indexed ``it // save_every`` and the
final one ``max(steps - 1, 1) // save_every + 1``. The scene-pool regime
(:func:`make_pooled_detector_step`) keeps a ring buffer of packed scenes
on the device. Every random number comes from ``torch.Generator``\\ s
seeded from ``seed``: the initialization (CPU), the scenes and the pool
windows (the device).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import torch
from torch import nn

from pix2pose_torch.models.ae import deterministic_cudnn
from pix2pose_torch.models.detector import CenterNetDetector, detector_loss
from pix2pose_torch.training.detector_data import (DetectorStore,
                                                   make_detector_batch,
                                                   pack_detector_batch,
                                                   unpack_detector_batch)
from pix2pose_torch.training.gan import init_like_flax
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import BIAS_INIT, state_dict_to_flax

WARMUP = 200  # steps of linear lr warmup


@dataclasses.dataclass
class DetTrainState:
    """A detector, its Adam optimizer and the number of steps taken."""

    model: nn.Module
    opt: torch.optim.Adam
    step: int = 0


def init_detector(model: nn.Module, seed: int) -> nn.Module:
    """flax's initialization of a detector, in place: LeCun-normal
    kernels and zero biases from a CPU generator seeded ``seed``
    (:func:`~pix2pose_torch.training.gan.init_like_flax`), then the
    constant bias of each classifier output (heat and seg at -2.19,
    RetinaNet's cls at -log(99)): a heat bias of 0 starts every focal-loss
    pixel at p = 0.5."""
    init_like_flax(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, m in model.named_modules():
            if name in BIAS_INIT:
                m.bias.fill_(BIAS_INIT[name])
    return model


def create_detector_state(model: nn.Module, seed: int = 0,
                          device="cuda") -> DetTrainState:
    """``model`` initialized as flax does (:func:`init_detector`), placed
    on ``device``, with Adam (betas (0.9, 0.999), eps 1e-8; the lr is set
    per step)."""
    model = init_detector(model, seed).to(torch.device(device))
    return DetTrainState(model=model, opt=torch.optim.Adam(
        model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8))


def adam_update(state: DetTrainState, total, lr: float):
    """Backward of ``total`` and one Adam update of ``state`` at ``lr``."""
    for group in state.opt.param_groups:
        group["lr"] = lr
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    state.opt.step()
    state.step += 1


def make_detector_step(model: nn.Module):
    """``step(state, batch, lr) -> parts``: the train-mode forward, the
    :func:`~pix2pose_torch.models.detector.detector_loss` (with the
    instance-mask term when the batch has ``gt_mask``) and one Adam update,
    in place, under cuDNN's deterministic algorithms
    (:func:`~pix2pose_torch.models.ae.deterministic_cudnn`: two trainings
    of one seed give the same weights). ``parts`` (``total``, ``heat``,
    ``wh``, ``off``, ``seg``, ``mask``) are 0-d device tensors: no host
    sync."""

    def step(state: DetTrainState, batch: dict, lr: float) -> dict:
        model.train()
        with deterministic_cudnn():
            total, parts = detector_loss(model(batch["image"]), batch)
            adam_update(state, total, lr)
        parts = {k: v.detach() for k, v in parts.items()}
        parts["total"] = total.detach()
        return parts

    return step


def make_pooled_detector_step(model: nn.Module, pool_size: int,
                              batch_size: int, im_size: int,
                              fresh_per_step: int = 4, k_obj: int = 8,
                              stride: int = 4, scale_range=(0.6, 1.6),
                              refresh_every: int = 4):
    """Scene-pool training: a ring buffer of packed scenes on the device
    (:func:`~pix2pose_torch.training.detector_data.pack_detector_batch`:
    uint8 image, bfloat16 dense targets, bool ``reg_mask``). Every
    ``refresh_every``-th step composes ``fresh_per_step * refresh_every``
    scenes into the pool at offset ``((it // refresh_every) * chunk) %
    pool_size``; every step trains on a random contiguous window of
    ``batch_size`` scenes. The reference composes its detector set
    offline and reuses every scene for many epochs; this keeps that
    amortization of the composer.

    Returns ``(init_pool, step_fn)``::

        pool = init_pool(store, gen)                          # once
        parts = step_fn(state, store, pool, it, gen, lr)      # in place

    ``step_fn`` takes ``draws`` (the fresh scenes' draws,
    :func:`~pix2pose_torch.training.detector_data.draw_detector_batch`)
    and ``start`` (the window) in place of ``gen``'s, as the tests inject
    the JAX package's."""
    chunk = fresh_per_step * refresh_every
    if pool_size % chunk or pool_size < batch_size:
        raise ValueError("pool_size must be a multiple of fresh_per_step"
                         " * refresh_every and >= batch_size")
    raw_step = make_detector_step(model)

    def compose(store, gen, draws=None):
        return pack_detector_batch(make_detector_batch(
            store, gen, chunk, im_size, k_obj=k_obj, stride=stride,
            scale_range=scale_range, draws=draws))

    def init_pool(store: DetectorStore, gen: torch.Generator) -> dict:
        chunks = [compose(store, gen) for _ in range(pool_size // chunk)]
        return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}

    def step_fn(state, store, pool: dict, it: int, gen, lr: float,
                draws: dict | None = None, start: int | None = None):
        if it % refresh_every == 0:
            fresh = compose(store, gen, draws)
            off = ((it // refresh_every) * chunk) % pool_size
            for k, v in pool.items():
                v[off:off + chunk] = fresh[k]
        dev = pool["image"].device
        if start is None:  # stays on the device: no host sync
            start = torch.randint(0, pool_size - batch_size + 1, (),
                                  generator=gen, device=dev)
        rows = start + torch.arange(batch_size, device=dev)
        batch = unpack_detector_batch(
            {k: v.index_select(0, rows) for k, v in pool.items()})
        return raw_step(state, batch, lr)

    return init_pool, step_fn


def _log(it: int, parts: dict, t0: float):
    m = {k: float(v) for k, v in parts.items()}
    print(f"it{it:05d} total={m['total']:.4f} heat={m['heat']:.4f} "
          f"wh={m['wh']:.4f} seg={m['seg']:.4f} mask={m['mask']:.4f} "
          f"({time.time() - t0:.1f}s)", flush=True)


def train_detector(store: DetectorStore, steps: int = 2000,
                   batch_size: int = 4, im_size: int = 512,
                   lr: float = 2.5e-4, ckpt_dir: str | None = None,
                   log_every: int = 20, seed: int = 0,
                   save_every: int = 1000, pool_size: int | None = None,
                   fresh_per_step: int = 4,
                   device="cuda") -> DetTrainState:
    """Train the CenterNet detector on scenes composed from ``store`` (on
    ``device``), resuming from ``ckpt_dir``'s newest state; returns the
    final :class:`DetTrainState`. ``pool_size`` switches to the
    scene-pool regime (:func:`make_pooled_detector_step`)."""
    dev = torch.device(device)
    model = CenterNetDetector(num_classes=store.num_classes)
    state = create_detector_state(model, seed, dev)
    if ckpt_dir:
        restored, ep = ckpt.restore_train_state(ckpt_dir, state)
        if restored is not None:
            state = restored
            print(f"resumed detector from checkpoint {ep}")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    if pool_size:
        init_pool, pooled = make_pooled_detector_step(
            model, pool_size, batch_size, im_size,
            fresh_per_step=fresh_per_step)
        pool = init_pool(store, torch.Generator(device=dev).manual_seed(
            seed + 2))

        def step_fn(it, cur_lr):
            return pooled(state, store, pool, it, gen, cur_lr)
    else:
        raw_step = make_detector_step(model)

        def step_fn(it, cur_lr):
            batch = make_detector_batch(store, gen, batch_size, im_size)
            return raw_step(state, batch, cur_lr)

    t0 = time.time()
    for it in range(steps):
        parts = step_fn(it, lr * min(1.0, (it + 1) / WARMUP))
        if (it + 1) % log_every == 0 or it == steps - 1:
            _log(it, parts, t0)
        if ckpt_dir and it > 0 and it % save_every == 0:
            ckpt.save_train_state(ckpt_dir, state, it // save_every)
    print(f"{steps} steps in {time.time() - t0:.1f}s")
    if ckpt_dir:
        if steps:  # a resumable final state, not only the export
            ckpt.save_train_state(ckpt_dir, state,
                                  max(steps - 1, 1) // save_every + 1)
        ckpt.export_inference(ckpt_dir,
                              state_dict_to_flax(model.state_dict()))
    return state


def load_store(ds, back_dir: str | None, device) -> DetectorStore:
    """A :class:`DetectorStore` of every object of ``ds`` with pairs in
    ``train_xyz/<obj:02d>/``, on ``device``; exits when there are none."""
    from pix2pose_torch.training.data import PatchStore

    stores = {}
    for obj_id in ds.model_ids:
        d = os.path.join(ds.dir, "train_xyz", f"{obj_id:02d}")
        if os.path.isdir(d):
            stores[obj_id] = PatchStore.load(d, back_dir, device=device)
    if not stores:
        raise SystemExit("no train_xyz data found — run render-pairs "
                         "first")
    return DetectorStore.from_patch_stores(
        stores, stores[next(iter(stores))].backs)


def main(argv: Sequence[str] | None = None):
    import argparse

    from pix2pose_torch.config import load_eval_config
    from pix2pose_torch.data.bop import BopDataset
    from pix2pose_torch.utils.cli import require_device

    p = argparse.ArgumentParser(
        prog="python -m pix2pose_torch.training.detector_train")
    p.add_argument("cfg")
    p.add_argument("dataset")
    p.add_argument("back_dir")
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on")
    args = p.parse_args(argv)
    device = require_device(args.device)

    ecfg = load_eval_config(args.cfg)
    ds = BopDataset(ecfg.dataset_dir, args.dataset, train=True)
    store = load_store(ds, args.back_dir, device)
    return train_detector(
        store, steps=args.steps, batch_size=args.batch,
        ckpt_dir=os.path.join(ds.dir, "weight_detection", "centernet"),
        device=device)


if __name__ == "__main__":
    main()
