"""Checkpoints (port of :mod:`pix2pose_tpu.utils.checkpoint`): the
trainer's per-epoch train states and the inference artifact.

A train state is ``<weight_dir>/epoch_XXXX.pt``, written with
``torch.save``: each network's and optimizer's ``state_dict``, the step
and the epoch (the JAX package writes an orbax ``epoch_XXXX/`` directory
of the same contents). Resuming reads the newest.

A deployment artifact is ``<weight_dir>/inference.npz``: the flax
variables tree (``{'params': ..., 'batch_stats': ...}``) as numpy arrays
keyed by "/"-joined paths. :func:`load_inference_params` returns the
nested numpy tree that :func:`pix2pose_torch.utils.convert.
flax_to_state_dict` takes. It is numpy only, so a checkpoint written by
either package loads on a machine without JAX.

The JAX package writes an orbax ``<weight_dir>/inference/`` directory,
which needs JAX to read. Convert it once where JAX is installed, with
``load_inference_params`` of ``pix2pose_tpu.utils.checkpoint`` and
``export_inference`` of this module::

    export_inference(wdir, jax.device_get(load_inference_params(wdir)))

A reference Keras ``inference*.hdf5`` (no ``inference.npz`` beside it)
is read through :mod:`pix2pose_torch.utils.hdf5_import`, the loader
chosen by the file's name as the JAX package chooses it; ``python -m
pix2pose_torch convert-weights`` writes it out as ``inference.npz`` once.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

NPZ_NAME = "inference.npz"
KERAS_NAMES = ("inference.hdf5", "inference_resnet_model.hdf5",
               "inference_resnet50.hdf5")


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"checkpoint key {k!r} contains '/'")
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def _epoch_path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"epoch_{epoch:04d}.pt")


def save_train_state(ckpt_dir: str, state, epoch: int) -> str:
    """Per-epoch snapshot of a train state dataclass (a
    :class:`~pix2pose_torch.training.gan.GanTrainState` or a
    :class:`~pix2pose_torch.training.detector_train.DetTrainState`): the
    ``state_dict`` of each network and optimizer field (networks with
    their BatchNorm statistics, optimizer moments and counts), the other
    fields (the step) as they are, and the epoch; returns the path."""
    import torch

    os.makedirs(ckpt_dir, exist_ok=True)
    path = _epoch_path(ckpt_dir, epoch)
    snap = {}
    for name in (f.name for f in dataclasses.fields(state)):
        value = getattr(state, name)
        snap[name] = (value.state_dict() if hasattr(value, "state_dict")
                      else value)
    snap["epoch"] = epoch
    torch.save(snap, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def latest_epoch(ckpt_dir: str) -> int:
    """The newest epoch snapshot by filename scan (``epoch_XXXX`` with or
    without ``.pt``, like the reference's resume at ``3_train:139-167``);
    -1 when none."""
    if not os.path.isdir(ckpt_dir):
        return -1
    best = -1
    for name in os.listdir(ckpt_dir):
        if name.startswith("epoch_"):
            stem = name.split("_")[1]
            stem = stem[:-3] if stem.endswith(".pt") else stem
            if stem.isdigit():
                best = max(best, int(stem))
    return best


def restore_train_state(ckpt_dir: str, state, epoch: int | None = None):
    """Load the given (or newest) epoch snapshot into ``state``'s networks
    and optimizers, in place, on the device its parameters are on, and
    set its other fields. Returns (state, epoch), or (None, -1) when there
    is none."""
    import torch

    e = latest_epoch(ckpt_dir) if epoch is None else epoch
    if e < 0:
        return None, -1
    names = [f.name for f in dataclasses.fields(state)]
    dev = next(getattr(state, names[0]).parameters()).device
    snap = torch.load(_epoch_path(ckpt_dir, e), map_location=dev)
    for name in names:
        value = getattr(state, name)
        if hasattr(value, "load_state_dict"):
            value.load_state_dict(snap[name])
        else:
            setattr(state, name, snap[name])
    return state, int(snap["epoch"])


def export_inference(weight_dir: str, variables: dict) -> str:
    """Write ``variables`` (nested dicts of arrays) to
    ``<weight_dir>/inference.npz``; returns the path."""
    os.makedirs(weight_dir, exist_ok=True)
    path = os.path.join(weight_dir, NPZ_NAME)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **dict(_flatten(variables)))
    os.replace(tmp, path)
    return path


def load_inference_params(weight_dir: str) -> dict | None:
    """The variables tree of ``<weight_dir>/inference.npz``, else of a
    Keras ``inference.hdf5`` / ``inference_resnet_model.hdf5`` /
    ``inference_resnet50.hdf5`` (ResNet-50 for a name with "resnet"), as
    nested dicts of numpy arrays; None when the directory holds no
    inference checkpoint. Raises on an orbax ``inference/`` directory,
    which needs JAX to read."""
    path = os.path.join(weight_dir, NPZ_NAME)
    if os.path.exists(path):
        tree: dict = {}
        with np.load(path) as z:
            for key in z.files:
                *parents, leaf = key.split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
        tree.setdefault("batch_stats", {})
        return tree
    if os.path.isdir(os.path.join(weight_dir, "inference")):
        raise RuntimeError(
            f"{weight_dir} holds an orbax 'inference/' checkpoint, which "
            f"needs JAX to read. Convert it once where JAX is installed:\n"
            f"  from pix2pose_tpu.utils.checkpoint import "
            f"load_inference_params\n"
            f"  from pix2pose_torch.utils.checkpoint import "
            f"export_inference\n"
            f"  export_inference(wdir, jax.device_get("
            f"load_inference_params(wdir)))")
    for name in KERAS_NAMES:
        h5 = os.path.join(weight_dir, name)
        if os.path.exists(h5):
            from pix2pose_torch.utils.hdf5_import import load_keras_inference
            return load_keras_inference(h5)
    return None
