"""Inference checkpoints (port of the deployment half of
:mod:`pix2pose_tpu.utils.checkpoint`).

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

Keras ``inference*.hdf5`` files are read by the JAX package's import
shim; the port reads them once ``hdf5_import`` is ported with training.
"""

from __future__ import annotations

import os

import numpy as np

NPZ_NAME = "inference.npz"
_KERAS_NAMES = ("inference.hdf5", "inference_resnet_model.hdf5",
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
    """The variables tree of ``<weight_dir>/inference.npz`` as nested
    dicts of numpy arrays, or None when the directory holds no inference
    checkpoint. Raises when it holds only a format the port cannot read
    (an orbax ``inference/`` directory, a Keras ``inference*.hdf5``)."""
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
    for name in _KERAS_NAMES:
        if os.path.exists(os.path.join(weight_dir, name)):
            raise RuntimeError(
                f"{os.path.join(weight_dir, name)} is a Keras checkpoint; "
                f"the port cannot read it yet. Import it with the JAX "
                f"package (pix2pose_tpu.utils.checkpoint."
                f"load_inference_params) and convert the result with "
                f"pix2pose_torch.utils.checkpoint.export_inference")
    return None
