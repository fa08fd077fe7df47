"""Flax variables <-> torch ``state_dict``, for every network the port
has: the generator (paper and ResNet-50 backbones), the GAN
discriminator, the CenterNet detector (ResNet-50 or tiny trunk, fused,
unfused or shared heads) and the RetinaNet detector (its ``down4`` /
``down5``, ``lat*``, ``smooth*`` and ``cls_*`` / ``box_*`` subnet
convs). :func:`state_dict_to_flax` is the inverse of
:func:`flax_to_state_dict`; the trainers export through it.

The port's modules carry the flax tree's names, so conversion is a
renaming plus three layout changes, and nothing is guessed from shapes:

- ``nn.Conv`` kernels are HWIO; torch wants OIHW;
- ``nn.ConvTranspose`` kernels are (kh, kw, in, out) and are applied
  WITHOUT a spatial flip, while torch's transposed conv flips: the kernel
  is flipped and reordered to (in, out, kh, kw) (the module side pads by
  1 and cuts the output to 2H x 2W, :class:`~pix2pose_torch.models.ae.
  _ConvTransposeSame`);
- ``nn.Dense`` kernels are (in, out); torch wants (out, in).

BatchNorm ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var``. No jax import: the
input is the variables tree as nested dicts of numpy arrays.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# flax module names whose 4-D kernel belongs to a ConvTranspose
_TRANSPOSED = ("deconv", "head_xyz", "head_prob")
# flax ``bias_init`` constants that are not zero: the CenterNet heat and
# seg outputs start at p ~ 0.1, RetinaNet's classifier at p = 0.01
BIAS_INIT = {"heat_out": -2.19, "seg_out": -2.19,
             "cls_out": -math.log((1 - 0.01) / 0.01)}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: dict) -> dict:
    """``{'params': ..., 'batch_stats': ...}`` (numpy leaves) -> a
    ``state_dict`` that the matching port module's
    ``load_state_dict(strict=True)`` accepts."""
    out = {}
    for path, leaf in _leaves(variables.get("params", {})):
        mod, name = path[:-1], path[-1]
        key = ".".join(mod)
        if name == "kernel" and leaf.ndim == 4:
            w = (leaf[::-1, ::-1].transpose(2, 3, 0, 1)
                 if mod[-1] in _TRANSPOSED else leaf.transpose(3, 2, 0, 1))
        elif name == "kernel" and leaf.ndim == 2:
            w = leaf.T
        elif name in ("bias", "scale"):
            w = leaf
        else:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        tname = {"kernel": "weight", "scale": "weight"}.get(name, name)
        out[f"{key}.{tname}"] = torch.from_numpy(
            np.array(w, dtype=np.float32))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        mod, name = path[:-1], path[-1]
        tname = {"mean": "running_mean", "var": "running_var"}[name]
        key = ".".join(mod)
        out[f"{key}.{tname}"] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
        out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out


def state_dict_to_flax(state_dict: dict) -> dict:
    """A port module's ``state_dict`` -> ``{'params': ..., 'batch_stats':
    ...}`` as nested dicts of float32 numpy arrays in flax layout (the
    inverse of :func:`flax_to_state_dict`, exact; ``num_batches_tracked``
    has no flax counterpart and is dropped)."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        a = t.detach().cpu().float().numpy()
        if name == "weight" and a.ndim == 4:
            col, leaf = "params", "kernel"
            a = (a.transpose(2, 3, 0, 1)[::-1, ::-1]
                 if mod[-1] in _TRANSPOSED else a.transpose(2, 3, 1, 0))
        elif name == "weight" and a.ndim == 2:
            col, leaf, a = "params", "kernel", a.T
        elif name == "weight":
            col, leaf = "params", "scale"
        elif name == "bias":
            col, leaf = "params", "bias"
        elif name in ("running_mean", "running_var"):
            col, leaf = "batch_stats", name[len("running_"):]
        else:
            raise KeyError(f"unexpected state_dict entry {key}")
        node = variables[col]
        for k in mod:
            node = node.setdefault(k, {})
        node[leaf] = np.array(a)  # a copy: t.numpy() shares t's memory
    return variables


def random_flax_variables(model: torch.nn.Module, seed: int) -> dict:
    """Seeded He-normal variables in FLAX layout for ``model``'s
    architecture (kernels in flax axis order, biases at flax's init: zero,
    or :data:`BIAS_INIT`'s constant for the detectors' classifiers; unit
    BatchNorm scale and variance, zero mean), as nested dicts of numpy
    arrays. Stands in
    for a trained checkpoint where only shapes matter."""
    rng = np.random.default_rng(seed)
    variables: dict = {"params": {}, "batch_stats": {}}

    def put(col, path, arr):
        d = variables[col]
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = arr.astype(np.float32)

    for key, t in model.state_dict().items():
        *mod, name = key.split(".")
        shape = tuple(t.shape)
        if name == "weight" and len(shape) == 4:
            if mod[-1] in _TRANSPOSED:            # (in, out, kh, kw)
                fshape = (shape[2], shape[3], shape[0], shape[1])
            else:                                 # (out, in, kh, kw)
                fshape = (shape[2], shape[3], shape[1], shape[0])
            fan_in = fshape[0] * fshape[1] * fshape[2]
            put("params", mod + ["kernel"],
                rng.normal(0.0, np.sqrt(2.0 / fan_in), fshape))
        elif name == "weight" and len(shape) == 2:
            put("params", mod + ["kernel"],
                rng.normal(0.0, np.sqrt(2.0 / shape[1]),
                           (shape[1], shape[0])))
        elif name == "weight":                    # BatchNorm
            put("params", mod + ["scale"], np.ones(shape))
        elif name == "bias":
            put("params", mod + ["bias"],
                np.full(shape, BIAS_INIT.get(mod[-1], 0.0)))
        elif name == "running_mean":
            put("batch_stats", mod + ["mean"], np.zeros(shape))
        elif name == "running_var":
            put("batch_stats", mod + ["var"], np.ones(shape))
    return variables
