"""ImageNet weights for the ResNet-50 generator's trunk (port of the
ImageNet half of :mod:`pix2pose_tpu.utils.hdf5_import`; reference
``pix2pose_model/resnet50_mod.py:246-258``).

Reads the keras-applications ``notop`` ResNet-50 file
(``resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5``) into the flax
layout of the generator's ``encoder/trunk`` subtree (nested dicts of
numpy arrays, the tree :func:`pix2pose_torch.utils.convert.
flax_to_state_dict` takes). Keras Conv2D kernels are already HWIO and
BatchNorm ``gamma / beta / moving_mean / moving_variance`` become
``scale / bias`` and ``mean / var``. ``h5py`` is imported only when a file
is read. The Keras ``inference*.hdf5`` generator import is not ported
yet.
"""

from __future__ import annotations

import numpy as np

# keras ResNet50 block names (module, keras res-id, projection shortcut)
# for the BOP'20 encoder (stages 2-3 only; reference resnet50_mod.py:214-231)
_RESNET_BLOCKS = [
    ("s2_b0", "2a", True), ("s2_b1", "2b", False), ("s2_b2", "2c", False),
    ("s3_b0", "3a", True), ("s3_b1", "3b", False), ("s3_b2", "3c", False),
    ("s3_b3", "3d", False),
]


def _read_layer(f, name):
    """{weight_name: array} of a layer in a Keras ``save_weights`` file, or
    None when the file has no such layer."""
    import h5py

    grp = f["model_weights"] if "model_weights" in f else f
    if name not in grp:
        return None
    out = {}

    def visit(key, obj):
        if isinstance(obj, h5py.Dataset):
            out[key.split("/")[-1].split(":")[0]] = np.asarray(obj)

    grp[name].visititems(visit)
    return out


def _normalize_weight_names(w: dict) -> dict:
    """Map keras-applications dataset-name variants onto the canonical
    kernel/bias/gamma/beta/moving_mean/moving_variance names (older files
    use layer-prefixed names like ``conv1_W:0`` / ``bn2a_branch2a_gamma``)."""
    out = {}
    for k, v in w.items():
        kk = k
        if kk not in ("kernel", "bias", "gamma", "beta", "moving_mean",
                      "moving_variance"):
            if kk.endswith("_W") or kk == "W":
                kk = "kernel"
            elif kk.endswith("_b") or kk == "b":
                kk = "bias"
            elif kk.endswith("gamma"):
                kk = "gamma"
            elif kk.endswith("beta"):
                kk = "beta"
            elif kk.endswith("running_mean") or kk.endswith("mean"):
                kk = "moving_mean"
            elif (kk.endswith("running_std") or kk.endswith("variance")
                  or kk.endswith("var")):
                kk = "moving_variance"
        out[kk] = v
    return out


def _set(tree, path, leaf_name, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf_name] = value


def load_imagenet_resnet50_trunk(h5_path: str) -> dict:
    """The notop file's stem and stages 2-3 as trunk-rooted ``{'params':
    ..., 'batch_stats': ...}`` (stages 4/5 in the file are ignored: the
    BOP'20 encoder's taps stop at stage 3). Merge into a generator's
    variables with :func:`init_generator_trunk_from_imagenet`."""
    import h5py

    params: dict = {}
    stats: dict = {}
    with h5py.File(h5_path, "r") as f:
        def layer(keras_name):
            w = _read_layer(f, keras_name)
            if w is None:
                raise KeyError(f"{keras_name} not in {h5_path}")
            return _normalize_weight_names(w)

        def conv(keras_name, path):
            w = layer(keras_name)
            _set(params, path, "kernel", w["kernel"])
            if "bias" in w:
                _set(params, path, "bias", w["bias"])

        def bn(keras_name, path):
            w = layer(keras_name)
            _set(params, path, "scale", w["gamma"])
            _set(params, path, "bias", w["beta"])
            _set(stats, path, "mean", w["moving_mean"])
            _set(stats, path, "var", w["moving_variance"])

        conv("conv1", ("stem_conv",))
        bn("bn_conv1", ("stem_bn",))
        for mod, rid, has_proj in _RESNET_BLOCKS:
            for br, sub, bn_sub in (("2a", "conv_a", "bn_a"),
                                    ("2b", "conv_b", "bn_b"),
                                    ("2c", "conv_c", "bn_c")):
                conv(f"res{rid}_branch{br}", (mod, sub))
                bn(f"bn{rid}_branch{br}", (mod, bn_sub))
            if has_proj:
                conv(f"res{rid}_branch1", (mod, "proj_conv"))
                bn(f"bn{rid}_branch1", (mod, "proj_bn"))
    return {"params": params, "batch_stats": stats}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def init_generator_trunk_from_imagenet(variables: dict, h5_path: str
                                       ) -> dict:
    """``variables`` (a ResNet-50 generator's flax-layout tree) with its
    ``encoder/trunk`` subtree replaced by the ImageNet weights of
    ``h5_path``. Every trunk leaf must be covered with its shape (else
    ValueError); the other leaves are kept. ``variables`` is not
    modified."""
    trunk = load_imagenet_resnet50_trunk(h5_path)
    out = {col: dict(sub) for col, sub in variables.items()}
    for col in ("params", "batch_stats"):
        enc = dict(out[col]["encoder"])
        ref = dict(_leaves(enc["trunk"]))
        got = dict(_leaves(trunk[col]))
        missing = set(ref) - set(got)
        if missing:
            raise ValueError(f"imagenet import missing trunk {col}: "
                             f"{sorted('/'.join(k) for k in missing)}")
        for k, v in ref.items():
            if tuple(np.shape(got[k])) != tuple(np.shape(v)):
                raise ValueError(
                    f"imagenet trunk shape mismatch at {'/'.join(k)}: "
                    f"{np.shape(got[k])} != {np.shape(v)}")
        enc["trunk"] = trunk[col]
        out[col]["encoder"] = enc
    return out
