"""Keras HDF5 weights into the port's generators (port of
:mod:`pix2pose_tpu.utils.hdf5_import`).

Two kinds of file:

- the reference's per-object generator weights, Keras ``save_weights``
  HDF5 (``inference.hdf5`` for the paper backbone,
  ``inference_resnet_model.hdf5`` / ``inference_resnet50.hdf5`` for
  ResNet-50; ``pix2pose_model/ae_model.py``): named convs ``conv1_1 ..
  conv4_2`` and ``deconv1-3``, the ResNet trunk's named layers, and
  auto-named ``batch_normalization_N`` / ``dense_N`` /
  ``conv2d_transpose_N`` in graph-construction order, whose numbering
  keeps counting across models built earlier in the same Keras process
  (the offsets are probed from the file);
- the keras-applications ``notop`` ResNet-50 file
  (``resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5``, reference
  ``pix2pose_model/resnet50_mod.py:246-258``) for the trunk's ImageNet
  initialization.

Both are read into the flax layout (nested dicts of numpy arrays,
``{'params': ..., 'batch_stats': ...}``), the one tree
:func:`pix2pose_torch.utils.convert.flax_to_state_dict` takes. Keras
Conv2D and Dense kernels are already HWIO / (in, out); a Conv2DTranspose
kernel is stored (kh, kw, OUT, IN) and applied as the gradient of a
convolution, which the flax layout equals after a spatial flip and an
axis swap (:func:`_kernel_ct`); BatchNorm ``gamma / beta / moving_mean /
moving_variance`` become ``scale / bias`` and ``mean / var``. ``h5py`` is
imported only when a file is read.
"""

from __future__ import annotations

import os

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


def _kernel_ct(k):
    """Keras Conv2DTranspose kernel -> flax ConvTranspose kernel."""
    return np.ascontiguousarray(k[::-1, ::-1].transpose(0, 1, 3, 2))


def _set(tree, path, leaf_name, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf_name] = value


class _Reader:
    """Layers of one open file into a flax-layout ``params`` /
    ``batch_stats`` pair."""

    def __init__(self, f, h5_path: str):
        self.f, self.h5_path = f, h5_path
        self.params: dict = {}
        self.stats: dict = {}

    def layer(self, keras_name):
        w = _read_layer(self.f, keras_name)
        if w is None:
            raise KeyError(f"{keras_name} not in {self.h5_path}")
        return _normalize_weight_names(w)

    def conv(self, keras_name, path, transpose: bool = False):
        w = self.layer(keras_name)
        _set(self.params, path, "kernel",
             _kernel_ct(w["kernel"]) if transpose else w["kernel"])
        if "bias" in w:
            _set(self.params, path, "bias", w["bias"])

    def bn(self, keras_name, path):
        w = self.layer(keras_name)
        _set(self.params, path, "scale", w["gamma"])
        _set(self.params, path, "bias", w["beta"])
        _set(self.stats, path, "mean", w["moving_mean"])
        _set(self.stats, path, "var", w["moving_variance"])

    def offset(self, prefix: str) -> int:
        """The auto-name offset of ``prefix``: one less than the smallest
        ``<prefix>_N`` among the top-level layer groups (nested weight
        groups keep the original name, so only the top level counts)."""
        grp = self.f["model_weights"] if "model_weights" in self.f \
            else self.f
        idx = [int(n[len(prefix) + 1:]) for n in grp.keys()
               if n.startswith(prefix + "_")
               and n[len(prefix) + 1:].isdigit()]
        return min(idx) - 1 if idx else 0

    def trunk(self, root=()):
        """The ResNet-50 stem and stages 2-3 under ``root``."""
        self.conv("conv1", root + ("stem_conv",))
        self.bn("bn_conv1", root + ("stem_bn",))
        for mod, rid, has_proj in _RESNET_BLOCKS:
            for br, sub, bn_sub in (("2a", "conv_a", "bn_a"),
                                    ("2b", "conv_b", "bn_b"),
                                    ("2c", "conv_c", "bn_c")):
                self.conv(f"res{rid}_branch{br}", root + (mod, sub))
                self.bn(f"bn{rid}_branch{br}", root + (mod, bn_sub))
            if has_proj:
                self.conv(f"res{rid}_branch1", root + (mod, "proj_conv"))
                self.bn(f"bn{rid}_branch1", root + (mod, "proj_bn"))

    def variables(self) -> dict:
        return {"params": self.params, "batch_stats": self.stats}


def load_imagenet_resnet50_trunk(h5_path: str) -> dict:
    """The notop file's stem and stages 2-3 as trunk-rooted ``{'params':
    ..., 'batch_stats': ...}`` (stages 4/5 in the file are ignored: the
    BOP'20 encoder's taps stop at stage 3). Merge into a generator's
    variables with :func:`init_generator_trunk_from_imagenet`."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        r = _Reader(f, h5_path)
        r.trunk()
    return r.variables()


# the paper encoder's named convs (keras name, flax module path)
_PAPER_ENCODER = [
    ("conv1_1", ("encoder", "e1_1")), ("conv1_2", ("encoder", "e1_2")),
    ("conv2_1", ("encoder", "e2_1")), ("conv2_2", ("encoder", "e2_2")),
    ("conv3_1", ("encoder", "e3_1")), ("conv3_2", ("encoder", "e3_2")),
    ("conv4_1", ("encoder", "e4_1")), ("conv4_2", ("encoder", "e4_2")),
]
_DECODER_CONVS = [("deconv1", ("d1_uni",)), ("deconv2", ("d2_uni",)),
                  ("deconv3", ("d3_uni",))]
# auto-named BatchNorms in graph order (``ae_model.py:70-150``): after
# every encoder conv, then the decoder's, interleaved with its deconvs
_DECODER_BN_ORDER = [("d1",), ("d1_uni",), ("d2",), ("d2_uni",), ("d3",),
                     ("d3_uni",)]
_PAPER_BN_ORDER = [path for _, path in _PAPER_ENCODER] + _DECODER_BN_ORDER
_RESNET_BN_ORDER = ([("encoder", "e4_1"), ("encoder", "e4_2")]
                    + _DECODER_BN_ORDER)
# the five auto-named Conv2DTranspose layers: three decoder stages, then
# the two heads
_CT_ORDER = [("d1", "deconv"), ("d2", "deconv"), ("d3", "deconv"),
             ("head_xyz",), ("head_prob",)]


def _check_model(model, variables):
    """Strict load of the converted tree into a torch generator: every
    weight of ``model`` present, with its shape."""
    from pix2pose_torch.utils.convert import flax_to_state_dict

    model.load_state_dict(flax_to_state_dict(variables), strict=True)


def _load_generator(h5_path: str, encoder, bn_order, model, bn_offset,
                    dense_offset, ct_offset) -> dict:
    import h5py

    with h5py.File(h5_path, "r") as f:
        r = _Reader(f, h5_path)
        bn_offset = bn_offset or r.offset("batch_normalization")
        dense_offset = dense_offset or r.offset("dense")
        ct_offset = ct_offset or r.offset("conv2d_transpose")
        encoder(r)
        for name, path in _DECODER_CONVS:
            r.conv(name, path + ("conv",))
        for i, path in enumerate(bn_order):
            r.bn(f"batch_normalization_{bn_offset + i + 1}", path + ("bn",))
        r.conv(f"dense_{dense_offset + 1}", ("fc_enc",))
        r.conv(f"dense_{dense_offset + 2}", ("fc_dec",))
        for i, path in enumerate(_CT_ORDER):
            r.conv(f"conv2d_transpose_{ct_offset + i + 1}", path,
                   transpose=True)
    variables = r.variables()
    if model is not None:
        _check_model(model, variables)
    return variables


def load_keras_generator(h5_path: str, model=None, bn_offset: int = 0,
                         dense_offset: int = 0, ct_offset: int = 0) -> dict:
    """A paper-backbone generator's ``inference.hdf5`` as flax-layout
    variables. The ``*_offset`` arguments shift the auto-name numbering;
    0 probes it from the file (the reference evaluator builds one graph
    per object, ``5_evaluation_bop_basic.py:206-225``, so later files
    count on). ``model`` (an ``AutoEncoder``) is checked by a strict
    load."""
    def encoder(r):
        for name, path in _PAPER_ENCODER:
            r.conv(name, path + ("conv",))

    return _load_generator(h5_path, encoder, _PAPER_BN_ORDER, model,
                           bn_offset, dense_offset, ct_offset)


def load_keras_generator_resnet50(h5_path: str, model=None,
                                  bn_offset: int = 0, dense_offset: int = 0,
                                  ct_offset: int = 0) -> dict:
    """A ResNet-50-backbone generator's HDF5 (``inference_resnet_model.
    hdf5`` / ``inference_resnet50.hdf5``) as flax-layout variables: the
    trunk's layers are named (``conv1``, ``bn2a_branch2a``,
    ``res2a_branch1``, ...), only the decoder's are auto-numbered."""
    def encoder(r):
        r.trunk(("encoder", "trunk"))
        r.conv("conv4_1", ("encoder", "e4_1", "conv"))
        r.conv("conv4_2", ("encoder", "e4_2", "conv"))

    return _load_generator(h5_path, encoder, _RESNET_BN_ORDER, model,
                           bn_offset, dense_offset, ct_offset)


def load_keras_inference(h5_path: str, model=None) -> dict:
    """The loader of a generator file chosen by its name: ResNet-50 for a
    name with "resnet", else the paper backbone."""
    loader = (load_keras_generator_resnet50
              if "resnet" in os.path.basename(h5_path)
              else load_keras_generator)
    return loader(h5_path, model)


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
