"""pix2pose_torch Keras generator import and ``convert-weights`` against
the JAX package, on the CPU.

The fake Keras files are the JAX import tests' (``tests/
test_hdf5_import.py``: the reference's layer names and shapes, random
weights). The port's loaders must give the JAX loaders' trees exactly,
array for array. The torch generator loaded from them is held to the
JAX generator on the same seeded input at the JAX import test's float32
bar (5e-4 absolute, mean below 2e-5): with these random weights the two
frameworks' float32 summation orders alone leave up to 4.4e-4 on a few
saturating tanh outputs (mean ~1e-6), so 1e-5 cannot hold for the whole
forward although every imported array is equal.
"""

import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2pose_tpu.models import build_generator as build_flax
from pix2pose_tpu.tools import convert_weights as jconvert
from pix2pose_tpu.utils import checkpoint as jckpt
from pix2pose_tpu.utils import hdf5_import as jh5
from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.models import build_generator
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils import hdf5_import as th5
from pix2pose_torch.utils.convert import flax_to_state_dict
from test_hdf5_import import (_write_fake_keras_generator,
                              _write_fake_keras_resnet50_generator)

torch.set_num_threads(4)
WRITERS = {"paper": ("inference.hdf5", _write_fake_keras_generator),
           "resnet50": ("inference_resnet_model.hdf5",
                        _write_fake_keras_resnet50_generator)}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    """{backbone: path} of a fake Keras file of each backbone."""
    out = {}
    for backbone, (name, write) in WRITERS.items():
        out[backbone] = str(tmp_path_factory.mktemp(backbone) / name)
        write(out[backbone])
    yield out
    for path in out.values():   # ~100 MB each
        shutil.rmtree(os.path.dirname(path))


def test_generator_import_matches_jax(keras_files):
    """Both backbones: the tree equals the JAX loader's; the torch
    generator (strict load) equals the flax generator at the float32 bar
    on a seeded batch of 2; ``load_inference_params`` reads the file by
    its name."""
    for backbone, path in keras_files.items():
        _check_import(backbone, path)


def _check_import(backbone, path):
    jload = (jh5.load_keras_generator_resnet50 if backbone == "resnet50"
             else jh5.load_keras_generator)
    ref = jload(path, build_flax(backbone))
    got = th5.load_keras_inference(path, build_generator(backbone))
    _assert_same_tree(got, ref)
    _assert_same_tree(ckpt.load_inference_params(os.path.dirname(path)),
                      ref)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 128, 128, 3)) \
        .astype(np.float32)
    xyz_j, prob_j = build_flax(backbone).apply(ref, jnp.asarray(x))
    model = build_generator(backbone)
    model.load_state_dict(flax_to_state_dict(got), strict=True)
    with torch.no_grad():
        xyz, prob = model(torch.from_numpy(x))
    for a, b in ((xyz, xyz_j), (prob, prob_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)
        assert float(np.abs(a.numpy() - np.asarray(b)).mean()) < 2e-5


def test_auto_name_offsets_are_probed(keras_files, tmp_path):
    """A file whose auto-named layers count on from earlier models (every
    ``batch_normalization_N`` / ``dense_N`` / ``conv2d_transpose_N``
    renumbered) loads the same tree, as in the JAX package."""
    for backbone, path in keras_files.items():
        _check_offsets(backbone, path, tmp_path / backbone)
    shutil.rmtree(tmp_path)     # the renumbered copies, ~200 MB


def _check_offsets(backbone, path, tmp_path):
    os.makedirs(tmp_path)
    shifted = str(tmp_path / os.path.basename(path))
    shutil.copy(path, shifted)
    with h5py.File(shifted, "r+") as f:
        for prefix, n, by in (("batch_normalization", 14, 14),
                              ("dense", 2, 3), ("conv2d_transpose", 5, 7)):
            for i in range(n, 0, -1):
                if f"{prefix}_{i}" in f:
                    f.move(f"{prefix}_{i}", f"{prefix}_{i + by}")
    got = th5.load_keras_inference(shifted)
    _assert_same_tree(got, th5.load_keras_inference(path))
    jload = (jh5.load_keras_generator_resnet50 if backbone == "resnet50"
             else jh5.load_keras_generator)
    _assert_same_tree(got, jload(shifted))


def test_convert_weights_on_both_inputs(keras_files, tmp_path, capsys):
    """``convert-weights`` on a Keras file of each backbone, under each
    name it is looked for by, writes ``inference.npz`` equal to the
    loader's tree. The JAX tool agrees on ``inference.hdf5`` only: it
    reads ``inference_resnet_model.hdf5`` with the paper loader
    (``KeyError`` on ``conv1_1``) and never looks for
    ``inference_resnet50.hdf5``."""
    for name, backbone in (("inference.hdf5", "paper"),
                           ("inference_resnet_model.hdf5", "resnet50"),
                           ("inference_resnet50.hdf5", "resnet50")):
        path = keras_files[backbone]
        wdir = str(tmp_path / name.split(".")[0])
        os.makedirs(wdir)
        shutil.copy(path, os.path.join(wdir, name))
        cli(["convert-weights", wdir, "--device", "cpu"])
        assert "converted" in capsys.readouterr().out
        _assert_same_tree(ckpt.load_inference_params(wdir),
                          th5.load_keras_inference(path))
        os.remove(os.path.join(wdir, ckpt.NPZ_NAME))
        if name == "inference.hdf5":   # the JAX tool's orbax export
            jconvert.convert(wdir)
            capsys.readouterr()
            _assert_same_tree(jax.device_get(jckpt.load_inference_params(
                wdir)), th5.load_keras_inference(path))
        elif name == "inference_resnet_model.hdf5":
            with pytest.raises(KeyError, match="conv1_1"):
                jconvert.convert(wdir, "resnet50")
        else:
            with pytest.raises(SystemExit, match="no training checkpoints"):
                jconvert.convert(wdir, "resnet50")
    shutil.rmtree(tmp_path)     # the copies and exports, ~400 MB


def test_convert_weights_from_a_train_state(tmp_path, capsys):
    """The newest ``epoch_XXXX.pt`` of the trainer wins over a Keras file
    beside it, and its generator is what ``inference.npz`` holds; an
    empty directory exits as the JAX tool does."""
    from pix2pose_torch.config import TrainConfig
    from pix2pose_torch.models import AutoEncoder, Discriminator
    from pix2pose_torch.training.gan import create_train_state, init_like_flax
    from pix2pose_torch.utils.convert import state_dict_to_flax

    wdir = str(tmp_path / "w")
    g = torch.Generator().manual_seed(3)
    state = create_train_state(init_like_flax(AutoEncoder(), g),
                               init_like_flax(Discriminator(128), g),
                               TrainConfig())
    for epoch in (1, 2):
        with torch.no_grad():
            next(state.gen.parameters()).add_(1.0)
        ckpt.save_train_state(wdir, state, epoch)
    _write_fake_keras_generator(os.path.join(wdir, "inference.hdf5"))
    cli(["convert-weights", wdir, "--device", "cpu"])
    assert "from epoch 2" in capsys.readouterr().out
    _assert_same_tree(ckpt.load_inference_params(wdir),
                      state_dict_to_flax(state.gen.state_dict()))
    os.makedirs(tmp_path / "empty")
    for convert in (lambda d: cli(["convert-weights", d, "--device", "cpu"]),
                    jconvert.convert):
        with pytest.raises(SystemExit, match="no training checkpoints"):
            convert(str(tmp_path / "empty"))
    shutil.rmtree(tmp_path)     # two train states, ~450 MB
