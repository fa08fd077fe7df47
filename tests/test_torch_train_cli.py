"""The port's ``train`` CLI on the CPU (``--device cpu``) on a tiny
``train_xyz``: what it writes, the strict reload of its export, resuming,
the refusal without CUDA and the float32 pin, the ImageNet trunk import
against the JAX package's, and the symmetry pool of a custom data_dir.
"""

import inspect
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.config import TrainConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.models import build_generator
from pix2pose_torch.training import multi as tmulti
from pix2pose_torch.training import train as ttrain
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.cli import load_generators, require_device
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)

torch.set_num_threads(1)

# a 2-fold symmetry about z, as models_info stores it (4x4 row-major)
Z180 = [-1, 0, 0, 0, 0, -1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]


def write_pairs(data_dir, n, seed, meta):
    """``n`` blob crops in the reference's (h, w, 6) npy format and a
    meta.json."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(60, 128), rng.randint(60, 128)
        arr = np.zeros((h, w, 6), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = ((yy - h / 2) ** 2 / (h / 2.5) ** 2
                + (xx - w / 2) ** 2 / (w / 2.5) ** 2) < 1
        arr[..., 0][blob] = rng.randint(50, 255)
        arr[..., 1][blob] = 128
        arr[..., 3][blob] = (xx[blob] * 255 // w).astype(np.uint8) | 1
        arr[..., 4][blob] = (yy[blob] * 255 // h).astype(np.uint8) | 1
        arr[..., 5][blob] = 128
        np.save(os.path.join(data_dir, f"{i:06d}.npy"), arr)
    with open(os.path.join(data_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


@pytest.fixture
def dataset(tmp_path):
    """A dataset directory with object 1's models_info (2-fold symmetric),
    its train_xyz pairs (the probe kept only the identity), backgrounds
    and a config per backbone."""
    ds = tmp_path / "tiny"
    os.makedirs(ds / "models")
    with open(ds / "models" / "models_info.json", "w") as f:
        json.dump({"1": {"diameter": 100.0,
                         "symmetries_discrete": [Z180]}}, f)
    write_pairs(ds / "train_xyz" / "01", 6, 0,
                {"rotation_lock": False, "visual_sym_idx": [0]})
    backs = tmp_path / "backs"
    os.makedirs(backs)
    rng = np.random.RandomState(1)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (100, 140, 3)).astype(
            np.uint8)).save(backs / f"b{i}.png")
    cfgs = {}
    for backbone in ("paper", "resnet50"):
        cfgs[backbone] = str(tmp_path / f"cfg_{backbone}.json")
        with open(cfgs[backbone], "w") as f:
            json.dump({"dataset_dir": str(tmp_path), "backbone": backbone},
                      f)
    return tmp_path, str(backs), cfgs


def test_train_cli_writes_exports_and_resumes(dataset, capsys):
    root, backs, cfgs = dataset
    args = ["train", cfgs["paper"], "tiny", "1", backs, "--max-steps", "2",
            "--batch", "2", "--device", "cpu"]
    state = cli(args)
    wdir = root / "tiny" / "pix2pose_weights" / "01"
    assert state.step == 2
    assert (wdir / "epoch_0001.pt").exists()
    assert (wdir / "val_img" / "epoch_01.png").exists()
    with Image.open(wdir / "val_img" / "epoch_01.png") as im:
        assert im.size == (3 * 128, 2 * 128)       # (input | GT | output)
    assert ckpt.latest_epoch(str(wdir)) == 1

    # the export loads strictly, equals the trained generator, and the
    # converters are exact inverses
    ds = BopDataset(str(root), "tiny", train=True)
    model = build_generator("paper")
    loaded = load_generators(ds, model, [1], torch.device("cpu"))[1]
    trained = state.gen.state_dict()
    for k, v in loaded.items():
        if v.is_floating_point():
            assert torch.equal(v, trained[k].cpu()), k
    again = flax_to_state_dict(state_dict_to_flax(loaded))
    assert again.keys() == loaded.keys()
    assert all(torch.equal(again[k], loaded[k]) for k in loaded)

    # a second run resumes at epoch 1
    capsys.readouterr()
    state = cli(args)
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert state.step == 4 and (wdir / "epoch_0002.pt").exists()
    assert ckpt.latest_epoch(str(wdir)) == 2


def test_require_device_pins_float32_and_refuses_without_cuda(
        dataset, monkeypatch):
    """Every CLI's device check turns TF32 off for cuDNN and matmuls;
    without ``--device`` the command runs on CUDA, so on a host without
    it ``train`` exits before loading anything."""
    root, backs, cfgs = dataset
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    assert require_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli(["train", cfgs["paper"], "tiny", "1", backs])
    assert not (root / "tiny" / "pix2pose_weights").exists()


def test_imagenet_trunk_matches_jax(dataset, tmp_path):
    """``--imagenet-h5`` on a test-written notop file: the port's trunk
    import gives the JAX import's arrays on the same variables, leaves the
    rest alone, and a one-step CLI run starts from them (each trunk
    parameter within lr of the file's value after one Adam step)."""
    from test_hdf5_import import _write_fake_imagenet_notop

    from pix2pose_tpu.utils import hdf5_import as jh5
    from pix2pose_torch.utils import hdf5_import as th5

    root, backs, cfgs = dataset
    h5 = str(tmp_path / "notop.h5")
    _write_fake_imagenet_notop(h5)
    variables = state_dict_to_flax(build_generator("resnet50").state_dict())
    got = th5.init_generator_trunk_from_imagenet(variables, h5)
    want = jh5.init_generator_trunk_from_imagenet(
        jax.tree_util.tree_map(jnp.asarray, variables), h5)
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        np.testing.assert_array_equal(flat_got[k], np.asarray(v), str(k))
    assert got["params"]["d1"] is variables["params"]["d1"]
    bad = {c: dict(v) for c, v in variables.items()}
    bad["params"] = dict(bad["params"], encoder={
        **variables["params"]["encoder"],
        "trunk": {**variables["params"]["encoder"]["trunk"],
                  "stem_conv": {"kernel": np.zeros((3, 3, 3, 64)),
                                "bias": np.zeros(64)}}})
    with pytest.raises(ValueError, match="shape mismatch"):
        th5.init_generator_trunk_from_imagenet(bad, h5)

    with pytest.raises(ValueError, match="requires backbone=resnet50"):
        cli(["train", cfgs["paper"], "tiny", "1", backs, "--imagenet-h5",
             h5, "--max-steps", "1", "--batch", "2", "--device", "cpu"])
    state = cli(["train", cfgs["resnet50"], "tiny", "1", backs,
                 "--imagenet-h5", h5, "--max-steps", "1", "--batch", "2",
                 "--device", "cpu"])
    trained = flat_params(state_dict_to_flax(state.gen.state_dict()))
    lr = TrainConfig().lr_schedule[0]
    for k, v in flat_params(got).items():
        if "trunk" in k:
            assert np.abs(trained[k] - v).max() <= lr * 1.001, k


def flat_params(variables):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                variables["params"])[0]}


def test_symmetry_pool_follows_a_custom_data_dir(dataset, monkeypatch):
    """A defect of the JAX trainer repaired in the port: with a custom
    ``data_dir``, ``pix2pose_tpu/training/train.py:84`` calls
    ``training_sym_pool(dataset, obj_id)``, which reads ``meta.json``
    from the dataset's default ``train_xyz``. Here that default says the
    probe kept only the identity (S=1) and the custom directory says both
    members of the 2-fold pool look alike (S=2): the JAX trainer argmins
    over the default's pool, the port over the custom data's."""
    from pix2pose_tpu.data.bop import BopDataset as JaxBopDataset
    from pix2pose_tpu.training import train as jtrain
    from pix2pose_tpu.utils.symmetry import training_sym_pool as jpool

    root, backs, _ = dataset
    custom = root / "elsewhere" / "01"
    write_pairs(custom, 4, 2, {"rotation_lock": False,
                               "visual_sym_idx": [0, 1]})
    # what the JAX trainer does (its call, and that call's result)
    assert "training_sym_pool(dataset, obj_id))" in inspect.getsource(
        jtrain.train_object)
    assert jpool(JaxBopDataset(str(root), "tiny"), 1).shape == (1, 3, 3)

    pools = []
    real = tmulti.training_sym_pool

    class PoolSeen(Exception):
        """Stops the trainer once it has its pool."""

    def recording(*args, **kw):
        pools.append(real(*args, **kw))
        raise PoolSeen

    # ``train`` is the multi-object trainer with one object
    monkeypatch.setattr(tmulti, "training_sym_pool", recording)
    ds = BopDataset(str(root), "tiny", train=True)
    with pytest.raises(PoolSeen):
        ttrain.train_object(ds, 1, backs, TrainConfig(batch_size=2),
                            data_dir=str(custom), device="cpu")
    assert pools[0].shape == (2, 3, 3)
    # with the default data_dir both read the same meta.json
    assert real(ds, 1).shape == (1, 3, 3)
