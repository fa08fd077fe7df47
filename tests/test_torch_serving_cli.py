"""pix2pose_torch serving CLI, checkpoints and model colorizer against the
JAX package on the same fixture.

The fixture is the JAX CLI test's cube dataset with a ResNet-50 generator
and a ResNet-50-trunk CenterNet detector (the CLI's defaults; the JAX
test's tiny-trunk detector could never be applied by it), written by the
JAX package as orbax checkpoints and converted for the port by the
two-line recipe of ``pix2pose_torch.utils.checkpoint``. Tolerances: the
generator output within 1e-4 of flax (``tests/test_torch_ae.py``'s bar);
weights, corners and norm-factor vectors exact; ``norm_factor.json``
within 1e-6 of the model's largest coordinate (the two packages sum the
float32 vertex means in different orders, so a center can differ by a
few float32 steps of the coordinates: 1.1e-5 mm on a 98-vertex cylinder
reaching 65 mm) and vertex colours equal but for truncation-boundary
flips (see the test)."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bop_fixture import build_cube_dataset, multishape_objects
from pix2pose_tpu.data.bop import BopDataset as JBopDataset
from pix2pose_tpu.data.ply import load_ply as jload_ply
from pix2pose_tpu.data.ply import save_ply as jsave_ply
from pix2pose_tpu.models.ae import build_generator as build_flax
from pix2pose_tpu.serving import __main__ as jserve_cli
from pix2pose_tpu.tools.colorize_models import colorize_dataset
from pix2pose_tpu.utils import checkpoint as jckpt
from pix2pose_torch import __main__ as tmain
from pix2pose_torch.data.ply import load_ply
from pix2pose_torch.models import CenterNetDetector, build_generator
from pix2pose_torch.serving import __main__ as serve_cli
from pix2pose_torch.utils import checkpoint as ckpt_util
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          random_flax_variables)
from test_torch_resnet50 import calibrate_batch_stats, seeded_flax_variables
from test_hdf5_import import _write_fake_keras_resnet50_generator

torch.set_num_threads(1)


def _orbax_then_convert(weight_dir, variables):
    """Write ``variables`` as the JAX package does (orbax), which the
    port refuses with the recipe, then convert the directory with it."""
    jckpt.export_inference(weight_dir, variables["params"],
                           variables["batch_stats"])
    with pytest.raises(RuntimeError, match="orbax"):
        ckpt_util.load_inference_params(weight_dir)
    ckpt_util.export_inference(
        weight_dir, jax.device_get(jckpt.load_inference_params(weight_dir)))


@pytest.fixture(scope="module")
def cli_dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve_cli_torch"))
    build_cube_dataset(root, n_scenes=1, ims_per_scene=1, split="test")
    ds_dir = os.path.join(root, "cubes")
    x = np.random.default_rng(20).uniform(
        -1, 1, (1, 128, 128, 3)).astype(np.float32)
    gen_vars = calibrate_batch_stats(
        build_generator("resnet50"), x,
        seeded_flax_variables(build_flax("resnet50"), x, seed=21))
    _orbax_then_convert(os.path.join(ds_dir, "pix2pose_weights", "01"),
                        gen_vars)
    det_vars = random_flax_variables(CenterNetDetector(num_classes=1), 22)
    _orbax_then_convert(os.path.join(ds_dir, "weight_detection",
                                     "centernet"), det_vars)
    ros_cfg = os.path.join(root, "ros_config.json")
    with open(ros_cfg, "w") as f:
        json.dump({"backbone": "resnet50", "obj_labels": [1],
                   "cam_K": np.eye(3).ravel().tolist(), "icp": False}, f)
    return root, ros_cfg, gen_vars, x


def test_converted_checkpoint_matches_flax_generator(cli_dataset):
    root, _, gen_vars, x = cli_dataset
    wdir = os.path.join(root, "cubes", "pix2pose_weights", "01")
    loaded = ckpt_util.load_inference_params(wdir)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(gen_vars)):
        np.testing.assert_array_equal(a, b)
    xyz_ref, prob_ref = build_flax("resnet50").apply(gen_vars,
                                                     jnp.asarray(x))
    model = build_generator("resnet50")
    model.load_state_dict(flax_to_state_dict(loaded), strict=True)
    with torch.no_grad():
        xyz, prob = model(torch.from_numpy(x))
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_ref), atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_ref), atol=1e-4)


def test_create_server_matches_jax_cli(cli_dataset):
    root, ros_cfg, _, _ = cli_dataset
    args = [ros_cfg, root, "cubes", "--port", "0"]
    jserver = jserve_cli.create_server(args)
    server = serve_cli.create_server(args + ["--device", "cpu"])
    try:
        assert server.address[1] > 0
        jsvc, svc = jserver.frontend.service, server.frontend.service
        assert list(svc.params_by_obj) == list(jsvc.params_by_obj) == [1]
        want = flax_to_state_dict(jax.device_get(jsvc.params_by_obj[1]))
        got = svc.params_by_obj[1]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert set(svc.box_corners) == set(jsvc.box_corners)
        np.testing.assert_array_equal(svc.box_corners[1],
                                      jsvc.box_corners[1])
        np.testing.assert_array_equal(svc.obj_params[1], jsvc.obj_params[1])
        det = svc.detector
        assert det.device == torch.device("cpu")
        assert det.model.layout == "fused" and det.model.trunk.stem_s2d
        assert det.class_to_obj_id == [1]
    finally:
        server.close()
        jserver.close()


def test_create_server_requires_weights_and_cuda(cli_dataset, tmp_path):
    """"no trained objects" without weights, as the JAX CLI says; a
    reference Keras checkpoint (``inference_resnet_model.hdf5``) is
    loaded strictly into the generator, and the start-up then stops at
    the missing detector; without ``--device`` on a host with no CUDA
    device the CLI refuses to start instead of picking the CPU."""
    root, ros_cfg, _, _ = cli_dataset
    bare = str(tmp_path / "bare")
    build_cube_dataset(bare, n_scenes=1, ims_per_scene=1, split="test")
    with pytest.raises(SystemExit, match="no trained objects"):
        serve_cli.create_server([ros_cfg, bare, "cubes", "--port", "0",
                                 "--device", "cpu"])
    keras_dir = os.path.join(bare, "cubes", "pix2pose_weights", "01")
    os.makedirs(keras_dir)
    _write_fake_keras_resnet50_generator(
        os.path.join(keras_dir, "inference_resnet_model.hdf5"))
    with pytest.raises(SystemExit, match="no trained detector"):
        serve_cli.create_server([ros_cfg, bare, "cubes", "--port", "0",
                                 "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_cli.create_server([ros_cfg, root, "cubes", "--port", "0"])


def test_colorize_models_matches_jax_tool(tmp_path, capsys):
    """``python -m pix2pose_torch colorize-models`` against the JAX tool
    on four shapes moved off their centers."""
    roots = [str(tmp_path / k) for k in ("jax", "torch")]
    for root in roots:
        model_dir = os.path.join(root, "shapes", "models")
        os.makedirs(model_dir)
        info, extent = {}, {}
        for obj_id, (v, f, _, _) in multishape_objects().items():
            shift = np.random.default_rng(obj_id).uniform(-20, 20, 3)
            v = (v + shift).astype(np.float32)
            jsave_ply(os.path.join(model_dir, f"obj_{obj_id:06d}.ply"), v, f)
            info[str(obj_id)] = {"diameter": 100.0}
            extent[str(obj_id)] = float(np.abs(v).max())
        with open(os.path.join(model_dir, "models_info.json"), "w") as fh:
            json.dump(info, fh)
    colorize_dataset(JBopDataset(roots[0], "shapes", train=True))
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as fh:
        json.dump({"dataset_dir": roots[1]}, fh)
    tmain.main(["colorize-models", cfg, "shapes"])
    capsys.readouterr()
    norms = []
    for root in roots:
        with open(os.path.join(root, "shapes", "models_xyz",
                               "norm_factor.json")) as fh:
            norms.append(json.load(fh))
    assert set(norms[0]) == set(norms[1]) == {"1", "2", "3", "4"}
    for obj_id in norms[0]:
        a, b = norms[0][obj_id], norms[1][obj_id]
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-6 * extent[obj_id], (obj_id, k)
        plys = [os.path.join(r, "shapes", "models_xyz",
                             f"obj_{int(obj_id):06d}.ply") for r in roots]
        ja, ta = jload_ply(plys[0]), load_ply(plys[1])
        np.testing.assert_array_equal(ta["pts"], ja["pts"])
        # colours are the float colour times 255, truncated: equal, except
        # by 1 where that product lies on an integer to float32 rounding
        # (the extreme vertex of an axis maps to 255.0 exactly)
        diff = ta["colors"].astype(int) - ja["colors"].astype(int)
        scale = np.array([a["x_scale"], a["y_scale"], a["z_scale"]])
        ct = np.array([a["x_ct"], a["y_ct"], a["z_ct"]])
        col = ((ja["pts"] - ct) / scale + 1.0) * 0.5 * 255.0
        on_int = np.abs(col - np.round(col)) < 1e-3
        assert np.all(np.abs(diff) <= 1) and np.all(on_int[diff != 0])
        np.testing.assert_array_equal(ta["faces"], ja["faces"])
    assert "colorize-models" in tmain._usage()
