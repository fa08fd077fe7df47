"""``python -m pix2pose_torch eval``, ``eval-icp`` and ``run-detector``
with ``--device cpu`` against the JAX package's CLIs on the JAX test
fixture's cube dataset.

The checkpoints are written by the JAX package (orbax) and converted for
the port by the recipe of ``pix2pose_torch.utils.checkpoint``: a paper
autoencoder whose seeded weights are set so that it passes its input
colours through (tanh of half the normalized colour, one encoder and one
decoder conv on the skip path; every other layer seeded and cut off; the
dataset's norm factor doubled to match), so that both packages' poses
land near GT and the rows do not hinge on the RANSAC draws; and the
CenterNet detector at the CLI's defaults with seeded heads scaled so that
its top-k peaks pass score_th 0.3.

Tolerances: CSV rows with the same (scene, image, object) ids in the same
order; detection JSON with equal boxes, ids and masks and scores within
1e-4; poses within 10 deg and 10% of t_z of GT (the passthrough decodes
2 tanh(x / 2) of the coordinates x, 7.6% short at the cube's corners),
within 5 deg and 15 mm after ICP."""

import json
import os

import numpy as np
import jax
import pytest
import torch

from bop_fixture import build_cube_dataset
from pix2pose_tpu import __main__ as jmain
from pix2pose_tpu.models.ae import build_generator as build_flax
from pix2pose_tpu.utils import checkpoint as jckpt
from pix2pose_torch import __main__ as tmain
from pix2pose_torch.data.bop import load_bop_results
from pix2pose_torch.models import CenterNetDetector
from pix2pose_torch.utils import checkpoint as ckpt_util
from pix2pose_torch.utils.convert import random_flax_variables
from test_torch_resnet50 import seeded_flax_variables

torch.set_num_threads(1)


def passthrough_variables(seed: int = 21) -> dict:
    """Seeded paper-AE variables that decode xyz = tanh(x / 2), x = (rgb
    - 128) / 128, on the 2x2 blocks of the stride-2 skip path, with error
    0.018 everywhere: e1_2 splits each colour channel into leaky-ReLU halves,
    d3_uni recombines them (identity BatchNorms), head_xyz upsamples by
    2x2 replication; d3_uni's kernel cuts every other path off."""
    x = np.zeros((1, 128, 128, 3), np.float32)
    v = seeded_flax_variables(build_flax("paper"), x, seed=seed)
    p, st = v["params"], v["batch_stats"]
    e, d = p["encoder"]["e1_2"], p["d3_uni"]
    for layer, stats in ((e, st["encoder"]["e1_2"]), (d, st["d3_uni"])):
        layer["conv"]["kernel"][:] = 0.0
        layer["conv"]["bias"][:] = 0.0
        layer["bn"]["scale"][:] = 1.0
        layer["bn"]["bias"][:] = 0.0
        stats["bn"]["mean"][:] = 0.0
        stats["bn"]["var"][:] = 1.0 - 1e-3      # BatchNorm eps 1e-3
    head = p["head_xyz"]
    head["kernel"][:] = 0.0
    head["bias"][:] = 0.0
    leak = 1.3           # lrelu(x) - lrelu(-x) = 1.3 x at slope 0.3
    for c in range(3):
        e["conv"]["kernel"][2, 2, c, c] = 1.0
        e["conv"]["kernel"][2, 2, c, 3 + c] = -1.0
        for o, sign in ((c, 1.0), (3 + c, -1.0)):
            d["conv"]["kernel"][2, 2, 64 + c, o] = sign / leak
            d["conv"]["kernel"][2, 2, 64 + 3 + c, o] = -sign / leak
        head["kernel"][1:3, 1:3, c, c] = 0.5 / leak
        head["kernel"][1:3, 1:3, 3 + c, c] = -0.5 / leak
    p["head_prob"]["kernel"][:] = 0.0
    p["head_prob"]["bias"][:] = -4.0
    return v


def _orbax_then_convert(weight_dir, variables):
    jckpt.export_inference(weight_dir, variables["params"],
                           variables["batch_stats"])
    ckpt_util.export_inference(
        weight_dir, jax.device_get(jckpt.load_inference_params(weight_dir)))


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.fixture(scope="module")
def cli_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_cli_torch"))
    entries = build_cube_dataset(root, n_scenes=1, ims_per_scene=1)
    ds_dir = os.path.join(root, "cubes")
    norm = os.path.join(ds_dir, "models_xyz", "norm_factor.json")
    with open(norm) as f:
        factors = json.load(f)
    for k in ("x_scale", "y_scale", "z_scale"):
        factors["1"][k] *= 2.0                  # the decoder's x / 2
    with open(norm, "w") as f:
        json.dump(factors, f)
    _orbax_then_convert(os.path.join(ds_dir, "pix2pose_weights", "01"),
                        passthrough_variables())
    det = random_flax_variables(CenterNetDetector(num_classes=1), 22)
    for head, bias in (("heat_out", 0.0), ("wh_out", 12.0),
                       ("off_out", 0.5)):
        det["params"][head]["kernel"] *= 0.01
        det["params"][head]["bias"][:] = bias
    _orbax_then_convert(os.path.join(ds_dir, "weight_detection",
                                     "centernet"), det)
    cfgs = {}
    for pkg in ("jax", "torch"):
        cfgs[pkg] = os.path.join(root, f"cfg_{pkg}.json")
        with open(cfgs[pkg], "w") as f:
            json.dump({"dataset_dir": root, "score_type": 2,
                       "task_type": 1, "outlier_th": [0.1, 0.2, 0.3],
                       "path_to_output": os.path.join(root, pkg)}, f)
    return root, entries, cfgs


def _run_both(cli_set, command, *args, jax_args=(), torch_args=()):
    """Run one command with both CLIs; returns (jax rows, port rows) of
    the CSV each writes under its path_to_output."""
    root, _, cfgs = cli_set
    jmain.main([command, cfgs["jax"], "cubes", *args, *jax_args])
    tmain.main([command, cfgs["torch"], "cubes", *args, *torch_args,
                "--device", "cpu"])
    suffix = "-icp" if command == "eval-icp" else ""
    return (load_bop_results(os.path.join(
                root, "jax", f"pix2pose-tpu{suffix}_cubes-test.csv")),
            load_bop_results(os.path.join(
                root, "torch", f"pix2pose-torch{suffix}_cubes-test.csv")))


def _same_ids(a, b):
    ids = lambda rows: [(r["scene_id"], r["im_id"], r["obj_id"])  # noqa
                        for r in rows]
    assert ids(a) == ids(b) and len(a) > 0


def test_eval_cli_matches_jax(cli_set):
    _, entries, _ = cli_set
    ref, got = _run_both(cli_set, "eval", "--max-det", "2")
    _same_ids(ref, got)
    _, _, R_gt, t_gt = entries[0]
    for r in got + ref:
        assert rot_err_deg(r["R"], R_gt) < 10.0
        assert np.linalg.norm(r["t"] - t_gt) < 0.1 * t_gt[2]


def test_eval_icp_cli_matches_jax(cli_set):
    _, entries, _ = cli_set
    ref, got = _run_both(cli_set, "eval-icp", "--max-det", "2")
    _same_ids(ref, got)
    _, _, R_gt, t_gt = entries[0]
    for r in got:
        assert rot_err_deg(r["R"], R_gt) < 5.0
        assert np.linalg.norm(r["t"] - t_gt) < 15.0


def test_run_detector_cli_and_replay_match_jax(cli_set):
    """run-detector's JSON against the JAX tool's, then ``eval
    --detections`` (score_type 2 with the replayed instance masks) on
    each package's own file."""
    root, _, cfgs = cli_set
    outs = {pkg: os.path.join(root, f"det_{pkg}.json")
            for pkg in ("jax", "torch")}
    jmain.main(["run-detector", cfgs["jax"], "cubes", "--out", outs["jax"]])
    tmain.main(["run-detector", cfgs["torch"], "cubes", "--out",
                outs["torch"], "--device", "cpu"])
    dets = {}
    for pkg, path in outs.items():
        with open(path) as f:
            dets[pkg] = json.load(f)
    assert len(dets["torch"]) == len(dets["jax"]) == 32
    for a, b in zip(dets["jax"], dets["torch"]):
        assert a["bbox"] == b["bbox"] and a["obj_id"] == b["obj_id"]
        assert a["mask_rle"] == b["mask_rle"]
        assert abs(a["score"] - b["score"]) <= 1e-4
    ref, got = _run_both(cli_set, "eval", "--max-det", "2",
                         jax_args=("--detections", outs["jax"]),
                         torch_args=("--detections", outs["torch"]))
    _same_ids(ref, got)
    assert all(np.isfinite(np.concatenate([r["R"].ravel(), r["t"]]))
               .all() for r in got)


def test_clis_refuse_without_cuda(cli_set):
    """Without ``--device`` each command runs on CUDA, so on a host
    without a CUDA device it exits before loading anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs none")
    _, _, cfgs = cli_set
    for command in ("eval", "eval-icp", "run-detector"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tmain.main([command, cfgs["torch"], "cubes"])
    usage = tmain._usage()
    assert all(c in usage for c in ("eval", "eval-icp", "run-detector"))
