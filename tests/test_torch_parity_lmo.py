"""pix2pose_torch ``parity-lmo`` against the JAX tool, on the CPU: the
data gate, the weight layouts, one RGB parity run on the JAX tests' cube
fixture and the exit code when gated.

The parity run's generator is ``test_torch_eval_cli.py``'s pass-through
paper autoencoder, written for both packages (the JAX package's orbax
export and the port's ``inference.npz``), so both packages' poses land
near GT. The two draw different RANSAC samples, so their poses agree to
pose-error tolerance, not bit for bit: every pose within 10 deg and 10%
of t_z of GT (``test_torch_eval_cli.py``'s bars), and each AR term
within 0.05, the step of one of the two targets crossing one of a
metric's ten thresholds (equal on this fixture). Scored by the port's
``evaluate_bop``, the JAX tool's own rows give the JAX tool's AR within
1e-6, so the ARs differ by the poses alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from bop_fixture import build_cube_dataset
from pix2pose_tpu.tools import parity_lmo as jpar
from pix2pose_torch.data.bop import BopDataset, load_bop_results
from pix2pose_torch.eval.metrics import evaluate_bop
from pix2pose_torch.tools import parity_lmo as tpar
from test_torch_eval_cli import (_orbax_then_convert, passthrough_variables,
                                 rot_err_deg)

torch.set_num_threads(4)
CFG = {"backbone": "paper", "score_type": 1, "task_type": 1,
       "outlier_th": [0.1, 0.2, 0.3]}


def test_gate_matches_jax(tmp_path):
    """Nothing there, a dataset directory without its files, and a
    complete one: the same (root, missing) from both tools."""
    for setup in (lambda: None, lambda: os.makedirs(tmp_path / "cubes"),
                  lambda: build_cube_dataset(str(tmp_path))):
        setup()
        got = tpar.find_bop_dataset(str(tmp_path), "cubes")
        assert got == jpar.find_bop_dataset(str(tmp_path), "cubes")
    assert got == (str(tmp_path), [])
    assert tpar.find_bop_dataset(str(tmp_path / "none"), "lmo")[0] is None


def test_weight_layouts(tmp_path):
    """The JAX tool's three layouts resolve alike; the port also takes a
    directory holding only its ``inference.npz``, which the JAX tool
    passes over."""
    ds_dir = tmp_path / "ds"
    w_in_ds = ds_dir / "pix2pose_weights" / "01"
    ext = tmp_path / "w" / "lmo" / "02"
    flat = tmp_path / "w" / "03"
    for d, name in ((w_in_ds, "inference.hdf5"),
                    (ext, "inference_resnet_model.hdf5"),
                    (flat, "inference_resnet50.hdf5")):
        os.makedirs(d)
        (d / name).write_bytes(b"x")
    for ds, root, obj in ((ds_dir, None, 1), (tmp_path / "no", tmp_path /
                                               "w", 2),
                          (tmp_path / "no", tmp_path / "w", 3),
                          (ds_dir, None, 4)):
        args = (str(ds), None if root is None else str(root), "lmo", obj)
        assert tpar.resolve_weight_dir(*args) == \
            jpar.resolve_weight_dir(*args)
    npz = tmp_path / "w" / "lmo" / "pix2pose_weights" / "05"
    os.makedirs(npz)
    (npz / "inference.npz").write_bytes(b"x")
    args = (str(tmp_path / "no"), str(tmp_path / "w"), "lmo", 5)
    assert tpar.resolve_weight_dir(*args) == str(npz)
    assert jpar.resolve_weight_dir(*args) is None


def test_run_parity_rgb_matches_jax(tmp_path):
    root = str(tmp_path)
    entries = build_cube_dataset(root, n_scenes=1, ims_per_scene=2)
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
    out = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    ref = jpar.run_parity(root, "cubes", cfg_path=CFG, out_dir=out["jax"])
    got = tpar.run_parity(root, "cubes", cfg_path=CFG, out_dir=out["torch"],
                          device="cpu")
    assert set(got) == set(ref)
    assert got["n_results"] == ref["n_results"] == len(entries)
    for k in ("baseline_rgb", "diff", "subset", "gt_detector"):
        assert got[k] == ref[k]
    rows = {pkg: load_bop_results(os.path.join(
        out[pkg], f"pix2pose-{'tpu' if pkg == 'jax' else 'torch'}_"
        "cubes-test.csv")) for pkg in out}
    gt = {(0, i): (R, t) for i, (_, _, R, t) in enumerate(entries)}
    for r in rows["torch"] + rows["jax"]:
        R_gt, t_gt = gt[(r["scene_id"], r["im_id"])]
        assert rot_err_deg(r["R"], R_gt) < 10.0
        assert np.linalg.norm(r["t"] - t_gt) < 0.1 * t_gt[2]
    ds = BopDataset(root, "cubes", train=False)
    on_jax_rows = evaluate_bop(rows["jax"], ds, device="cpu")
    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd"):
        assert abs(on_jax_rows[k] - ref[k]) < 1e-6, k
        assert abs(got[k] - ref[k]) <= 0.05, (k, got[k], ref[k])
        assert 0.0 <= got[k] <= 1.0
    assert got["AR"] > 0.3


def test_main_exits_2_when_gated(tmp_path, capsys):
    for main in (tpar.main, jpar.main):
        with pytest.raises(SystemExit) as e:
            main(["--bop-root", str(tmp_path / "none")])
        assert e.value.code == 2
    out = capsys.readouterr().out
    assert out.count("parity run gated OFF") == 2
