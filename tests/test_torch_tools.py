"""pix2pose_torch entry points: the rasterizer benchmark's command line on
the CPU, and the card as every entry point's default device (with no
fallback to the CPU when there is no card)."""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def test_bench_rasterizer_cli_agrees_on_cpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "pix2pose_torch.tools.bench_rasterizer",
         "--device", "cpu", "--faces", "200", "--windows", "1", "--k", "1",
         "--core-runs", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    rows = [ln.split(":")[0].strip() for ln in out.stdout.splitlines()
            if "ms/frame" in ln]
    assert rows == ["scan", "exhaustive", "binned"]
    cores = [ln.split(":")[0].strip() for ln in out.stdout.splitlines()
             if "ms/launch, median of 2 " in ln]
    assert cores == ["exhaustive_core", "binned_core"]
    agree = [ln for ln in out.stdout.splitlines()
             if ln.startswith("outputs agree:")]
    assert len(agree) == 1 and agree[0].startswith("outputs agree: True")


def test_entry_points_default_to_the_card(tmp_path):
    from pix2pose_torch.data.synthetic_bop import build_rehearsal_dataset
    from pix2pose_torch.eval.icp_refine import make_multiframe_icp_refiner
    from pix2pose_torch.inference.engine import Pix2PoseEstimator
    from pix2pose_torch.serving.service import PoseService
    from pix2pose_torch.tools import (bench_rasterizer, render_train_views,
                                      render_training_pairs)

    for fn in (Pix2PoseEstimator, PoseService, make_multiframe_icp_refiner,
               build_rehearsal_dataset, bench_rasterizer.run,
               render_training_pairs.render_object_pairs,
               render_train_views.render_train_split):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for mod in (bench_rasterizer, render_train_views, render_training_pairs):
        assert re.search(r'add_argument\("--device", default="cuda"\)',
                         inspect.getsource(mod.main))
    if torch.cuda.is_available():
        return
    # without a card the default fails; it does not fall back to the CPU
    with pytest.raises((RuntimeError, AssertionError)):
        build_rehearsal_dataset(str(tmp_path), n_train=1, n_test=1)
    with pytest.raises((RuntimeError, AssertionError)):
        make_multiframe_icp_refiner(np.zeros((1, 3, 3), np.float32),
                                    np.zeros((1, 1, 3), np.int32), 8, 8)
