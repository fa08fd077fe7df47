"""The plain reference against the program at a tiny size on the CPU,
through the harness's whole run (the kernels' plain paths)."""

from __future__ import annotations

import time

from benchmark import run


def _execute(root, cell, seed, seconds=3.0):
    return run.execute(cell, seed, seconds, False, "cpu", root=root,
                       t_start=time.monotonic())


def test_serving_reference_agrees_with_the_program(tiny_root):
    # long enough for a server batch of full-size frames on a busy CPU
    out = _execute(tiny_root, "tiny.rgb", 3000000025, seconds=12.0)
    r = out["readings"]
    assert out["correct"], out["checks"]
    assert r["compared"] > 0 and r["valid_poses"] > 0
    assert r["box_mismatch"] == 0 and r["wire_mismatch"] == 0
    assert r["valid_mismatch"] == 0 and r["xyz_gap_share"] == 0
    assert r["xyz_gap_max"] < 1e-6 and r["inlier_gap"] == 0
    assert r["truth_deg_median"] < 2.0 and r["truth_t_median"] < 0.02
    assert out["failed"] == 0 and out["e2e"]["frames_per_s"] > 0


def test_training_reference_agrees_with_the_program(tiny_root):
    out = _execute(tiny_root, "tiny.train", 3000000022)
    r = out["readings"]
    assert r["batch_mismatch"] == 0
    assert r["recon_gap_step1"] < 1e-5
    assert r["grad_gap"] < 0.05 and r["update_gap"] < 0.2
    assert out["e2e"]["train_samples_per_s"] > 0
