"""Shared fixtures of the benchmark's own tests: a tree of tiny cells built
from the benchmark's files, and the card check for tests marked ``gpu``."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import common


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


def tiny_tree(root: Path) -> Path:
    """A copy of the benchmark's cells, configurations, mixes and metric
    readers under ``root``, plus ``tiny.rgb`` (2 objects of 1 280 faces in
    LM-O's 640 x 480 frames, where the objects span enough pixels for PnP
    to be well posed; 2 slots, 2 cameras) and ``tiny.train`` (batch 4)."""
    for sub in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(common.ROOT / sub, root / sub,
                        ignore=shutil.ignore_patterns("*.py")
                        if sub == "traffic" else None)
    cfg = common.load_json(root / "configs" / "pix2pose-paper-lmo.json")
    cfg.update(objects=cfg["objects"][:2], mesh_level=3, max_det=2)
    cfg["train"]["batch_size"] = 4
    _dump(root / "configs" / "tiny-paper.json", cfg)
    mix = common.load_json(root / "traffic" / "lmo-rgb-4cam.json")
    mix.update(cameras=2, visible_per_frame=[1, 2, 2, 1], min_visible_px=20,
               pool_blocks=2, sampled_batches=2, warmup_per_camera=1)
    _dump(root / "traffic" / "tiny-cams.json", mix)
    mix = common.load_json(root / "traffic" / "train-b50.json")
    mix.update(patches=6, backgrounds=2, patch_px=100)
    _dump(root / "traffic" / "tiny-train.json", mix)
    for cell, base, traffic in (("tiny.rgb", "paper.lmo-rgb-4cam",
                                 "tiny-cams"),
                                ("tiny.train", "paper.train-b50",
                                 "tiny-train")):
        c = common.load_json(root / "workloads" / f"{base}.json")
        c.update(config="tiny-paper", traffic=traffic)
        _dump(root / "workloads" / f"{cell}.json", c)
    return root


def _dump(path: Path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return tiny_tree(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
