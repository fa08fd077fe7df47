"""pix2pose_torch ``ab-e2e`` on the CPU: override parsing against the JAX
tool's, exactly; a mini A/B whose identical variants give a delta of
exactly 0; a ``max_pnp_points`` override, which the engine runs with its
correspondences compacted; the exit codes. The mini runs build the cube set with 8
train views (the tool's default is 48) and train 2 steps at batch 2 (an
override on both sides; the tool's batch is 32).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pix2pose_tpu.tools import ab_e2e as jab
from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.tools import ab_e2e as tab

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
SMALL = "train.batch_size=2"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A cube set with 8 train views, which the mini runs share."""
    root = str(tmp_path_factory.mktemp("ab") / "ab")
    tab._build_dataset(root, 8, "cpu")
    return root


def test_parse_overrides_matches_jax():
    pairs = ["select_stride=4", "prosac=false", "prosac=Yes",
             "train.compute_dtype=bfloat16", "train.batch_size=16",
             "outlier_th=0.1,0.2", "train.lr_schedule=1e-3,1e-4",
             "max_pnp_points=512", "max_pnp_points=none",
             "max_pnp_points=2.5", "max_pnp_points=many",
             "train.label_flipping=0.1", "inlier_th=0.25"]
    for i in range(len(pairs)):
        got = tab.parse_overrides(pairs[:i + 1])
        assert got == jab.parse_overrides(pairs[:i + 1]), pairs[i]
        assert [type(v) for d in got for v in d.values()] == [
            type(v) for d in jab.parse_overrides(pairs[:i + 1])
            for v in d.values()]
    assert tab.parse_overrides(None) == jab.parse_overrides(None) == ({}, {})
    for bad in (["not_a_field=1"], ["train.nope=1"], ["select_stride"],
                ["select_stride="]):
        with pytest.raises(SystemExit) as t:
            tab.parse_overrides(bad)
        with pytest.raises(SystemExit) as j:
            jab.parse_overrides(bad)
        assert str(t.value) == str(j.value)


def test_identical_variants_give_zero_delta(root, capsys):
    out = tab.run_ab(seeds=1, steps=2, a_pairs=[SMALL],
                     b_pairs=[SMALL, "select_stride=8", "select_stride=4"],
                     root=root, device="cpu")
    # the B list's last select_stride (4) is the engine's default
    assert out["retrained"] is False
    assert out["rows"] == [{"seed": 0, "ar_a": out["rows"][0]["ar_a"],
                            "ar_b": out["rows"][0]["ar_a"], "delta": 0.0}]
    assert 0.0 <= out["rows"][0]["ar_a"] <= 1.0
    assert out["mean_delta"] == out["min_delta"] == 0.0 and out["pass"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out


def test_max_pnp_points_override_fails_before_training(root, monkeypatch):
    """A ``max_pnp_points`` override is accepted and runs: B's engine
    compacts its correspondences to the cap (the engine's PnP calls
    ``compact_correspondences``), both ARs are in [0, 1], and "none" keeps
    the engine's default (no cap)."""
    from pix2pose_torch.ops import pnp

    caps = []
    compact = pnp.compact_correspondences

    def counting(obj, img, valid, k_max, quality=None):
        caps.append(k_max)
        return compact(obj, img, valid, k_max, quality)

    monkeypatch.setattr(pnp, "compact_correspondences", counting)
    out = tab.run_ab(seeds=1, steps=2, a_pairs=[SMALL],
                     b_pairs=[SMALL, "max_pnp_points=512"], root=root,
                     device="cpu")
    assert caps and set(caps) == {512}
    assert out["retrained"] is False
    assert all(0.0 <= out["rows"][0][k] <= 1.0 for k in ("ar_a", "ar_b"))
    assert tab.parse_overrides(["max_pnp_points=none"]) == (
        {}, {"max_pnp_points": None})


def test_exit_codes(root, monkeypatch):
    """0 on pass, 1 on fail (a negative margin fails a zero delta), as
    ``python -m pix2pose_torch ab-e2e`` exits; no CUDA: refused."""
    args = ["ab-e2e", "--seeds", "1", "--steps", "2", "--root", root,
            "--a", SMALL, "--b", SMALL, "--device", "cpu"]
    assert cli(args) == 0
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "pix2pose_torch"] + args
        + ["--margin", "-0.5"], cwd=REPO, capture_output=True, text=True,
        env={**env, "OMP_NUM_THREADS": "1"}, timeout=300)
    assert out.returncode == 1, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["pass"] is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli(args[:-2])


def test_generator_pass_uses_deterministic_cudnn(root, monkeypatch):
    """What makes A = A exact on the card: the generator's training step
    and the engine's pass run under ``torch.backends.cudnn.deterministic``
    (the default GPU algorithms of its transposed convolutions, forward
    and backward, sum with atomics) and restore the caller's setting;
    ``ab-e2e --retrain`` trains A and B apart."""
    from pix2pose_torch.config import TrainConfig
    from pix2pose_torch.models import AutoEncoder, Discriminator
    from pix2pose_torch.training.gan import (create_train_state,
                                             draw_labels, init_like_flax,
                                             make_train_step)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = []

    def hook(*_):
        seen.append(torch.backends.cudnn.deterministic)

    est = tab._estimator({}, "paper", "cpu")
    est.model.register_forward_hook(hook)
    x = torch.zeros((1, 128, 128, 3))
    est._apply(None, x)
    est._apply(est.model.state_dict(), x)
    cfg = TrainConfig(batch_size=2)
    init = torch.Generator().manual_seed(0)
    gen = init_like_flax(AutoEncoder(), init)
    gen.register_forward_hook(hook)
    state = create_train_state(gen, init_like_flax(Discriminator(), init),
                               cfg)
    batch = {"src": torch.zeros((2, 128, 128, 3)),
             "tgt": torch.zeros((2, 128, 128, 3)),
             "prob_gt": torch.zeros((2, 128, 128, 1))}
    labels = draw_labels(init, 2, cfg.label_flipping)
    for det in (True, False):
        make_train_step(cfg, deterministic=det)(
            state, batch, torch.eye(3)[None], 1e-3, labels)
    assert seen == [True] * 4 + [False] * 2
    assert torch.backends.cudnn.deterministic is False

    seeds = []

    def untrained(store, seed, *args):
        seeds.append(seed)
        return est.model.state_dict()

    monkeypatch.setattr(tab, "_train", untrained)
    assert cli(["ab-e2e", "--seeds", "1", "--steps", "2", "--root", root,
                "--a", SMALL, "--b", SMALL, "--retrain", "--device",
                "cpu"]) == 0
    assert seeds == [0, 0]
