"""pix2pose_torch ``rehearsal`` on the CPU: the RLE, the detector's scale
range and the detections file against the JAX tool's, exactly, and the
micro run of the whole pipeline at the JAX test's profile
(``tests/test_rehearsal.py:66-84``).

The micro run's generators train at batch 2 (the tool's recipe is 32,
which takes ~8 s per object step on one CPU thread); everything else is
the tool's. It checks structure and plumbing, not accuracy. Two training
steps give neither a detector box of 4 px nor a generator error map below
any threshold, so two stand-ins carry poses through the evaluators: the
detector (run as the tool runs it) hands on the first two ground-truth
detections of each frame, and the engine decodes with
:class:`~pix2pose_torch.utils.synthetic.OracleGenerator` while it is still
handed each object's trained weights. The detections file, its replay,
the per-object weights and parameters, the ICP meshes and ``max_det``
are the tool's own.
"""

import json
import os

import numpy as np
import pytest
import torch

from pix2pose_tpu.data.bop import BopDataset as JaxBopDataset
from pix2pose_tpu.data.bop import get_target_list
from pix2pose_tpu.inference import detector as jdet
from pix2pose_tpu.tools import rehearsal as jreh
from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.config import TrainConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.inference import detector as tdet
from pix2pose_torch.models import AutoEncoder, CenterNetDetector
from pix2pose_torch.tools import rehearsal as treh
from pix2pose_torch.utils.synthetic import OracleGenerator

torch.set_num_threads(1)

# the JAX tool's summary keys (pix2pose_tpu/tools/rehearsal.py)
JAX_KEYS = {"root", "det_scale_range", "det_box_mAP50", "det_box_mAP75",
            "det_mask_mAP50", "det_mask_mAP75", "det_test_box_mAP50",
            "det_test_mask_mAP50", "det_test_n_gt", "det_test_n_det",
            "wall_s"} | {f"AR_{e}_{t}" for e in ("rgb", "rgbd")
                         for t in ("centernet", "precomputed")} | {
    f"AR_rgb_{t}_per_object" for t in ("centernet", "precomputed")}


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """The micro run's root and summary (one run for the module)."""
    root = str(tmp_path_factory.mktemp("rehearsal") / "r")

    class GtBackedDetector(treh.TorchDetector):
        def detect(self, scene_id, im_id, rgb):
            super().detect(scene_id, im_id, rgb)
            gt = tdet.GtDetector(BopDataset(root, "rehearsal", train=False))
            return gt.detect(scene_id, im_id, rgb)[:2]

    class OracleEstimator(treh.Pix2PoseEstimator):
        def __init__(self, model, cfg, device):
            super().__init__(OracleGenerator(), cfg, device=device)

        def _apply(self, params, x):
            assert params is not None       # the object's trained weights
            return self.model(x)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(treh, "TrainConfig",
                  lambda **kw: TrainConfig(**{**kw, "batch_size": 2}))
        m.setattr(treh, "TorchDetector", GtBackedDetector)
        m.setattr(treh, "Pix2PoseEstimator", OracleEstimator)
        summary = treh.run_rehearsal(
            out_root=root, gan_steps=2, det_steps=2, n_train=3, n_test=2,
            det_im=256, det_k_obj=5, map_images=4, icp=True, device="cpu")
    return root, summary


def test_rle_encode_matches_jax_and_round_trips():
    rng = np.random.RandomState(0)
    masks = [rng.rand(13, 17) < p for p in (0.1, 0.4, 0.9)] + [
        np.ones((4, 4), bool), np.zeros((4, 4), bool),
        np.eye(5, dtype=bool)]
    for m in masks:
        got = treh._rle_encode(m)
        assert got == jreh._rle_encode(m)
        np.testing.assert_array_equal(
            tdet.PrecomputedDetector._decode_rle(got), m)


def test_detector_scale_range_matches_jax(micro):
    root, summary = micro
    ds_t = BopDataset(root, "rehearsal", train=True)
    ds_j = JaxBopDataset(root, "rehearsal", train=True)
    for det_im in (256, 384, 512):
        got = treh._detector_scale_range(ds_t, det_im)
        assert got == jreh._detector_scale_range(ds_j, det_im), det_im
        assert 0.08 <= got[0] < got[1] <= 1.6
    assert summary["det_scale_range"] == treh._detector_scale_range(ds_t, 256)


def test_dump_detections_writes_the_jax_file(micro, tmp_path):
    """The same test targets through a jittered ``GtDetector`` of each
    package (boxes, scores and RLE masks): the two files are equal byte
    for byte, and the port's replays through ``PrecomputedDetector``."""
    root, _ = micro
    ds_t = BopDataset(root, "rehearsal", train=False)
    ds_j = JaxBopDataset(root, "rehearsal", train=False)
    targets = get_target_list(os.path.join(ds_j.dir,
                                           "test_targets_bop19.json"))
    paths = [str(tmp_path / f"{n}.json") for n in ("jax", "port")]
    n_j = jreh.dump_detections(jdet.GtDetector(ds_j, jitter=3, seed=4), ds_j,
                               targets, paths[0])
    n_t = treh.dump_detections(tdet.GtDetector(ds_t, jitter=3, seed=4), ds_t,
                               targets, paths[1])
    assert n_t == n_j >= 10
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    pre = tdet.PrecomputedDetector(paths[1])
    gt = tdet.GtDetector(ds_t, jitter=3, seed=4)
    for scene_id, im_id, *_ in targets:
        got = pre.detect(scene_id, im_id, None)
        want = gt.detect(scene_id, im_id, None)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.bbox, b.bbox)
            np.testing.assert_array_equal(a.mask, b.mask)


def test_micro_rehearsal_writes_every_output(micro, monkeypatch):
    root, summary = micro
    assert JAX_KEYS <= set(summary)
    assert set(summary["stage_s"]) >= {"dataset", "colorize", "pairs", "gan",
                                       "detector", "eval_rgbd_precomputed"}
    for k in JAX_KEYS:
        if k.startswith("AR_") and not k.endswith("_per_object"):
            assert all(0.0 <= v <= 1.0 for v in summary[k].values()), k
    out = os.path.join(root, "out")
    with open(os.path.join(out, "rehearsal_summary.json")) as f:
        assert json.load(f)["det_test_n_gt"] == summary["det_test_n_gt"] > 0
    with open(os.path.join(out, "detections.json")) as f:
        assert len(json.load(f)) == summary["det_test_n_det"]
    csvs = sorted(f for f in os.listdir(out) if f.endswith(".csv"))
    assert csvs == sorted(f"rehearsal-{t}{e}_rehearsal-test.csv"
                          for t in ("centernet", "precomputed")
                          for e in ("", "-icp"))
    # poses from both transports, equal but for the per-image wall time
    for e in ("", "-icp"):
        rows = {}
        for t in ("centernet", "precomputed"):
            with open(os.path.join(
                    out, f"rehearsal-{t}{e}_rehearsal-test.csv")) as f:
                lines = f.read().splitlines()
            assert lines[0].endswith(",time")
            rows[t] = [line.rsplit(",", 1)[0] for line in lines[1:]]
        assert rows["centernet"], e
        assert rows["centernet"] == rows["precomputed"], e
    w = torch.load(os.path.join(out, "weights.pt"))
    assert sorted(w["gen"]) == [1, 2, 3, 4] and sorted(w["locks"]) == \
        [1, 2, 3, 4]
    for o, state in w["gen"].items():
        AutoEncoder().load_state_dict(state, strict=True)
        assert w["obj_params"][o].shape == (6,)
    CenterNetDetector(num_classes=4).load_state_dict(w["det"], strict=True)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli(["rehearsal", "--root", root, "--gan-steps", "1"])
