"""pix2pose_torch detection metrics and detector tools against the JAX
package on the CPU: the metric functions, the two repaired defects of the
JAX module, ``eval-detector --split test`` with both heads, and
``scene-gen``.

Tolerances: the metric functions exact (float64 host numpy, the same
code). The repaired defects are shown against the JAX result and against
the JAX result with the repair applied to its inputs (then equal). The
CLI's numbers equal the JAX functions' on the JAX adapters' detections
with the same two repairs (half-open boxes, GT read by the integer image
id: the JAX CLI finds no GT at all, shown). ``scene-gen`` at axis-aligned
placements with the JAX draws injected: the uint8 frames each tool
encodes within 1 LSB (the float images agree within 2e-7, and truncation
to uint8 flips a value that lies that close to an integer: ~1 000-3 000
of a 128 x 128 frame's 49 152 values, most on flat backgrounds whose
resize lands 1 ulp under k / 255); the decoded JPEGs, which spread such
flips through the quantized DCT, within a mean of 0.5 and a max of 12
LSB (measured 0.21-0.44 and 6-11); the masks equal, ``gt.csv`` and
``label.csv`` equal (no row flips here: sizes and offsets are equal).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pix2pose_tpu.data.bop import BopDataset as JaxBopDataset
from pix2pose_tpu.eval import detection_metrics as jdm
from pix2pose_tpu.inference.detector import Detection as JaxDetection
from pix2pose_tpu.models import detector as jdet
from pix2pose_tpu.models import retinanet as jret
from pix2pose_tpu.tools import eval_detector as jed
from pix2pose_tpu.tools import scene_gen_detection as jsg
from pix2pose_tpu.training import detector_data as jdd
from pix2pose_tpu.utils import checkpoint as jckpt
from pix2pose_torch import __main__ as tmain
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.eval import detection_metrics as tdm
from pix2pose_torch.inference.detector import Detection
from pix2pose_torch.models import detector as tdet
from pix2pose_torch.tools import scene_gen_detection as tsg
from pix2pose_torch.training import detector_data as tdd
from pix2pose_torch.utils import checkpoint as ckpt_util
from pix2pose_torch.utils.synthetic import build_cube_dataset
from test_torch_detector_data import _St, _blob_patches, jax_draws
from test_torch_gan import seeded_variables
from test_torch_train_cli import write_pairs

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)

TINY = dict(trunk="tiny", head_dim=16)


def _random_sets(rng, n_img=6, n_cls=3, hw=24):
    """Seeded preds / gts with boxes, masks and jittered copies of the GT
    as true positives, plus false positives and misses."""
    preds, gts = [], []
    for _ in range(n_img):
        m = rng.integers(0, 5)
        tl = rng.uniform(0, 12, (m, 2))
        gb = np.concatenate([tl, tl + rng.uniform(3, 12, (m, 2))], 1)
        gc = rng.integers(0, n_cls, m)
        keep = rng.uniform(size=m) < 0.7
        pb = np.concatenate([gb[keep] + rng.normal(0, 1.0, (keep.sum(), 4)),
                             rng.uniform(0, 20, (2, 4)).cumsum(1)])
        pc = np.concatenate([gc[keep], rng.integers(0, n_cls, 2)])
        ps = np.round(rng.uniform(0, 1, len(pb)), 1)   # score ties
        masks = []
        for boxes in (gb, pb):
            mk = np.zeros((len(boxes), hw, hw), bool)
            for i, b in enumerate(np.clip(boxes, 0, hw).astype(int)):
                mk[i, b[0]:b[2] + 1, b[1]:b[3] + 1] = True
            masks.append(mk)
        gts.append({"bbox": gb, "cls": gc, "mask": masks[0]})
        preds.append({"bbox": pb, "score": ps, "cls": pc, "mask": masks[1]})
    return preds, gts


def _same(a, b, path=""):
    """Nested results equal, NaN == NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


def test_metric_functions_match_jax():
    rng = np.random.default_rng(0)
    assert tdm.COCO_IOU_THS == jdm.COCO_IOU_THS
    a, b = rng.uniform(0, 20, (7, 4)).cumsum(1), rng.uniform(0, 20, (5, 4))
    np.testing.assert_array_equal(tdm.box_iou_matrix(a, b),
                                  jdm.box_iou_matrix(a, b))
    ma, mb = rng.uniform(size=(4, 9, 9)) > 0.5, rng.uniform(
        size=(3, 9, 9)) > 0.6
    np.testing.assert_array_equal(tdm.mask_iou_matrix(ma, mb),
                                  jdm.mask_iou_matrix(ma, mb))
    for tp in (rng.uniform(size=13) > 0.4, np.zeros(0, bool)):
        for n_gt in (0, 9):
            _same(tdm.average_precision(tp, n_gt),
                  jdm.average_precision(tp, n_gt))
    for seed in range(3):
        preds, gts = _random_sets(np.random.default_rng(seed))
        for iou_type in ("bbox", "mask"):
            _same(tdm.evaluate_detections(preds, gts, iou_type=iou_type),
                  jdm.evaluate_detections(preds, gts, iou_type=iou_type))
        _same(tdm.evaluate_detections(preds, gts, (0.3,), False),
              jdm.evaluate_detections(preds, gts, (0.3,), False))
        _same(tdm.tune_score_threshold(preds, gts),
              jdm.tune_score_threshold(preds, gts))
        dets = [(i, float(s), bb) for i, p in enumerate(preds)
                for s, bb, c in zip(p["score"], p["bbox"], p["cls"])
                if c == 1]
        g = {i: gg["bbox"][gg["cls"] == 1] for i, gg in enumerate(gts)}
        _same(tdm._match_class(dets, g, 0.5), jdm._match_class(dets, g, 0.5))
    assert tdm.evaluate_detections(preds, gts)["mAP50"] > 0.2


@pytest.fixture(scope="module")
def cube_set(tmp_path_factory):
    """The cube BOP set (1 scene x 2 images, 480x640, one object) with a
    config, in both packages' BopDataset."""
    root = str(tmp_path_factory.mktemp("det_metrics"))
    build_cube_dataset(root, n_scenes=1, ims_per_scene=2, device="cpu")
    cfg = os.path.join(root, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"dataset_dir": root, "backbone": "paper"}, f)
    return root, cfg


class _GtBoxDetector:
    """Per image: the GT's inclusive box (a true positive) and a shifted
    copy (a false positive); ``masks`` says which get a mask."""

    def __init__(self, ds, det_cls, masks, half_open=False, fill=False):
        self.ds, self.cls, self.masks = ds, det_cls, masks
        self.shift = np.array([0, 0, 1, 1]) if half_open else 0
        self.fill = fill

    def detect(self, scene_id, im_id, rgb):
        m = np.asarray(Image.open(self.ds.mask_path(
            scene_id, im_id, 0, visib=True))) > 127
        v, u = np.nonzero(m)
        box = np.array([v.min(), u.min(), v.max(), u.max()])
        out = []
        for k, (b, with_mask) in enumerate(zip(
                (box, box + [9, 6, 9, 6]), self.masks)):
            mask = None
            if with_mask or self.fill:
                mask = np.zeros(m.shape, bool)
                mask[b[0]:b[2] + 1, b[1]:b[3] + 1] = True
            out.append(self.cls(bbox=b + self.shift, obj_id=1,
                                score=0.9 - 0.2 * k, mask=mask))
        return out


def test_repaired_defects_against_jax(cube_set):
    """(1) a detection without a mask: the JAX module leaves the image
    with 0 mask rows (mask mAP raises IndexError) or fails to stack mixed
    masks; the port gives it its box as a mask. (2) inclusive detector
    boxes against half-open GT boxes: the JAX module scores an exact box
    below IoU 1 (~1 px short per side); the port's half-open boxes score
    it at 1. With both repairs applied
    to its inputs the JAX module gives the port's numbers."""
    root, _ = cube_set
    ds = BopDataset(root, "cubes", train=False)
    jds = JaxBopDataset(root, "cubes", train=False)
    targets = [(0, i, [1], [1]) for i in range(2)]
    with pytest.raises(IndexError):
        jdm.evaluate_detections(*jdm.collect_bop_split_detections(
            _GtBoxDetector(jds, JaxDetection, (False, True)), jds, targets),
            iou_type="mask")
    with pytest.raises((TypeError, ValueError)):
        jdm.collect_bop_split_detections(
            _GtBoxDetector(jds, JaxDetection, (True, False)), jds, targets)

    for masks in ((False, True), (True, False)):
        preds, gts = tdm.collect_bop_split_detections(
            _GtBoxDetector(ds, Detection, masks), ds, targets)
        jpreds, jgts = jdm.collect_bop_split_detections(
            _GtBoxDetector(jds, JaxDetection, masks, half_open=True,
                           fill=True), jds, targets)
        _same(preds, jpreds)
        _same(gts, jgts)
        for iou_type in ("bbox", "mask"):
            res = tdm.evaluate_detections(preds, gts, iou_type=iou_type)
            _same(res, jdm.evaluate_detections(jpreds, jgts,
                                               iou_type=iou_type))
        box = tdm.evaluate_detections(preds, gts)
        assert box["mAP50"] == box["mAP75"] == box["mAP"] == 1.0
    # the exact box's IoU with its GT: 1 in the port, below 1 in JAX
    rp, rg = jdm.collect_bop_split_detections(
        _GtBoxDetector(jds, JaxDetection, (True, True)), jds, targets)
    for i in range(2):
        assert tdm.box_iou_matrix(preds[i]["bbox"][:1],
                                  gts[i]["bbox"])[0, 0] == 1.0
        assert jdm.box_iou_matrix(rp[i]["bbox"][:1],
                                  rg[i]["bbox"])[0, 0] < 0.99


def _write_detector(ds_dir, head, fmodel, seed):
    """Seeded flax variables for ``fmodel`` (heads scaled so scores
    spread around 0.3-0.7 and boxes are cube-sized), written as orbax for
    the JAX CLI and converted to ``inference.npz`` for the port."""
    v = seeded_variables(fmodel, np.zeros((1, 64, 64, 3), np.float32), seed)
    p = v["params"]
    scaled = (("heat_out", 0.0), ("wh_out", 25.0), ("off_out", 0.5)) \
        if head == "centernet" else (("cls_out", 0.0), ("box_out", 0.0))
    for name, bias in scaled:
        p[name]["kernel"] = p[name]["kernel"] * 0.01
        p[name]["bias"] = np.full_like(p[name]["bias"], bias)
    wdir = os.path.join(ds_dir, "weight_detection", head)
    jckpt.export_inference(wdir, v["params"], v["batch_stats"])
    ckpt_util.export_inference(wdir, jax.device_get(
        jckpt.load_inference_params(wdir)))
    return v


class _StrKeys:
    """A JAX BopDataset whose scene_gt is keyed by str(im_id), the key
    the JAX eval-detector looks up."""

    def __init__(self, ds):
        self.ds = ds

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def scene_gt(self, scene_id):
        return {str(k): v for k, v in self.ds.scene_gt(scene_id).items()}


@pytest.mark.parametrize("head", ["centernet", "retinanet"])
def test_eval_detector_test_split_matches_jax(cube_set, monkeypatch,
                                              tmp_path, head):
    """``eval-detector --split test --device cpu`` (tiny models at the
    CLI's 512 px input, seeded weights; both CLIs' model classes patched
    to the same widths) against the JAX CLI's adapter and metrics with the
    repairs applied. The CenterNet head's mask mAP is scored over the same
    detections and GT as its box mAP."""
    from pix2pose_tpu.inference.jax_detector import (JaxDetector,
                                                     RetinaNetAdapter)
    from pix2pose_torch.models import retinanet as tret
    from pix2pose_torch.tools import eval_detector as ted

    root, cfg = cube_set
    ds_dir = os.path.join(root, "cubes")
    fcls = {"centernet": jdet.CenterNetDetector,
            "retinanet": jret.RetinaNetDetector}[head]
    for mod, cls in ((jdet, jdet.CenterNetDetector),
                     (jret, jret.RetinaNetDetector),
                     (ted, tdet.CenterNetDetector),
                     (ted, tret.RetinaNetDetector)):
        monkeypatch.setattr(mod, cls.__name__,
                            functools.partial(cls, **TINY))
    fmodel = fcls(num_classes=1, **TINY)
    v = _write_detector(ds_dir, head, fmodel, 8)
    args = [cfg, "cubes", "--split", "test", "--head", head, "--tune"]
    got = tmain.main(["eval-detector"] + args + [
        "--json", str(tmp_path / "t.json"), "--device", "cpu"])
    assert json.load(open(tmp_path / "t.json")) == json.loads(
        json.dumps(got))
    jed.main(args + ["--json", str(tmp_path / "j.json")])
    jres = json.load(open(tmp_path / "j.json"))
    assert jres["n_gt"] == {}          # the JAX CLI finds no GT

    jds = JaxBopDataset(root, "cubes", train=False)
    adapter = (RetinaNetAdapter if head == "retinanet" else JaxDetector)(
        fmodel, v, jds.model_ids, score_th=0.3)
    preds, gts = [], []
    for im_id in range(2):
        rgb = jds.load_rgb(0, im_id)
        dets = adapter.detect(0, im_id, rgb)
        preds.append({"bbox": np.asarray([d.bbox for d in dets], np.float64)
                      .reshape(-1, 4) + [0, 0, 1, 1],
                      "score": np.asarray([d.score for d in dets]),
                      "cls": np.zeros(len(dets), np.int64),
                      "mask": tdm.detection_masks(dets, *rgb.shape[:2])})
        gt = jed.gt_boxes_from_masks(_StrKeys(jds), 0, im_id)
        gt["mask"] = np.stack([np.asarray(Image.open(jds.mask_path(
            0, im_id, 0, visib=True))) > 0])
        gts.append(gt)
    want = jdm.evaluate_detections(preds, gts)
    n_det = sum(len(p["score"]) for p in preds)
    assert got["n_det"] == n_det > 0
    assert got["n_gt_total"] == 2 and got["n_gt"] == {"0": 2}
    for k in ("mAP50", "mAP75", "mAP"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
    if head == "centernet":
        want = jdm.evaluate_detections(preds, gts, iou_type="mask")
        assert got["mask"]["n_gt"] == {"0": 2}
        for k in ("mAP50", "mAP75", "mAP"):
            assert got["mask"][k] == pytest.approx(
                want[k], rel=1e-9, abs=1e-12), k
    else:
        assert "mask" not in got
    tuned = jdm.tune_score_threshold(preds, gts)
    assert got["tuned"]["best_th"] == pytest.approx(tuned["best_th"])
    assert got["tuned"]["best_f1"] == pytest.approx(tuned["best_f1"])


def test_scene_gen_matches_jax(cube_set, monkeypatch, tmp_path):
    """``generate_scenes`` with the JAX tool's draws injected (axis-aligned
    placements; JAX's warp in float32), then the CLI on the CPU."""
    uniform = jax.random.uniform

    def fixed(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if isinstance(minval, float) and minval == -np.pi:
            return jnp.zeros(shape, jnp.float32)
        return uniform(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", fixed)
    monkeypatch.setattr(jsg, "make_detector_batch", jax.jit(
        functools.partial(jdd.make_detector_batch.__wrapped__,
                          warp_dtype=None),
        static_argnames=("batch_size", "im_size", "k_obj")))
    rng = np.random.RandomState(4)
    objs = {3: _St(*_blob_patches(rng, 3, (250, 90, 60))),
            7: _St(*_blob_patches(rng, 3, (60, 230, 120)))}
    backs = np.stack([np.full((256, 256, 3), 60 + 40 * i, np.uint8)
                      for i in range(2)])
    jst = jdd.DetectorStore.from_patch_stores(objs, jnp.asarray(backs))
    tst = tdd.DetectorStore.from_patch_stores(
        {o: _St(*(torch.from_numpy(a) for a in (s.rgb, s.mask, s.extent)))
         for o, s in objs.items()}, torch.from_numpy(backs))
    kw = dict(num=8, im_size=128, k_obj=3, class_to_obj_id=[3, 7])
    frames = {}
    save = Image.Image.save

    def recording(im, fp, *args, **kwargs):   # the uint8 frame encoded
        if str(fp).endswith(".jpg"):
            frames[str(fp)] = np.asarray(im, np.int16)
        return save(im, fp, *args, **kwargs)

    monkeypatch.setattr(Image.Image, "save", recording)
    jsg.generate_scenes(jst, str(tmp_path / "jax"), seed=0, **kw)
    _, kb = jax.random.split(jax.random.PRNGKey(0))
    assert tsg.generate_scenes(tst, str(tmp_path / "torch"), draws=[
        jax_draws(kb, jst, 8, 128, 3, angle=0.0)], **kw) == 8
    for i in range(8):
        fn = f"{i:06d}"
        a, b = (frames[str(tmp_path / p / f"{fn}.jpg")]
                for p in ("torch", "jax"))
        assert np.abs(a - b).max() <= 1, i
        a, b = (np.asarray(Image.open(tmp_path / p / f"{fn}.jpg"), np.int16)
                for p in ("torch", "jax"))
        diff = np.abs(a - b)
        assert diff.mean() < 0.5 and diff.max() <= 12, (i, diff.max())
        ma, mb = (np.load(tmp_path / p / "mask" / f"{fn}.npy")
                  for p in ("torch", "jax"))
        assert ma.dtype == np.uint8 and ma.shape == (128, 128)
        np.testing.assert_array_equal(ma, mb)
    for name in ("gt.csv", "label.csv"):
        rows = [(tmp_path / p / name).read_text() for p in ("torch", "jax")]
        assert rows[0] == rows[1], name
    assert len((tmp_path / "torch" / "gt.csv").read_text().split()) >= 8

    # the CLI on the CPU, and its refusal without CUDA
    root, cfg = cube_set
    write_pairs(os.path.join(root, "cubes", "train_xyz", "01"), 3, 0,
                {"rotation_lock": False, "visual_sym_idx": [0]})
    back_dir = tmp_path / "backs"
    os.makedirs(back_dir)
    Image.fromarray(backs[1]).save(back_dir / "b.png")
    args = [cfg, "cubes", str(back_dir), "--num", "2"]
    assert tmain.main(["scene-gen"] + args + ["--device", "cpu"]) == 2
    # as a process it exits 0: the dispatcher does not turn the returned
    # scene count into an exit status
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "pix2pose_torch", "scene-gen"] + args
        + ["--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        env={**env, "OMP_NUM_THREADS": "1"}, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = os.path.join(root, "cubes", "train_detect")
    assert sorted(os.listdir(out)) == ["000000.jpg", "000001.jpg", "gt.csv",
                                       "label.csv", "mask"]
    assert open(os.path.join(out, "label.csv")).read() == "obj_1,0\n"
    if not torch.cuda.is_available():
        for cmd in (["scene-gen"] + args,
                    ["eval-detector", cfg, "cubes"]):
            with pytest.raises(SystemExit, match="no CUDA device"):
                tmain.main(cmd)
