"""pix2pose_torch RGB evaluation against the JAX package on the JAX test
fixture's cube dataset (oracle generator, XYZ-coloured renders): the
detectors, RLE export and LineMOD split reader, the port's own copy of
the cube dataset, the score_type-2 mask scores, the instance-masked engine and
:class:`BopEvaluator` end to end.

Tolerances: detections, RLE, target lists, boxes, masks and counts exact;
mask IoU within 1e-7 (union exact); resampled mask crops at 1e-5 absolute
on >= 99.9% of elements (``tests/test_torch_engine.py``'s bar); poses
within 2 deg and 2% of t_z of GT (``tests/test_bop_eval.py``'s bar);
scores within 1e-2 relative of the JAX evaluator's (the RANSAC draws
differ: JAX threefry keys cannot be reproduced in torch). The port's
serial and image-chunked drives are held to equal CSVs."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from bop_fixture import build_cube_dataset
from pix2pose_tpu.config import EvalConfig as JEvalConfig
from pix2pose_tpu.data import BopDataset as JBopDataset
from pix2pose_tpu.data.bop import \
    target_list_from_linemod_split as jlinemod_split
from pix2pose_tpu.eval import bop_eval as jbop_eval
from pix2pose_tpu.inference import Pix2PoseEstimator as JEstimator
from pix2pose_tpu.inference import detector as jdet
from pix2pose_tpu.inference.engine import \
    estimators_for_objects as jestimators_for_objects
from pix2pose_tpu.ops import boxes as jboxes
from pix2pose_tpu.ops import crop as jcrop
from pix2pose_tpu.tools import run_detector as jrun_detector
from pix2pose_torch.config import EvalConfig
from pix2pose_torch.data.bop import BopDataset, load_bop_results, \
    target_list_from_linemod_split
from pix2pose_torch.eval import bop_eval
from pix2pose_torch.inference import detector as tdet
from pix2pose_torch.inference.engine import (Pix2PoseEstimator, _crop_masks,
                                             estimators_for_objects,
                                             stack_object_params)
from pix2pose_torch.ops import crop as tcrop
from pix2pose_torch.ops.boxes import CropBox
from pix2pose_torch.tools import run_detector
from pix2pose_torch.utils import synthetic as tsyn
from synthetic import CAM_K, OracleGenerator

torch.set_num_threads(1)
OBJ_PARAM = np.array([40, 40, 40, 0, 0, 0], np.float32)
CFG_KW = dict(score_type=2, task_type=2, cand_factor=1.0,
              outlier_th=(0.1, 0.2, 0.3), inlier_th=0.1)


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_torch"))
    entries = build_cube_dataset(root, n_scenes=1, ims_per_scene=3)
    model = OracleGenerator()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    cfg = EvalConfig(dataset_dir=root, **CFG_KW)
    est = Pix2PoseEstimator(tsyn.OracleGenerator(), cfg.estimator(0),
                            device="cpu")
    return root, entries, model, params, est


def _same_detections(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.bbox, y.bbox)
        assert (x.obj_id, x.score) == (y.obj_id, y.score)
        assert (x.mask is None) == (y.mask is None)
        if x.mask is not None:
            np.testing.assert_array_equal(x.mask, y.mask)


def test_detectors_rle_and_split_match_jax(cubes, tmp_path):
    """GtDetector (jitter draws advancing per call), the RLE export and
    its replay through PrecomputedDetector, and the LineMOD split reader
    give exactly the JAX package's records."""
    root = cubes[0]
    jds, ds = JBopDataset(root, "cubes", False), BopDataset(root, "cubes",
                                                           False)
    jgt, gt = jdet.GtDetector(jds, jitter=6, seed=3), \
        tdet.GtDetector(ds, jitter=6, seed=3)
    for im in (0, 1, 2, 0):
        rgb = ds.load_rgb(0, im)
        _same_detections(jgt.detect(0, im, rgb), gt.detect(0, im, rgb))

    rng = np.random.default_rng(0)
    for first in (False, True):
        m = rng.random((7, 9)) < 0.4
        m[0, 0] = first
        rle = run_detector.encode_rle(m)
        assert rle == jrun_detector.encode_rle(m)
        np.testing.assert_array_equal(
            tdet.PrecomputedDetector._decode_rle(rle), m)

    targets = [(0, i, [1], [1]) for i in range(3)]
    path = str(tmp_path / "det.json")
    n = run_detector.export_detections(tdet.GtDetector(ds, jitter=2), ds,
                                       targets, path)
    assert n == 3
    jpre, pre = jdet.PrecomputedDetector(path), tdet.PrecomputedDetector(path)
    for im in range(3):
        _same_detections(jpre.detect(0, im, None), pre.detect(0, im, None))
    assert pre.detect(0, 9, None) == []

    split = tmp_path / "split.txt"
    split.write_text("3\n\n17\n5\n")
    assert target_list_from_linemod_split(str(split), 4) == \
        jlinemod_split(str(split), 4) == [(4, 3, [4], [1]), (4, 17, [4], [1]),
                                          (4, 5, [4], [1])]
    assert target_list_from_linemod_split(str(split), 4, scene_id=2)[0] \
        == (2, 3, [4], [1])


def test_cube_dataset_matches_fixture(cubes, tmp_path):
    """``utils.synthetic.build_cube_dataset`` (rendered by the port)
    against the JAX fixture it copies: the same poses, metadata and
    masks; RGB within 1 level and depth within 1 mm (the float renders
    agree to rtol 1e-5, so a truncation to uint8 / uint16 may flip)."""
    root = cubes[0]
    entries = tsyn.build_cube_dataset(str(tmp_path), 1, 3, device="cpu")
    for (s, i, R, t), (s2, i2, R2, t2) in zip(entries, cubes[1]):
        assert (s, i) == (s2, i2)
        np.testing.assert_array_equal(R, R2)
        np.testing.assert_array_equal(t, t2)
    jds, ds = JBopDataset(root, "cubes", False), BopDataset(str(tmp_path),
                                                           "cubes", False)
    assert ds.model_ids == jds.model_ids == [1]
    assert ds.models_info == jds.models_info
    for name in ("models_xyz/norm_factor.json", "test_targets_bop19.json",
                 "test/000000/scene_gt.json"):
        with open(os.path.join(root, "cubes", name)) as a, \
                open(os.path.join(str(tmp_path), "cubes", name)) as b:
            assert json.load(a) == json.load(b), name
    for im in range(3):
        np.testing.assert_array_equal(ds.scene_camera(0)[im]["cam_K"],
                                      jds.scene_camera(0)[im]["cam_K"])
        m = np.asarray(Image.open(ds.mask_path(0, im, 0, visib=True)))
        mj = np.asarray(Image.open(jds.mask_path(0, im, 0, visib=True)))
        np.testing.assert_array_equal(m, mj)
        assert m.any()
        drgb = ds.load_rgb(0, im).astype(int) - jds.load_rgb(0, im)
        assert np.abs(drgb).max() <= 1
        ddep = ds.load_depth(0, im) - jds.load_depth(0, im)
        assert np.abs(ddep).max() <= 1e-3 + 1e-6


def test_mask_scores_match_jax():
    """score_type-2 IoU and union on the stage-2 grid, per image and
    image-batched, against ``_mask_scores`` / ``_mask_scores_many``:
    boxes hanging off the image, rounding at half pixels, stride 2."""
    rng = np.random.default_rng(1)
    b, n, h, w, g = 2, 3, 60, 80, 32
    det = rng.random((b, n, h, w)) < 0.5
    pred = rng.random((b, n, g, g)) < 0.5
    bb = np.stack([rng.integers(-10, 40, (b, n)), rng.integers(-10, 60,
                                                                (b, n))], -1)
    bb = np.concatenate([bb, bb + rng.integers(5, 45, (b, n, 2))], -1)
    box = jax.vmap(jax.vmap(lambda x: jboxes.get_boxes(x, h, w, 1.5)))(
        jnp.asarray(bb))
    tbox = CropBox(*(torch.as_tensor(np.array(f)) for f in box))
    iou, union = bop_eval._mask_scores(torch.as_tensor(det), tbox,
                                       torch.as_tensor(pred), 2)
    jiou, junion = jbop_eval._mask_scores_many(jnp.asarray(det), box,
                                               jnp.asarray(pred), 2)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-7,
                               rtol=0)
    np.testing.assert_array_equal(union.numpy(), np.asarray(junion))
    for i in range(b):
        j1 = jbop_eval._mask_scores(
            jnp.asarray(det[i]), jax.tree_util.tree_map(lambda x: x[i], box),
            jnp.asarray(pred[i]), 2)
        t1 = bop_eval._mask_scores(torch.as_tensor(det[i]),
                                   tbox.map(lambda x: x[i]),
                                   torch.as_tensor(pred[i]), 2)
        np.testing.assert_array_equal(t1[1].numpy(), np.asarray(j1[1]))
        np.testing.assert_allclose(t1[0].numpy(), np.asarray(j1[0]),
                                   atol=1e-7, rtol=0)
    assert 0 < float(iou.mean()) < 1


def test_masked_engine_matches_jax(cubes):
    """The instance-masked engine: mask crops against the JAX
    ``crop_resize_2d``; with each detection's mask cut to its left half,
    the masked stage 1 (whose foreground decides the stage-2 window), the
    PnP masks and foreground equal JAX's (the oracle makes every
    threshold's candidate identical, so they do not depend on RANSAC);
    ``estimate_batch`` with per-image generators equals per-image calls,
    ``estimate_objects`` equals per-object calls, and
    ``estimators_for_objects`` groups objects as JAX does."""
    root, entries, model, params, est = cubes
    ds = BopDataset(root, "cubes", False)
    dets = [tdet.GtDetector(ds, jitter=3, seed=1).detect(0, i, None)[0]
            for i in range(2)]
    rgbs = np.stack([ds.load_rgb(0, i) for i in range(2)])
    n = 2
    bboxes = np.zeros((2, n, 4), np.int32)
    masks = np.zeros((2, n, 480, 640), bool)
    for i, d in enumerate(dets):
        u_mid = (d.bbox[1] + d.bbox[3]) // 2
        bboxes[i, 0] = d.bbox
        masks[i, 0] = d.mask
        masks[i, 0, :, u_mid:] = False          # left half of the object
        bboxes[i, 1] = d.bbox + 5
        masks[i, 1] = d.mask
    valid = np.ones((2, n), bool)
    jest = JEstimator(model, est.cfg)

    # mask crops (float before the threshold, and thresholded)
    jout = [jest(params, rgbs[i], bboxes[i], valid[i], CAM_K, OBJ_PARAM,
                 jax.random.PRNGKey(i), det_masks=jnp.asarray(masks[i]))
            for i in range(2)]
    for key in ("box1", "box2"):
        jb = [getattr(o, key) for o in jout]
        tb = CropBox(*(torch.as_tensor(np.stack([np.asarray(f) for f in fs]))
                       for fs in zip(*jb)))
        ref = np.stack([np.asarray(jax.vmap(
            lambda m, bx: jcrop.crop_resize_2d(m, bx, 128, False))(
            jnp.asarray(masks[i], jnp.float32), jb[i])) for i in range(2)])
        got = _crop_masks(torch.as_tensor(masks), tb, 128)
        np.testing.assert_array_equal(got.numpy(), ref > 0.5)
        flt = tcrop.crop_resize(
            torch.as_tensor(masks.reshape(4, 480, 640, 1), dtype=torch.float32),
            tb.map(lambda x: x.reshape(4, 1)), 128, False).reshape(ref.shape)
        assert (np.abs(flt.numpy() - ref) <= 1e-5).mean() >= 0.999

    gens = [torch.Generator().manual_seed(10 + i) for i in range(2)]
    out = est.estimate_batch(None, rgbs, bboxes, valid, np.stack([CAM_K] * 2),
                             OBJ_PARAM, gens, det_masks=masks)
    unmasked = est.estimate_batch(None, rgbs, bboxes, valid,
                                  np.stack([CAM_K] * 2), OBJ_PARAM,
                                  torch.Generator().manual_seed(0))
    for i in range(2):
        for name, jf, tf in zip(CropBox._fields, jout[i].box2, out.box2):
            np.testing.assert_array_equal(tf[i].numpy(), np.asarray(jf),
                                          name)
        np.testing.assert_array_equal(out.valid[i].numpy(),
                                      np.asarray(jout[i].valid))
        np.testing.assert_array_equal(out.mask_pnp[i].numpy(),
                                      np.asarray(jout[i].mask_pnp))
        np.testing.assert_array_equal(out.fg128[i].numpy(),
                                      np.asarray(jout[i].fg128))
        one = est(None, rgbs[i], bboxes[i], valid[i], CAM_K, OBJ_PARAM,
                  torch.Generator().manual_seed(10 + i), det_masks=masks[i])
        np.testing.assert_array_equal(one.R.numpy(), out.R[i].numpy())
        np.testing.assert_array_equal(one.t.numpy(), out.t[i].numpy())
        R_gt, t_gt = entries[i][2], entries[i][3]
        assert rot_err_deg(out.R[i, 0].numpy(), R_gt) < 2.0
        assert np.linalg.norm(out.t[i, 0].numpy() - t_gt) < 0.02 * t_gt[2]
    # the half mask moved the stage-2 window of detection 0 only
    assert not torch.equal(out.box2.u2[:, 0], unmasked.box2.u2[:, 0])
    assert torch.equal(out.box2.u2[:, 1], unmasked.box2.u2[:, 1])

    stacked = stack_object_params([{"dummy": torch.zeros(1)}] * 2)
    objs = est.estimate_objects(stacked, rgbs[0], bboxes[0][None].repeat(
        2, 0), valid[0][None].repeat(2, 0), CAM_K, np.stack([OBJ_PARAM] * 2),
        torch.Generator().manual_seed(4), det_masks=masks[0][None].repeat(
            2, 0))
    for o in range(2):
        np.testing.assert_array_equal(objs.mask_pnp[o].numpy(),
                                      out.mask_pnp[0].numpy())
        np.testing.assert_array_equal(objs.box2.v1[o].numpy(),
                                      out.box2.v1[0].numpy())

    per_obj = EvalConfig(outlier_th=[[0.1, 0.2], [0.3, 0.4], [0.1, 0.2]])
    jper_obj = JEvalConfig(outlier_th=[[0.1, 0.2], [0.3, 0.4], [0.1, 0.2]])
    got = estimators_for_objects(tsyn.OracleGenerator(), per_obj, [4, 5, 6],
                                 device="cpu")
    ref = jestimators_for_objects(model, jper_obj, [4, 5, 6])
    assert [id(got[o]) == id(got[4]) for o in (5, 6)] == \
        [id(ref[o]) == id(ref[4]) for o in (5, 6)] == [False, True]
    assert got[5].cfg.outlier_th == ref[5].cfg.outlier_th


class _TwoPerObject:
    """Each GT detection, then a weaker copy of it: box shifted by 6 px
    and its mask cut to the upper half (a lower mask score)."""

    def __init__(self, det):
        self.det = det

    def detect(self, scene_id, im_id, rgb):
        out = []
        for d in self.det.detect(scene_id, im_id, rgb):
            m = d.mask.copy()
            v_mid = (d.bbox[0] + d.bbox[2]) // 2
            m[v_mid:] = False
            out += [d, dataclasses.replace(d, bbox=d.bbox + 6, mask=m)]
        return out


def test_evaluator_matches_jax_and_chunked(cubes):
    """:class:`BopEvaluator` (score_type 2, SiSo so both detections of an
    object give rows) against the JAX evaluator: the same rows in the same
    order, poses to GT, scores within 1e-2 relative; then the port's
    ViVo run, serial and ``image_chunk=2``, to equal CSVs."""
    root, entries, model, params, est = cubes
    jds, ds = JBopDataset(root, "cubes", False), BopDataset(root, "cubes",
                                                           False)
    cfg = EvalConfig(dataset_dir=root, **dict(CFG_KW, task_type=1))
    jcfg = JEvalConfig(dataset_dir=root, **dict(CFG_KW, task_type=1))
    jev = jbop_eval.BopEvaluator(
        jds, jcfg, JEstimator(model, jcfg.estimator(0)), {1: params},
        {1: OBJ_PARAM}, _TwoPerObject(jdet.GtDetector(jds, jitter=6)),
        max_det=4)
    ev = bop_eval.BopEvaluator(
        ds, cfg, est, {1: {"dummy": torch.zeros(1)}}, {1: OBJ_PARAM},
        _TwoPerObject(tdet.GtDetector(ds, jitter=6)), max_det=4)
    ev.warmup()
    ref, got = jev.run(), ev.run()
    assert [(r["scene_id"], r["im_id"], r["obj_id"]) for r in got] == \
        [(r["scene_id"], r["im_id"], r["obj_id"]) for r in ref]
    assert len(got) == 2 * len(entries)
    gt = {(s, i): (R, t) for s, i, R, t in entries}
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-2)
        R_gt, t_gt = gt[(a["scene_id"], a["im_id"])]
        assert rot_err_deg(a["R"], R_gt) < 2.0
        assert np.linalg.norm(a["t"] - t_gt) < 0.02 * t_gt[2]
    assert min(r["score"] for r in got) < 0.9   # the weaker copies

    runs = []
    for chunk in (None, 2):
        e = bop_eval.BopEvaluator(
            ds, dataclasses.replace(cfg, task_type=2), est,
            {1: {"dummy": torch.zeros(1)}}, {1: OBJ_PARAM},
            tdet.GtDetector(ds, jitter=6, seed=3), max_det=4)
        out_dir = os.path.join(root, f"out_{chunk}")
        rows = e.run(out_dir=out_dir, seed=5, image_chunk=chunk)
        assert len(rows) == len(entries)
        csv = os.path.join(out_dir, "pix2pose-torch_cubes-test.csv")
        assert len(load_bop_results(csv)) == len(rows)
        with open(csv) as f:
            runs.append([ln.rsplit(",", 1)[0] for ln in f.read().split()])
    assert runs[0] == runs[1]
