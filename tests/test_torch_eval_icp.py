"""pix2pose_torch RGB-D evaluation with ICP against the JAX package on the
JAX test fixture's cube dataset (oracle generator): the one-mesh and
batched refiners, :class:`BopEvaluatorICP` end to end, round-1 recovery,
batched vs serial and the occupancy gating.

Tolerances: refined poses within 0.5 deg and 1 mm of the JAX refiner's
(both sample deterministically; the renders agree to rtol 1e-5); refiner
scores within 1% relative; evaluator rows the JAX evaluator's (scene,
image, object) in order, poses within 5 deg and 15 mm of GT
(``tests/test_icp_eval.py``'s bar; the RANSAC draws differ); batched vs
serial within 2 deg, 10 mm and 0.05 in score, as the JAX test holds its
two paths."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from bop_fixture import build_cube_dataset
from pix2pose_tpu.config import EvalConfig as JEvalConfig
from pix2pose_tpu.data import BopDataset as JBopDataset
from pix2pose_tpu.eval.bop_eval_icp import BopEvaluatorICP as JEvaluatorICP
from pix2pose_tpu.eval.icp_refine import make_icp_refiner as jmake_refiner
from pix2pose_tpu.inference import Pix2PoseEstimator as JEstimator
from pix2pose_tpu.inference.detector import GtDetector as JGtDetector
from pix2pose_tpu.ops import geometry as jgeometry
from pix2pose_tpu.ops import rasterizer as jrasterizer
from pix2pose_torch.config import EvalConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.eval.bop_eval_icp import BopEvaluatorICP
from pix2pose_torch.eval.icp_refine import (make_batch_icp_refiner,
                                            make_icp_refiner, stack_meshes)
from pix2pose_torch.inference.detector import GtDetector
from pix2pose_torch.inference.engine import Pix2PoseEstimator
from pix2pose_torch.ops import geometry
from pix2pose_torch.utils import synthetic as tsyn
from synthetic import CAM_K, OracleGenerator, pose_with_euler

torch.set_num_threads(1)
OBJ_PARAM = np.array([40, 40, 40, 0, 0, 0], np.float32)
CFG_KW = dict(score_type=2, task_type=2, cand_factor=1.0,
              outlier_th=(0.1, 0.2, 0.3), inlier_th=0.1)
PARAMS = {"dummy": torch.zeros(1)}


def rot_err_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra).T @ Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


@pytest.fixture(scope="module")
def icp_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_icp_torch"))
    entries = build_cube_dataset(root, n_scenes=1, ims_per_scene=2)
    ds = BopDataset(root, "cubes", train=False)
    cfg = EvalConfig(dataset_dir=root, **CFG_KW)
    est = Pix2PoseEstimator(tsyn.OracleGenerator(), cfg.estimator(0),
                            device="cpu")
    return root, entries, ds, cfg, est


def _evaluator(icp_set, detector, **kw):
    _, _, ds, cfg, est = icp_set
    return BopEvaluatorICP(ds, cfg, est, {1: PARAMS}, {1: OBJ_PARAM},
                           {1: tsyn.cube_mesh(40.0)}, detector, max_det=2,
                           **kw)


def test_icp_refiner_matches_jax():
    """``make_icp_refiner`` on a perturbed pose (as
    ``tests/test_icp_eval.py:26``) against the JAX refiner; the batched
    refiner over two hypotheses of two meshes equals single calls."""
    verts, faces = tsyn.cube_mesh(40.0)
    R, t = pose_with_euler()
    depth_mm, mask = jrasterizer.render_depth(verts, faces, R, t, CAM_K, 480,
                                              640)
    depth = np.asarray(depth_mm) / 1000.0
    union = np.array(mask)
    dR = Rotation.from_euler("xyz", [0.05, -0.04, 0.06]).as_matrix()
    R0 = (dR @ R).astype(np.float32)
    t0 = t + np.array([8.0, -6.0, 15.0], np.float32)

    jtp = jgeometry.backproject(jnp.asarray(depth), CAM_K)
    jtn = jgeometry.normals_from_depth(jnp.asarray(depth), CAM_K,
                                       refine=True)
    ref = jmake_refiner(verts / 1000.0, faces, 480, 640)(
        jnp.asarray(R0), jnp.asarray(t0), CAM_K, jnp.asarray(union),
        jnp.asarray(depth), jtp, jtn, jax.random.PRNGKey(0))

    d, K = torch.as_tensor(depth), torch.as_tensor(CAM_K)
    tp, tn = geometry.backproject(d, K), geometry.normals_from_depth(d, K)
    refine = make_icp_refiner(verts / 1000.0, faces, 480, 640, device="cpu")
    got = refine(torch.as_tensor(R0), torch.as_tensor(t0), K,
                 torch.as_tensor(union), d, tp, tn)
    assert bool(got.ok) and bool(ref.ok)
    assert rot_err_deg(got.R.numpy(), np.asarray(ref.R)) < 0.5
    assert np.linalg.norm(got.t_mm.numpy() - np.asarray(ref.t_mm)) < 1.0
    np.testing.assert_allclose(float(got.score), float(ref.score), rtol=1e-2)
    np.testing.assert_allclose(float(got.ratio), float(ref.ratio),
                               atol=1e-2)
    assert rot_err_deg(got.R.numpy(), R) < 0.5 * rot_err_deg(R0, R)
    assert np.linalg.norm(got.t_mm.numpy() - t) < 0.5 * np.linalg.norm(t0 - t)

    # the batched refiner: hypothesis 1 on a bank entry that is the cube
    sv, sf = stack_meshes([tsyn.uv_sphere(8, 10, 30.0),
                           (verts, faces)])
    batch = make_batch_icp_refiner(sv / 1000.0, sf, 480, 640, device="cpu")
    both = batch([1, 1], torch.as_tensor(np.stack([R0, R])),
                 torch.as_tensor(np.stack([t0, t])), K,
                 torch.as_tensor(np.stack([union, union])), d, tp, tn)
    np.testing.assert_allclose(both.R[0].numpy(), got.R.numpy(), atol=1e-5)
    np.testing.assert_allclose(both.t_mm[0].numpy(), got.t_mm.numpy(),
                               atol=1e-3)
    assert int(both.overflow.sum()) == 0


def test_rgbd_eval_matches_jax(icp_set):
    """:class:`BopEvaluatorICP` (batched) against the JAX evaluator: the
    same rows, every pose within 5 deg and 15 mm of GT."""
    root, entries, ds, cfg, est = icp_set
    jds = JBopDataset(root, "cubes", train=False)
    model = OracleGenerator()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    jcfg = JEvalConfig(dataset_dir=root, **CFG_KW)
    jev = JEvaluatorICP(jds, jcfg, JEstimator(model, jcfg.estimator(0)),
                        {1: params}, {1: OBJ_PARAM},
                        {1: tsyn.cube_mesh(40.0)},
                        JGtDetector(jds, jitter=4), max_det=2)
    ev = _evaluator(icp_set, GtDetector(ds, jitter=4))
    assert ev.batched
    ref, got = jev.run(), ev.run(out_dir=root)
    assert [(r["scene_id"], r["im_id"], r["obj_id"]) for r in got] == \
        [(r["scene_id"], r["im_id"], r["obj_id"]) for r in ref]
    assert len(got) >= len(entries) and ev.render_overflow == 0
    gt = {(s, i): (R, t) for s, i, R, t in entries}
    for r in got:
        R_gt, t_gt = gt[(r["scene_id"], r["im_id"])]
        assert rot_err_deg(r["R"], R_gt) < 5.0
        assert np.linalg.norm(r["t"] - t_gt) < 15.0


class _RelabeledDetector:
    """GtDetector reporting a non-target obj_id: round 0 must skip it,
    round 1 must recover the object from the unused ROI
    (``icp3d:394-433``)."""

    def __init__(self, ds, wrong_id=77):
        self.inner = GtDetector(ds)
        self.wrong_id = wrong_id

    def detect(self, scene_id, im_id, rgb):
        dets = self.inner.detect(scene_id, im_id, rgb)
        for d in dets:
            d.obj_id = self.wrong_id
        return dets


def test_round2_recovers_missing_object(icp_set):
    root, entries, ds, _, _ = icp_set
    for batched in (True, False):
        ev = _evaluator(icp_set, _RelabeledDetector(ds), batched=batched)
        results = ev.run(target_list=[(0, 0, [1], [1])])
        assert len(results) >= 1
        assert results[0]["obj_id"] == 1
        assert rot_err_deg(results[0]["R"], entries[0][2]) < 5.0


def test_batched_path_matches_serial(icp_set):
    """The per-round batched path against the per-hypothesis serial loop
    (fresh same-seed detectors: GtDetector's jitter draws advance per
    call)."""
    _, _, ds, _, _ = icp_set
    ev_b = _evaluator(icp_set, GtDetector(ds, jitter=4, seed=3))
    ev_s = _evaluator(icp_set, GtDetector(ds, jitter=4, seed=3),
                      batched=False)
    assert ev_b.batched and not ev_s.batched
    tl = [(0, 0, [1], [1]), (0, 1, [1], [1])]
    rows_b, rows_s = ev_b.run(target_list=tl), ev_s.run(target_list=tl)
    assert len(rows_b) == len(rows_s) == 2
    for rb, rs in zip(rows_b, rows_s):
        assert (rb["scene_id"], rb["im_id"], rb["obj_id"]) == \
            (rs["scene_id"], rs["im_id"], rs["obj_id"])
        assert rot_err_deg(rb["R"], rs["R"]) < 2.0
        assert np.linalg.norm(rb["t"] - rs["t"]) < 10.0
        assert abs(rb["score"] - rs["score"]) < 0.05


class _DuplicatingDetector:
    def __init__(self, ds):
        self.inner = GtDetector(ds)

    def detect(self, scene_id, im_id, rgb):
        dets = self.inner.detect(scene_id, im_id, rgb)
        return dets + [copy.deepcopy(d) for d in dets]


def test_occupancy_gating_skips_duplicate_detections(icp_set):
    """The duplicate ROI is occupancy-gated in round 0 and its round-1
    retest is blocked because the instance count is filled: one row, on
    both paths."""
    _, _, ds, _, _ = icp_set
    for batched in (True, False):
        ev = _evaluator(icp_set, _DuplicatingDetector(ds), batched=batched)
        rows = ev._process_image(
            ds.load_rgb(0, 0), ds.load_depth(0, 0, 1.0),
            ds.scene_camera(0)[0]["cam_K"], 0, 0, [1], [1],
            torch.Generator().manual_seed(0))
        assert len(rows) == 1
