"""pix2pose_torch BOP metrics against the JAX package: the distance
functions, the VSD renders (the z-buffer's plain version on the CPU),
bop_toolkit's per-threshold greedy matching, the AR harness and ADD(-S)
recall, on the JAX test fixture's cube dataset.

Tolerances: distances within 1e-4 relative (fp32 sums in another order);
VSD errors within 1e-3 absolute (depth renders agree to rtol 1e-5, so
``dist <= tau`` may flip on a boundary pixel, which moves an error by
1 / n_union); match counts exact; AR dicts within 1e-3; ADD recall
exact."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bop_fixture import build_cube_dataset, multishape_objects
from pix2pose_tpu.data import BopDataset as JBopDataset
from pix2pose_tpu.eval import metrics as jmetrics
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.eval import metrics
from synthetic import CAM_K, pose_with_euler

torch.set_num_threads(1)


def _poses(rng, n):
    return [pose_with_euler(yaw=rng.uniform(-2, 2), pitch=rng.uniform(-1, 1),
                            roll=rng.uniform(-2, 2), tx=rng.uniform(-40, 40),
                            ty=rng.uniform(-30, 30), tz=rng.uniform(450, 800))
            for _ in range(n)]


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("metrics_torch"))
    entries = build_cube_dataset(root, n_scenes=1, ims_per_scene=2)
    return root, entries


def test_distance_metrics_match_jax():
    """ADD, ADI, MSSD and MSPD on seeded pose pairs of the four fixture
    shapes, with a rotation-only pool and a full (R_s, t_s) pool."""
    rng = np.random.default_rng(0)
    rot180 = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    pool_r = np.stack([np.eye(3, dtype=np.float32), rot180])
    pool_rt = (pool_r, np.stack([np.zeros(3, np.float32),
                                 np.array([6.0, -4.0, 2.0], np.float32)]))
    for obj_id, (v, _, _, _) in multishape_objects().items():
        pts = torch.as_tensor(v)
        (Ra, ta), (Rb, tb) = _poses(rng, 2)
        tb = ta + rng.normal(0, 5, 3).astype(np.float32) if obj_id % 2 \
            else tb
        for fn, jfn in ((metrics.add_metric, jmetrics.add_metric),
                        (metrics.adi_metric, jmetrics.adi_metric)):
            np.testing.assert_allclose(float(fn(pts, Ra, ta, Rb, tb)),
                                       float(jfn(jnp.asarray(v), Ra, ta, Rb,
                                                 tb)), rtol=1e-4)
        for pool, jpool in ((pool_r, jnp.asarray(pool_r)),
                            (pool_rt, tuple(jnp.asarray(p)
                                            for p in pool_rt))):
            np.testing.assert_allclose(
                float(metrics.mssd_metric(pts, pool, Ra, ta, Rb, tb)),
                float(jmetrics.mssd_metric(jnp.asarray(v), jpool, Ra, ta, Rb,
                                           tb)), rtol=1e-4)
            np.testing.assert_allclose(
                float(metrics.mspd_metric(pts, pool, CAM_K, Ra, ta, Rb, tb)),
                float(jmetrics.mspd_metric(jnp.asarray(v), jpool, CAM_K, Ra,
                                           ta, Rb, tb)), rtol=1e-4)
    # the symmetric estimate scores ~0 only with the full transform
    R, t = pose_with_euler()
    v = torch.as_tensor(multishape_objects()[1][0])
    R_est, t_est = R @ rot180, R @ pool_rt[1][1] + t
    assert float(metrics.mssd_metric(v, pool_rt, R_est, t_est, R, t)) < 1e-3
    assert float(metrics.mssd_metric(v, pool_r, R_est, t_est, R, t)) > 5.0


def test_vsd_matches_jax():
    """VSD errors at 240x320 (both poses in one P=2 render) against the
    JAX ``make_vsd``: at GT, offset in depth, rotated, and with a scene
    depth that occludes part of the object."""
    v, f, _, _ = multishape_objects()[1]
    K = np.asarray(CAM_K) / 2.0
    K[2, 2] = 1.0
    taus = np.array([5.0, 20.0, 40.0], np.float32)
    vsd = metrics.make_vsd(v, f, 240, 320, device="cpu")
    jvsd = jmetrics.make_vsd(v, f, 240, 320)
    R, t = pose_with_euler()
    R2, _ = pose_with_euler(yaw=0.5)
    occl = np.zeros((240, 320), np.float32)
    occl[:, :160] = t[2] - 60.0                # a wall in front, left half
    cases = [(R, t, np.zeros((240, 320), np.float32)),
             (R, t + np.array([0, 0, 15.0], np.float32),
              np.zeros((240, 320), np.float32)),
             (R2, t + np.array([4.0, 0, 0], np.float32), occl),
             (R, t + np.array([0, 0, 8.0], np.float32), occl)]
    errs = []
    for R_e, t_e, scene in cases:
        e, ovf = vsd(R_e, t_e, R, t, K, torch.as_tensor(scene), taus)
        je, jovf = jvsd(R_e, t_e, R, t, K, jnp.asarray(scene),
                        jnp.asarray(taus))
        np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-3,
                                   rtol=0)
        assert int(ovf) == int(jovf) == 0
        errs.append(e.numpy())
    assert (errs[0] < 0.02).all() and errs[1][0] > 0.5 > errs[1][1]
    assert 0.02 < errs[2][1] < 0.98


def test_greedy_match_count_matches_jax():
    """bop_toolkit's per-threshold greedy matching: the hand cases of the
    JAX test, then seeded error matrices with ties and infinities."""
    E = np.array([[10.0, 40.0], [5.0, 60.0]])
    for th, n in ((7.0, 1), (15.0, 1), (100.0, 2), (10.0, 1)):
        assert metrics._greedy_match_count(E, th) == n
    rng = np.random.default_rng(2)
    for _ in range(50):
        err = np.round(rng.uniform(0, 10, (rng.integers(1, 5),
                                           rng.integers(1, 5))))
        err[rng.random(err.shape) < 0.2] = np.inf
        for th in (0.5, 3.0, 7.0, 11.0):
            assert metrics._greedy_match_count(err, th) == \
                jmetrics._greedy_match_count(err, th)
    assert metrics._subsample_idx(10, 4).tolist() == \
        jmetrics._subsample_idx(10, 4).tolist() == [0, 3, 6, 9]


def _ar_close(a, b):
    assert set(a) == set(b)
    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd"):
        if k in a:
            assert abs(a[k] - b[k]) <= 1e-3, (k, a, b)
    assert a["per_object"].keys() == b["per_object"].keys()
    for o in a["per_object"]:
        for m, x in a["per_object"][o].items():
            assert abs(x - b["per_object"][o][m]) <= 1e-3


def test_evaluate_bop_matches_jax(cubes, tmp_path):
    """The AR harness on perfect, bad and slightly-off results, then the
    duplicate-instance image where per-threshold re-matching decides the
    answer (AR_mssd 0.5, ``tests/test_metrics.py``)."""
    root, entries = cubes
    ds, jds = BopDataset(root, "cubes", False), JBopDataset(root, "cubes",
                                                           False)
    perfect = [{"scene_id": s, "im_id": i, "obj_id": 1, "score": 1.0,
                "R": R, "t": t} for s, i, R, t in entries]
    bad = [dict(r, R=np.eye(3, dtype=np.float32),
                t=r["t"] + np.array([200, 200, 400], np.float32))
           for r in perfect]
    off = [dict(r, t=r["t"] + np.array([3.0 + 3 * k, -2.0, 9.0],
                                       np.float32))
           for k, r in enumerate(perfect)]
    for res, lo, hi in ((perfect, 0.97, 1.0), (bad, 0.0, 0.2),
                        (off, 0.2, 0.97)):
        got = metrics.evaluate_bop(res, ds, device="cpu")
        _ar_close(got, jmetrics.evaluate_bop(res, jds))
        assert lo <= got["AR"] <= hi, got

    build_cube_dataset(str(tmp_path), n_scenes=1, ims_per_scene=1)
    gt_path = os.path.join(str(tmp_path), "cubes", "test", "000000",
                           "scene_gt.json")
    with open(gt_path) as fh:
        gt = json.load(fh)
    R = np.asarray(gt["0"][0]["cam_R_m2c"], np.float32).reshape(3, 3)
    t1 = np.asarray(gt["0"][0]["cam_t_m2c"], np.float32)
    gt["0"].append({"obj_id": 1, "cam_R_m2c": R.reshape(-1).tolist(),
                    "cam_t_m2c": (t1 + [200.0, 0, 0]).tolist()})
    with open(gt_path, "w") as fh:
        json.dump(gt, fh)
    results = [{"scene_id": 0, "im_id": 0, "obj_id": 1, "score": 0.9,
                "R": R, "t": t1 + np.array([10.0, 0, 0], np.float32)},
               {"scene_id": 0, "im_id": 0, "obj_id": 1, "score": 0.8,
                "R": R, "t": t1 + np.array([5.0, 0, 0], np.float32)}]
    kw = dict(target_list=[(0, 0, [1], [2])], metrics=("mssd",))
    got = metrics.evaluate_bop(results, BopDataset(str(tmp_path), "cubes",
                                                   False), device="cpu",
                               **kw)
    _ar_close(got, jmetrics.evaluate_bop(
        results, JBopDataset(str(tmp_path), "cubes", False), **kw))
    assert abs(got["AR_mssd"] - 0.5) < 1e-6


def test_add_recall_matches_jax(cubes):
    root, entries = cubes
    ds, jds = BopDataset(root, "cubes", False), JBopDataset(root, "cubes",
                                                           False)
    perfect = [{"scene_id": s, "im_id": i, "obj_id": 1, "score": 1.0,
                "R": R, "t": t} for s, i, R, t in entries]
    near = [dict(r, t=r["t"] + np.array([0, 0, 12.0 * k + 2], np.float32))
            for k, r in enumerate(perfect)]
    for res, want in ((perfect, 1.0), (near, 0.5)):
        for th in (0.05, 0.1):
            got = metrics.add_recall(res, ds, th_frac=th, device="cpu")
            assert got == jmetrics.add_recall(res, jds, th_frac=th)
        assert metrics.add_recall(res, ds, device="cpu") == want
