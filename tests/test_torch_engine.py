"""pix2pose_torch engine stages against the JAX engine's computation, stage
by stage, each fed the JAX stage before it (oracle generator on analytic
cube scenes, two images x two detections).

Tolerances: boxes, masks, counts and validity exact; resampled crops at
1e-5 absolute on >= 99.9% of elements (a mask sample within rounding of
the 0.9 threshold may flip a pixel); coordinates at 1e-4 mm."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.config import EstimatorConfig
from pix2pose_tpu.inference import engine as jengine
from pix2pose_tpu.ops import boxes as jboxes
from pix2pose_tpu.ops import crop as jcrop
from pix2pose_tpu.ops.color import color01_to_xyz
from pix2pose_torch.inference.engine import Pix2PoseEstimator, Stage1
from pix2pose_torch.ops.boxes import CropBox
from pix2pose_torch.utils import synthetic as tsyn
from synthetic import CAM_K, OracleGenerator, pose_with_euler, xyz_scene

torch.set_num_threads(1)
CFG = EstimatorConfig(outlier_th=(0.1, 0.2, 0.3), inlier_th=0.1)
OBJ_PARAM = np.array([40, 40, 40, 0, 0, 0], np.float32)
T = lambda x: torch.as_tensor(np.array(x))          # noqa: E731
TB = lambda b: CropBox(*(T(f) for f in b))          # noqa: E731


def _jax_stage1(model, params, rgb, bboxes):
    """The JAX engine's stage 1 (``engine.py:305-350``) for one image."""
    size = CFG.im_size
    im_h, im_w = rgb.shape[:2]
    rgb_n = (jnp.asarray(rgb, jnp.float32) - 128.0) / 128.0
    box1 = jax.vmap(lambda b: jboxes.get_boxes(b, im_h, im_w,
                                               CFG.box_size))(bboxes)
    dec1, prob1 = model.apply(params, jcrop.crop_resize_batch(rgb_n, box1,
                                                              size, True))
    fg1 = jnp.linalg.norm(dec1, axis=-1) > CFG.gray_norm_th
    fg_bbox = jax.vmap(jboxes.bbox_from_mask)(fg1)
    h1, w1 = (box1.height.astype(jnp.float32),
              box1.width.astype(jnp.float32))
    canvas = fg_bbox.astype(jnp.float32) * jnp.stack([h1, w1, h1, w1],
                                                     1) / size
    gi = jnp.arange(size, dtype=jnp.float32)
    fg_f = fg1.astype(jnp.float32)
    fg_n = jnp.maximum(fg_f.sum((1, 2)), 1.0)
    mean_v = (fg_f * gi[None, :, None]).sum((1, 2)) / fg_n
    mean_u = (fg_f * gi[None, None, :]).sum((1, 2)) / fg_n
    cx = (bboxes[:, 1] + bboxes[:, 3]).astype(jnp.float32) / 2.0
    cy = (bboxes[:, 0] + bboxes[:, 2]).astype(jnp.float32) / 2.0
    ct = jnp.stack([jnp.floor(mean_v - (size - 1) / 2.0 + cy),
                    jnp.floor(mean_u - (size - 1) / 2.0 + cx)], 1)
    box2 = jax.vmap(lambda b, c, m: jboxes.get_boxes(
        b, im_h, im_w, CFG.box_size, ct=c, max_w=m))(
        canvas, ct, (box1.v2_ori - box1.v1_ori).astype(jnp.float32))
    return rgb_n, box1, prob1[..., 0], fg1, fg1.sum((1, 2)), box2


@pytest.fixture(scope="module")
def scene():
    model = OracleGenerator()
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3)))
    det = tsyn.PerFrameDetector(n_det=2)
    rgbs, bbs = [], []
    for i in range(2):
        R, t = pose_with_euler(yaw=0.3 + 0.5 * i, tx=20.0 * i - 10.0)
        rgb, _, _ = xyz_scene(R, t)
        rgbs.append(rgb)
        bbs.append(np.stack([d.bbox for d in det.detect(rgb)]))
    rgbs, bbs = np.stack(rgbs), np.stack(bbs)
    stage1 = jax.jit(lambda p, r, b: _jax_stage1(model, p, r, b))
    s1 = [stage1(params, r, b) for r, b in zip(rgbs, bbs)]
    stack = lambda i: jax.tree_util.tree_map(           # noqa: E731
        lambda *x: np.stack([np.asarray(a) for a in x]), *[s[i] for s in s1])
    jax_s1 = [stack(i) for i in range(6)]
    est = Pix2PoseEstimator(tsyn.OracleGenerator(), CFG, device="cpu")
    return model, params, est, rgbs, bbs, jax_s1


def test_stage1_matches_jax(scene):
    _, _, est, rgbs, bbs, (_, box1, prob1, fg1, n_init, box2) = scene
    rgb_n = (T(rgbs).float() - 128.0) / 128.0
    got = est.stage1(None, rgb_n, T(bbs))
    for name, r, g in zip(CropBox._fields, box1, got.box1):
        np.testing.assert_array_equal(g.numpy(), r, name)
    np.testing.assert_allclose(got.prob1.numpy(), prob1, atol=1e-6)
    np.testing.assert_array_equal(got.fg1.numpy(), fg1)
    np.testing.assert_array_equal(got.n_init.numpy(), n_init)
    for name, r, g in zip(CropBox._fields, box2, got.box2):
        np.testing.assert_array_equal(g.numpy(), r, name)


def _jax_stage2_inputs(rgb_n, box1, prob1, fg1, box2):
    th = jnp.asarray(CFG.outlier_th, jnp.float32)
    crops2 = jcrop.crop_resize_batch(rgb_n, box2, CFG.im_size, True)
    fg_th = fg1[:, None] & (prob1[:, None] < th[None, :, None, None])
    mask2 = jax.vmap(lambda m, b1, b2: jengine._stage2_mask_on_grid(
        m.astype(jnp.float32), b1, b2, CFG.im_size))(fg_th, box1, box2)
    return (crops2[:, None] * mask2[..., None],
            fg_th.sum((2, 3)) >= CFG.min_stage1_px)


def test_stage2_inputs_and_correspondences_match_jax(scene):
    model, params, est, rgbs, bbs, jax_s1 = scene
    rgb_n, box1, prob1, fg1, n_init, box2 = jax_s1
    ref = [jax.jit(_jax_stage2_inputs)(
        *(jax.tree_util.tree_map(lambda x: x[b], a)
          for a in (rgb_n, box1, prob1, fg1, box2))) for b in range(2)]
    ref_in = np.stack([np.asarray(r[0]) for r in ref])
    ref_ok = np.stack([np.asarray(r[1]) for r in ref])
    s1 = Stage1(TB(box1), T(prob1), T(fg1), T(n_init), TB(box2))
    th = torch.tensor(CFG.outlier_th)
    got_in, got_ok = est.stage2_inputs(T(rgb_n), s1, th)
    assert (np.abs(got_in.numpy() - ref_in) <= 1e-5).mean() >= 0.999
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)

    # correspondences, fed the JAX stage-2 network outputs
    b, n, n_th, s = 2, 2, 3, CFG.im_size
    dec2, prob2 = model.apply(params, jnp.asarray(ref_in.reshape(-1, s, s,
                                                                 3)))
    dec2 = np.asarray(dec2).reshape(b, n, n_th, s, s, 3)
    prob2 = np.asarray(prob2).reshape(b, n, n_th, s, s)
    corr = est.correspondences(T(dec2), T(prob2), TB(box2), T(OBJ_PARAM),
                               T(ref_ok))
    st, gs = est.pnp_stride, s // est.pnp_stride
    fg2 = np.linalg.norm(dec2, axis=-1) > CFG.gray_norm_th
    xyz01 = np.clip((np.where(fg2[..., None], dec2, 0.0) + 1) * 0.5, 0, 1)
    vv, uu, in_img = jax.jit(jax.vmap(jax.vmap(
        lambda bx: jcrop.crop_pixel_centers(bx, s))))(box2)
    sub = lambda a: np.asarray(a)[..., ::st, ::st]  # noqa: E731
    ref_obj = np.asarray(color01_to_xyz(xyz01[..., ::st, ::st, :],
                                        OBJ_PARAM[:3], OBJ_PARAM[3:]))
    ref_val = sub(fg2) & (sub(prob2) < CFG.inlier_th) & sub(in_img)[:, :,
                                                                    None]
    ref_img = np.broadcast_to(np.stack([sub(uu), sub(vv)], -1)[:, :, None],
                              (b, n, n_th, gs, gs, 2))
    np.testing.assert_allclose(corr.obj.numpy(),
                               ref_obj.reshape(-1, gs * gs, 3), atol=1e-4)
    np.testing.assert_array_equal(corr.img.numpy(),
                                  ref_img.reshape(-1, gs * gs, 2))
    np.testing.assert_array_equal(corr.valid.numpy(),
                                  ref_val.reshape(-1, gs * gs))
    np.testing.assert_array_equal(corr.cand_ok.numpy(),
                                  ref_ok & (fg2.sum((-2, -1))
                                            >= CFG.min_stage1_px))
    assert corr.valid.any()


def test_select_matches_jax(scene):
    """Candidate selection against the JAX engine's selection rule
    (recomputed here in numpy) on the same PnP results."""
    model, params, est, rgbs, bbs, jax_s1 = scene
    rgb_n, box1, prob1, fg1, n_init, box2 = jax_s1
    s1 = Stage1(TB(box1), T(prob1), T(fg1), T(n_init), TB(box2))
    th = torch.tensor(CFG.outlier_th)
    stage2_in, cand_ok = est.stage2_inputs(T(rgb_n), s1, th)
    s = CFG.im_size
    dec2, prob2 = est.model(stage2_in.reshape(-1, s, s, 3))
    corr = est.correspondences(dec2.reshape(2, 2, 3, s, s, 3),
                               prob2.reshape(2, 2, 3, s, s), s1.box2,
                               T(OBJ_PARAM), cand_ok)
    res = est.solve(corr, T(np.stack([CAM_K] * 2)),
                    torch.Generator().manual_seed(1))
    cam_ks = T(np.stack([CAM_K] * 2))
    det_valid = torch.tensor([[True, True], [True, False]])
    got = est.select(s1, corr, res, cam_ks, det_valid)

    # the JAX engine's selection (``engine.py:441-463``) per image
    for bi in range(2):
        sub = lambda a: np.asarray(a)[..., ::4, ::4]  # noqa: E731
        vv, uu, _ = jax.vmap(lambda bx: jcrop.crop_pixel_centers(bx, s))(
            jax.tree_util.tree_map(lambda x: x[bi], box2))
        fg2s = sub(corr.fg2[bi].numpy()).astype(np.float32)
        fg2_n = np.maximum(fg2s.sum((2, 3)), 1.0)
        ct_v = (fg2s * sub(vv)[:, None]).sum((2, 3)) / fg2_n
        ct_u = (fg2s * sub(uu)[:, None]).sum((2, 3)) / fg2_n
        t = res.t[bi].numpy()
        tz = t[..., 2]
        pu = CAM_K[0, 0] * t[..., 0] / np.where(tz == 0, 1e9, tz) + CAM_K[0, 2]
        pv = CAM_K[1, 1] * t[..., 1] / np.where(tz == 0, 1e9, tz) + CAM_K[1, 2]
        dist = ((pv - ct_v) ** 2 + (pu - ct_u) ** 2) / (
            res.n_inliers[bi].numpy().astype(np.float32) + 1e-6)
        usable = corr.cand_ok[bi].numpy() & res.ok[bi].numpy()
        dist = np.where(usable, dist, np.inf)
        best = np.argmin(dist, axis=1)
        ok = usable.any(1) & det_valid[bi].numpy()
        np.testing.assert_array_equal(got.valid[bi].numpy(), ok)
        for j in range(2):
            if ok[j]:
                np.testing.assert_array_equal(got.R[bi, j].numpy(),
                                              res.R[bi, j, best[j]].numpy())
                np.testing.assert_array_equal(got.n_inliers[bi, j].numpy(),
                                              res.n_inliers[bi, j, best[j]])
    assert got.valid[0].all() and not got.valid[1, 1]


def test_single_image_call_matches_batched(scene):
    _, _, est, rgbs, bbs, _ = scene
    params = {"dummy": torch.zeros(1)}
    one = est(params, rgbs[0], bbs[0], np.ones(2, bool), CAM_K, OBJ_PARAM,
              torch.Generator().manual_seed(3))
    many = est.estimate_objects_images(
        {"dummy": torch.zeros(1, 1)}, rgbs[:1], bbs[:1, None],
        np.ones((1, 1, 2), bool), CAM_K[None], OBJ_PARAM[None],
        torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(one.t.numpy(), many.t[0, 0].numpy())
    assert one.valid.all() and one.box2.v1.shape == (2,)
