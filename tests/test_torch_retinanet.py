"""pix2pose_torch RetinaNet head against the JAX package on the CPU: the
anchors, the anchor assignment, the forward and the loss from the same
flax variables, the decode with its class-aware NMS, and the detector
adapter.

Tolerances: anchors, assignment (classes, positives, ignores) and the
NMS's kept slots exact; regression targets and decoded boxes within
1e-5; forward outputs and losses within 1e-5 (float32 convolutions
summed in different orders).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.inference.jax_detector import \
    RetinaNetAdapter as JaxRetinaNetAdapter
from pix2pose_tpu.models import retinanet as jret
from pix2pose_tpu.training import detector_data as jdd
from pix2pose_torch.inference.torch_detector import RetinaNetAdapter
from pix2pose_torch.models import retinanet as tret
from pix2pose_torch.training.detector_train import init_detector
from pix2pose_torch.utils.convert import flax_to_state_dict
from test_torch_detector_data import _St, _blob_patches
from test_torch_gan import seeded_variables

torch.set_num_threads(2)

TINY = dict(num_classes=2, trunk="tiny", head_dim=16)


def test_anchor_boxes_match_jax():
    for size, kw in ((128, {}), (512, {}), (96, {"base": 3.0}),
                     (64, {"strides": (8,)})):
        got = tret.anchor_boxes(size, **kw)
        np.testing.assert_array_equal(got, jret.anchor_boxes(size, **kw))
    # the order contract: position-major, the 9 shapes fastest
    a = tret.anchor_boxes(64, strides=(8,)).reshape(8, 8, 9, 4)
    cv = (a[..., 0] + a[..., 2]) / 2
    cu = (a[..., 1] + a[..., 3]) / 2
    assert np.allclose(cv, cv[..., :1]) and np.allclose(cu, cu[..., :1])
    np.testing.assert_allclose(cv[:, 0, 0], (np.arange(8) + 0.5) * 8)
    np.testing.assert_allclose(cu[0, :, 0], (np.arange(8) + 0.5) * 8)


def _gt_cases():
    """(B, K) GT sets: a GT under every anchor, two identical GTs sharing
    a best anchor with an invalid one, a GT equal to anchor 100, and two
    composed scenes' boxes (distractor slots invalid)."""
    anchors = tret.anchor_boxes(128)
    box = [60.0, 60.0, 70.0, 70.0]
    sets = [([box, [0.0] * 4, [0.0] * 4], [3, -1, -1],
             [True, False, False]),
            ([box, box, [0.0] * 4], [3, 4, -1], [True, True, False]),
            ([list(anchors[100]), [0.0] * 4, [5.0, 5.0, 40.0, 90.0]],
             [2, -1, 1], [True, False, True])]
    rng = np.random.RandomState(3)
    objs = {1: _St(*_blob_patches(rng, 2, (250, 90, 60))),
            2: _St(*_blob_patches(rng, 2, (60, 230, 120)))}
    distr = _St(*_blob_patches(rng, 1, (150, 150, 150)))
    store = jdd.DetectorStore.from_patch_stores(
        objs, np.full((1, 256, 256, 3), 40, np.uint8), distractors=[distr])
    b = jdd.make_detector_batch(store, jax.random.PRNGKey(1), 2, 128, 3,
                                warp_dtype=None)
    for i in range(2):
        sets.append((np.asarray(b["gt_bbox"][i]), np.asarray(b["gt_cls"][i]),
                     np.asarray(b["gt_valid"][i])))
    return (np.stack([np.asarray(s[0], np.float32) for s in sets]),
            np.stack([np.asarray(s[1], np.int32) for s in sets]),
            np.stack([np.asarray(s[2], bool) for s in sets]))


def test_assign_anchors_matches_jax():
    anchors = tret.anchor_boxes(128)
    gb, gc, gv = _gt_cases()
    got = tret.assign_anchors(torch.from_numpy(anchors), torch.from_numpy(gb),
                              torch.from_numpy(gc), torch.from_numpy(gv))
    want = jax.vmap(jret.assign_anchors, in_axes=(None, 0, 0, 0))(
        jnp.asarray(anchors), gb, gc, gv)
    cls_t, box_t, pos, ignore = (t.numpy() for t in got)
    np.testing.assert_array_equal(cls_t, np.asarray(want[0]))
    np.testing.assert_array_equal(pos, np.asarray(want[2]))
    np.testing.assert_array_equal(ignore, np.asarray(want[3]))
    np.testing.assert_allclose(box_t, np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
    # the forced cases: the small GT's best anchor is its only positive;
    # the collision goes to the lower GT index; the invalid GT leaves
    # anchor 0 alone
    best = int(np.argmax(np.asarray(jret.iou_matrix(
        jnp.asarray(anchors), jnp.asarray(gb[0, :1])))[:, 0]))
    assert pos[0].sum() == 1 and pos[0, best] and cls_t[0, best] == 3
    assert pos[1, best] and cls_t[1, best] == 3 and not pos[1, 0]
    assert pos[2, 100] and cls_t[2, 100] == 2
    assert pos[3:].any()


def test_forward_init_and_loss_match_flax():
    x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(
        np.float32)
    fmodel = jret.RetinaNetDetector(**TINY)
    v = seeded_variables(fmodel, x, 4)
    model = tret.RetinaNetDetector(**TINY)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    want = jax.jit(fmodel.apply)(v, x)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    # flax's init: the classifier's bias at -log(99), others zero
    init = init_detector(tret.RetinaNetDetector(**TINY), 0)
    jinit = jax.jit(fmodel.init)(jax.random.PRNGKey(0),
                                 x[:1, :32, :32])["params"]
    for name in ("cls_out", "box_out", "down4", "smooth0"):
        np.testing.assert_allclose(
            getattr(init, name).bias.detach().numpy(),
            np.asarray(jinit[name]["bias"]), rtol=1e-6, err_msg=name)
    assert float(init.cls_out.bias.detach()[0]) == pytest.approx(
        -math.log(99))

    anchors = tret.anchor_boxes(128)
    gb, gc, gv = (a[3:] for a in _gt_cases())
    total, parts = tret.retinanet_loss(
        got, torch.from_numpy(anchors), torch.from_numpy(gb),
        torch.from_numpy(gc), torch.from_numpy(gv), 2)
    jtotal, jparts = jret.retinanet_loss(want, jnp.asarray(anchors), gb, gc,
                                         gv, 2)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    for k in ("cls", "box"):
        assert float(parts[k]) == pytest.approx(float(jparts[k]),
                                                rel=1e-5), k


def test_decode_and_nms_match_jax():
    """Random logits and deltas, plus overlapping anchors of one class
    (suppressed), of another class (kept) and an exact score tie."""
    anchors = tret.anchor_boxes(128)
    a_total, c = anchors.shape[0], 3
    rng = np.random.default_rng(5)
    logits = rng.normal(-4.0, 1.5, (2, a_total, c)).astype(np.float32)
    deltas = rng.normal(0, 0.5, (2, a_total, 4)).astype(np.float32)
    cand = np.array(jret.iou_matrix(jnp.asarray(anchors[500:501]),
                                    jnp.asarray(anchors)))[0]
    cand[500] = 0
    i1 = int(np.argmax(cand))
    logits[0, 500, 1], logits[0, i1, 1], logits[0, i1, 2] = 6.0, 5.0, 4.0
    deltas[0, [500, i1]] = 0.0
    logits[1, 10, 0] = logits[1, 20, 0] = 3.0       # a tie
    got = tret.decode_retinanet(
        tret.RetinaOut(torch.from_numpy(logits), torch.from_numpy(deltas)),
        torch.from_numpy(anchors), top_k=16)
    want = jret.decode_retinanet(jret.RetinaOut(logits, deltas),
                                 jnp.asarray(anchors), top_k=16)
    boxes, score, cls = (t.numpy() for t in got)
    np.testing.assert_array_equal(cls, np.asarray(want[2]))
    np.testing.assert_array_equal(score > 0, np.asarray(want[1]) > 0)
    np.testing.assert_allclose(score, np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_allclose(boxes, np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    # the crafted slots (random logits stay under 0.95): anchor 500's
    # class 1 kept, i1's class 1 suppressed, i1's class 2 kept
    assert sorted(cls[0][score[0] > 0.97].tolist()) == [1, 2]
    assert (score[0] == 0).any()


def test_adapter_matches_jax():
    """One 480x640 frame through both adapters (tiny trunk, 128 px input,
    seeded weights): the same detections, box-shaped masks."""
    fmodel = jret.RetinaNetDetector(**TINY)
    v = seeded_variables(fmodel, np.zeros((1, 128, 128, 3), np.float32), 6)
    yy, xx = np.mgrid[0:480, 0:640]
    rgb = np.stack([xx * 255 // 640, yy * 255 // 480,
                    (xx + yy) % 255], -1).astype(np.uint8)
    want = JaxRetinaNetAdapter(fmodel, v, [5, 9], score_th=0.3,
                               input_size=128).detect(0, 0, rgb)
    got = RetinaNetAdapter(tret.RetinaNetDetector(**TINY),
                           flax_to_state_dict(v), [5, 9], score_th=0.3,
                           input_size=128, device="cpu").detect(0, 0, rgb)
    assert len(want) > 3 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.bbox, w.bbox)
        assert g.obj_id == w.obj_id
        assert g.score == pytest.approx(w.score, rel=1e-5)
        np.testing.assert_array_equal(g.mask, w.mask)
        assert g.mask.sum() == ((g.bbox[2] - g.bbox[0] + 1)
                                * (g.bbox[3] - g.bbox[1] + 1))
