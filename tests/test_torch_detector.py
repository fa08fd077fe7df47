"""pix2pose_torch CenterNet/CondInst detector against the JAX package on
the same seeded variables and inputs: the network in its three head
layouts, the decode, and the detector adapter with its input resize.

Tolerances: network outputs within 1e-4 absolute (fp32 convolutions
summed in different orders); decoded boxes, classes and centers exact and
masks equal on hand-made maps; the adapters' boxes exact (int32), scores
within 1e-5 and masks equal on >= 99.9% of pixels; the input resize
within 1e-5 of ``jax.image.resize``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.inference.jax_detector import JaxDetector
from pix2pose_tpu.models import detector as jdet
from pix2pose_torch.inference.torch_detector import (TorchDetector,
                                                     resize_square)
from pix2pose_torch.models import CenterNetDetector
from pix2pose_torch.models import detector as tdet
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          random_flax_variables)
from test_torch_resnet50 import (assert_same_tree, calibrate_batch_stats,
                                 seeded_flax_variables)

torch.set_num_threads(1)

LAYOUTS = {"fused": {}, "unfused": {"fused_heads": False},
           "shared": {"shared_head_dim": 24}}


def _tiny_pair(layout, x, num_classes=3, seed=0):
    kw = dict(num_classes=num_classes, head_dim=16, trunk="tiny",
              **LAYOUTS[layout])
    fmodel = jdet.CenterNetDetector(**kw)
    model = CenterNetDetector(**kw).eval()
    v = calibrate_batch_stats(model, x,
                              seeded_flax_variables(fmodel, x, seed=seed))
    return fmodel, model, v


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tiny_detector_matches_flax(layout):
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    fmodel, model, v = _tiny_pair(layout, x)
    assert_same_tree(random_flax_variables(model, 0), v)
    res = model.load_state_dict(flax_to_state_dict(v), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    ref = fmodel.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for name in jdet.DetectorOut._fields:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)


def test_decode_handmade_peaks_with_ties():
    """Peaks of equal score (ties across pixels and classes, and the
    flat background, which survives NMS as equal peaks) come out in
    ``jax.lax.top_k``'s order."""
    h = w = 24
    c = 2
    rng = np.random.default_rng(11)
    heat = np.full((1, h, w, c), -8.0, np.float32)
    for (v, u, k, s) in ((3, 4, 0, 5.0), (3, 18, 1, 5.0), (12, 8, 0, 5.0),
                         (12, 8, 1, 5.0), (20, 20, 1, 7.0),
                         (7, 14, 0, 2.0)):
        heat[0, v, u, k] = s
    wh = rng.uniform(1, 6, (1, h, w, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (1, h, w, 2)).astype(np.float32)
    ctrl = rng.normal(0, 0.5, (1, h, w, tdet.N_CTRL)).astype(np.float32)
    mfeat = rng.normal(0, 1, (1, h, w, tdet.MASK_DIM)).astype(np.float32)
    seg = np.zeros((1, h, w, c), np.float32)
    arrays = dict(heat=heat, wh=wh, off=off, seg=seg, ctrl=ctrl,
                  mfeat=mfeat)
    ref = jdet.decode_detections(
        jdet.DetectorOut(**{k: jnp.asarray(a) for k, a in arrays.items()}),
        top_k=12)
    got = tdet.decode_detections(
        tdet.DetectorOut(**{k: torch.from_numpy(a)
                            for k, a in arrays.items()}), top_k=12)
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.cls.numpy(), np.asarray(ref.cls))
    np.testing.assert_array_equal(got.bbox.numpy(), np.asarray(ref.bbox))
    np.testing.assert_array_equal(got.center.numpy(), np.asarray(ref.center))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    # the ties and six background peaks are really in the top 12
    scores = np.asarray(ref.score[0])
    assert np.sum(scores == scores[1]) == 4
    assert np.sum(scores == scores[-1]) == 6
    assert got.mask.numpy().any()


def test_torch_detector_matches_jax_detector():
    """The adapter end to end on a 120x160 frame at input_size 64 (32
    detections; their masks are in fact equal on every pixel), after its
    resize on its own: 480x640 -> 512x512 (rows upsampled, columns
    downsampled by 0.8 with jax's default antialiasing)."""
    rng = np.random.default_rng(14)
    rgb = rng.integers(0, 256, (480, 640, 3)).astype(np.uint8)
    ref = jax.image.resize(jnp.asarray(rgb, jnp.float32) / 255.0,
                           (512, 512, 3), method="linear")
    got = resize_square(rgb, 512, "cpu")
    assert got.shape == (512, 512, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    fmodel, model, v = _tiny_pair("fused", x, num_classes=2, seed=13)
    # seeded heads: heat near p = 0.5 so some peaks pass score_th 0.3,
    # sizes ~5 grid cells (20 px at input 64)
    v["params"]["heat_out"]["kernel"] *= 0.1
    v["params"]["heat_out"]["bias"][:] = 0.0
    v["params"]["wh_out"]["kernel"] *= 0.1
    v["params"]["wh_out"]["bias"][:] = 5.0
    rgb = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
    jd = JaxDetector(fmodel, v, class_to_obj_id=[3, 7], input_size=64)
    td = TorchDetector(model, flax_to_state_dict(v), [3, 7], input_size=64,
                       device="cpu")
    ref, got = jd.detect(0, 0, rgb), td.detect(0, 0, rgb)
    assert len(got) == len(ref) >= 1
    n_px = n_same = 0
    for a, b in zip(got, ref):
        assert a.bbox.dtype == b.bbox.dtype == np.int32
        np.testing.assert_array_equal(a.bbox, b.bbox)
        assert a.obj_id == b.obj_id
        assert abs(a.score - b.score) <= 1e-5
        assert a.mask.shape == b.mask.shape == (120, 160)
        n_px += a.mask.size
        n_same += int((a.mask == b.mask).sum())
    assert n_same >= 0.999 * n_px
