"""pix2pose_torch detector scene synthesis against the JAX package on the
CPU. threefry bits cannot be reproduced in torch, so the JAX draws of a
batch are derived from its key by the same splits as
``make_detector_batch`` and ``_place_one`` make (:func:`jax_draws`) and
injected into the port. JAX runs with ``warp_dtype=None`` (float32).

Tolerances: at axis-aligned placements (angle 0) JAX's two-pass warp is
the gather's bilinear, so the image and every target hold within 1e-6
(integer targets exact). At other angles the two-pass footprint differs
from the gather's, so the images hold at ``tests/test_affine.py``'s
two-pass bounds (mean < 2e-3 over the frame, max < 0.3 away from the
placements' mask edges, where a mask-threshold flip swaps object and
background at single pixels), each placement's mask and visible mask
at the frame's resolution by IoU > 0.99, and ``gt_valid``, ``gt_cls``
and ``reg_mask`` equal for every instance.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.training import detector_data as jdd
from pix2pose_torch.training import detector_data as tdd

torch.set_num_threads(2)


def _blob_patches(rng, n, tint):
    """(n, 128, 128, 3) uint8 smooth-shaded ellipses, masks, extents."""
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32)
    rgbs, masks, extents = [], [], []
    for _ in range(n):
        rv, ru = rng.randint(20, 50, 2)
        m = ((yy - 64) / rv) ** 2 + ((xx - 64) / ru) ** 2 < 1
        shade = 0.6 + 0.4 * (yy + xx) / 256.0
        rgb = np.zeros((128, 128, 3), np.uint8)
        rgb[m] = (np.asarray(tint)[None] * shade[m][:, None]).astype(
            np.uint8)
        rgbs.append(rgb)
        masks.append(m)
        extents.append(float(2 * max(rv, ru)))
    return np.stack(rgbs), np.stack(masks), np.array(extents, np.float32)


class _St:
    def __init__(self, rgb, mask, extent):
        self.rgb, self.mask, self.extent = rgb, mask, extent


@pytest.fixture(scope="module")
def stores():
    """Two classes and one distractor set (label -1), smooth backgrounds;
    the same arrays in both packages' ``DetectorStore``."""
    rng = np.random.RandomState(0)
    objs = {3: _St(*_blob_patches(rng, 3, (250, 90, 60))),
            7: _St(*_blob_patches(rng, 3, (60, 230, 120)))}
    distr = _St(*_blob_patches(rng, 2, (150, 150, 150)))
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    backs = np.stack([np.stack([xx * 200, yy * 160, (xx + yy) * 60 + 20],
                               -1) * (0.6 + 0.2 * i)
                      for i in range(2)]).astype(np.uint8)
    jst = jdd.DetectorStore.from_patch_stores(
        {o: _St(*(jnp.asarray(a) for a in (s.rgb, s.mask, s.extent)))
         for o, s in objs.items()}, jnp.asarray(backs),
        distractors=[_St(*(jnp.asarray(a) for a in
                           (distr.rgb, distr.mask, distr.extent)))])
    tst = tdd.DetectorStore.from_patch_stores(
        {o: _St(*(torch.from_numpy(a) for a in (s.rgb, s.mask, s.extent)))
         for o, s in objs.items()}, torch.from_numpy(backs),
        distractors=[_St(*(torch.from_numpy(a) for a in
                           (distr.rgb, distr.mask, distr.extent)))])
    return jst, tst


def jax_draws(key, store, bsz, im_size, k_obj, scale_range=(0.6, 1.6),
              angle=None):
    """The random numbers of the JAX ``make_detector_batch(store, key,
    ...)``, by its own splits, in the layout of the port's
    ``draw_detector_batch``; ``angle`` fixes every placement's angle."""
    per = []
    for kscene in jax.random.split(key, bsz):
        ks = jax.random.split(kscene, 5)
        pidx = jax.random.randint(ks[0], (k_obj,), 0, store.rgb.shape[0])
        rows = []
        for kk, i in zip(jax.random.split(ks[2], k_obj), np.asarray(pidx)):
            k4 = jax.random.split(kk, 4)
            scale = jax.random.uniform(k4[0], minval=scale_range[0],
                                       maxval=scale_range[1])
            ang = (jnp.float32(angle) if angle is not None else
                   jax.random.uniform(k4[1], minval=-np.pi, maxval=np.pi))
            margin = store.extent[i] * scale * 0.5 + 4.0
            rows.append([scale, ang] + [
                jax.random.uniform(k4[j], minval=margin,
                                   maxval=im_size - margin) for j in (2, 3)])
        rows = np.asarray(rows, np.float32)
        per.append({
            "pidx": pidx,
            "bidx": jax.random.randint(ks[1], (), 0, store.backs.shape[0]),
            "scale": rows[:, 0], "angle": rows[:, 1], "cv": rows[:, 2],
            "cu": rows[:, 3],
            "flat_val": jax.random.uniform(ks[3], (3,), minval=0.25,
                                           maxval=0.75),
            "flat": jax.random.bernoulli(ks[4], 0.2)})
    out = {k: torch.from_numpy(np.stack([np.asarray(p[k]) for p in per]))
           for k in per[0]}
    out["pidx"], out["bidx"] = out["pidx"].long(), out["bidx"].long()
    return out


def _jax_batch(store, key, bsz, im_size, k_obj, angle=None,
               monkeypatch=None):
    """JAX's batch at ``warp_dtype=None`` from a fresh trace; ``angle``
    fixes every placement's angle (its uniform draw is replaced)."""
    if angle is not None:
        uniform = jax.random.uniform

        def fixed(key, shape=(), dtype=jnp.float32, minval=0.0,
                  maxval=1.0):
            if isinstance(minval, float) and minval == -np.pi:
                return jnp.full(shape, angle, jnp.float32)
            return uniform(key, shape, dtype, minval, maxval)

        monkeypatch.setattr(jax.random, "uniform", fixed)
    fn = jax.jit(functools.partial(
        jdd.make_detector_batch.__wrapped__, batch_size=bsz,
        im_size=im_size, k_obj=k_obj, warp_dtype=None))
    return {k: np.asarray(v) for k, v in fn(store, key).items()}


def _check_exact(got, want):
    for name in ("image", "heat", "wh", "off", "seg", "gt_bbox", "gt_mask",
                 "gt_center"):
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    for name in ("reg_mask", "gt_cls", "gt_valid"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], name)


@pytest.mark.parametrize("im_size,bsz", [(128, 2), (320, 1)])
def test_axis_aligned_batch_matches_jax(stores, monkeypatch, im_size, bsz):
    """Padded window (S < 296) and direct clamped window (S >= 296)."""
    js, ts = stores
    key = jax.random.PRNGKey(4 + im_size)
    k_obj = 3
    want = _jax_batch(js, key, bsz, im_size, k_obj, angle=0.0,
                      monkeypatch=monkeypatch)
    d = jax_draws(key, js, bsz, im_size, k_obj, angle=0.0)
    got = tdd.make_detector_batch(ts, None, bsz, im_size, k_obj, draws=d)
    _check_exact(got, want)
    assert got["gt_valid"].any() and got["reg_mask"].sum() >= 1


def _visible(masks):
    """(K, S, S) placement masks -> visible masks (slot k occluded by the
    slots after it), bool."""
    occ = np.zeros(masks.shape[1:], bool)
    out = np.zeros(masks.shape, bool)
    for k in range(masks.shape[0] - 1, -1, -1):
        out[k] = (masks[k] > 0) & ~occ
        occ |= masks[k] > 0
    return out


def _iou(a, b):
    union = np.sum(a | b)
    return np.sum(a & b) / union if union else 1.0


def test_rotated_batch_within_two_pass_bounds(stores):
    """Each placement's mask and visible mask at the frame's resolution by
    IoU > 0.99 (every placement; measured worst 0.9959 here), and each
    batch's ``gt_mask`` the stride-grid sample of its own visible masks.
    (On the 32 x 32 grid one cell of a 38-cell mask flips, IoU 0.974:
    the grid samples the frame, so the frame is where they are held.)"""
    js, ts = stores
    im_size, bsz, k_obj = 128, 2, 3
    key = jax.random.PRNGKey(21)
    want = _jax_batch(js, key, bsz, im_size, k_obj)
    d = jax_draws(key, js, bsz, im_size, k_obj)
    assert (d["angle"].abs() > 0.1).all()
    got = tdd.make_detector_batch(ts, None, bsz, im_size, k_obj, draws=d)
    _, masks = tdd._place(ts, d, im_size)
    for b, kscene in enumerate(jax.random.split(key, bsz)):
        ks = jax.random.split(kscene, 5)
        jm = np.stack([np.asarray(jdd._place_one(
            kk, js.rgb[i], js.mask[i], js.extent[i], im_size, (0.6, 1.6),
            None)[1]) for kk, i in zip(jax.random.split(ks[2], k_obj),
                                       d["pidx"][b].numpy())])
        tm = masks[b].numpy()
        vt, vj = _visible(tm), _visible(jm)
        for k in range(k_obj):
            assert _iou(tm[k] > 0, jm[k] > 0) > 0.99, (b, k)
            assert _iou(vt[k], vj[k]) > 0.99, (b, k)
        for vis, batch in ((vt, got), (vj, want)):
            gv = np.asarray(batch["gt_valid"][b])
            np.testing.assert_array_equal(
                np.asarray(batch["gt_mask"][b]),
                vis[:, ::4, ::4] * gv[:, None, None])
    for name in ("gt_valid", "gt_cls"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], name)
    # reg_mask at every valid instance's center cell
    gc = np.round(got["gt_center"].numpy()).astype(int).clip(0, 31)
    for b, k in zip(*np.nonzero(want["gt_valid"])):
        assert got["reg_mask"][b, gc[b, k, 0], gc[b, k, 1]] == 1.0
        assert want["reg_mask"][b, gc[b, k, 0], gc[b, k, 1]] == 1.0
    diff = np.abs(got["image"].numpy() - want["image"])
    assert diff.mean() < 2e-3, diff.mean()
    # away from the placements' mask edges, where a threshold flip swaps
    # object and background at single pixels
    _, masks = tdd._place(ts, d, im_size)
    m = masks.reshape(-1, 1, im_size, im_size)
    edge = (torch.nn.functional.max_pool2d(m, 3, 1, 1)
            + torch.nn.functional.max_pool2d(-m, 3, 1, 1)) > 0
    edge = edge.reshape(bsz, k_obj, im_size, im_size).any(1).numpy()
    assert edge.mean() < 0.1 and diff.max(-1)[~edge].max() < 0.3


def test_distractors_and_pack_roundtrip(stores):
    """Distractors composite but never become targets; a store's own
    generator gives one batch per seed; pack / unpack equal JAX's on the
    same batch (bfloat16 rounding is round-to-nearest-even in both)."""
    js, ts = stores
    g = torch.Generator().manual_seed(3)
    d = tdd.draw_detector_batch(g, ts, 4, 128, 6)
    d["pidx"][:, :2] = ts.rgb.shape[0] - 1    # a distractor in two slots
    b = tdd.make_detector_batch(ts, None, 4, 128, 6, draws=d)
    assert not b["gt_valid"][:, :2].any()
    assert (b["gt_cls"][:, :2] == -1).all()
    assert b["gt_valid"].any()
    again = tdd.make_detector_batch(ts, torch.Generator().manual_seed(3), 4,
                                    128, 6)
    other = tdd.make_detector_batch(ts, torch.Generator().manual_seed(3), 4,
                                    128, 6)
    assert all(torch.equal(again[k], other[k]) for k in again)
    for name, lo, hi in (("scale", 0.6, 1.6), ("angle", -np.pi, np.pi),
                         ("flat_val", 0.25, 0.75)):
        assert float(d[name].min()) >= lo and float(d[name].max()) < hi

    packed = tdd.pack_detector_batch(b)
    assert packed["image"].dtype == torch.uint8
    assert packed["reg_mask"].dtype == torch.bool
    assert all(packed[k].dtype == torch.bfloat16 for k in tdd._PACK_BF16)
    jpacked = jdd.pack_detector_batch(
        {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    for k, v in packed.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jpacked[k], np.float32), k)
    un = tdd.unpack_detector_batch(packed)
    jun = jdd.unpack_detector_batch(jpacked)
    for k, v in un.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jun[k]), k)
    assert torch.equal(tdd.pack_detector_batch(un)["image"],
                       packed["image"])
