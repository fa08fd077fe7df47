"""pix2pose_torch training-batch synthesis against the JAX package on the
CPU. threefry bits cannot be reproduced in torch, so the JAX draws of each
batch are derived from its key by the same splits as ``make_batch`` and
``_one_sample`` make (:func:`jax_draws`) and injected into the port.

Tolerances: ``PatchStore.load`` exact; the gather warp, the augmentation
parts and the pre-warp composite of both stages within 1e-5; the warped
batch against JAX's ``_one_sample`` within 5e-6 at axis-aligned angles.
At other angles the JAX trainer warps with the banded-matmul two-pass
form (``affine_sample_mm``), which the port does not port (a gather is
exact on the GPU), so there the two agree within ``tests/test_affine.py``'s
two-pass bounds (mean < 2e-3, max < 0.3, and the thresholded mask's IoU
> 0.99; the first two hold for smooth content, so the test's backgrounds
are smooth gradients).
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pix2pose_tpu.ops import affine as jaffine
from pix2pose_tpu.training import data as jdata
from pix2pose_torch.ops import affine as taffine
from pix2pose_torch.training import data as tdata

torch.set_num_threads(1)
B = 4


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same patch directory (reference npy crops, one with the
    visibility channel) and backgrounds loaded by both packages."""
    root = tmp_path_factory.mktemp("train_xyz")
    data_dir, back_dir = root / "01", root / "backs"
    os.makedirs(data_dir)
    os.makedirs(back_dir)
    rng = np.random.RandomState(0)
    for i in range(6):
        h, w = rng.randint(60, 128), rng.randint(60, 128)
        arr = np.zeros((h, w, 7 if i == 0 else 6), np.uint8)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = ((yy - h / 2) ** 2 / (h / 2.5) ** 2
                + (xx - w / 2) ** 2 / (w / 2.5) ** 2) < 1
        arr[..., 0][blob] = rng.randint(50, 255)
        arr[..., 1][blob] = 128
        arr[..., 2][blob] = (xx[blob] * 200 // w).astype(np.uint8)
        arr[..., 3][blob] = (xx[blob] * 255 // w).astype(np.uint8) | 1
        arr[..., 4][blob] = (yy[blob] * 255 // h).astype(np.uint8) | 1
        arr[..., 5][blob] = 128
        if i == 0:
            arr[..., 6] = blob & (xx < w * 0.7)
        np.save(data_dir / f"{i:04d}.npy", arr)
    yy, xx = np.mgrid[0:100, 0:140] / 100.0
    for i in range(3):
        img = np.stack([xx * (60 + 40 * i), yy * 120, (xx + yy) * 50 + 30],
                       -1)
        Image.fromarray(img.astype(np.uint8)).save(back_dir / f"b{i}.png")
    with open(back_dir / "notes.txt", "w") as f:    # not an image: skipped
        f.write("x")
    return (jdata.PatchStore.load(str(data_dir), str(back_dir)),
            tdata.PatchStore.load(str(data_dir), str(back_dir),
                                  device="cpu"))


def jax_draws(key, store, bsz, full_rotation=True):
    """The random numbers of the JAX ``make_batch(store, key, ...)``, by
    its own splits, in the layout of the port's ``draw_batch``."""
    rand = jdata._rand
    kidx, kback, kaug = jax.random.split(key, 3)
    d = {"idx": jax.random.randint(kidx, (bsz,), 0, store.n_data),
         "bidx": jax.random.randint(kback, (bsz,), 0,
                                    store.backs.shape[0])}
    per = []
    for k in jax.random.split(kaug, bsz):
        ks = jax.random.split(k, 12)
        kj = jax.random.split(ks[0], 6)

        def rect(kk, lo, hi):
            r = jax.random.split(kk, 4)
            return jnp.stack([rand(r[0], lo=lo, hi=hi),
                              rand(r[1], lo=lo, hi=hi),
                              rand(r[2], lo=-0.5, hi=0.5),
                              rand(r[3], lo=-0.5, hi=0.5)])

        noise = jax.random.normal(kj[4], (128, 128, 3)) * (10 / 255)
        per.append({
            "shift": rand(kj[0], 3, lo=-15 / 255, hi=15 / 255),
            "contrast": rand(kj[1], lo=0.8, hi=1.3),
            "gain": jnp.where(jax.random.bernoulli(kj[2]),
                              rand(kj[2], 3, lo=0.8, hi=1.2),
                              rand(kj[2], lo=0.8, hi=1.2) * jnp.ones(3)),
            "alpha": rand(kj[3], lo=0.0, hi=0.7),
            "noise": jnp.where(jax.random.bernoulli(kj[5], 0.1), noise,
                               jnp.zeros_like(noise)),
            "off": jax.random.randint(ks[1], (2,), 0,
                                      jdata.BACK - jdata.WORK),
            "occ": rect(ks[2], 0.2, 0.7), "miss": rect(ks[3], 0.0, 0.5),
            "wrong": rect(ks[4], 0.0, 0.5),
            "scale": rand(ks[5], lo=-0.3, hi=0.3),
            "jitter": jax.random.uniform(ks[6], (2,), minval=-5.0,
                                         maxval=5.0),
            "angle": (rand(ks[7], lo=-180.0, hi=180.0) if full_rotation
                      else rand(ks[7], lo=-15.0, hi=15.0))})
    for name in per[0]:
        d[name] = jnp.stack([p[name] for p in per])
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def jax_composite(key, store, i, b, stage2):
    """``_one_sample``'s lines up to the warp, with its helpers: the
    pre-warp (comp, ws_xyz, ws_mask) of one sample."""
    ks = jax.random.split(key, 12)
    W, P = jdata.WORK, jdata.PATCH
    rgb = jdata._color_jitter(ks[0], store.rgb[i].astype(jnp.float32) / 255)
    xyz = store.xyz[i].astype(jnp.float32) / 255.0
    mask, extent = store.mask[i], store.extent[i]
    off = jax.random.randint(ks[1], (2,), 0, jdata.BACK - W)
    back = jax.lax.dynamic_slice(store.backs[b], (off[0], off[1], 0),
                                 (W, W, 3)).astype(jnp.float32) / 255.0
    pad = (W - P) // 2
    ws_mask = jnp.zeros((W, W)).at[pad:pad + P, pad:pad + P].set(
        mask.astype(jnp.float32))
    ws_rgb = jnp.zeros((W, W, 3)).at[pad:pad + P, pad:pad + P].set(rgb)
    ws_xyz = jnp.full((W, W, 3), 0.5).at[pad:pad + P, pad:pad + P].set(
        jnp.where(mask[..., None], xyz, 0.5))
    in_mask = ws_mask * (1.0 - jdata._rect_mask(ks[2], 0.2, 0.7, extent))
    comp = jnp.where(in_mask[..., None] > 0, ws_rgb, back)
    blur = jdata._blur_ws(in_mask)
    comp = jnp.where(((blur > 0.01) & (blur < 0.99))[..., None],
                     jdata._blur_ws(comp), comp)
    if stage2:
        m = (jdata._blur_ws(in_mask) > 0.05) & (
            jnp.linalg.norm((ws_xyz - 0.5) * 2.0, axis=-1) > 0.3)
        gray = jnp.full_like(comp, 0.5)
        out = jnp.where(m[..., None], comp, gray)
        out = jnp.where(jdata._rect_mask(ks[3], 0.0, 0.5, extent)[..., None],
                        gray, out)
        wrong = jdata._rect_mask(ks[4], 0.0, 0.5, extent) & ~(ws_mask > 0)
        comp = jnp.where(wrong[..., None], comp, out)
    return comp, ws_xyz, ws_mask


def test_patch_store_and_affine_match_jax(stores):
    js, ts = stores
    for name in ("rgb", "xyz", "mask", "extent", "backs"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert ts.n_data == 6 and ts.backs.shape[0] == 3
    assert not ts.mask[0].all() and ts.mask[0].sum() < ts.mask[1].sum() * 2

    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (3, 192, 192, 7)).astype(np.float32)
    center = rng.uniform(80, 110, (3, 2)).astype(np.float32)
    scale = np.array([0.7, 1.0, 1.6], np.float32)
    angle = np.deg2rad([0.0, 37.0, -123.0]).astype(np.float32)
    mats = taffine.make_affine(torch.from_numpy(center), (63.5, 63.5),
                               torch.from_numpy(scale),
                               torch.from_numpy(angle))
    for k in range(3):
        ref = jaffine.make_affine(center[k], jnp.array([63.5, 63.5]),
                                  scale[k], angle[k])
        np.testing.assert_allclose(mats[k].numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-5)
        # the map runs the output past the source's edge: fill counts too
        for fill in (0.0, 0.5):
            got = taffine.affine_sample(torch.from_numpy(img[k:k + 1]),
                                        mats[k:k + 1], 128, 128, fill)[0]
            want = jaffine.affine_sample(img[k], mats[k].numpy(), 128, 128,
                                         fill)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5)
    batched = taffine.affine_sample(torch.from_numpy(img), mats, 128, 128)
    single = torch.cat([taffine.affine_sample(torch.from_numpy(
        img[k:k + 1]), mats[k:k + 1], 128, 128) for k in range(3)])
    assert torch.equal(batched, single)


def test_augment_parts_and_composite_match_jax(stores):
    """color jitter, occlusion rectangles, the box blur, and the pre-warp
    workspace of both stages."""
    js, ts = stores
    key = jax.random.PRNGKey(3)
    d = jax_draws(key, js, B)
    idx, bidx = d["idx"].numpy(), d["bidx"].numpy()
    rgb = ts.rgb[d["idx"]].float() / 255.0
    got = tdata.color_jitter(rgb, d).numpy()
    extent = ts.extent[d["idx"]]
    rects = tdata.rect_mask(d["occ"], extent).numpy()
    _, _, kaug = jax.random.split(key, 3)
    keys = jax.random.split(kaug, B)
    for s in range(B):
        ks = jax.random.split(keys[s], 12)
        want = jdata._color_jitter(ks[0], js.rgb[idx[s]].astype(
            jnp.float32) / 255.0)
        np.testing.assert_allclose(got[s], np.asarray(want), atol=1e-5)
        np.testing.assert_array_equal(rects[s], np.asarray(jdata._rect_mask(
            ks[2], 0.2, 0.7, js.extent[idx[s]])))
    x = np.random.default_rng(2).uniform(0, 1, (2, 192, 192, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tdata.blur_ws(torch.from_numpy(x)).numpy(),
        np.stack([np.asarray(jdata._blur_ws(v)) for v in x]), atol=1e-6)
    np.testing.assert_allclose(
        tdata.blur_ws(torch.from_numpy(x[..., 0])).numpy(),
        np.stack([np.asarray(jdata._blur_ws(v[..., 0])) for v in x]),
        atol=1e-6)

    for stage2 in (True, False):
        comp, ws_xyz, ws_mask = tdata.composite(ts, d, stage2)
        for s in range(B):
            want = jax_composite(keys[s], js, idx[s], bidx[s], stage2)
            for g, w in zip((comp[s], ws_xyz[s], ws_mask[s]), want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5, err_msg=str(stage2))
    # the two stages differ only in the input
    assert not torch.equal(comp, tdata.composite(ts, d, True)[0])


def _jax_batch(store, key, step, full_rotation=True):
    """JAX's batch from a fresh trace (a patched ``_rand`` takes effect)."""
    return jax.jit(functools.partial(jdata._make_batch, batch_size=B,
                                     full_rotation=full_rotation))(
        store, key, step)


def test_batch_axis_aligned_matches_jax_one_sample(stores, monkeypatch):
    """At an axis-aligned rotation JAX's two-pass warp equals a gather, so
    the whole batch (both stages) holds within 5e-6. The angle is 0: the
    only one whose rotation is exact in float32 (cos(pi / 2) rounds to
    -4.4e-8, and at the composite's sharp edges 90 degrees then differ by
    up to 1e-5)."""
    js, ts = stores
    rand = jdata._rand
    angle = 0.0
    for step in (0, 1):
        def fixed_angle(key, *shape, lo=0.0, hi=1.0):
            if lo in (-180.0, -15.0):
                return jnp.full(shape, angle, jnp.float32)
            return rand(key, *shape, lo=lo, hi=hi)

        monkeypatch.setattr(jdata, "_rand", fixed_angle)
        key = jax.random.PRNGKey(5 + step)
        want = _jax_batch(js, key, step)
        d = jax_draws(key, js, B)
        d["angle"] = torch.full((B,), angle)
        got = tdata.make_batch(ts, None, step, B, draws=d)
        for name in ("src", "tgt", "prob_gt"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), atol=5e-6,
                                       err_msg=f"{name} at {angle} deg")


def test_batch_rotated_within_two_pass_bounds(stores):
    js, ts = stores
    for step, full in ((0, True), (1, False)):
        key = jax.random.PRNGKey(11 + step)
        want = _jax_batch(js, key, step, full)
        got = tdata.make_batch(ts, None, step, B,
                               draws=jax_draws(key, js, B, full))
        for name in ("src", "tgt"):
            diff = np.abs(got[name].numpy() - np.asarray(want[name]))
            assert diff.mean() < 2e-3 and diff.max() < 0.3, \
                (name, step, diff.mean(), diff.max())
        # the thresholded mask: test_affine.py's IoU bar
        g, w = got["prob_gt"].numpy() > 0.5, np.asarray(want["prob_gt"]) > 0.5
        assert np.sum(g & w) / np.sum(g | w) > 0.99, step


def test_make_batch_deterministic_and_stage_parity(stores):
    """One generator seed gives one batch; even steps take the stage-2
    input (gray outside the dilated object mask) and odd steps the plain
    one, from the same draws: the targets do not change with the stage."""
    _, ts = stores

    def batch(seed, step):
        return tdata.make_batch(ts, torch.Generator().manual_seed(seed),
                                step, 8)

    a, b = batch(0, 1), batch(0, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["src"], batch(1, 1)["src"])
    s2 = batch(0, 2)
    assert torch.equal(s2["tgt"], a["tgt"])
    assert torch.equal(s2["prob_gt"], a["prob_gt"])
    gray2 = (s2["src"].abs() < 1e-6).all(-1).float().mean()
    gray1 = (a["src"].abs() < 1e-6).all(-1).float().mean()
    assert float(gray2) > float(gray1) + 0.1, (float(gray2), float(gray1))
    for k, (lo, hi) in {"src": (-1, 1), "tgt": (-1, 1),
                        "prob_gt": (0, 1)}.items():
        assert a[k].min() >= lo - 1e-5 and a[k].max() <= hi + 1e-5
    assert set(torch.unique(a["prob_gt"]).tolist()) <= {0.0, 1.0}
