"""Training-batch synthesis on the device (port of
:mod:`pix2pose_tpu.training.data`).

The reference streams batches from 6 host processes doing per-sample
skimage work (``pix2pose_util/data_io.py``, hooked up at
``tools/3_train_pix2pose.py:204-206``). Here one batch is one set of
tensor operations over all B samples, with no loop per sample:

  workspace composite (patch over a random 192 px crop of a background)
  -> color jitter (channel shifts, contrast, per-channel gain, blur, noise)
  -> occlusion cut-outs (input only; the targets keep the full silhouette,
     ``data_io.py:106,261-262``)
  -> stage-2 input simulation on even steps: gray background masked by
     the blurred cut mask, gray cut-outs, wrong-background inclusions
     (``data_io.py:203-255``)
  -> boundary blur band (``data_io.py:186-195``)
  -> one affine sample (center jitter, scale 1.5 x (1 +- 0.3), rotation)
     to 128 px (``data_io.py:110-123,264-272``), a gather
     (:func:`pix2pose_torch.ops.affine.affine_sample`).

Every random number of a batch comes from :func:`draw_batch`, which makes
all of them with one ``torch.Generator`` and returns them as tensors;
:func:`make_batch` takes such a dict in its place, so a caller can inject
the JAX package's draws (threefry bits cannot be reproduced in torch).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from pix2pose_torch.ops.affine import affine_sample, make_affine

WORK = 192  # workspace resolution (the patch sits centered)
PATCH = 128
BACK = 256  # stored background resolution
_PAD = (WORK - PATCH) // 2


@dataclasses.dataclass
class PatchStore:
    """Padded training patches and backgrounds, on one device."""

    rgb: torch.Tensor     # (N, 128, 128, 3) uint8
    xyz: torch.Tensor     # (N, 128, 128, 3) uint8 (coordinate colors)
    mask: torch.Tensor    # (N, 128, 128) bool silhouette
    extent: torch.Tensor  # (N,) float32: max(h, w) of the un-padded patch
    backs: torch.Tensor   # (M, 256, 256, 3) uint8

    @property
    def n_data(self) -> int:
        return self.rgb.shape[0]

    @classmethod
    def load(cls, data_dir: str, back_dir: str | None,
             max_patches: int = 20000, max_backs: int = 512,
             device="cuda"):
        """Read the reference's (h, w, 6|7) uint8 npy crops
        (``2_2_render_pix2pose_training.py:76-96``) and the background
        images (resized to 256 x 256 bilinear; a gray one when none)."""
        from PIL import Image

        rgbs, xyzs, masks, extents = [], [], [], []
        files = sorted(f for f in os.listdir(data_dir)
                       if f.endswith(".npy"))[:max_patches]
        for fn in files:
            arr = np.load(os.path.join(data_dir, fn))
            h, w = arr.shape[:2]
            rgb = np.zeros((PATCH, PATCH, 3), np.uint8)
            xyz = np.zeros((PATCH, PATCH, 3), np.uint8)
            v0, u0 = (PATCH - h) // 2, (PATCH - w) // 2
            rgb[v0:v0 + h, u0:u0 + w] = arr[..., :3]
            xyz[v0:v0 + h, u0:u0 + w] = arr[..., 3:6]
            m = xyz.sum(axis=2) > 0
            if arr.shape[2] == 7:
                vm = np.zeros((PATCH, PATCH), bool)
                vm[v0:v0 + h, u0:u0 + w] = arr[..., 6] > 0
                m &= vm
            rgbs.append(rgb)
            xyzs.append(xyz)
            masks.append(m)
            extents.append(float(max(h, w)))
        backs = []
        bfiles = (sorted(os.listdir(back_dir))[:max_backs]
                  if back_dir and os.path.isdir(back_dir) else [])
        for fn in bfiles:
            try:
                img = Image.open(os.path.join(back_dir, fn)).convert("RGB")
            except OSError:  # not an image
                continue
            backs.append(np.asarray(
                img.resize((BACK, BACK), Image.BILINEAR), np.uint8))
        if not backs:
            backs = [np.full((BACK, BACK, 3), 127, np.uint8)]
        dev = torch.device(device)
        return cls(rgb=torch.as_tensor(np.stack(rgbs), device=dev),
                   xyz=torch.as_tensor(np.stack(xyzs), device=dev),
                   mask=torch.as_tensor(np.stack(masks), device=dev),
                   extent=torch.as_tensor(np.array(extents, np.float32),
                                          device=dev),
                   backs=torch.as_tensor(np.stack(backs), device=dev))


def draw_batch(gen: torch.Generator, batch_size: int, n_data: int,
               n_backs: int, full_rotation: bool = True) -> dict:
    """Every random number of one batch, from ``gen`` on its device:

    - ``idx``, ``bidx`` (B,) int64: patch and background of each sample;
    - ``shift`` (B, 3) in [-15/255, 15/255), ``contrast`` (B,) in
      [0.8, 1.3), ``gain`` (B, 3) in [0.8, 1.2) (one value for all three
      channels in half of the samples), ``alpha`` (B,) in [0, 0.7) (blur
      lerp), ``noise`` (B, 128, 128, 3): N(0, 10/255) on one sample in
      ten, 0 elsewhere;
    - ``off`` (B, 2) int64 in [0, 64): the background crop's corner;
    - ``occ``, ``miss``, ``wrong`` (B, 4): rectangles as (h, w) fractions
      of the patch extent in [0.2, 0.7) for ``occ`` and [0, 0.5) for the
      stage-2 ``miss`` / ``wrong``, then center offsets (v, u) in
      [-0.5, 0.5);
    - ``scale`` (B,) in [-0.3, 0.3), ``jitter`` (B, 2) in [-5, 5) px,
      ``angle`` (B,) degrees in [-180, 180), or [-15, 15) without
      ``full_rotation``.
    """
    dev = gen.device
    b = batch_size

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def rect(lo, hi):
        return torch.cat([u(lo, hi, b, 2), u(-0.5, 0.5, b, 2)], 1)

    idx = torch.randint(0, n_data, (b,), generator=gen, device=dev)
    bidx = torch.randint(0, n_backs, (b,), generator=gen, device=dev)
    per_channel = u(0.0, 1.0, b, 1) < 0.5
    noise_on = u(0.0, 1.0, b, 1, 1, 1) < 0.1
    noise = torch.randn((b, PATCH, PATCH, 3), generator=gen, device=dev)
    return {
        "idx": idx, "bidx": bidx,
        "shift": u(-15 / 255, 15 / 255, b, 3),
        "contrast": u(0.8, 1.3, b),
        "gain": torch.where(per_channel, u(0.8, 1.2, b, 3),
                            u(0.8, 1.2, b, 1).expand(b, 3)),
        "alpha": u(0.0, 0.7, b),
        "noise": torch.where(noise_on, noise * (10 / 255),
                             torch.zeros_like(noise)),
        "off": torch.randint(0, BACK - WORK, (b, 2), generator=gen,
                             device=dev),
        "occ": rect(0.2, 0.7), "miss": rect(0.0, 0.5),
        "wrong": rect(0.0, 0.5),
        "scale": u(-0.3, 0.3, b), "jitter": u(-5.0, 5.0, b, 2),
        "angle": (u(-180.0, 180.0, b) if full_rotation
                  else u(-15.0, 15.0, b)),
    }


def blur_ws(img):
    """3x3 box blur with zero "SAME" padding per channel: (B, H, W, C) or
    (B, H, W)."""
    x = img if img.ndim == 4 else img[..., None]
    c = x.shape[-1]
    k = torch.full((c, 1, 3, 3), 1.0 / 9.0, dtype=x.dtype, device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=c)
    y = y.permute(0, 2, 3, 1)
    return y if img.ndim == 4 else y[..., 0]


def color_jitter(img, d: dict):
    """imgaug-sequence equivalent (``data_io.py:42-51``) on (B, H, W, 3)
    images in [0, 1], with the draws of :func:`draw_batch`."""
    img = img + d["shift"][:, None, None, :]
    img = (img - 0.5) * d["contrast"][:, None, None, None] + 0.5
    img = img * d["gain"][:, None, None, :]
    # light blur: lerp toward a 3x3 box blur by sigma / 0.5
    alpha = d["alpha"][:, None, None, None]
    img = img * (1 - alpha) + blur_ws(img) * alpha
    return torch.clamp(img + d["noise"], 0.0, 1.0)


def rect_mask(r, extent):
    """(B, WORK, WORK) bool rectangles in workspace coordinates around the
    patch center (``data_io.py:156-166``): ``r`` (B, 4) as in
    :func:`draw_batch`, scaled by ``extent`` (B,)."""
    h, w = r[:, 0] * extent, r[:, 1] * extent
    cv = WORK / 2 + r[:, 2] * extent
    cu = WORK / 2 + r[:, 3] * extent
    grid = torch.arange(WORK, dtype=torch.float32, device=r.device)
    inside_v = (grid >= cv[:, None]) & (grid < (cv + h)[:, None])
    inside_u = (grid >= cu[:, None]) & (grid < (cu + w)[:, None])
    return inside_v[:, :, None] & inside_u[:, None, :]


def composite(store: PatchStore, d: dict, stage2: bool):
    """The pre-warp workspace of each sample: ``comp`` (B, 192, 192, 3)
    input in [0, 1], ``ws_xyz`` (B, 192, 192, 3) coordinate target (0.5
    off the object) and ``ws_mask`` (B, 192, 192) silhouette."""
    idx = d["idx"]
    rgb = color_jitter(store.rgb[idx].float() / 255.0, d)
    xyz = store.xyz[idx].float() / 255.0
    mask = store.mask[idx]
    extent = store.extent[idx]

    grid = torch.arange(WORK, device=idx.device)
    rows = d["off"][:, 0, None] + grid
    cols = d["off"][:, 1, None] + grid
    back = store.backs[d["bidx"][:, None, None], rows[:, :, None],
                       cols[:, None, :]].float() / 255.0
    pad = (0, 0, _PAD, _PAD, _PAD, _PAD)
    ws_mask = F.pad(mask.float(), pad[2:])
    ws_rgb_patch = F.pad(rgb, pad)
    ws_xyz = F.pad(torch.where(mask[..., None], xyz, 0.5), pad, value=0.5)

    # an occlusion cut-out removes object: the background shows
    occ = rect_mask(d["occ"], extent)
    in_mask = ws_mask * (1.0 - occ.float())
    comp = torch.where(in_mask[..., None] > 0, ws_rgb_patch, back)

    blurred_mask = blur_ws(in_mask)
    band = (blurred_mask > 0.01) & (blurred_mask < 0.99)
    comp = torch.where(band[..., None], blur_ws(comp), comp)

    if stage2:
        # the slightly dilated mask, on non-gray coordinates only
        diff = (ws_xyz - 0.5) * 2.0
        m = (blurred_mask > 0.05) & ((diff * diff).sum(-1).sqrt() > 0.3)
        gray = torch.full_like(comp, 0.5)
        out = torch.where(m[..., None], comp, gray)
        # simulated stage-1 misses: a gray rectangle over the object
        out = torch.where(rect_mask(d["miss"], extent)[..., None], gray, out)
        # wrong background inclusion: a background rectangle leaks back in
        wrong = rect_mask(d["wrong"], extent) & ~(ws_mask > 0)
        comp = torch.where(wrong[..., None], comp, out)
    return comp, ws_xyz, ws_mask


def make_batch(store: PatchStore, gen: torch.Generator | None, step: int,
               batch_size: int = 50, full_rotation: bool = True,
               draws: dict | None = None) -> dict:
    """One training batch on the store's device: ``src``, ``tgt`` (B, 128,
    128, 3) in [-1, 1] and ``prob_gt`` (B, 128, 128, 1) in {0, 1}.
    Stage-2-style inputs on even steps, plain stage-1 inputs on odd
    (``data_io.py:203``: ``batch_count % 2``). The draws come from
    ``gen`` (:func:`draw_batch`) unless given."""
    d = draws if draws is not None else draw_batch(
        gen, batch_size, store.n_data, store.backs.shape[0], full_rotation)
    comp, ws_xyz, ws_mask = composite(store, d, step % 2 == 0)
    extent = store.extent[d["idx"]]
    win = torch.clamp(extent * 1.5 * (1.0 + d["scale"]), min=16.0)
    center_src = WORK / 2 + d["jitter"]
    angle = d["angle"] * math.pi / 180.0
    mat = make_affine(center_src, ((PATCH - 1) / 2.0, (PATCH - 1) / 2.0),
                      win / PATCH, angle)
    # one warp for all seven channels (src | tgt | mask)
    stacked = torch.cat([(comp - 0.5) * 2.0, (ws_xyz - 0.5) * 2.0,
                         ws_mask[..., None]], -1)
    warped = affine_sample(stacked, mat, PATCH, PATCH, 0.0)
    return {"src": warped[..., :3], "tgt": warped[..., 3:6],
            "prob_gt": (warped[..., 6:7] > 0.5).float()}
