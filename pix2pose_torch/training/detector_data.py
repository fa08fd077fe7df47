"""Detector-training scene synthesis on the device (port of
:mod:`pix2pose_tpu.training.detector_data`).

The reference writes 200k cluttered composites to disk for Mask-RCNN /
RetinaNet training (``tools/1_1_scene_gen_for_detection_maskrcnn.py``:
5-20 scaled, rotated, occluding crops per COCO background, visibility
filter 0.3). Here one batch is one set of tensor operations over B scenes
of K placements each, with no loop per sample:

  K patches per scene -> random affine placement (scale, rotation,
  shift; one batched gather warp) -> ordered compositing (slot k is
  occluded by slots > k, like the sequential pastes of ``1_1:163-241``)
  -> CenterNet targets (gaussian center heatmaps, box sizes, offsets,
  per-class masks) and the instance targets of the mask head, with the
  0.3 visibility filter (``1_1:250-256``).

Every random number of a batch comes from :func:`draw_detector_batch`,
one ``torch.Generator``; :func:`make_detector_batch` takes such a dict,
so a caller can inject the JAX package's draws (threefry bits cannot be
reproduced in torch).

Each patch is warped into a ``_WIN``-sized window around its center and
the window pasted into the frame, as the JAX composer does: with frames
of at least ``_WIN`` the window is clamped into the frame and the
affine's target center shifted to compensate, so the sampling
coordinates, and the cut of a footprint that would leave the window, are
the JAX package's. The JAX package warps the window with a banded matmul
in bfloat16 (``warp_dtype``) only to avoid gathers on the TPU; here it is
a float32 gather (:func:`pix2pose_torch.ops.affine.affine_sample`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from pix2pose_torch.ops.affine import affine_sample, make_affine

PATCH = 128
# the warp window covers the largest footprint: a 128 px patch at scale
# 1.6, any rotation (128 * 1.6 * sqrt(2) ~ 290), +1 px fractional placement
_WIN = 296


@dataclasses.dataclass
class DetectorStore:
    """All objects' patches in one pool, with class labels."""

    rgb: torch.Tensor     # (P, 128, 128, 3) uint8
    mask: torch.Tensor    # (P, 128, 128) bool
    label: torch.Tensor   # (P,) int64 class index (0-based; -1 distractor)
    extent: torch.Tensor  # (P,) float32
    backs: torch.Tensor   # (M, 256, 256, 3) uint8
    num_classes: int

    @classmethod
    def from_patch_stores(cls, stores: dict, backs, distractors=()):
        """``stores``: {obj_id: PatchStore-like with ``rgb`` / ``mask`` /
        ``extent``}; class index = rank of obj_id. ``distractors``: more
        PatchStore-likes whose patches are composited into scenes with
        label -1: they occlude and clutter like the reference's COCO-crop
        distractors but never become targets. Concatenated on the
        device of ``backs``."""
        dev = torch.as_tensor(backs).device
        rgbs, masks, labels, extents = [], [], [], []
        groups = [(stores[o], ci) for ci, o in enumerate(sorted(stores))]
        groups += [(st, -1) for st in distractors]
        for st, ci in groups:
            rgb = torch.as_tensor(st.rgb, device=dev)
            rgbs.append(rgb)
            masks.append(torch.as_tensor(st.mask, device=dev))
            extents.append(torch.as_tensor(st.extent, dtype=torch.float32,
                                           device=dev))
            labels.append(torch.full((rgb.shape[0],), ci, dtype=torch.int64,
                                     device=dev))
        return cls(rgb=torch.cat(rgbs), mask=torch.cat(masks),
                   label=torch.cat(labels), extent=torch.cat(extents),
                   backs=torch.as_tensor(backs, device=dev),
                   num_classes=len(stores))


def _gauss_radius(h, w, min_overlap: float = 0.7):
    """CenterNet gaussian radius from the box size."""
    a = min_overlap
    return torch.clamp(torch.minimum(h, w) * (1 - a) / (1 + a), min=2.0)


def draw_detector_batch(gen: torch.Generator, store: DetectorStore,
                        batch_size: int, im_size: int, k_obj: int,
                        scale_range=(0.6, 1.6)) -> dict:
    """Every random number of one batch, from ``gen`` on its device:
    ``pidx`` (B, K) patch of each placement, ``bidx`` (B,) background;
    per placement ``scale`` in ``scale_range``, ``angle`` in [-pi, pi)
    and the center ``cv``, ``cu`` (B, K), uniform over the frame less a
    margin of half the scaled extent + 4 px (at the margin when that
    leaves no room); ``flat_val`` (B, 3) in [0.25, 0.75) and ``flat``
    (B,) bool, true with probability 0.2: a flat background of that
    color."""
    dev = gen.device
    b, k = batch_size, k_obj

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    pidx = torch.randint(0, store.rgb.shape[0], (b, k), generator=gen,
                         device=dev)
    bidx = torch.randint(0, store.backs.shape[0], (b,), generator=gen,
                         device=dev)
    scale = u(scale_range[0], scale_range[1], b, k)
    angle = u(-math.pi, math.pi, b, k)
    margin = store.extent.to(dev)[pidx] * scale * 0.5 + 4.0

    def center():  # jax.random.uniform's form: never below the margin
        return torch.maximum(margin, u(0.0, 1.0, b, k)
                             * (im_size - margin - margin) + margin)

    cv, cu = center(), center()
    return {"pidx": pidx, "bidx": bidx, "scale": scale, "angle": angle,
            "cv": cv, "cu": cu, "flat_val": u(0.25, 0.75, b, 3),
            "flat": torch.rand((b,), generator=gen, device=dev) < 0.2}


def _place(store: DetectorStore, d: dict, im_size: int):
    """Warp every placement's (rgb | mask) patch into its window and
    paste the window into the frame: (B, K, S, S, 3) float rgb and
    (B, K, S, S) float mask in {0, 1}."""
    b, k = d["pidx"].shape
    s = im_size
    pidx = d["pidx"].reshape(-1)
    pad = _WIN // 2
    cv, cu = d["cv"].reshape(-1), d["cu"].reshape(-1)
    iv0 = torch.floor(cv).long() - pad  # window origin in the frame
    iu0 = torch.floor(cu).long() - pad
    if im_size >= _WIN:
        iv0 = torch.clamp(iv0, 0, s - _WIN)
        iu0 = torch.clamp(iu0, 0, s - _WIN)
    # out -> src map: src px per out px = 1 / scale; center in window px
    center_out = torch.stack([cv - iv0, cu - iu0], -1)
    mat = make_affine(((PATCH - 1) / 2.0, (PATCH - 1) / 2.0), center_out,
                      1.0 / d["scale"].reshape(-1), d["angle"].reshape(-1))
    stacked = torch.cat([store.rgb[pidx].float() / 255.0,
                         store.mask[pidx].float()[..., None]], -1)
    win = affine_sample(stacked, mat, _WIN, _WIN, 0.0)  # (BK, WIN, WIN, 4)
    # paste: frame pixel (i, j) is window pixel (i - iv0, j - iu0)
    grid = torch.arange(s, device=win.device)
    rows, cols = grid - iv0[:, None], grid - iu0[:, None]     # (BK, S)
    ok = (((rows >= 0) & (rows < _WIN))[:, :, None]
          & ((cols >= 0) & (cols < _WIN))[:, None, :])
    out = win[torch.arange(b * k, device=win.device)[:, None, None],
              rows.clamp(0, _WIN - 1)[:, :, None],
              cols.clamp(0, _WIN - 1)[:, None, :]]
    out = torch.where(ok[..., None], out, 0.0).reshape(b, k, s, s, 4)
    return out[..., :3], (out[..., 3] > 0.5).float()


def make_detector_batch(store: DetectorStore, gen: torch.Generator | None,
                        batch_size: int = 8, im_size: int = 512,
                        k_obj: int = 8, stride: int = 4,
                        min_visib: float = 0.3, scale_range=(0.6, 1.6),
                        draws: dict | None = None) -> dict:
    """One detector training batch on the store's device.

    ``scale_range`` sets the placement scale (x the 128 px patch): match
    it to the deployment's apparent object sizes (a detector trained at
    (0.6, 1.6), 77-205 px instances, merges adjacent duplicates that
    appear at ~40 px into one detection).

    Returns ``image`` (B, S, S, 3) in [0, 1]; the targets ``heat`` (B, h,
    w, C), ``wh``, ``off`` (B, h, w, 2), ``reg_mask`` (B, h, w) and ``seg``
    (B, h, w, C) at the stride grid; ``gt_bbox`` (B, K, 4) visible-region
    [v1, u1, v2, u2) in image pixels, ``gt_cls`` (B, K), ``gt_valid`` (B,
    K) (False for instances under the visibility cut and for
    distractors); ``gt_mask`` (B, K, h, w) visible instance masks and
    ``gt_center`` (B, K, 2) grid centers for the mask head. The draws
    come from ``gen`` (:func:`draw_detector_batch`) unless given."""
    if scale_range[1] * PATCH * 1.4143 + 2 > _WIN:
        raise ValueError(f"scale_range {scale_range}: the largest "
                         f"footprint leaves the {_WIN} px warp window")
    d = draws if draws is not None else draw_detector_batch(
        gen, store, batch_size, im_size, k_obj, scale_range)
    s, hs, c = im_size, im_size // stride, store.num_classes
    b, k = d["pidx"].shape
    dev = store.rgb.device
    rgbs, masks = _place(store, d, im_size)
    labels = store.label[d["pidx"]]                               # (B, K)

    # background: the stored image resized to S, or (1 in 5) a flat color
    back = store.backs[d["bidx"]].permute(0, 3, 1, 2).float() / 255.0
    back = F.interpolate(back, size=(s, s), mode="bilinear",
                         antialias=True, align_corners=False)
    back = back.permute(0, 2, 3, 1)
    back = torch.where(d["flat"][:, None, None, None],
                       d["flat_val"][:, None, None, :].expand_as(back), back)

    # ordered compositing: slot k is occluded by the union of slots > k
    mb = masks > 0
    later = torch.flip(torch.cumsum(torch.flip(mb.int(), [1]), 1), [1])
    visible = masks * (later - mb.int() == 0).float()
    img = back
    for kk in range(k):
        img = torch.where(visible[:, kk, ..., None] > 0, rgbs[:, kk], img)

    # targets: boxes at full image resolution (stride-grid boxes would
    # quantize the GT by +-stride px); heat / wh / off on the stride grid
    vis_s = visible[:, :, ::stride, ::stride]
    area_full = torch.clamp(masks.sum((2, 3)), min=1.0)
    area_vis = visible.sum((2, 3))
    big = 1e9
    gvf = torch.arange(s, dtype=torch.float32, device=dev)
    rows = (visible > 0).any(3)                                # (B, K, S)
    cols = (visible > 0).any(2)
    vmin = torch.where(rows, gvf, big).amin(-1)
    vmax = torch.where(rows, gvf, -big).amax(-1)
    umin = torch.where(cols, gvf, big).amin(-1)
    umax = torch.where(cols, gvf, -big).amax(-1)
    valid = ((area_vis / area_full >= min_visib) & (area_vis > 4.0)
             & (labels >= 0))  # distractors never become targets
    cls_safe = torch.clamp(labels, min=0)
    # center and size in stride-grid units (the head's output frame)
    gcv = (vmin + vmax) / 2.0 / stride
    gcu = (umin + umax) / 2.0 / stride
    hh = torch.clamp(vmax - vmin + 1.0, min=1.0) / stride
    ww = torch.clamp(umax - umin + 1.0, min=1.0) / stride

    heat = torch.zeros((b, hs, hs, c), device=dev)
    wh = torch.zeros((b, hs, hs, 2), device=dev)
    off = torch.zeros((b, hs, hs, 2), device=dev)
    reg = torch.zeros((b, hs, hs), device=dev)
    seg = torch.zeros((b, hs, hs, c), device=dev)
    onehot = F.one_hot(cls_safe, c).float()                    # (B, K, C)
    v = torch.arange(hs, dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)
    upd = valid.float()
    radius = _gauss_radius(hh, ww)
    ci = torch.clamp(torch.round(gcv).long(), 0, hs - 1)
    cj = torch.clamp(torch.round(gcu).long(), 0, hs - 1)
    for kk in range(k):  # slot order: a later valid slot wins a shared cell
        cvk, cuk, vk = gcv[:, kk], gcu[:, kk], valid[:, kk]
        g = torch.exp(-(((v[None, :, None] - cvk[:, None, None]) ** 2
                         + (v[None, None, :] - cuk[:, None, None]) ** 2)
                        / (2 * (radius[:, kk] / 3.0)[:, None, None] ** 2)))
        g = torch.where(vk[:, None, None], g, 0.0)
        heat = torch.maximum(heat, g[..., None]
                             * onehot[:, kk, None, None, :])
        # force an exact-1 positive at the center cell
        i, j, cl = ci[:, kk], cj[:, kk], cls_safe[:, kk]
        heat[bi, i, j, cl] = torch.maximum(heat[bi, i, j, cl], upd[:, kk])
        wh[bi, i, j] = torch.where(
            vk[:, None], torch.stack([hh[:, kk], ww[:, kk]], -1),
            wh[bi, i, j])
        off[bi, i, j] = torch.where(
            vk[:, None], torch.stack([cvk - i, cuk - j], -1), off[bi, i, j])
        reg[bi, i, j] = torch.maximum(reg[bi, i, j], upd[:, kk])
        seg = torch.maximum(seg, vis_s[:, kk, ..., None]
                            * onehot[:, kk, None, None, :]
                            * upd[:, kk, None, None, None])
    gt_bbox = torch.stack([vmin, umin, vmax + 1.0, umax + 1.0], -1)
    gt_bbox = torch.where(valid[..., None], gt_bbox, 0.0)
    return {"image": img, "heat": heat, "wh": wh, "off": off,
            "reg_mask": reg, "seg": seg, "gt_bbox": gt_bbox,
            "gt_cls": labels, "gt_valid": valid,
            "gt_mask": vis_s * upd[..., None, None],
            "gt_center": torch.stack([gcv, gcu], -1)}


_PACK_BF16 = ("heat", "wh", "off", "seg", "gt_mask")


def pack_detector_batch(batch: dict) -> dict:
    """The scene pool's compact encoding: image -> uint8, dense targets
    -> bfloat16, reg_mask -> bool (~3.6x less pool memory). Image error
    +-0.5/255, below the uint8 patches' own; bfloat16 targets < 0.4%
    relative."""
    out = dict(batch)
    out["image"] = torch.round(
        torch.clamp(batch["image"], 0.0, 1.0) * 255.0).to(torch.uint8)
    for name in _PACK_BF16:
        out[name] = batch[name].to(torch.bfloat16)
    out["reg_mask"] = batch["reg_mask"] > 0.5
    return out


def unpack_detector_batch(packed: dict) -> dict:
    """Inverse of :func:`pack_detector_batch` (the training dtypes)."""
    out = dict(packed)
    out["image"] = packed["image"].to(torch.float32) / 255.0
    for name in _PACK_BF16:
        out[name] = packed[name].to(torch.float32)
    out["reg_mask"] = packed["reg_mask"].to(torch.float32)
    return out
