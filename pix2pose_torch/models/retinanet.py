"""RetinaNet-style anchor detector, the alternative detection head (port
of :mod:`pix2pose_tpu.models.retinanet`).

The reference's T-Less results use fizyr keras-retinanet
(``5_evaluation_bop_basic.py:64-97``) beside Mask-RCNN. This is its
counterpart on the shared trunk:

- the trunk's stride-8 tap extended to P3/P4/P5 (strides 8/16/32) by two
  3x3/2 convs with flax "SAME" padding, an FPN with 2x nearest
  upsampling and a 3x3 ``smooth`` conv per level;
- 9 anchors per cell (3 scales x 3 ratios), shared 4-conv subnets: focal
  classification (alpha 0.25, gamma 2) and smooth-L1 regression of
  (dy, dx, dh, dw) deltas scaled by keras-retinanet's std 0.2.

Assignment (:func:`assign_anchors`) and decoding (:func:`decode_retinanet`,
a top-k over all anchors and classes, then a greedy class-aware NMS) run
on the device with fixed shapes, batched over images. There is no mask
head (the reference's retinanet path has none either); the detector
adapter emits box-shaped masks.

Layouts: the model takes NHWC images and returns (B, A_total, C) logits
and (B, A_total, 4) deltas in the JAX package's anchor order (see
:func:`anchor_boxes`); module names match the flax tree.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from pix2pose_torch.models.detector import TinyTrunk, _SameConv, \
    _top_k_jax_order
from pix2pose_torch.models.resnet50 import ResNet50Trunk

BOX_STD = 0.2  # keras-retinanet delta scaling


class RetinaOut(NamedTuple):
    cls_logits: torch.Tensor  # (B, A_total, C)
    box_deltas: torch.Tensor  # (B, A_total, 4)


def anchor_boxes(im_size: int, strides: Sequence[int] = (8, 16, 32),
                 scales: Sequence[float] = (1.0, 1.26, 1.587),
                 ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 base: float = 4.0) -> np.ndarray:
    """All anchors of a square ``im_size`` input, (A_total, 4) float32
    [v1, u1, v2, u2] pixels; level base size ``base * stride``.

    Order contract: position-major within each level, ``index = (v * n +
    u) * (S * R) + (scale_i * R + ratio_i)``, which is the head's
    ``(B, H, W, A * C) -> (B, H * W * A, C)`` reshape. An anchor-major
    layout would scramble predictions against targets."""
    out = []
    for s in strides:
        n = im_size // s
        cv = (np.arange(n) + 0.5) * s
        size = base * s
        hws = np.array([[size * sc * math.sqrt(r), size * sc / math.sqrt(r)]
                        for sc in scales for r in ratios], np.float64)
        vv, uu = np.meshgrid(cv, cv, indexing="ij")
        ctr = np.stack([vv, uu], -1)[:, :, None, :]   # (n, n, 1, 2)
        half = hws[None, None, :, :] / 2              # (1, 1, A, 2)
        lvl = np.concatenate([ctr - half, ctr + half], axis=-1)
        out.append(lvl.reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


class RetinaNetDetector(nn.Module):
    """Trunk (ResNet-50 with the classic stem, or :class:`TinyTrunk`) ->
    P3-P5 FPN -> shared ``cls`` / ``box`` subnets."""

    def __init__(self, num_classes: int, head_dim: int = 128,
                 n_anchors: int = 9, trunk: str = "resnet50"):
        super().__init__()
        if trunk == "tiny":
            self.trunk = TinyTrunk()
            c3 = 128
        elif trunk == "resnet50":
            self.trunk = ResNet50Trunk(stem_s2d=False)
            c3 = 512
        else:
            raise ValueError(f"trunk {trunk!r}: 'resnet50' or 'tiny'")
        self.num_classes = num_classes
        hd = head_dim
        self.down4 = _SameConv(c3, hd, 3, 2)
        self.down5 = _SameConv(hd, hd, 3, 2)
        self.lat5 = nn.Conv2d(hd, hd, 1)
        self.lat4 = nn.Conv2d(hd, hd, 1)
        self.lat3 = nn.Conv2d(c3, hd, 1)
        for i in range(3):
            setattr(self, f"smooth{i}", nn.Conv2d(hd, hd, 3, padding=1))
        for name, out_ch in (("cls", n_anchors * num_classes),
                             ("box", n_anchors * 4)):
            for i in range(4):
                setattr(self, f"{name}_c{i}", nn.Conv2d(hd, hd, 3,
                                                        padding=1))
            setattr(self, f"{name}_out", nn.Conv2d(hd, out_ch, 3, padding=1))

    def _subnet(self, name, p):
        for i in range(4):
            p = F.relu(getattr(self, f"{name}_c{i}")(p))
        return getattr(self, f"{name}_out")(p)

    def forward(self, x) -> RetinaOut:
        """x (B, H, W, 3) NHWC, H and W multiples of 32."""
        _, _, c3 = self.trunk(x.permute(0, 3, 1, 2))   # stride 8
        c4 = self.down4(c3)
        c5 = self.down5(F.relu(c4))
        p5 = self.lat5(c5)
        p4 = self.lat4(c4) + F.interpolate(p5, scale_factor=2,
                                           mode="nearest")
        p3 = self.lat3(c3) + F.interpolate(p4, scale_factor=2,
                                           mode="nearest")
        cls_all, box_all = [], []
        for i, p in enumerate((p3, p4, p5)):
            p = getattr(self, f"smooth{i}")(p)
            b = p.shape[0]
            cls_all.append(self._subnet("cls", p).permute(0, 2, 3, 1)
                           .reshape(b, -1, self.num_classes).float())
            box_all.append(self._subnet("box", p).permute(0, 2, 3, 1)
                           .reshape(b, -1, 4).float())
        return RetinaOut(cls_logits=torch.cat(cls_all, 1),
                         box_deltas=torch.cat(box_all, 1))


def _to_cwh(boxes):
    cv = (boxes[..., 0] + boxes[..., 2]) / 2
    cu = (boxes[..., 1] + boxes[..., 3]) / 2
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    return cv, cu, h, w


def encode_deltas(anchors, boxes):
    """GT boxes -> regression targets relative to the anchors."""
    av, au, ah, aw = _to_cwh(anchors)
    bv, bu, bh, bw = _to_cwh(boxes)
    return torch.stack([(bv - av) / ah, (bu - au) / aw,
                        torch.log(torch.clamp(bh, min=1.0) / ah),
                        torch.log(torch.clamp(bw, min=1.0) / aw)],
                       -1) / BOX_STD


def decode_deltas(anchors, deltas):
    """Regression outputs -> boxes."""
    av, au, ah, aw = _to_cwh(anchors)
    d = deltas * BOX_STD
    cv = av + d[..., 0] * ah
    cu = au + d[..., 1] * aw
    h = ah * torch.exp(torch.clamp(d[..., 2], -4.0, 4.0))
    w = aw * torch.exp(torch.clamp(d[..., 3], -4.0, 4.0))
    return torch.stack([cv - h / 2, cu - w / 2, cv + h / 2, cu + w / 2], -1)


def iou_matrix(a, b):
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU of [v1, u1, v2, u2]
    boxes (leading axes broadcast)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9), 0.0)


def assign_anchors(anchors, gt_bbox, gt_cls, gt_valid, pos_iou: float = 0.5,
                   neg_iou: float = 0.4):
    """Anchor targets for a batch: anchors (A, 4), gt_bbox (B, K, 4),
    gt_cls (B, K), gt_valid (B, K). Returns (cls_target_idx (B, A), box
    targets (B, A, 4) deltas, pos (B, A) bool, ignore (B, A) bool).

    Each valid GT's best anchor is forced positive (objects smaller than
    the best-matching anchor never reach ``pos_iou``). Two valid GTs that
    share a best anchor resolve to the lower GT index, and invalid GTs
    are dropped, by ``scatter_reduce`` (amax / amin) into an extra slot
    past the anchors that is then cut."""
    b, k = gt_valid.shape
    n_a = anchors.shape[0]
    iou = iou_matrix(anchors, gt_bbox)                        # (B, A, K)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best_iou = iou.amax(2)
    best_gt = iou.argmax(2)  # the first maximum, as jnp.argmax
    best_a = iou.argmax(1)                                    # (B, K)
    safe_a = torch.where(gt_valid, best_a, n_a)
    forced = torch.zeros((b, n_a + 1), dtype=torch.int64,
                         device=anchors.device).scatter_reduce(
        1, safe_a, gt_valid.long(), "amax")[:, :n_a] > 0
    gt_index = torch.arange(k, device=anchors.device).expand(b, k)
    forced_gt = torch.full((b, n_a + 1), k, dtype=torch.int64,
                           device=anchors.device).scatter_reduce(
        1, safe_a, torch.where(gt_valid, gt_index, k), "amin")[:, :n_a]
    best_gt = torch.where(forced, torch.clamp(forced_gt, max=k - 1), best_gt)
    pos = (best_iou >= pos_iou) | forced
    ignore = (best_iou >= neg_iou) & ~pos
    cls_t = torch.gather(gt_cls.long(), 1, best_gt)
    box_t = encode_deltas(anchors, torch.gather(
        gt_bbox, 1, best_gt[..., None].expand(b, n_a, 4)))
    return cls_t, box_t, pos, ignore


def retinanet_loss(out: RetinaOut, anchors, gt_bbox, gt_cls, gt_valid,
                   num_classes: int, alpha: float = 0.25, gamma: float = 2.0,
                   pos_iou: float = 0.5, neg_iou: float = 0.4):
    """(total, {"cls", "box"}): focal classification over the
    non-ignored anchors and smooth-L1 over the positives, each per image
    over its positives, then averaged over the batch."""
    cls_idx, box_t, pos, ignore = assign_anchors(
        anchors, gt_bbox, gt_cls, gt_valid, pos_iou=pos_iou, neg_iou=neg_iou)
    cls_t = (F.one_hot(torch.clamp(cls_idx, min=0), num_classes).float()
             * pos[..., None].float())
    p = torch.sigmoid(out.cls_logits)
    pt = torch.where(cls_t > 0, p, 1.0 - p)
    a_t = torch.where(cls_t > 0, alpha, 1.0 - alpha)
    focal = -a_t * torch.pow(1 - pt, gamma) * torch.log(
        torch.clamp(pt, min=1e-6))
    focal = torch.where(ignore[..., None], 0.0, focal)
    n_pos = torch.clamp(pos.sum(1).float(), min=1.0)
    l_cls = focal.sum((1, 2)) / n_pos
    diff = torch.abs(out.box_deltas - box_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    l_box = (sl1 * pos[..., None]).sum((1, 2)) / n_pos
    total = l_cls.mean() + l_box.mean()
    return total, {"cls": l_cls.mean(), "box": l_box.mean()}


def decode_retinanet(out: RetinaOut, anchors, top_k: int = 64,
                     nms_iou: float = 0.5):
    """Top-k over all (anchor, class) scores, ties to the lower index as
    ``jax.lax.top_k``, then a greedy class-aware NMS over the k slots: slot
    i is suppressed by an earlier KEPT slot of its class with IoU >=
    ``nms_iou``. Returns (bbox (B, k, 4), score (B, k), cls (B, k)); a
    suppressed slot has score 0."""
    anchors = torch.as_tensor(anchors, device=out.cls_logits.device)
    probs = torch.sigmoid(out.cls_logits)
    b, a, c = probs.shape
    score, idx = _top_k_jax_order(probs.reshape(b, a * c), top_k)
    cls = idx % c
    aidx = idx // c
    boxes = decode_deltas(anchors[aidx], torch.gather(
        out.box_deltas, 1, aidx[..., None].expand(b, top_k, 4)))
    sup = ((iou_matrix(boxes, boxes) >= nms_iou)
           & (cls[:, :, None] == cls[:, None, :]))           # (B, k, k)
    keep = torch.ones((b, top_k), dtype=torch.bool, device=boxes.device)
    slot = torch.arange(top_k, device=boxes.device)
    for i in range(top_k):
        earlier = (slot < i) & keep
        keep[:, i] = ~(sup[:, i] & earlier).any(1)
    return boxes, torch.where(keep, score, 0.0), cls
