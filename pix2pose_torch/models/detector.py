"""In-repo 2D detector and its training losses (port of
:mod:`pix2pose_tpu.models.detector`).

A center-point detector on the ResNet-50 trunk (or the small
:class:`TinyTrunk`): FPN-lite fusion of the stride-8 and stride-4 taps,
then dense heads at stride 4 -- ``heat`` (per-class center logits),
``wh`` (box height/width), ``off`` (sub-stride center offset), ``seg``
(per-class mask logits), and ``ctrl``/``mfeat``: per-pixel weights of a
3-layer 1x1 FCN and the shared features it runs on, which give each peak
its own instance mask (CondInst, Tian et al. 2020).

:func:`decode_detections` is CenterNet's decode: 3x3 max-pool NMS, a
global top-k over (h * w * c), offsets and sizes gathered at each peak,
and the dynamic mask FCN per peak as batched matmuls, masks clipped to
their box. Ties in the top-k go to the lower flat index, as
``jax.lax.top_k`` orders them.

Training: :func:`detector_loss` sums CenterNet's penalty-reduced focal
loss on the heatmap, L1 on sizes and offsets at the centers, BCE on the
semantic masks and, with instance targets, :func:`instance_mask_loss`
(CondInst's dice loss of the dynamic FCN run at each GT center). The two
BatchNorms (``TinyTrunk``'s and ``fuse_bn``) are
:class:`~pix2pose_torch.models.batchnorm.BatchNorm2d`: their train-mode
running variance is the biased one, as flax's.

Layouts: the model takes NHWC images like the JAX package and returns a
:class:`DetectorOut` of NHWC maps; inside it runs NCHW. Module names
match the flax tree (``trunk``, ``lat3``, ``heads_conv``, ``heat_out``,
...).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
import torch.nn.functional as F

from pix2pose_torch.models.ae import _same_pad
from pix2pose_torch.models.batchnorm import BatchNorm2d
from pix2pose_torch.models.resnet50 import ResNet50Trunk

MASK_DIM = 8             # channels of the shared mask-feature map
_CTRL_IN = MASK_DIM + 2  # + 2 peak-relative coordinate channels
# dynamic FCN: (in->8) + (8->8) + (8->1), weights + biases flattened
N_CTRL = (_CTRL_IN * 8 + 8) + (8 * 8 + 8) + (8 * 1 + 1)
REL_NORM = 16.0          # stride-grid units; ~64 px at stride 4

# (name, output channels or None for num_classes) in the flax call order,
# which is the fused layout's slot order
_HEADS = (("heat", None), ("wh", 2), ("off", 2), ("seg", None),
          ("ctrl", N_CTRL), ("mfeat", MASK_DIM))


class DetectorOut(NamedTuple):
    heat: torch.Tensor   # (B, H/4, W/4, C) logits
    wh: torch.Tensor     # (B, H/4, W/4, 2)
    off: torch.Tensor    # (B, H/4, W/4, 2)
    seg: torch.Tensor    # (B, H/4, W/4, C) logits
    ctrl: torch.Tensor   # (B, H/4, W/4, N_CTRL) dynamic mask-FCN params
    mfeat: torch.Tensor  # (B, H/4, W/4, MASK_DIM) shared mask features


class _SameConv(nn.Conv2d):
    """Conv with flax "SAME" padding (asymmetric where the stride needs
    it: 3x3/2 on an even size pads (0, 1))."""

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        (t, b), (l, r) = (_same_pad(k, s, x.shape[2]),
                          _same_pad(k, s, x.shape[3]))
        return super().forward(F.pad(x, (l, r, t, b)))


class TinyTrunk(nn.Module):
    """Small conv trunk with :class:`ResNet50Trunk`'s (f1, f2, f3) tap
    contract (strides 2/4/8), for fast experiments and CPU tests."""

    def __init__(self, width: int = 32):
        super().__init__()
        spec = (("b1", 3, width, 2), ("b2", width, 2 * width, 2),
                ("b2b", 2 * width, 2 * width, 1),
                ("b3", 2 * width, 4 * width, 2),
                ("b3b", 4 * width, 4 * width, 1))
        for name, cin, cout, stride in spec:
            setattr(self, f"{name}_conv", _SameConv(cin, cout, 3, stride))
            setattr(self, f"{name}_bn",
                    BatchNorm2d(cout, eps=1e-3, momentum=0.01))

    def _block(self, name, y):
        return F.relu(getattr(self, f"{name}_bn")(
            getattr(self, f"{name}_conv")(y)))

    def forward(self, x):
        f1 = self._block("b1", x)
        f2 = self._block("b2b", self._block("b2", f1))
        f3 = self._block("b3b", self._block("b3", f2))
        return f1, f2, f3


class CenterNetDetector(nn.Module):
    """Center-point detector with per-instance dynamic masks.

    Head layouts, which checkpoints differ by: ``fused_heads`` (default)
    computes the six heads' 3x3 hidden convs as one ``heads_conv`` of
    width 6 * head_dim, each head's 1x1 ``*_out`` reading its own channel
    slice; unfused, each head has its own ``*_conv``; ``shared_head_dim``
    > 0 feeds every ``*_out`` from one shared 3x3 hidden of that width.
    ``stem_s2d`` runs the ResNet-50 trunk's stem on space-to-depth input.
    """

    def __init__(self, num_classes: int, head_dim: int = 128,
                 trunk: str = "resnet50", fused_heads: bool = True,
                 stem_s2d: bool = True, shared_head_dim: int = 0):
        super().__init__()
        if trunk == "tiny":
            self.trunk = TinyTrunk()
            c2, c3 = 64, 128
        elif trunk == "resnet50":
            self.trunk = ResNet50Trunk(stem_s2d=stem_s2d)
            c2, c3 = 256, 512
        else:
            raise ValueError(f"trunk {trunk!r}: 'resnet50' or 'tiny'")
        self.num_classes = num_classes
        self.head_dim = head_dim
        self.layout = ("shared" if shared_head_dim else
                       "fused" if fused_heads else "unfused")
        self.lat3 = nn.Conv2d(c3, head_dim, 1)
        self.lat2 = nn.Conv2d(c2, head_dim, 1)
        self.fuse = nn.Conv2d(head_dim, head_dim, 3, padding=1)
        self.fuse_bn = BatchNorm2d(head_dim, eps=1e-3, momentum=0.01)
        if self.layout == "shared":
            self.heads_conv = nn.Conv2d(head_dim, shared_head_dim, 3,
                                        padding=1)
            hidden = shared_head_dim
        elif self.layout == "fused":
            self.heads_conv = nn.Conv2d(head_dim, 6 * head_dim, 3,
                                        padding=1)
            hidden = head_dim
        else:
            hidden = head_dim
        for name, ch in _HEADS:
            if self.layout == "unfused":
                setattr(self, f"{name}_conv",
                        nn.Conv2d(head_dim, head_dim, 3, padding=1))
            setattr(self, f"{name}_out",
                    nn.Conv2d(hidden, num_classes if ch is None else ch, 1))

    def forward(self, x) -> DetectorOut:
        """x (B, H, W, 3) NHWC, H and W multiples of 8 (16 with the s2d
        stem) -> :class:`DetectorOut` at stride 4, NHWC fp32."""
        f1, f2, f3 = self.trunk(x.permute(0, 3, 1, 2))
        p3 = F.interpolate(self.lat3(f3), scale_factor=2, mode="nearest")
        p = self.lat2(f2) + p3
        p = F.relu(self.fuse_bn(self.fuse(p)))
        if self.layout != "unfused":
            hidden = F.relu(self.heads_conv(p))
        outs = []
        for slot, (name, _) in enumerate(_HEADS):
            if self.layout == "shared":
                y = hidden
            elif self.layout == "fused":
                y = hidden[:, slot * self.head_dim:(slot + 1)
                           * self.head_dim]
            else:
                y = F.relu(getattr(self, f"{name}_conv")(p))
            y = getattr(self, f"{name}_out")(y)
            outs.append(y.permute(0, 2, 3, 1).float())
        return DetectorOut(*outs)


def _split_ctrl(ctrl):
    """(..., N_CTRL) -> ((w1, b1), (w2, b2), (w3, b3)) of the dynamic FCN
    with the flax function's flat layout; leading axes kept."""
    lead = ctrl.shape[:-1]
    out, i = [], 0
    for shape in ((_CTRL_IN, 8), (8,), (8, 8), (8,), (8, 1), (1,)):
        n = math.prod(shape)
        out.append(ctrl[..., i:i + n].reshape(*lead, *shape))
        i += n
    w1, b1, w2, b2, w3, b3 = out
    return (w1, b1), (w2, b2), (w3, b3)


def dynamic_mask_logits(mfeat, ctrl, center_vu):
    """Instance mask logits over the stride grid, for K peaks at once.

    mfeat (..., hs, ws, MASK_DIM) shared features; ctrl (..., K, N_CTRL)
    controllers gathered at the peaks; center_vu (..., K, 2) peak (v, u)
    in grid units; the leading axes (none, or the batch) agree. Returns
    (..., K, hs, ws). Inputs are the features concatenated with
    peak-relative coordinates, then three 1x1 layers as batched matmuls.
    """
    hs, ws = mfeat.shape[-3:-1]
    *lead, k, _ = ctrl.shape
    dev = mfeat.device
    vv = (torch.arange(hs, dtype=torch.float32, device=dev)
          - center_vu[..., 0:1]) / REL_NORM                  # (..., K, hs)
    uu = (torch.arange(ws, dtype=torch.float32, device=dev)
          - center_vu[..., 1:2]) / REL_NORM                  # (..., K, ws)
    rel = torch.stack([vv[..., :, None].expand(*lead, k, hs, ws),
                       uu[..., None, :].expand(*lead, k, hs, ws)], dim=-1)
    x = torch.cat([mfeat[..., None, :, :, :].expand(*lead, k, hs, ws,
                                                    MASK_DIM), rel], dim=-1)
    x = x.reshape(*lead, k, hs * ws, _CTRL_IN)
    (w1, b1), (w2, b2), (w3, b3) = _split_ctrl(ctrl)
    x = F.relu(x @ w1 + b1[..., None, :])
    x = F.relu(x @ w2 + b2[..., None, :])
    return (x @ w3 + b3[..., None, :])[..., 0].reshape(*lead, k, hs, ws)


class Detections(NamedTuple):
    """Top-k decoded detections (fixed k; filter by score on the host)."""

    bbox: torch.Tensor    # (B, K, 4) [v1, u1, v2, u2] image pixels
    score: torch.Tensor   # (B, K)
    cls: torch.Tensor     # (B, K) class index (0-based)
    center: torch.Tensor  # (B, K, 2) (v, u)
    mask: torch.Tensor | None = None  # (B, K, H/4, W/4) bool


def _top_k_jax_order(flat, k: int):
    """Top ``k`` along the last axis, ties to the lower index (the order
    of ``jax.lax.top_k``); a stable descending sort, so the order does not
    depend on the device's top-k."""
    score, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return score[..., :k], idx[..., :k]


def decode_detections(out: DetectorOut, top_k: int = 32, stride: int = 4,
                      with_masks: bool = True) -> Detections:
    """Heatmap peaks -> boxes (+ per-instance masks), fixed shapes."""
    heat = torch.sigmoid(out.heat)
    b, h, w, c = heat.shape
    pooled = F.max_pool2d(heat.permute(0, 3, 1, 2), 3, 1, padding=1) \
        .permute(0, 2, 3, 1)
    heat = torch.where(torch.abs(heat - pooled) < 1e-6, heat, 0.0)
    score, idx = _top_k_jax_order(heat.reshape(b, h * w * c), top_k)
    cls = idx % c
    pix = idx // c
    pv = (pix // w).to(torch.float32)
    pu = (pix % w).to(torch.float32)

    def gather_hw(maps):
        flat = maps.reshape(b, h * w, maps.shape[-1])
        return torch.gather(
            flat, 1, pix[..., None].expand(-1, -1, maps.shape[-1]))

    off = gather_hw(out.off)  # (B, K, 2)
    wh = gather_hw(out.wh)
    cv = (pv + off[..., 0]) * stride
    cu = (pu + off[..., 1]) * stride
    hh = torch.clamp(wh[..., 0], min=0.0) * stride
    ww = torch.clamp(wh[..., 1], min=0.0) * stride
    bbox = torch.stack([cv - hh / 2, cu - ww / 2, cv + hh / 2, cu + ww / 2],
                       dim=-1)
    masks = None
    if with_masks:
        ctrl = gather_hw(out.ctrl)
        grid_center = torch.stack([pv + off[..., 0], pu + off[..., 1]],
                                  dim=-1)
        logits = dynamic_mask_logits(out.mfeat, ctrl,
                                     grid_center)    # (B, K, hs, ws)
        # the mask lives inside its box (Mask-RCNN semantics)
        gv = torch.arange(h, dtype=torch.float32, device=heat.device) * stride
        gu = torch.arange(w, dtype=torch.float32, device=heat.device) * stride
        in_v = ((gv >= bbox[..., 0, None]) & (gv <= bbox[..., 2, None]))
        in_u = ((gu >= bbox[..., 1, None]) & (gu <= bbox[..., 3, None]))
        masks = (logits > 0.0) & in_v[..., :, None] & in_u[..., None, :]
    return Detections(bbox=bbox, score=score, cls=cls,
                      center=torch.stack([cv, cu], dim=-1), mask=masks)


def focal_loss(heat_logits, heat_gt, alpha: float = 2.0, beta: float = 4.0):
    """Penalty-reduced pixel-wise focal loss (CenterNet / CornerNet form).

    ``heat_gt`` is the splatted gaussian target in [0, 1]; only exact 1.0
    counts as a positive."""
    p = torch.sigmoid(heat_logits)
    pos = (heat_gt >= 1.0).to(torch.float32)
    neg_w = torch.pow(1.0 - heat_gt, beta)
    eps = 1e-6
    pos_loss = -torch.pow(1.0 - p, alpha) * torch.log(p + eps) * pos
    neg_loss = (-torch.pow(p, alpha) * torch.log(1.0 - p + eps) * neg_w
                * (1.0 - pos))
    n_pos = torch.clamp(pos.sum(), min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / n_pos


def instance_mask_loss(out: DetectorOut, gt_center, gt_mask, gt_valid):
    """Dice loss of the dynamic mask FCN at the GT centers (CondInst
    training: the controller gathered at each instance's rounded and
    clipped center, the target that instance's visible mask), over all
    B x K instances in one batched call.

    gt_center (B, K, 2) float grid centers; gt_mask (B, K, hs, ws) in
    {0, 1}; gt_valid (B, K) bool."""
    b, hs, ws, _ = out.mfeat.shape
    ci = torch.clamp(torch.round(gt_center[..., 0]).long(), 0, hs - 1)
    cj = torch.clamp(torch.round(gt_center[..., 1]).long(), 0, ws - 1)
    bi = torch.arange(b, device=ci.device)[:, None]
    ctrl = out.ctrl[bi, ci, cj]                              # (B, K, N)
    p = torch.sigmoid(dynamic_mask_logits(out.mfeat, ctrl, gt_center))
    inter = (p * gt_mask).sum((2, 3))
    denom = (p * p).sum((2, 3)) + (gt_mask * gt_mask).sum((2, 3))
    dice = 1.0 - 2.0 * inter / torch.clamp(denom, min=1e-6)
    valid = gt_valid.to(torch.bool)
    return (torch.where(valid, dice, 0.0).sum()
            / torch.clamp(valid.sum().to(torch.float32), min=1.0))


def detector_loss(out: DetectorOut, targets: dict, w_heat: float = 1.0,
                  w_wh: float = 0.1, w_off: float = 1.0, w_seg: float = 1.0,
                  w_mask: float = 1.0):
    """(total, parts). ``targets``: ``heat`` (B, h, w, C) gaussians,
    ``wh`` / ``off`` (B, h, w, 2), ``reg_mask`` (B, h, w) 1 at centers,
    ``seg`` (B, h, w, C) binary; with ``gt_center`` / ``gt_mask`` /
    ``gt_valid`` also the instance-mask term (``parts["mask"]``)."""
    l_heat = focal_loss(out.heat, targets["heat"])
    m = targets["reg_mask"][..., None]
    n_pos = torch.clamp(targets["reg_mask"].sum(), min=1.0)
    l_wh = (torch.abs(out.wh - targets["wh"]) * m).sum() / n_pos
    l_off = (torch.abs(out.off - targets["off"]) * m).sum() / n_pos
    seg = out.seg
    l_seg = torch.mean(F.relu(seg) - seg * targets["seg"]
                       + torch.log1p(torch.exp(-torch.abs(seg))))
    total = w_heat * l_heat + w_wh * l_wh + w_off * l_off + w_seg * l_seg
    parts = {"heat": l_heat, "wh": l_wh, "off": l_off, "seg": l_seg}
    if "gt_mask" in targets:
        l_mask = instance_mask_loss(out, targets["gt_center"],
                                    targets["gt_mask"], targets["gt_valid"])
        total = total + w_mask * l_mask
        parts["mask"] = l_mask
    return total, parts
