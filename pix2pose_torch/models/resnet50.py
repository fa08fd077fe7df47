"""ResNet-50 trunk with tappable stage activations (port of
:mod:`pix2pose_tpu.models.resnet50`).

Stages 1-3 of ResNet-50 (the BOP'20 encoder and the detector never run
stages 4/5), returning the three U-Net taps (reference
``pix2pose_model/resnet50_mod.py:40-279``, taps at ``ae_model.py:178-188``).
For a 128x128 input: stem ReLU (64, 64, 64), stage-2 block c
(256, 32, 32), stage-3 block d (512, 16, 16), NCHW.

Hazards kept from the flax graph: BatchNorm eps is 1.001e-5 (keras
ResNet50; the AE's own layers use 1e-3), every conv has a bias (flax
``nn.Conv`` default), and the bottleneck's stride sits on the 1x1
``conv_a`` and on ``proj_conv``, not on the 3x3. Module names match the
flax tree, so :func:`pix2pose_torch.utils.convert.flax_to_state_dict`
loads it. Layout: NCHW in, NCHW out.
"""

from __future__ import annotations

import numpy as np
from torch import nn
import torch.nn.functional as F

from pix2pose_torch.models.batchnorm import BatchNorm2d

_BN_EPS = 1.001e-5


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=_BN_EPS, momentum=0.01)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual block; ``project`` adds a strided 1x1
    projection on the shortcut (keras ``conv_block``), else an identity
    shortcut (``identity_block``)."""

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 project: bool = False):
        super().__init__()
        self.project = project
        if project:
            self.proj_conv = nn.Conv2d(cin, filters * 4, 1, stride)
            self.proj_bn = _bn(filters * 4)
        self.conv_a = nn.Conv2d(cin, filters, 1, stride)
        self.bn_a = _bn(filters)
        self.conv_b = nn.Conv2d(filters, filters, 3, 1, padding=1)
        self.bn_b = _bn(filters)
        self.conv_c = nn.Conv2d(filters, filters * 4, 1)
        self.bn_c = _bn(filters * 4)

    def forward(self, x):
        shortcut = self.proj_bn(self.proj_conv(x)) if self.project else x
        y = F.relu(self.bn_a(self.conv_a(x)))
        y = F.relu(self.bn_b(self.conv_b(y)))
        return F.relu(self.bn_c(self.conv_c(y)) + shortcut)


def space_to_depth(x, block: int = 2):
    """NCHW (B, C, H, W) -> (B, b*b*C, H/b, W/b) with the flax function's
    channel layout ``(qv, qu, c)`` row-major within each block."""
    b, c, h, w = x.shape
    if h % block or w % block:
        raise ValueError(f"space_to_depth: {tuple(x.shape)} not divisible "
                         f"by {block}")
    x = x.reshape(b, c, h // block, block, w // block, block)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, block * block * c, h // block, w // block)


def s2d_stem_kernel(k7):
    """Remap a classic (7, 7, C, 64) HWIO stride-2 stem kernel into the
    exactly equivalent (4, 4, 4*C, 64) kernel of the space-to-depth stem
    (numpy, flax layout). Input index m = 2i + (a - 3) in block
    coordinates m = 2p + q gives block offset (a - 3)//2 + 2 in 0..3 and
    parity (a - 3) % 2."""
    k7 = np.asarray(k7)
    kh, kw, c, co = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"s2d_stem_kernel: kernel {k7.shape}")
    k2 = np.zeros((4, 4, 4 * c, co), k7.dtype)
    for a in range(7):
        for b in range(7):
            pv, qv = (a - 3) // 2 + 2, (a - 3) % 2
            pu, qu = (b - 3) // 2 + 2, (b - 3) % 2
            s = (qv * 2 + qu) * c
            k2[pv, pu, s:s + c] = k7[a, b]
    return k2


class ResNet50Trunk(nn.Module):
    """Stages 1-3 of ResNet-50 -> (f1, f2, f3) at strides 2, 4, 8.

    ``stem_s2d`` computes the stem as a 4x4/1 conv over
    ``space_to_depth(x)`` (12 input channels) with asymmetric padding
    (2, 1), the layout the in-repo detector is trained with; a trained
    s2d kernel has no 7x7 preimage, so it is kept as it is. The classic
    stem is a 7x7/2 conv padded 3, then a 3x3/2 max-pool padded 1 with
    -inf (as ``nn.max_pool``)."""

    def __init__(self, stage_blocks=(3, 4), stem_s2d: bool = False):
        super().__init__()
        self.stem_s2d = stem_s2d
        if stem_s2d:
            self.stem_conv = nn.Conv2d(12, 64, 4)
        else:
            self.stem_conv = nn.Conv2d(3, 64, 7, 2, padding=3)
        self.stem_bn = _bn(64)
        self.s2_b0 = Bottleneck(64, 64, stride=1, project=True)
        for i in range(1, stage_blocks[0]):
            setattr(self, f"s2_b{i}", Bottleneck(256, 64))
        self.s3_b0 = Bottleneck(256, 128, stride=2, project=True)
        for i in range(1, stage_blocks[1]):
            setattr(self, f"s3_b{i}", Bottleneck(512, 128))
        self.stage_blocks = tuple(stage_blocks)

    def forward(self, x):
        if self.stem_s2d:
            # block row i needs input blocks i-2..i+1 -> pad (2, 1)
            y = self.stem_conv(F.pad(space_to_depth(x), (2, 1, 2, 1)))
        else:
            y = self.stem_conv(x)
        f1 = F.relu(self.stem_bn(y))
        y = F.max_pool2d(f1, 3, 2, padding=1)
        for i in range(self.stage_blocks[0]):
            y = getattr(self, f"s2_b{i}")(y)
        f2 = y
        for i in range(self.stage_blocks[1]):
            y = getattr(self, f"s3_b{i}")(y)
        return f1, f2, y
