"""Pix2Pose autoencoder generator, both backbones (port of
:mod:`pix2pose_tpu.models.ae`).

- ``paper`` (reference Keras graph ``pix2pose_model/ae_model.py:70-150``):
  four stages of paired stride-2 5x5 convs (both convs of a stage read the
  previous stage's concat; channels 128/256/256/512 at 64/32/16/8
  squared), bottleneck Flatten -> Dense(256) -> Dense(8*8*256), three
  decoder stages of ConvTranspose 5x5/2 + skip concat (second conv of the
  matching encoder stage) + 5x5 conv, and two ConvTranspose heads: tanh
  XYZ and sigmoid error.
- ``resnet50`` (BOP'20, ``ae_model.py:175-240``): the encoder is ResNet-50
  stages 1-3 plus one paired 5x5/2 stage (16 -> 8, 512 channels); the
  skips are channel slices [:32] / [:128] / [:128] of the stage taps; the
  bottleneck and decoder are the paper's.

Layout: the public forward takes and returns NHWC like the JAX package;
inside it runs NCHW for cuDNN. Module names match the flax tree so
:func:`pix2pose_torch.utils.convert.flax_to_state_dict` is a renaming plus
layout changes. BatchNorm eps is Keras' 1e-3 (momentum 0.99 in Keras is
0.01 in torch; the running variance takes the biased batch variance, as
flax's does, :mod:`pix2pose_torch.models.batchnorm`); LeakyReLU slope is
0.3.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
import torch.nn.functional as F

from pix2pose_torch.models.batchnorm import BatchNorm2d
from pix2pose_torch.models.resnet50 import ResNet50Trunk

_LEAK = 0.3


@contextlib.contextmanager
def deterministic_cudnn(on: bool = True):
    """cuDNN's deterministic algorithms while the block runs (``on``),
    the caller's setting afterwards. The generator's training step and
    its inference pass run under it: the default GPU algorithms of its
    transposed convolutions, forward and backward, sum with atomics, so
    two float32 trainings of one seed, or two passes over the same crops,
    gave different weights and poses. The detectors' training steps run
    under it too: their convolutions' backward, the one operation of the
    step without a deterministic default, made two trainings of one seed
    differ. The detector's inference pass does not need it."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _same_pad(k: int, stride: int, size: int):
    """(lo, hi) padding of TF/flax "SAME" for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class _ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 5,
                 stride: int = 1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv2d(cin, cout, kernel, stride)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.01)

    def forward(self, x):
        (t, b), (l, r) = (_same_pad(self.kernel, self.stride, x.shape[2]),
                          _same_pad(self.kernel, self.stride, x.shape[3]))
        y = self.conv(F.pad(x, (l, r, t, b)))
        return F.leaky_relu(self.bn(y), _LEAK)


class _ConvTransposeSame(nn.ConvTranspose2d):
    """flax ``ConvTranspose((5, 5), strides=2, padding="SAME")``: torch's
    transposed conv with padding 1, cut to the first 2H x 2W outputs (the
    weights are the flax kernel spatially flipped; see the converter)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 5, stride=2, padding=1)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        return super().forward(x)[:, :, :2 * h, :2 * w]


class _DeconvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = _ConvTransposeSame(cin, cout)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.01)

    def forward(self, x):
        return F.leaky_relu(self.bn(self.deconv(x)), _LEAK)


class PairedConvEncoder(nn.Module):
    """The paper's twin-conv encoder (``ae_model.py:74-106``). Returns the
    8x8x512 bottleneck input and the three skips (second conv of stages
    1-3), NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        for stage, ch in enumerate((64, 128, 128, 256)):
            setattr(self, f"e{stage + 1}_1", _ConvBNAct(cin, ch, stride=2))
            setattr(self, f"e{stage + 1}_2", _ConvBNAct(cin, ch, stride=2))
            cin = 2 * ch

    def forward(self, x):
        skips = []
        for stage in range(4):
            a = getattr(self, f"e{stage + 1}_1")(x)
            b = getattr(self, f"e{stage + 1}_2")(x)
            x = torch.cat([a, b], dim=1)
            skips.append(b)
        return x, (skips[0], skips[1], skips[2])


class ResNetEncoder(nn.Module):
    """BOP'20 encoder: ResNet-50 taps + one paired stage to 8x8x512
    (``ae_model.py:178-196``). Returns the bottleneck input and the
    channel-sliced skips, NCHW."""

    def __init__(self):
        super().__init__()
        self.trunk = ResNet50Trunk()
        self.e4_1 = _ConvBNAct(512, 256, stride=2)
        self.e4_2 = _ConvBNAct(512, 256, stride=2)

    def forward(self, x):
        f1, f2, f3 = self.trunk(x)
        feats = torch.cat([self.e4_1(f3), self.e4_2(f3)], dim=1)
        return feats, (f1[:, :32], f2[:, :128], f3[:, :128])


class AutoEncoder(nn.Module):
    """Generator: (B, 128, 128, 3) NHWC in [-1, 1] -> (xyz (B, 128, 128, 3)
    in [-1, 1], error (B, 128, 128, 1) in [0, 1])."""

    def __init__(self, backbone: str = "paper", bottleneck: int = 256):
        super().__init__()
        if backbone == "paper":
            self.encoder, skip1 = PairedConvEncoder(), 64
        elif backbone == "resnet50":
            self.encoder, skip1 = ResNetEncoder(), 32
        else:
            raise ValueError(f"backbone {backbone!r}: 'paper' or 'resnet50'")
        self.fc_enc = nn.Linear(8 * 8 * 512, bottleneck)
        self.fc_dec = nn.Linear(bottleneck, 8 * 8 * 256)
        self.d1 = _DeconvBNAct(256, 256)
        self.d1_uni = _ConvBNAct(256 + 128, 256)
        self.d2 = _DeconvBNAct(256, 128)
        self.d2_uni = _ConvBNAct(128 + 128, 256)
        self.d3 = _DeconvBNAct(256, 64)
        self.d3_uni = _ConvBNAct(64 + skip1, 128)
        self.head_xyz = _ConvTransposeSame(128, 3)
        self.head_prob = _ConvTransposeSame(128, 1)

    def bottleneck(self, feats):
        """(B, 512, 8, 8) NCHW encoder output -> (B, 256, 8, 8) decoder
        input. The flax Dense layers read an NHWC flatten and write an
        NHWC reshape."""
        b = feats.shape[0]
        z = self.fc_enc(feats.permute(0, 2, 3, 1).reshape(b, -1))
        return self.fc_dec(z).reshape(b, 8, 8, 256).permute(0, 3, 1, 2)

    def forward(self, x):
        feats, (s1, s2, s3) = self.encoder(x.permute(0, 3, 1, 2))
        y = self.bottleneck(feats)
        y = self.d1_uni(torch.cat([self.d1(y), s3], dim=1))
        y = self.d2_uni(torch.cat([self.d2(y), s2], dim=1))
        y = self.d3_uni(torch.cat([self.d3(y), s1], dim=1))
        xyz = torch.tanh(self.head_xyz(y))
        prob = torch.sigmoid(self.head_prob(y))
        return (xyz.permute(0, 2, 3, 1).float(),
                prob.permute(0, 2, 3, 1).float())


def build_generator(backbone: str = "paper") -> AutoEncoder:
    """The inference generator, in eval mode (BatchNorm uses its running
    statistics)."""
    return AutoEncoder(backbone=backbone).eval()
