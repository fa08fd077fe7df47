"""Plain float32 networks of the reference, as functions of a name -> tensor
dict in the program's checkpoint layout (the benchmark makes the weights
in that layout and hands the same dict to both sides).

Written from the published layer lists (``ae_model.py:70-172``) with
TensorFlow "SAME" padding. A transposed convolution is computed here as a
convolution over the zero-dilated input with the spatially flipped kernel,
not by ``conv_transpose2d``. BatchNorm: inference reads the running
statistics; training normalizes by the batch's biased variance and moves
the running statistics by 0.01 towards the batch's (Keras momentum 0.99).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def same_pad(x, k: int, stride: int):
    h, w = x.shape[2], x.shape[3]

    def lo_hi(size):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        return total // 2, total - total // 2

    (t, b), (l, r) = lo_hi(h), lo_hi(w)
    return F.pad(x, (l, r, t, b))


def conv_same(x, w, b, stride: int):
    return F.conv2d(same_pad(x, w.shape[-1], stride), w, b, stride)


def deconv_same(x, w, b):
    """5x5/2 transposed conv, "SAME" (output 2H x 2W), for a kernel stored
    (in, out, k, k) with torch's transposed-conv meaning, padding 1."""
    n, c, h, wd = x.shape
    k = w.shape[-1]
    xd = x.new_zeros((n, c, 2 * h - 1, 2 * wd - 1))
    xd[:, :, ::2, ::2] = x
    p = k - 1 - 1
    xd = F.pad(xd, (p, p, p, p))
    y = F.conv2d(xd, w.flip(2, 3).transpose(0, 1), b)
    return y[:, :, :2 * h, :2 * wd]


class BN:
    """BatchNorm over a dict of parameters; ``stats`` collects the train-mode
    running statistics it computes (name -> (mean, var))."""

    def __init__(self, p: dict, train: bool, eps: float):
        self.p, self.train, self.eps = p, train, eps
        self.new_stats: dict = {}

    def __call__(self, x, name: str):
        g, b = self.p[name + ".weight"], self.p[name + ".bias"]
        if self.train:
            mean = x.mean((0, 2, 3))
            var = ((x - mean[None, :, None, None]) ** 2).mean((0, 2, 3))
            rm, rv = self.p[name + ".running_mean"], \
                self.p[name + ".running_var"]
            self.new_stats[name + ".running_mean"] = \
                0.99 * rm + 0.01 * mean.detach()
            self.new_stats[name + ".running_var"] = \
                0.99 * rv + 0.01 * var.detach()
        else:
            mean, var = self.p[name + ".running_mean"], \
                self.p[name + ".running_var"]
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None]) * (inv * g)[None, :, None,
                                                             None]
                + b[None, :, None, None])


def _cba(p, bn, x, name, stride, leak=0.3):
    y = conv_same(x, p[name + ".conv.weight"], p[name + ".conv.bias"], stride)
    return F.leaky_relu(bn(y, name + ".bn"), leak)


def _dba(p, bn, x, name):
    y = deconv_same(x, p[name + ".deconv.weight"], p[name + ".deconv.bias"])
    return F.leaky_relu(bn(y, name + ".bn"), 0.3)


def _resnet_trunk(p, bn_r, x):
    def c(x, name, stride, pad):
        return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride,
                        pad)

    t = "encoder.trunk."
    f1 = F.relu(bn_r(c(x, t + "stem_conv", 2, 3), t + "stem_bn"))
    y = F.max_pool2d(f1, 3, 2, padding=1)
    taps = []
    for stage, n_blocks in ((2, 3), (3, 4)):
        for i in range(n_blocks):
            nm = f"{t}s{stage}_b{i}."
            stride = 2 if (stage == 3 and i == 0) else 1
            sc = (bn_r(c(y, nm + "proj_conv", stride, 0), nm + "proj_bn")
                  if i == 0 else y)
            z = F.relu(bn_r(c(y, nm + "conv_a", stride, 0), nm + "bn_a"))
            z = F.relu(bn_r(c(z, nm + "conv_b", 1, 1), nm + "bn_b"))
            y = F.relu(bn_r(c(z, nm + "conv_c", 1, 0), nm + "bn_c") + sc)
        taps.append(y)
    return f1, taps[0], taps[1]


def generator(p: dict, x, backbone: str, train: bool = False):
    """(B, 128, 128, 3) in [-1, 1] -> (xyz (B, 128, 128, 3) tanh, error
    (B, 128, 128, 1) sigmoid) and the train-mode running statistics."""
    bn = BN(p, train, 1e-3)
    y = x.permute(0, 3, 1, 2)
    if backbone == "paper":
        skips = []
        for s in range(4):
            a = _cba(p, bn, y, f"encoder.e{s + 1}_1", 2)
            b = _cba(p, bn, y, f"encoder.e{s + 1}_2", 2)
            y = torch.cat([a, b], 1)
            skips.append(b)
        s1, s2, s3 = skips[:3]
    else:
        bn_r = BN(p, train, 1.001e-5)
        f1, f2, f3 = _resnet_trunk(p, bn_r, y)
        y = torch.cat([_cba(p, bn, f3, "encoder.e4_1", 2),
                       _cba(p, bn, f3, "encoder.e4_2", 2)], 1)
        s1, s2, s3 = f1[:, :32], f2[:, :128], f3[:, :128]
        bn.new_stats.update(bn_r.new_stats)
    n = y.shape[0]
    z = y.permute(0, 2, 3, 1).reshape(n, -1) @ p["fc_enc.weight"].T \
        + p["fc_enc.bias"]
    z = z @ p["fc_dec.weight"].T + p["fc_dec.bias"]
    y = z.reshape(n, 8, 8, 256).permute(0, 3, 1, 2)
    y = _cba(p, bn, torch.cat([_dba(p, bn, y, "d1"), s3], 1), "d1_uni", 1)
    y = _cba(p, bn, torch.cat([_dba(p, bn, y, "d2"), s2], 1), "d2_uni", 1)
    y = _cba(p, bn, torch.cat([_dba(p, bn, y, "d3"), s1], 1), "d3_uni", 1)
    xyz = torch.tanh(deconv_same(y, p["head_xyz.weight"], p["head_xyz.bias"]))
    prob = torch.sigmoid(deconv_same(y, p["head_prob.weight"],
                                     p["head_prob.bias"]))
    return (xyz.permute(0, 2, 3, 1), prob.permute(0, 2, 3, 1),
            bn.new_stats)


def discriminator(p: dict, x, train: bool = True):
    """(B, 128, 128, 3) -> (B,) logits and the train-mode statistics:
    seven 3x3/2 "SAME" conv + BatchNorm + LeakyReLU(0.2) blocks, flatten in
    (H, W, C) order, one linear unit."""
    bn = BN(p, train, 1e-3)
    y = x.permute(0, 3, 1, 2)
    for i in range(1, 8):
        y = conv_same(y, p[f"conv{i}.weight"], p[f"conv{i}.bias"], 2)
        y = F.leaky_relu(bn(y, f"bn{i}"), 0.2)
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
    return (y @ p["fc.weight"].T + p["fc.bias"])[:, 0], bn.new_stats
