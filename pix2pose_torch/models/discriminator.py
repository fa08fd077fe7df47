"""DCGAN discriminator (port of :mod:`pix2pose_tpu.models.discriminator`;
reference ``pix2pose_model/ae_model.py:153-172``).

Seven stride-2 3x3 conv blocks (filters ``64 * min(8, 2**i)``: 64, 128,
256, then 512 x 4) with flax "SAME" padding, BatchNorm (eps 1e-3, flax
momentum 0.99) and LeakyReLU 0.2 (the AE's is 0.3), then flatten and one
linear unit. Returns the logit; the sigmoid lives in the loss
(:func:`pix2pose_torch.models.losses.bce_logits`).

Layout: NHWC in like the generator; the flatten reads NHWC order as the
flax ``Dense`` does. Module names match the flax tree, so
:func:`pix2pose_torch.utils.convert.flax_to_state_dict` loads it.
"""

from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from pix2pose_torch.models.ae import _same_pad
from pix2pose_torch.models.batchnorm import BatchNorm2d

_LEAK = 0.2
_BLOCKS = 7


class Discriminator(nn.Module):
    """(B, S, S, 3) NHWC in [-1, 1] -> (B, 1) float32 logits. ``im_size``
    fixes the linear layer's input, ``ceil(S / 2**7)**2 * 512`` (512 at
    128 px)."""

    def __init__(self, im_size: int = 128):
        super().__init__()
        cin, size = 3, im_size
        for i in range(_BLOCKS):
            feats = 64 * min(8, 2 ** i)
            setattr(self, f"conv{i + 1}", nn.Conv2d(cin, feats, 3, 2))
            setattr(self, f"bn{i + 1}",
                    BatchNorm2d(feats, eps=1e-3, momentum=0.01))
            cin, size = feats, -(-size // 2)
        self.fc = nn.Linear(cin * size * size, 1)

    def forward(self, x):
        # the generator hands over float32 images; compute in the weights'
        # dtype, as flax casts to the module's
        y = x.permute(0, 3, 1, 2).to(self.conv1.weight.dtype)
        for i in range(_BLOCKS):
            (t, b), (l, r) = (_same_pad(3, 2, y.shape[2]),
                              _same_pad(3, 2, y.shape[3]))
            y = getattr(self, f"conv{i + 1}")(F.pad(y, (l, r, t, b)))
            y = F.leaky_relu(getattr(self, f"bn{i + 1}")(y), _LEAK)
        y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
        return self.fc(y).float()
