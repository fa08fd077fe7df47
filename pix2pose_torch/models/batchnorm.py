"""BatchNorm with flax's running-statistics update.

In train mode ``torch.nn.BatchNorm2d`` folds the UNBIASED batch variance
(divided by n - 1) into ``running_var``; flax ``nn.BatchNorm`` folds the
biased one (divided by n), as Keras does. The normalization itself uses
the biased variance in both. Inference only reads the running statistics,
so the difference shows once a network trains: at batch B a 1x1 feature
map (the discriminator's last block) has n = B, and its running variance
would grow by B / (B - 1) on every update.

:class:`BatchNorm2d` keeps torch's module, parameter and buffer names (so
checkpoints load as before) and its eval-mode forward; only the train-mode
update of the running statistics changes.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update uses the biased batch
    variance (``running = (1 - m) * running + m * batch``, ``m`` the torch
    momentum; flax momentum 0.99 is torch momentum 0.01). The statistics
    are taken in float32 or wider, whatever the input's dtype."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(
                x.to(torch.promote_types(x.dtype, torch.float32)),
                dim=(0, 2, 3), correction=0)
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)
