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

Data parallel: inside :func:`synced_over` a network's train-mode
BatchNorms normalize with the statistics of the whole batch spread over a
process group (sum and centred sum of squares all-reduced with autograd,
so the gradients flow through them as in one process), which is what a
one-program step over the global batch computes; ``nn.SyncBatchNorm``
would fold the unbiased variance into the running statistics.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
import torch.nn.functional as F


@contextlib.contextmanager
def synced_over(group, *nets: nn.Module):
    """The :class:`BatchNorm2d` layers of ``nets`` take their train-mode
    statistics over ``group`` (a ``torch.distributed`` process group;
    None: this process's batch) while the block runs."""
    layers = [m for net in nets for m in net.modules()
              if isinstance(m, BatchNorm2d)]
    prev = [m.sync_group for m in layers]
    for m in layers:
        m.sync_group = group
    try:
        yield
    finally:
        for m, g in zip(layers, prev):
            m.sync_group = g


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update uses the biased batch
    variance (``running = (1 - m) * running + m * batch``, ``m`` the torch
    momentum; flax momentum 0.99 is torch momentum 0.01). The statistics
    are taken in float32 or wider, whatever the input's dtype.
    ``sync_group`` (set by :func:`synced_over`) spreads them over a
    process group."""

    sync_group = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if self.sync_group is not None:
            return self._synced_forward(x, self.sync_group)
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

    def _synced_forward(self, x, group):
        """Train-mode forward over ``group``'s whole batch: the mean, then
        the biased variance from the centred sum of squares, each summed
        over the group (differentiable all-reduce)."""
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        n = xf.numel() // xf.shape[1] * dist.get_world_size(group)
        mean = all_reduce(xf.sum((0, 2, 3)), group=group) / n
        d = xf - mean[None, :, None, None]
        var = all_reduce((d * d).sum((0, 2, 3)), group=group) / n
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (1.0 / float(self.num_batches_tracked)
                 if self.momentum is None else self.momentum)
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        y = d * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] \
                + self.bias[None, :, None, None]
        return y.to(x.dtype)
