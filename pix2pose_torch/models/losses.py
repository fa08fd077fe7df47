"""Losses: the symmetry-aware transformer loss and the GAN BCE (port of
:mod:`pix2pose_tpu.models.losses`; reference
``pix2pose_model/ae_model.py:24-67`` and ``3_train_pix2pose.py:180,185``).

The transformer loss scores the predicted per-pixel coordinates against
the ground truth under every pose of the object's discrete-symmetry pool,
keeps the per-sample minimum, and couples the confidence head to the
per-pixel error::

  loss = 3 * visible * L1_xyz + (1 - visible) * L1_xyz
         + 0.5 * (prob - min(L1_xyz, 1))^2       averaged over pixels,

with ``L1_xyz`` the per-pixel mean-abs coordinate error under the best
symmetry pose and ``visible = prob_gt > 0.5``. Of equal per-symmetry
sums the first pool member wins, as with ``jnp.argmin``.
"""

from __future__ import annotations

import torch


def transformer_loss(pred_xyz, gt_xyz, prob_pred, prob_gt, sym_pool):
    """(B,) per-sample reconstruction loss.

    Args:
      pred_xyz: (B, H, W, 3) tanh output in [-1, 1].
      gt_xyz: (B, H, W, 3) target coordinate image in [-1, 1].
      prob_pred: (B, H, W, 1) sigmoid confidence/error output.
      prob_gt: (B, H, W, 1) visibility ground truth in [0, 1].
      sym_pool: (S, 3, 3) rotation pool; S = 1 (identity) for asymmetric
        objects.
    """
    pool = torch.as_tensor(sym_pool, dtype=pred_xyz.dtype,
                           device=pred_xyz.device)
    prob = prob_pred[..., 0]
    visible = (prob_gt[..., 0] > 0.5).to(pred_xyz.dtype)
    if pool.shape[0] > 1:
        # (S, B, H, W, 3): GT coordinates rotated into each symmetry frame
        gt_s = torch.einsum("sij,bhwj->sbhwi", pool, gt_xyz)
        diff = (gt_s - pred_xyz[None]).abs().mean(-1)     # (S, B, H, W)
        best = diff.sum((2, 3)).argmin(0)                 # (B,)
        loss_xyz = diff.gather(
            0, best[None, :, None, None].expand(1, *diff.shape[1:]))[0]
    else:
        loss_xyz = (gt_xyz - pred_xyz).abs().mean(-1)
    prob_loss = (prob - loss_xyz.clamp(max=1.0)).square()
    loss = (visible * loss_xyz * 3.0 + (1.0 - visible) * loss_xyz
            + 0.5 * prob_loss)
    return loss.mean((1, 2))


def bce_logits(logits, labels):
    """Mean binary cross-entropy on logits (Keras BCE); ``labels`` may be
    soft (label smoothing) and broadcast to the flattened logits."""
    logits = logits.reshape(-1)
    labels = torch.broadcast_to(
        torch.as_tensor(labels, dtype=logits.dtype, device=logits.device),
        logits.shape)
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()
