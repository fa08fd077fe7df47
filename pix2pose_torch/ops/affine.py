"""Affine bilinear resampling on the device (port of the gather form of
:mod:`pix2pose_tpu.ops.affine`).

The training-batch synthesis warps each sample with one 2x3 map
(rotation + scale + translation), the reference's host-side skimage
crop / rotate / resize chain (``pix2pose_util/data_io.py:264-272``) fused
into one sampling step. On the GPU this is a 4-tap gather, batched over
the samples. The JAX package's banded-matmul twin (``affine_sample_mm``)
exists only to avoid gathers on the TPU and is not ported; at axis-aligned
angles the two agree to float32 rounding, otherwise within its two-pass
footprint.
"""

from __future__ import annotations

import torch


def affine_sample(img, mat, out_h: int, out_w: int, fill: float = 0.0):
    """Sample ``img`` at ``mat @ [i, j, 1]`` for each output pixel (i, j).

    Args:
      img: (B, H, W, C) source.
      mat: (B, 2, 3) output -> source coordinate maps (row, col convention).
      fill: value outside the source.

    Returns:
      (B, out_h, out_w, C).
    """
    b, h, w, c = img.shape
    dev = img.device
    ii = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    m = mat.to(torch.float32)[:, :, :, None, None]          # (B, 2, 3, 1, 1)
    sv = m[:, 0, 0] * ii + m[:, 0, 1] * jj + m[:, 0, 2]     # (B, oh, ow)
    su = m[:, 1, 0] * ii + m[:, 1, 1] * jj + m[:, 1, 2]
    v0f, u0f = torch.floor(sv), torch.floor(su)
    fv, fu = sv - v0f, su - u0f
    v0, u0 = v0f.to(torch.int64), u0f.to(torch.int64)
    flat = img.reshape(b, h * w, c)

    def tap(vi, ui):
        ok = (vi >= 0) & (vi < h) & (ui >= 0) & (ui < w)
        idx = vi.clamp(0, h - 1) * w + ui.clamp(0, w - 1)
        val = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        val = val.reshape(b, out_h, out_w, c)
        return torch.where(ok[..., None], val, torch.full_like(val, fill))

    return (tap(v0, u0) * ((1 - fv) * (1 - fu))[..., None]
            + tap(v0, u0 + 1) * ((1 - fv) * fu)[..., None]
            + tap(v0 + 1, u0) * (fv * (1 - fu))[..., None]
            + tap(v0 + 1, u0 + 1) * (fv * fu)[..., None])


def make_affine(center_src, center_out, scale, angle_rad):
    """(B, 2, 3) maps: output px -> source px with rotation ``angle_rad``
    (B,) and uniform ``scale`` (B,) (source px per output px) about
    ``center_src`` and ``center_out``, each (B, 2) or one (2,) pair for
    all."""
    dev = angle_rad.device
    center_src = torch.as_tensor(center_src, dtype=torch.float32, device=dev)
    center_out = torch.as_tensor(center_out, dtype=torch.float32, device=dev)
    c = torch.cos(angle_rad) * scale
    s = torch.sin(angle_rad) * scale
    # [sv; su] = R_scaled @ ([i; j] - center_out) + center_src
    a00, a01, a10, a11 = c, -s, s, c
    b0 = center_src[..., 0] - (a00 * center_out[..., 0]
                               + a01 * center_out[..., 1])
    b1 = center_src[..., 1] - (a10 * center_out[..., 0]
                               + a11 * center_out[..., 1])
    return torch.stack([torch.stack([a00, a01, b0], -1),
                        torch.stack([a10, a11, b1], -1)], 1)
