"""Texture sampling for the textured render (port of
:mod:`pix2pose_tpu.ops.texture`).

The reference renders UV-textured models through GLSL
(``rendering/renderer.py:50-79``: ``texture2D(u_tex, v_texcoord)`` with the
texture image flipped vertically at load time, ``rendering/model.py:103``,
OpenGL's v-up convention). Here the rasterizer interpolates the UV
attribute per pixel (perspective-correct, like a GL varying) and this
module does the sampler's job as one batched bilinear gather in plain
PyTorch indexing.
"""

from __future__ import annotations

import torch


def sample_texture(tex, uv, flip_v: bool = True):
    """Bilinear texture lookup (GL ``texture2D`` semantics, clamp-to-edge).

    Args:
      tex: (Ht, Wt, C) texture image in image-row order (row 0 = TOP of
        the picture, as decoders emit it). The GL flip (``model.py:103``)
        is folded into the coordinate transform via ``flip_v`` instead of
        flipping the array.
      uv: (..., 2) texture coordinates on the same device; u right, v UP
        from the bottom edge (GL convention) when ``flip_v`` is True.

    Returns:
      (..., C) float32 bilinearly interpolated texels.
    """
    tex = torch.as_tensor(tex, dtype=torch.float32, device=uv.device)
    ht, wt = tex.shape[0], tex.shape[1]
    u = torch.clamp(uv[..., 0], 0.0, 1.0)
    v = torch.clamp(uv[..., 1], 0.0, 1.0)
    # texel-center sampling: u in [0, 1] spans [-0.5, Wt - 0.5] texel space
    x = u * wt - 0.5
    y = ((1.0 - v) if flip_v else v) * ht - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # clamp-to-edge: x1 clamps from the UNclamped floor, so coordinates
    # past the edge collapse both taps onto the edge texel
    xi, yi = x0f.to(torch.int64), y0f.to(torch.int64)
    x0 = torch.clamp(xi, 0, wt - 1)
    y0 = torch.clamp(yi, 0, ht - 1)
    x1 = torch.clamp(xi + 1, 0, wt - 1)
    y1 = torch.clamp(yi + 1, 0, ht - 1)
    top = tex[y0, x0] * (1.0 - fx) + tex[y0, x1] * fx
    bot = tex[y1, x0] * (1.0 - fx) + tex[y1, x1] * fx
    return top * (1.0 - fy) + bot * fy
