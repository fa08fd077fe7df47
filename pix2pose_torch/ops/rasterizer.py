"""Triangle rasterizer front end (port of :mod:`pix2pose_tpu.ops.rasterizer`):
depth + mask + perspective-correct vertex attributes, and the textured
render built on them.

Conventions match the reference renderers: OpenCV pinhole projection
(u = fx x/z + cx), camera looks down +z, depth 0 = background.

Two rasterizers:

- :func:`rasterize`, the windowed chunked scan: faces in fixed chunks, each
  chunk tested against every window pixel as dense tensor math and folded
  into the carried z-buffer with a z-min. Plain PyTorch (the JAX package
  runs it as XLA, not as a Pallas kernel), for any device.
- :func:`pix2pose_torch.ops.rasterizer_cuda.rasterize_binned`, full frames:
  the hand-written CUDA kernel for CUDA tensors, its plain PyTorch version
  for CPU tensors.

:func:`render_mesh` renders full frames through the binned entry; the
scan serves windows (the rasterizer benchmark's ``scan`` row).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RenderOut(NamedTuple):
    depth: torch.Tensor   # (..., h, w) float32, 0 = background
    attr: torch.Tensor    # (..., h, w, C) interpolated vertex attributes
    mask: torch.Tensor    # (..., h, w) bool
    # dropped work pairs of a capacity-limited rasterizer. The port's
    # kernel walks every overlapping chunk, so this is always 0; the field
    # stays so callers keep checking it.
    overflow: torch.Tensor | int = 0


def project_vertices(verts, R, t, K):
    """Model-space vertices (..., V, 3) -> (uv (..., V, 2), z (..., V)).

    X_cam = R X + t, u = fx x/z + skew y/z + cx, v = fy y/z + cy; R is
    (..., 3, 3) and t (..., 3) with the same leading axes as ``verts``."""
    p = verts @ R.transpose(-1, -2) + t[..., None, :]
    z = p[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = K[0, 0] * p[..., 0] / zs + K[0, 1] * p[..., 1] / zs + K[0, 2]
    v = K[1, 1] * p[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def _pad_faces(faces, chunk: int):
    f = faces.shape[0]
    pad = (-f) % chunk
    if pad:
        faces = torch.cat([faces, torch.full((pad, 3), -1, dtype=faces.dtype,
                                             device=faces.device)])
    return faces, (f + pad) // chunk


def rasterize(uv, z, faces, attrs, h: int, w: int, v0=0, u0=0,
              chunk: int = 128, far: float = 1e9) -> RenderOut:
    """Rasterize one projected mesh into an (h, w) window at offset
    (v0, u0): the chunked scan of the JAX package's ``rasterize``.

    Args:
      uv: (V, 2) projected pixel coords (full-image frame).
      z: (V,) camera-space depths (> 0 in front).
      faces: (F, 3) int vertex indices; index -1 marks padding.
      attrs: (V, C) per-vertex attributes (e.g. XYZ colors).
      h, w: window size. v0, u0: window origin. chunk: faces per step.

    Per pixel the nearest covering face wins (z-min, strict ``<`` across
    chunks, first face within a chunk); coverage tests ``0 <= a, b, c <= 1``
    on barycentrics computed with a division per pixel and face, unlike
    the kernels' affine 1/z max, so edge and tie pixels can differ from
    them. Temporaries are (h*w, chunk).

    Returns :class:`RenderOut` with window-frame depth/attr/mask.
    """
    from pix2pose_torch.ops.smallmat import first_argmax

    dev = uv.device
    uv = uv.to(torch.float32)
    z = z.to(torch.float32)
    attrs = attrs.to(torch.float32)
    n_attr = attrs.shape[-1]
    faces, n_chunks = _pad_faces(faces.to(torch.int64), chunk)

    # pixel centers in full-image coordinates
    pv = torch.arange(h, dtype=torch.float32, device=dev) + float(v0)
    pu = torch.arange(w, dtype=torch.float32, device=dev) + float(u0)
    px_u = pu[None, :].expand(h, w).reshape(-1, 1)          # (N, 1)
    px_v = pv[:, None].expand(h, w).reshape(-1, 1)

    zbuf = torch.full((h * w,), far, dtype=torch.float32, device=dev)
    abuf = torch.zeros((h * w, n_attr), dtype=torch.float32, device=dev)
    for fc in faces.view(n_chunks, chunk, 3):
        valid_f = fc[:, 0] >= 0
        idx = torch.clamp(fc, min=0)
        tri_uv = uv[idx]        # (chunk, 3, 2)
        tri_z = z[idx]          # (chunk, 3)
        tri_a = attrs[idx]      # (chunk, 3, C)

        u1, u2, u3 = tri_uv[:, 0, 0], tri_uv[:, 1, 0], tri_uv[:, 2, 0]
        v1, v2, v3 = tri_uv[:, 0, 1], tri_uv[:, 1, 1], tri_uv[:, 2, 1]
        den = (v2 - v3) * (u1 - u3) + (u3 - u2) * (v1 - v3)  # (chunk,)
        den_ok = torch.abs(den) > 1e-12
        den = torch.where(den_ok, den, 1.0)

        du = px_u - u3           # (N, chunk)
        dv = px_v - v3
        a = ((v2 - v3) * du + (u3 - u2) * dv) / den
        b = ((v3 - v1) * du + (u1 - u3) * dv) / den
        c = 1.0 - a - b
        cover = ((a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
                 & (c >= 0) & (c <= 1)
                 & (den_ok & valid_f & (tri_z > 0).all(dim=1)))

        # perspective-correct interpolation: linear in (1/z, attr/z)
        inv_z = 1.0 / torch.clamp(tri_z, min=1e-9)   # (chunk, 3)
        inv_zi = a * inv_z[:, 0] + b * inv_z[:, 1] + c * inv_z[:, 2]
        zi = 1.0 / torch.clamp(inv_zi, min=1e-12)    # (N, chunk)
        zi = torch.where(cover, zi, far)

        amin = first_argmax(-zi, dim=1)              # first minimum
        zmin = zi.gather(1, amin[:, None])[:, 0]
        take = zmin < zbuf

        # attributes of the winning face, perspective-correct
        aw = a.gather(1, amin[:, None])[:, 0]
        bw = b.gather(1, amin[:, None])[:, 0]
        cw = 1.0 - aw - bw
        fa = tri_a[amin]          # (N, 3, C)
        fz = inv_z[amin]          # (N, 3)
        num = (aw[:, None] * fa[:, 0] * fz[:, 0:1]
               + bw[:, None] * fa[:, 1] * fz[:, 1:2]
               + cw[:, None] * fa[:, 2] * fz[:, 2:3])
        denom = aw * fz[:, 0] + bw * fz[:, 1] + cw * fz[:, 2]
        attr_pix = num / torch.clamp(denom, min=1e-12)[:, None]

        zbuf = torch.where(take, zmin, zbuf)
        abuf = torch.where(take[:, None], attr_pix, abuf)

    mask = zbuf < far
    depth = torch.where(mask, zbuf, 0.0).reshape(h, w)
    attr = torch.where(mask[:, None], abuf, 0.0).reshape(h, w, n_attr)
    return RenderOut(depth=depth, attr=attr, mask=mask.reshape(h, w))


def render_mesh(verts, faces, attrs, R, t, K, h: int, w: int) -> RenderOut:
    """Pose + project + rasterize a full (h, w) frame.

    Args:
      verts: (V, 3) or (P, V, 3) vertices. faces: (F, 3) or (P, F, 3) int
        indices, -1 = padding (wraps to the last vertex and is degenerate,
        as in the JAX package). attrs: (V, C) or (P, V, C).
      R, t: (3, 3)/(3,) or (P, 3, 3)/(P, 3) poses (t in vertex units).
      K: (3, 3) intrinsics.

    Goes to the binned entry
    (:func:`~pix2pose_torch.ops.rasterizer_cuda.rasterize_binned`: the
    CUDA kernel for CUDA tensors). Returns :class:`RenderOut`, with a
    leading P axis when the inputs have one.
    """
    from pix2pose_torch.ops.rasterizer_cuda import rasterize_binned

    batched = verts.dim() == 3
    if not batched:
        verts, faces, attrs = verts[None], faces[None], attrs[None]
        R, t = R[None], t[None]
    K = torch.as_tensor(K, dtype=torch.float32, device=verts.device)
    uv, z = project_vertices(verts.to(torch.float32),
                             R.to(torch.float32), t.to(torch.float32), K)
    out = rasterize_binned(uv, z, faces, attrs.to(torch.float32), h, w)
    if not batched:
        out = RenderOut(out.depth[0], out.attr[0], out.mask[0],
                        out.overflow)
    return out


def render_depth(verts, faces, R, t, K, h: int, w: int):
    """Depth + mask only (the reference CUDA renderer's contract,
    ``gpu_render.py:122-125``)."""
    attrs = torch.zeros(verts.shape[:-1] + (1,), dtype=torch.float32,
                        device=verts.device)
    out = render_mesh(verts, faces, attrs, R, t, K, h, w)
    return out.depth, out.mask


def _headlight_shade(normals, R, ambient: float, diffuse: float):
    """Per-vertex headlight Lambertian term, clipped at 1 like the GL
    shader (``renderer.py:44-46``: ``min(1, ambient + 0.5 * diffuse)``).
    The reference shades with flat face normals (dFdx/dFdy); vertex
    normals give the smooth-shaded equivalent. (V, 3) or (P, V, 3) normals
    and (3, 3) or (P, 3, 3) R give (V,) or (P, V)."""
    n_cam = normals.to(torch.float32) @ R.to(torch.float32).transpose(-1, -2)
    lam = torch.clamp(-n_cam[..., 2], 0.0, 1.0)
    return torch.clamp(ambient + diffuse * lam, max=1.0)


def render_textured(verts, faces, uv_coords, texture, normals, R, t, K,
                    h: int, w: int, ambient: float = 0.5,
                    diffuse: float = 0.5) -> RenderOut:
    """UV-textured lit render (the reference's textured GL program,
    ``rendering/renderer.py:50-79``): per-vertex UVs are interpolated
    perspective-correct alongside a headlight shade term, then the texture
    is sampled bilinearly per covered pixel and modulated,
    ``gl_FragColor = texture2D(u_tex, v_texcoord) * light_w``.

    Args:
      uv_coords: (V, 2) GL texture coordinates (v up from the bottom; the
        image flip of ``model.py:103`` is handled by the sampler).
      texture: (Ht, Wt, C) texture image, image-row order, any range
        (output attr is in the texture's range).
      normals: (V, 3) unit vertex normals for the shade term.

    Returns :class:`RenderOut` whose ``attr`` is the shaded (h, w, C) RGB.
    """
    from pix2pose_torch.ops.texture import sample_texture

    shade = _headlight_shade(normals, R, ambient, diffuse)
    uvs = uv_coords.to(torch.float32).expand(shade.shape + (2,))
    attrs = torch.cat([uvs, shade[..., None]], dim=-1)
    out = render_mesh(verts, faces, attrs, R, t, K, h, w)
    rgb = sample_texture(texture, out.attr[..., :2])
    rgb = rgb * torch.clamp(out.attr[..., 2:3], 0.0, 1.0)
    rgb = torch.where(out.mask[..., None], rgb, 0.0)
    return RenderOut(depth=out.depth, attr=rgb, mask=out.mask,
                     overflow=out.overflow)
