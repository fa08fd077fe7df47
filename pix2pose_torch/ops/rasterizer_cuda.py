"""Z-buffer rasterizer: the CUDA kernel, its plain PyTorch version, and the
host-side set-up they share (port of
:mod:`pix2pose_tpu.ops.rasterizer_pallas`, both kernels).

Host side, in torch for both versions, ported literally from the JAX
package:

- :func:`_sorted_tris` pads faces to 128-face chunks, sorts them stably by
  the 16x128 screen bin of their centroid, and turns each face into nine
  affine coefficients: barycentric a, b and interpolated 1/z as
  ``c_u * u + c_v * v + c_0`` in pixel coordinates. It also returns each
  chunk's screen bounds. The sort order decides which face wins a tie in
  the strict ``>`` depth test, and which sorted-face id lands in ``fidx``;
- :func:`_attr_epilogue` inverts 1/z and interpolates vertex attributes
  perspective-correct from the winning face.

In between, per pixel: the max of interpolated 1/z over covering faces,
strict ``>``, faces walked in sorted order. ``csrc/rasterizer.cu`` computes
it with one per-chunk body behind two entries, one per TPU kernel, both
merging candidates through 64-bit (1/z, face) keys:

- :func:`rasterize_binned` (``rasterize_pallas_binned``, K1): any frame;
  a (tile, chunk) work list built on the device (its plain version is
  :func:`_work_list_plain`);
- :func:`rasterize_exhaustive` (``rasterize_pallas``, K2): frames that tile
  by 16x128, one mesh or a batch; the tiles x chunks grid split into
  blocks of 32 chunks.

Each picks by the tensors' device: CUDA tensors launch the kernel (and add
one to the entry's ``launches``; each call enqueues a memset and the build,
raster and finalize kernels), CPU tensors run :func:`_binned_core_plain`,
the same function in PyTorch, which is also the kernel's reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from pix2pose_torch.ops.rasterizer import RenderOut
from pix2pose_torch.ops.smallmat import first_argmax

TILE_V = 16      # centroid-bin height of the face sort; K2's frame tile
TILE_U = 128     # centroid-bin width of the face sort; K2's frame tile
FACE_CHUNK = 128  # faces per chunk; the kernel stages one chunk at a time
KERNEL_TILE_V = 16  # the CUDA kernel's pixel tile (csrc/rasterizer.cu)
KERNEL_TILE_U = 32

_PLAIN_BAND = 16          # rows per band of the plain version
_PLAIN_MAX_ELEMS = 1 << 20  # pixels x faces per plain temporary (4 MB)

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "rasterizer.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]


def _sorted_tris(uv, z, faces, h: int, w: int):
    """Per-face affine coefficients, spatially sorted.

    Args: uv (P, V, 2), z (P, V), faces (P, F, 3) (-1 wraps to the last
    vertex, like jnp indexing). Returns (packed (P, 9, Fp) rows
    ca_u ca_v ca_0 cb_u cb_v cb_0 cz_u cz_v cz_0, sorted faces (P, Fp, 3),
    chunk bounds (P, Fp/128, 4) as v_min v_max u_min u_max). Degenerate,
    padded and behind-camera faces get coefficients that always fail
    coverage and do not widen the bounds (padding does; degenerate faces
    do, as in the JAX package)."""
    p, n_v = z.shape
    dev = z.device
    f = faces.shape[1]
    pad = (-f) % FACE_CHUNK
    faces = faces.to(torch.int64)
    if pad:
        faces = torch.cat([faces, torch.zeros((p, pad, 3), dtype=torch.int64,
                                              device=dev)], dim=1)
    fp = f + pad
    valid_face = (torch.arange(fp, device=dev) < f)[None].expand(p, fp)
    fw = torch.remainder(faces, n_v)
    pi = torch.arange(p, device=dev)[:, None, None]
    tri_v = uv[pi, fw, 1]                              # (P, Fp, 3)
    tri_u = uv[pi, fw, 0]
    tri_z = torch.where(valid_face[..., None], z[pi, fw], -1.0)

    # spatial sort by the centroid's 16x128 screen bin
    n_tu = w // TILE_U
    cv = torch.clamp(tri_v.mean(-1), 0.0, h - 1.0)
    cu = torch.clamp(tri_u.mean(-1), 0.0, w - 1.0)
    bin_id = (torch.floor(cv / TILE_V) * n_tu
              + torch.floor(cu / TILE_U)).to(torch.int32)
    bin_id = torch.where(valid_face, bin_id, 2 ** 30)
    order = torch.argsort(bin_id, dim=-1, stable=True)
    take = lambda a: torch.gather(a, 1, order[..., None].expand(a.shape))
    tri_v, tri_u, tri_z, faces = (take(tri_v), take(tri_u), take(tri_z),
                                  take(faces))
    valid_face = torch.gather(valid_face, 1, order)

    #   a = ((v2-v3)(pu-u3) + (u3-u2)(pv-v3)) / den, expanded
    v1, v2, v3 = tri_v.unbind(-1)
    u1, u2, u3 = tri_u.unbind(-1)
    z1, z2, z3 = tri_z.unbind(-1)
    den = (v2 - v3) * (u1 - u3) + (u3 - u2) * (v1 - v3)
    ok = (valid_face & (torch.abs(den) > 1e-12) & (z1 > 0) & (z2 > 0)
          & (z3 > 0))
    den = torch.where(ok, den, 1.0)
    ca_u = (v2 - v3) / den
    ca_v = (u3 - u2) / den
    ca_0 = -(ca_u * u3 + ca_v * v3)
    cb_u = (v3 - v1) / den
    cb_v = (u1 - u3) / den
    cb_0 = -(cb_u * u3 + cb_v * v3)
    iz1 = 1.0 / torch.clamp(z1, min=1e-9)
    iz2 = 1.0 / torch.clamp(z2, min=1e-9)
    iz3 = 1.0 / torch.clamp(z3, min=1e-9)
    cz_u = ca_u * (iz1 - iz3) + cb_u * (iz2 - iz3)
    cz_v = ca_v * (iz1 - iz3) + cb_v * (iz2 - iz3)
    cz_0 = iz3 + ca_0 * (iz1 - iz3) + cb_0 * (iz2 - iz3)
    # invalid faces: a == -1 everywhere -> coverage always fails
    rows = [torch.where(ok, x, fill) for x, fill in (
        (ca_u, 0.0), (ca_v, 0.0), (ca_0, -1.0), (cb_u, 0.0), (cb_v, 0.0),
        (cb_0, 0.0), (cz_u, 0.0), (cz_v, 0.0), (cz_0, 0.0))]
    packed = torch.stack(rows, dim=1).contiguous()    # (P, 9, Fp)

    n_chunks = fp // FACE_CHUNK
    big = 1e9
    vf = valid_face[..., None]
    red = lambda a, fn: fn(a.reshape(p, n_chunks, FACE_CHUNK), dim=-1)
    bounds = torch.stack([
        red(torch.where(vf, tri_v, big).amin(-1), torch.amin),
        red(torch.where(vf, tri_v, -big).amax(-1), torch.amax),
        red(torch.where(vf, tri_u, big).amin(-1), torch.amin),
        red(torch.where(vf, tri_u, -big).amax(-1), torch.amax)],
        dim=-1).contiguous()                           # (P, n_chunks, 4)
    return packed, faces, bounds


def _attr_epilogue(izb, fidx, ba, bb, faces, z, attrs,
                   overflow=0) -> RenderOut:
    """Perspective-correct attributes from the winning faces. ``izb`` is
    the interpolated-1/z buffer (0 = background); all inputs carry the
    leading P axis."""
    p, n_v = z.shape
    pi = torch.arange(p, device=z.device)[:, None, None]
    mask = izb > 0
    depth = torch.where(mask, 1.0 / torch.clamp(izb, min=1e-12), 0.0)
    fv = torch.remainder(faces[pi, torch.clamp(fidx, min=0).to(torch.int64)],
                         n_v)                          # (P, H, W, 3)
    fa = attrs[pi[..., None], fv]                      # (P, H, W, 3, C)
    fz = torch.clamp(z[pi[..., None], fv], min=1e-9)   # (P, H, W, 3)
    cw = 1.0 - ba - bb
    w0, w1, w2 = ba / fz[..., 0], bb / fz[..., 1], cw / fz[..., 2]
    wsum = w0 + w1 + w2
    attr = (fa[..., 0, :] * w0[..., None] + fa[..., 1, :] * w1[..., None]
            + fa[..., 2, :] * w2[..., None]) \
        / torch.clamp(wsum, min=1e-12)[..., None]
    attr = torch.where(mask[..., None], attr, 0.0)
    return RenderOut(depth=depth, attr=attr, mask=mask, overflow=overflow)


def _binned_core_plain(packed, bounds, h: int, w: int):
    """Plain PyTorch z-buffer over the packed coefficients: for each pixel
    the max of interpolated 1/z over covering faces, strict ``>``, faces in
    sorted order (so the FIRST face reaching the max wins), initial 1/z 0
    and face -1. Rows are walked in bands; each band sees only the chunks
    whose bounds overlap it, over the columns those chunks span, in face
    groups that keep each temporary under ``_PLAIN_MAX_ELEMS`` elements.
    Returns (izb, fidx, a, b), each (P, h, w)."""
    p_n, _, fp = packed.shape
    dev = packed.device
    f32 = torch.float32
    izb = torch.zeros((p_n, h, w), dtype=f32, device=dev)
    fidx = torch.full((p_n, h, w), -1, dtype=torch.int32, device=dev)
    out_a = torch.zeros((p_n, h, w), dtype=f32, device=dev)
    out_b = torch.zeros((p_n, h, w), dtype=f32, device=dev)
    lane = torch.arange(FACE_CHUNK, device=dev)
    for p in range(p_n):
        bd = bounds[p]
        for v0 in range(0, h, _PLAIN_BAND):
            v1 = min(v0 + _PLAIN_BAND, h) - 1
            sel = torch.nonzero((bd[:, 1] >= v0) & (bd[:, 0] <= v1)
                                & (bd[:, 3] >= 0) & (bd[:, 2] <= w - 1))[:, 0]
            if sel.numel() == 0:
                continue
            u0 = max(0, math.floor(float(bd[sel, 2].min())))
            u1 = min(w - 1, math.ceil(float(bd[sel, 3].max())))
            pv = torch.arange(v0, v1 + 1, dtype=f32, device=dev)
            pu = torch.arange(u0, u1 + 1, dtype=f32, device=dev)
            nv, nu = pv.numel(), pu.numel()
            PV = pv[:, None].expand(nv, nu).reshape(-1, 1)
            PU = pu[None, :].expand(nv, nu).reshape(-1, 1)
            npx = nv * nu
            fids = (sel[:, None] * FACE_CHUNK + lane).reshape(-1)
            group = max(FACE_CHUNK, (_PLAIN_MAX_ELEMS // npx)
                        // FACE_CHUNK * FACE_CHUNK)
            zb = torch.zeros(npx, dtype=f32, device=dev)
            fb = torch.full((npx,), -1, dtype=torch.int64, device=dev)
            ab = torch.zeros(npx, dtype=f32, device=dev)
            bb = torch.zeros(npx, dtype=f32, device=dev)
            for s in range(0, fids.numel(), group):
                fi = fids[s:s + group]
                cf = packed[p][:, fi]                  # (9, G)
                A = cf[0] * PU + cf[1] * PV + cf[2]    # (npx, G)
                B = cf[3] * PU + cf[4] * PV + cf[5]
                C = 1.0 - A - B
                cover = (A >= 0) & (B >= 0) & (C >= 0)
                Z = cf[6] * PU + cf[7] * PV + cf[8]
                cand = torch.where(cover, Z, -1.0)
                cand = torch.where(torch.isnan(cand), -1.0, cand)
                j = first_argmax(cand, dim=1)[:, None]
                m = cand.gather(1, j)[:, 0]
                better = m > zb
                zb = torch.where(better, m, zb)
                fb = torch.where(better, fi[j[:, 0]], fb)
                ab = torch.where(better, A.gather(1, j)[:, 0], ab)
                bb = torch.where(better, B.gather(1, j)[:, 0], bb)
            rs, cs = slice(v0, v1 + 1), slice(u0, u1 + 1)
            izb[p, rs, cs] = zb.view(nv, nu)
            fidx[p, rs, cs] = fb.view(nv, nu).to(torch.int32)
            out_a[p, rs, cs] = ab.view(nv, nu)
            out_b[p, rs, cs] = bb.view(nv, nu)
    return izb, fidx, out_a, out_b


def _work_list_plain(bounds, h: int, w: int, tile_v: int = KERNEL_TILE_V,
                     tile_u: int = KERNEL_TILE_U):
    """Plain version of the kernel's device-built (tile, chunk) work list
    (the port of ``_build_pairs``'s WORK entries, with no capacity).

    Each chunk's bounds (P, nc, 4) become a span of tiles clipped to the
    frame; off-screen (including NaN) and empty chunks get none. Returns
    (offsets (P * nc + 1,) int64: the exclusive prefix sum of the per-chunk
    tile counts over (hypothesis, chunk), the total last; items (N, 4)
    int64 rows (p, tile_v index, tile_u index, chunk), chunk-major, each
    decoded from its index by a search in the prefix sums)."""
    p_n, nc, _ = bounds.shape
    dev = bounds.device
    n_tv, n_tu = -(-h // tile_v), -(-w // tile_u)
    b = bounds.reshape(-1, 4)
    on = ((b[:, 1] >= 0) & (b[:, 0] <= h - 1) & (b[:, 3] >= 0)
          & (b[:, 2] <= w - 1) & (b[:, 0] <= b[:, 1]))
    b = torch.where(on[:, None], b, 0.0)

    def tile(x, t, n):
        return torch.clamp(torch.floor(x / t), 0, n - 1).to(torch.int64)

    tv0, tv1 = tile(b[:, 0], tile_v, n_tv), tile(b[:, 1], tile_v, n_tv)
    tu0, tu1 = tile(b[:, 2], tile_u, n_tu), tile(b[:, 3], tile_u, n_tu)
    nu = tu1 - tu0 + 1
    count = torch.where(on, (tv1 - tv0 + 1) * nu, 0)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(count, 0)])
    i = torch.arange(int(offsets[-1]), device=dev)
    g = torch.searchsorted(offsets[1:], i, right=True)
    k = i - offsets[g]
    items = torch.stack([g // nc, tv0[g] + k // nu[g], tu0[g] + k % nu[g],
                         g % nc], dim=1)
    return offsets, items


def work_list_stats(bounds, h: int, w: int) -> dict:
    """The kernel's K1 work list for these chunk bounds (the counterpart of
    the JAX package's ``binned_pair_stats``; the port has no capacity to
    check): ``items`` (tile, chunk) items at the kernel's tile, ``tiles``
    (hypothesis, tile) pairs with work, and ``longest`` the most chunks on
    one of them."""
    _, items = _work_list_plain(bounds, h, w)
    n_tv, n_tu = -(-h // KERNEL_TILE_V), -(-w // KERNEL_TILE_U)
    per_tile = torch.bincount((items[:, 0] * n_tv + items[:, 1]) * n_tu
                              + items[:, 2])
    return {"items": len(items), "tiles": int((per_tile > 0).sum()),
            "longest": int(per_tile.max()) if len(items) else 0}


# ------------------------------------------------------------ CUDA route
_lib = None
_lib_lock = threading.Lock()
build_log: dict = {}  # nvcc command, seconds and -Xptxas -v output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA rasterizer is built from "
                       f"{_SRC} at first use and needs the CUDA toolkit")


def load_library():
    """Build ``csrc/rasterizer.cu`` with nvcc for sm_90a into
    ``pix2pose_torch/_build`` (cached by source and flag hash) and load it.
    Raises if the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()) \
            .hexdigest()[:16]
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = _BUILD_DIR / f"librasterizer_{tag}.so"
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log.update(cmd=" ".join(cmd),
                             seconds=time.perf_counter() - t0,
                             output=proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.p2p_rasterize_binned, lib.p2p_rasterize_exhaustive):
            fn.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
            fn.restype = i32
        lib.p2p_build_worklist.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
        lib.p2p_build_worklist.restype = i32
        lib.p2p_scratch_bytes.argtypes = [i32] * 5
        lib.p2p_scratch_bytes.restype = ctypes.c_size_t
        _lib = lib
        return lib


def _checked(packed, bounds, h: int, w: int):
    """Check the kernel's inputs; returns (library, P, Fp, chunks,
    scratch buffer)."""
    if packed.device.type != "cuda" or bounds.device != packed.device:
        raise ValueError("packed and bounds must be on one CUDA device")
    if packed.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError("packed and bounds must be float32")
    if not (packed.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("packed and bounds must be contiguous")
    if packed.data_ptr() % 16 or bounds.data_ptr() % 16:
        raise ValueError("packed and bounds must be 16-byte aligned (the "
                         "kernel copies them in 16-byte pieces)")
    p_n, nine, fp = packed.shape
    if nine != 9 or fp % FACE_CHUNK or fp == 0:
        raise ValueError(f"packed must be (P, 9, k*{FACE_CHUNK}), "
                         f"got {tuple(packed.shape)}")
    if tuple(bounds.shape) != (p_n, fp // FACE_CHUNK, 4):
        raise ValueError(f"bounds must be (P, Fp/{FACE_CHUNK}, 4), "
                         f"got {tuple(bounds.shape)}")
    if not (0 < p_n <= 65535 and 0 < h and 0 < w):
        raise ValueError(f"unsupported P={p_n}, h={h}, w={w}")
    nc = fp // FACE_CHUNK
    tiles = -(-h // KERNEL_TILE_V) * -(-w // KERNEL_TILE_U)
    if p_n * nc * tiles >= 2 ** 31:
        raise ValueError(f"P={p_n} x {nc} chunks x {tiles} tiles overflows "
                         "the kernel's int32 work-item index")
    if torch.cuda.get_device_capability(packed.device) != (9, 0):
        raise RuntimeError("the rasterizer kernel is built for sm_90a "
                           "(Hopper)")
    lib = load_library()
    scratch = torch.empty(lib.p2p_scratch_bytes(p_n, fp, nc, h, w),
                          dtype=torch.uint8, device=packed.device)
    return lib, p_n, fp, nc, scratch


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"rasterizer kernel launch ({what}) failed: "
                           f"CUDA error {err}")


def _core_cuda(entry: str, packed, bounds, h: int, w: int):
    """Launch the kernel through the C entry ``entry`` on PyTorch's current
    stream (one memset and three kernels). Same contract as
    :func:`_binned_core_plain`; raises on anything it does not take."""
    lib, p_n, fp, nc, scratch = _checked(packed, bounds, h, w)
    dev = packed.device
    izb = torch.empty((p_n, h, w), dtype=torch.float32, device=dev)
    fidx = torch.empty((p_n, h, w), dtype=torch.int32, device=dev)
    out_a = torch.empty_like(izb)
    out_b = torch.empty_like(izb)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(getattr(lib, entry)(
        packed.data_ptr(), bounds.data_ptr(), izb.data_ptr(),
        fidx.data_ptr(), out_a.data_ptr(), out_b.data_ptr(),
        scratch.data_ptr(), p_n, fp, nc, h, w, stream), entry)
    return izb, fidx, out_a, out_b


def _work_list_cuda(packed, bounds, h: int, w: int):
    """The kernel's device-built prefix sums over (hypothesis, chunk), as
    :func:`_work_list_plain` returns them (int64); not counted as a
    z-buffer launch."""
    lib, p_n, fp, nc, scratch = _checked(packed, bounds, h, w)
    offsets = torch.empty(p_n * nc + 1, dtype=torch.int32,
                          device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    _raise_on(lib.p2p_build_worklist(
        packed.data_ptr(), bounds.data_ptr(), offsets.data_ptr(),
        scratch.data_ptr(), p_n, fp, nc, h, w, stream), "p2p_build_worklist")
    return offsets.to(torch.int64)


def _binned_core_cuda(packed, bounds, h: int, w: int):
    """K1's launch: any frame size."""
    out = _core_cuda("p2p_rasterize_binned", packed, bounds, h, w)
    rasterize_binned.launches += 1
    return out


def _exhaustive_core_cuda(packed, bounds, h: int, w: int):
    """K2's launch: frames that tile by 16x128."""
    _check_tiles(h, w)
    out = _core_cuda("p2p_rasterize_exhaustive", packed, bounds, h, w)
    rasterize_exhaustive.launches += 1
    return out


def _check_inputs(uv, z, faces, attrs):
    if uv.dim() != 3 or uv.shape[-1] != 2:
        raise ValueError(f"uv must be (P, V, 2), got {tuple(uv.shape)}")
    p_n, n_v = uv.shape[:2]
    if tuple(z.shape) != (p_n, n_v):
        raise ValueError(f"z must be (P, V), got {tuple(z.shape)}")
    if faces.dim() != 3 or faces.shape[0] != p_n or faces.shape[2] != 3:
        raise ValueError(f"faces must be (P, F, 3), got "
                         f"{tuple(faces.shape)}")
    if attrs.dim() != 3 or tuple(attrs.shape[:2]) != (p_n, n_v):
        raise ValueError(f"attrs must be (P, V, C), got "
                         f"{tuple(attrs.shape)}")
    if faces.dtype.is_floating_point:
        raise TypeError("faces must be an integer tensor")
    devs = {t.device for t in (uv, z, faces, attrs)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def rasterize_binned_plain(uv, z, faces, attrs, h: int, w: int
                           ) -> RenderOut:
    """:func:`rasterize_binned` with the plain PyTorch z-buffer, on any
    device."""
    _check_inputs(uv, z, faces, attrs)
    uv, z, attrs = (x.to(torch.float32) for x in (uv, z, attrs))
    packed, faces_s, bounds = _sorted_tris(uv, z, faces, h, w)
    izb, fidx, a, b = _binned_core_plain(packed, bounds, h, w)
    return _attr_epilogue(izb, fidx, a, b, faces_s, z, attrs)


def rasterize_binned(uv, z, faces, attrs, h: int, w: int) -> RenderOut:
    """Rasterize P projected meshes into full (h, w) frames.

    Args:
      uv: (P, V, 2) projected pixel coords. z: (P, V) camera depths.
      faces: (P, F, 3) vertex indices (-1 = padding). attrs: (P, V, C).

    CUDA tensors go to the hand-written kernel (no fallback: a failed
    build or launch raises); CPU tensors go to the plain version. Any h
    and w. ``overflow`` is 0: the kernel has no work-list capacity.
    Computes what ``rasterize_pallas_binned`` computes in the JAX package.
    """
    _check_inputs(uv, z, faces, attrs)
    if uv.device.type == "cpu":
        return rasterize_binned_plain(uv, z, faces, attrs, h, w)
    if uv.device.type != "cuda":
        raise ValueError(f"no rasterizer for device {uv.device}")
    uv, z, attrs = (x.to(torch.float32) for x in (uv, z, attrs))
    packed, faces_s, bounds = _sorted_tris(uv, z, faces, h, w)
    izb, fidx, a, b = _binned_core_cuda(packed, bounds, h, w)
    return _attr_epilogue(izb, fidx, a, b, faces_s, z, attrs)


rasterize_binned.launches = 0  # kernel launches, for checks of the path


def _check_tiles(h: int, w: int):
    if h % TILE_V or w % TILE_U:
        raise ValueError(f"(h={h}, w={w}) must tile by ({TILE_V}, {TILE_U})")


def _as_batch(uv, z, faces, attrs):
    """Add the leading P axis to one mesh (uv (V, 2)); returns the inputs
    and whether they had one."""
    if uv.dim() == 2:
        return (uv[None], z[None], faces[None], attrs[None]), False
    return (uv, z, faces, attrs), True


def _unbatch(out: RenderOut) -> RenderOut:
    return RenderOut(out.depth[0], out.attr[0], out.mask[0], out.overflow)


def rasterize_exhaustive_plain(uv, z, faces, attrs, h: int, w: int
                               ) -> RenderOut:
    """:func:`rasterize_exhaustive` with the plain PyTorch z-buffer, on any
    device."""
    _check_tiles(h, w)
    (uv, z, faces, attrs), batched = _as_batch(uv, z, faces, attrs)
    out = rasterize_binned_plain(uv, z, faces, attrs, h, w)
    return out if batched else _unbatch(out)


def rasterize_exhaustive(uv, z, faces, attrs, h: int, w: int) -> RenderOut:
    """Rasterize projected meshes into full (h, w) frames: the counterpart
    of ``rasterize_pallas`` (K2).

    Args:
      uv: (V, 2) projected pixel coords of one mesh, or a (P, V, 2) batch.
      z: (V,) or (P, V) camera depths. faces: (F, 3) or (P, F, 3) vertex
        indices (-1 = padding). attrs: (V, C) or (P, V, C).
      h, w: frame size; raises ``ValueError`` unless h % 16 == 0 and
        w % 128 == 0, as the JAX function does.

    CUDA tensors launch the kernel through its exhaustive entry (no
    fallback: a failed build or launch raises); CPU tensors go to the
    plain version. ``overflow`` is 0. Returns :class:`RenderOut` with the
    inputs' leading axes.
    """
    _check_tiles(h, w)
    (uv, z, faces, attrs), batched = _as_batch(uv, z, faces, attrs)
    _check_inputs(uv, z, faces, attrs)
    if uv.device.type == "cpu":
        out = rasterize_binned_plain(uv, z, faces, attrs, h, w)
    elif uv.device.type == "cuda":
        uv, z, attrs = (x.to(torch.float32) for x in (uv, z, attrs))
        packed, faces_s, bounds = _sorted_tris(uv, z, faces, h, w)
        izb, fidx, a, b = _exhaustive_core_cuda(packed, bounds, h, w)
        out = _attr_epilogue(izb, fidx, a, b, faces_s, z, attrs)
    else:
        raise ValueError(f"no rasterizer for device {uv.device}")
    return out if batched else _unbatch(out)


rasterize_exhaustive.launches = 0  # kernel launches, for checks of the path


def render_mesh_exhaustive(verts, faces, attrs, R, t, K, h: int, w: int
                           ) -> RenderOut:
    """Pose + project + :func:`rasterize_exhaustive` (the counterpart of
    ``render_mesh_pallas``). One mesh (V, 3) with a (3, 3)/(3,) pose, or a
    (P, ...) batch of each; K (3, 3)."""
    from pix2pose_torch.ops.rasterizer import project_vertices

    K = torch.as_tensor(K, dtype=torch.float32, device=verts.device)
    uv, z = project_vertices(verts.to(torch.float32), R.to(torch.float32),
                             t.to(torch.float32), K)
    return rasterize_exhaustive(uv, z, faces, attrs.to(torch.float32), h, w)

