"""The z-buffer CUDA kernel, through its binned (K1) and exhaustive (K2)
entries, against its plain PyTorch version on the card (skips without a
CUDA device). Imports no jax, so it runs where only
torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Bar: masks equal, 1/z, a and b bit-equal, the winning face equal on every
covered pixel, overflow 0, and each entry's launch counter counts exactly
its z-buffer calls. The device-built work list equals its plain version."""

import numpy as np
import pytest
import torch

from pix2pose_torch.ops import rasterizer_cuda as rc
from pix2pose_torch.ops.rasterizer import project_vertices
from pix2pose_torch.tools import bench_rasterizer
from pix2pose_torch.utils.synthetic import (CAM_K, cube_mesh,
                                            pose_with_euler, uv_sphere)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _project(verts, faces, poses, dev):
    n = len(poses)
    R = torch.as_tensor(np.stack([p[0] for p in poses]), device=dev)
    t = torch.as_tensor(np.stack([p[1] for p in poses]), device=dev)
    v = torch.as_tensor(verts, device=dev).expand(n, -1, -1)
    f = torch.as_tensor(faces, device=dev).expand(n, -1, -1)
    uv, z = project_vertices(v, R, t, torch.as_tensor(CAM_K, device=dev))
    return uv, z, f, v


def _assert_exact(got, ref, min_covered):
    """All four outputs (izb, fidx, a, b) bit-equal."""
    torch.cuda.synchronize()
    m = ref[0] > 0
    assert int(m.sum()) > min_covered
    assert torch.equal(got[0] > 0, m)
    for g, r in zip(got, ref):
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def _spanning(n_hyp, h, w, n_faces=1024, seed=0):
    """Large triangles near the camera: every 128-face chunk spans the
    whole frame (more (tile, chunk) pairs at 480x640 than the JAX binned
    path's default capacity holds)."""
    rng = np.random.default_rng(seed)
    n_v = 3 * n_faces
    uv = np.stack([rng.uniform(-0.5 * w, 1.5 * w, (n_hyp, n_v)),
                   rng.uniform(-0.5 * h, 1.5 * h, (n_hyp, n_v))], -1)
    z = rng.uniform(0.5, 2.0, (n_hyp, n_v))
    f = np.arange(n_v, dtype=np.int32).reshape(n_faces, 3)
    return (torch.as_tensor(uv, dtype=torch.float32),
            torch.as_tensor(z, dtype=torch.float32),
            torch.as_tensor(f)[None].expand(n_hyp, -1, -1))


def _snapped(n_hyp, h, w, n_faces=4096, seed=1):
    """Small triangles on integer pixels moved by a few float ulps: pixel
    centers a rounding error off an edge, where the cull box must not
    drop what the float test covers."""
    rng = np.random.default_rng(seed)
    tri = (rng.integers([0, 0], [w, h], (n_hyp, n_faces, 1, 2))
           + rng.integers(-6, 7, (n_hyp, n_faces, 3, 2))).astype(np.float32)
    for _ in range(3):
        tri = np.where(rng.random(tri.shape) < 0.5, np.nextafter(
            tri, np.float32(np.inf) * rng.choice([-1, 1], tri.shape)
            .astype(np.float32)), tri)
    f = torch.arange(3 * n_faces).reshape(n_faces, 3)
    return (torch.as_tensor(tri.reshape(n_hyp, -1, 2)),
            torch.ones(n_hyp, 3 * n_faces), f[None].expand(n_hyp, -1, -1))


def _poses(n):
    return [pose_with_euler(yaw=0.7 * i, pitch=-0.2 * i, tx=-20.0 + 15 * i,
                            ty=5.0 - 3 * i, tz=450.0 + 30 * i)
            for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("mesh,h,w", [("cube", 480, 640),
                                      ("sphere", 300, 401)])
def test_kernel_matches_plain(mesh, h, w):
    dev = _cuda()
    verts, faces = (cube_mesh(40.0) if mesh == "cube"
                    else uv_sphere(60, 90, 45.0))
    poses = [pose_with_euler(yaw=0.5 * i, pitch=0.2 * i, tx=10.0 * i,
                             tz=400.0 + 50 * i) for i in range(3)]
    uv, z, f, v = _project(verts, faces, poses, dev)
    packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
    before = rc.rasterize_binned.launches
    got = rc._binned_core_cuda(packed, bounds, h, w)
    assert rc.rasterize_binned.launches == before + 1
    ref = rc._binned_core_plain(packed, bounds, h, w)
    _assert_exact(got, ref, 1000)
    out = rc.rasterize_binned(uv, z, f, v, h, w)
    assert int(out.overflow) == 0 and torch.equal(out.mask, ref[0] > 0)


@pytest.mark.gpu
def test_exhaustive_kernel_matches_plain():
    """K2 at 480x640 on a 40 000-face sphere, P=4, and one mesh."""
    dev = _cuda()
    h, w = 480, 640
    verts, faces = uv_sphere(101, 200, 50.0)
    uv, z, f, v = _project(verts, faces, _poses(4), dev)
    packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
    before = (rc.rasterize_binned.launches, rc.rasterize_exhaustive.launches)
    got = rc._exhaustive_core_cuda(packed, bounds, h, w)
    assert (rc.rasterize_binned.launches,
            rc.rasterize_exhaustive.launches) == (before[0], before[1] + 1)
    _assert_exact(got, rc._binned_core_plain(packed, bounds, h, w), 10000)
    one = rc.rasterize_exhaustive(uv[1], z[1], f[1], v[1], h, w)
    ref = rc.rasterize_exhaustive_plain(uv[1], z[1], f[1], v[1], h, w)
    assert int(one.overflow) == 0 and torch.equal(one.mask, ref.mask)
    with pytest.raises(ValueError):
        rc._exhaustive_core_cuda(packed, bounds, 100, 200)


@pytest.mark.gpu
def test_hard_meshes_both_entries():
    """Both entries at 480x640: a sphere with every face listed twice
    (exact ties: the smaller sorted id must win), large triangles whose
    chunks span the frame, small triangles a few ulps off the pixel grid
    and the benchmark's 98 124-face sphere; P=8 (the small triangles
    P=2)."""
    dev = _cuda()
    h, w = 480, 640
    verts, faces = uv_sphere(60, 90, 45.0)
    ties = _project(verts, np.concatenate([faces, faces]), _poses(8), dev)
    bverts, bfaces = bench_rasterizer.uv_sphere(99000)
    big = _project(bverts * 1000.0, bfaces, _poses(8), dev)
    span = tuple(x.to(dev) for x in _spanning(8, h, w))
    snap = tuple(x.to(dev) for x in _snapped(2, h, w))
    for name, (uv, z, f) in (("ties", ties[:3]), ("spanning", span),
                             ("snapped", snap), ("sphere98k", big[:3])):
        packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
        ref = rc._binned_core_plain(packed, bounds, h, w)
        for core in (rc._binned_core_cuda, rc._exhaustive_core_cuda):
            _assert_exact(core(packed, bounds, h, w), ref, 20000)


@pytest.mark.gpu
def test_device_work_list_matches_plain():
    """The build kernel's prefix sums equal :func:`_work_list_plain`'s, on
    real chunk bounds plus chunks that are off-screen, empty, partly
    off-screen and NaN, at a frame that tiles and one that does not."""
    dev = _cuda()
    verts, faces = bench_rasterizer.uv_sphere(99000)
    uv, z, f, _ = _project(verts * 1000.0, faces, _poses(3), dev)
    extra = torch.tensor([[-30.0, -1.0, 10.0, 50.0], [1e9, -1e9, 1e9, -1e9],
                          [5.0, 9.0, -20.0, -0.5], [-5.0, 300.5, -7.0, 900.0],
                          [float("nan"), 3.0, 3.0, 9.0],
                          [299.0, 299.0, 400.0, 400.0]], device=dev)
    for h, w in ((480, 640), (300, 401)):
        packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
        rows = torch.cat([bounds, extra.expand(3, -1, -1)], dim=1)
        packed = torch.cat([packed, torch.zeros(
            (3, 9, extra.shape[0] * rc.FACE_CHUNK), device=dev)], dim=2)
        for b in (bounds, rows.contiguous()):
            p = packed[..., :b.shape[1] * rc.FACE_CHUNK].contiguous()
            offsets, items = rc._work_list_plain(b, h, w)
            assert int(offsets[-1]) == len(items) > 0
            assert torch.equal(rc._work_list_cuda(p, b, h, w), offsets)
