"""The z-buffer CUDA kernel, through its binned (K1) and exhaustive (K2)
entries, against its plain PyTorch version on the card (skips without a
CUDA device). Imports no jax, so it runs where only
torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

Bar: masks equal, 1/z within rtol 1e-5 where covered, winning face equal
on >= 99.5% of covered pixels, overflow 0, and each entry's launch
counter counts exactly its kernel launches."""

import numpy as np
import pytest
import torch

from pix2pose_torch.ops import rasterizer_cuda as rc
from pix2pose_torch.ops.rasterizer import project_vertices
from pix2pose_torch.utils.synthetic import (CAM_K, cube_mesh,
                                            pose_with_euler, uv_sphere)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh,h,w", [("cube", 480, 640),
                                      ("sphere", 300, 401)])
def test_kernel_matches_plain(mesh, h, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    verts, faces = (cube_mesh(40.0) if mesh == "cube"
                    else uv_sphere(60, 90, 45.0))
    poses = [pose_with_euler(yaw=0.5 * i, pitch=0.2 * i, tx=10.0 * i,
                             tz=400.0 + 50 * i) for i in range(3)]
    R = torch.as_tensor(np.stack([p[0] for p in poses]), device=dev)
    t = torch.as_tensor(np.stack([p[1] for p in poses]), device=dev)
    v = torch.as_tensor(verts, device=dev).expand(3, -1, -1)
    f = torch.as_tensor(faces, device=dev).expand(3, -1, -1)
    uv, z = project_vertices(v, R, t, torch.as_tensor(CAM_K, device=dev))
    packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
    before = rc.rasterize_binned.launches
    izb_k, fid_k, _, _ = rc._binned_core_cuda(packed, bounds, h, w)
    assert rc.rasterize_binned.launches == before + 1
    izb_p, fid_p, _, _ = rc._binned_core_plain(packed, bounds, h, w)
    torch.cuda.synchronize()
    m = izb_p > 0
    assert m.sum() > 1000
    assert torch.equal(izb_k > 0, m)
    rel = ((izb_k - izb_p).abs() / izb_p.abs().clamp(min=1e-30))[m]
    assert float(rel.max()) <= 1e-5
    assert float((fid_k == fid_p)[m].float().mean()) >= 0.995
    out = rc.rasterize_binned(uv, z, f, v, h, w)
    assert int(out.overflow) == 0 and torch.equal(out.mask, m)


@pytest.mark.gpu
def test_exhaustive_kernel_matches_plain():
    """K2 at 480x640 on a 40 000-face sphere, P=4, and one mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    h, w = 480, 640
    verts, faces = uv_sphere(101, 200, 50.0)
    poses = [pose_with_euler(yaw=0.7 * i, pitch=-0.2 * i, tx=-20.0 + 15 * i,
                             tz=450.0 + 60 * i) for i in range(4)]
    R = torch.as_tensor(np.stack([p[0] for p in poses]), device=dev)
    t = torch.as_tensor(np.stack([p[1] for p in poses]), device=dev)
    v = torch.as_tensor(verts, device=dev).expand(4, -1, -1)
    f = torch.as_tensor(faces, device=dev).expand(4, -1, -1)
    uv, z = project_vertices(v, R, t, torch.as_tensor(CAM_K, device=dev))
    packed, _, bounds = rc._sorted_tris(uv, z, f, h, w)
    before = (rc.rasterize_binned.launches, rc.rasterize_exhaustive.launches)
    izb_k, fid_k, _, _ = rc._exhaustive_core_cuda(packed, bounds, h, w)
    assert (rc.rasterize_binned.launches,
            rc.rasterize_exhaustive.launches) == (before[0], before[1] + 1)
    izb_p, fid_p, _, _ = rc._binned_core_plain(packed, bounds, h, w)
    torch.cuda.synchronize()
    m = izb_p > 0
    assert m.sum() > 10000
    assert torch.equal(izb_k > 0, m)
    rel = ((izb_k - izb_p).abs() / izb_p.abs().clamp(min=1e-30))[m]
    assert float(rel.max()) <= 1e-5
    assert float((fid_k == fid_p)[m].float().mean()) >= 0.995
    one = rc.rasterize_exhaustive(uv[1], z[1], f[1], v[1], h, w)
    ref = rc.rasterize_exhaustive_plain(uv[1], z[1], f[1], v[1], h, w)
    assert int(one.overflow) == 0 and torch.equal(one.mask, ref.mask)
    with pytest.raises(ValueError):
        rc._exhaustive_core_cuda(packed, bounds, 100, 200)
