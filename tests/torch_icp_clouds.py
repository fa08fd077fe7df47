"""The clouds of an ``icp-robustness`` sweep point, for the ``pp_weight``
checks of ``tests/test_torch_icp_robustness.py`` and ``chip_smoke.py``:
what the refiner's first ICP call sees (its evenly strided samples after
its centroid pre-alignment), built from the refiner's own helpers."""

import torch

from pix2pose_torch.eval.icp_refine import (_gather_rows, _masked_median3,
                                            _sample_masked)
from pix2pose_torch.ops import geometry, rasterizer
from pix2pose_torch.tools.icp_robustness import (IM_H, IM_W, K, _case_frame,
                                                 prism_mesh)


def case_clouds(case, seed: int = 0, n_src: int = 1024, n_tgt: int = 4096,
                device="cuda"):
    """``(src, src_valid, tgt, tgt_n, tgt_valid)`` in metres: the source
    sampled from the prism rendered at the sweep point's perturbed pose
    and moved onto the target's median centroid, the target sampled from
    its sensor frame."""
    verts, faces = prism_mesh()
    _, _, R0, t0, (union, dj, tgt_pts, tgt_normals) = _case_frame(
        verts, faces, case, seed, device)
    dev = union.device
    kk = torch.as_tensor(K, device=dev)
    d0, m0 = rasterizer.render_depth(
        torch.as_tensor(verts / 1000.0, device=dev),
        torch.as_tensor(faces, device=dev), torch.as_tensor(R0, device=dev),
        torch.as_tensor(t0 / 1000.0, device=dev), kk, IM_H, IM_W)
    sidx, svalid = _sample_masked((m0 & union).reshape(1, -1), n_src)
    src = _gather_rows(geometry.backproject(d0, kk).reshape(1, -1, 3), sidx)
    tidx, tvalid = _sample_masked((union & (dj > 0)).reshape(1, -1), n_tgt)
    tgt = _gather_rows(tgt_pts.reshape(1, -1, 3), tidx)
    tgt_n = _gather_rows(tgt_normals.reshape(1, -1, 3), tidx)
    src = src + (_masked_median3(tgt, tvalid)
                 - _masked_median3(src, svalid))[:, None]
    return src[0], svalid[0], tgt[0], tgt_n[0], tvalid[0]
