"""Batched point-to-plane ICP with robust rejection (port of
:mod:`pix2pose_tpu.ops.icp`).

Replaces ``cv2.ppf_match_3d_ICP(iterations=100, tolerence=0.005,
rejectionScale=2.5, numLevels=2).registerModelToScene``
(``tools/5_evaluation_bop_icp3d.py:88-89``). Nearest neighbours come from
a dense (S, T) distance matrix; pairs beyond ``rejection_scale`` x the
median correspondence distance (floored at ``tolerance``) are dropped;
each iteration solves the 6x6 point-to-plane normal equations with the
rotation centred on the source centroid, optionally blended with a
point-to-point term (``pp_weight``); two coarse-to-fine levels. All
matmuls are full fp32: the ``|a|^2 - 2ab + |b|^2`` expansion cancels
catastrophically in TF32, and the port never enables TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pix2pose_torch.ops import smallmat
from pix2pose_torch.ops.pnp import _rodrigues


class ICPResult(NamedTuple):
    R: torch.Tensor         # (..., 3, 3) delta rotation
    t: torch.Tensor         # (..., 3) delta translation (input units)
    residual: torch.Tensor  # (...) mean |point-to-plane| of kept pairs
    ok: torch.Tensor        # (...) bool


def _masked_quantile(x, mask, q: float):
    """Quantile of x (..., N) over mask along the last axis (sort with
    +big padding)."""
    xs = torch.sort(torch.where(mask, x, 3.4e38), dim=-1).values
    n = mask.sum(-1)
    idx = (torch.clamp(n - 1, min=0).to(torch.float32) * q).to(torch.int64)
    idx = torch.clamp(idx, 0, x.shape[-1] - 1)
    return torch.take_along_dim(xs, idx[..., None], dim=-1)[..., 0]


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _icp_level(R, t, src, tgt_p, tgt_n, src_valid, tgt_valid, iters: int,
               rejection_scale: float, tolerance: float,
               pp_weight: float = 0.0):
    """``iters`` Gauss-Newton steps at one level. R (B, 3, 3), t (B, 3),
    src (B, S, 3), tgt_p/tgt_n (B, T, 3), masks (B, S)/(B, T)."""
    big = 1e12
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    res = torch.zeros(R.shape[:-2], dtype=R.dtype, device=R.device)
    tgt_sq = (tgt_p ** 2).sum(-1)[:, None, :]
    for _ in range(iters):
        sp = src @ R.transpose(-1, -2) + t[:, None, :]          # (B, S, 3)
        d2 = ((sp ** 2).sum(-1)[..., None]
              - 2.0 * sp @ tgt_p.transpose(-1, -2) + tgt_sq)
        d2 = torch.where(tgt_valid[:, None, :], d2, big)
        d2_min, nn = d2.min(dim=-1)
        q = torch.take_along_dim(tgt_p, nn[..., None], dim=1)
        n = torch.take_along_dim(tgt_n, nn[..., None], dim=1)
        dist = torch.linalg.vector_norm(sp - q, dim=-1)
        w0 = src_valid & (d2_min < big / 2)
        # robust rejection: median-proportional, floored at the tolerance
        # (see the JAX package for the measurements behind both choices)
        med = _masked_quantile(dist, w0, 0.5)
        keep = w0 & (dist < rejection_scale
                     * torch.clamp(med, min=tolerance)[:, None])
        w = keep.to(torch.float32)
        n_keep = torch.clamp(w.sum(-1), min=1.0)
        # rotation about the source centroid keeps the 6x6 well conditioned
        c = (sp * w[..., None]).sum(1) / n_keep[:, None]
        r = ((sp - q) * n).sum(-1)
        jw = torch.linalg.cross(sp - c[:, None], n, dim=-1)
        J = torch.cat([jw, n], dim=-1)                          # (B, S, 6)
        Jw = J * w[..., None]
        JtJ = Jw.transpose(-1, -2) @ J
        Jtr = (Jw * r[..., None]).sum(1)
        if pp_weight > 0:
            # point-to-point term: it has no sliding null space where only
            # flat faces are seen, weighted low so the plane term sets the
            # converged precision
            j_pp = torch.cat([-_skew(sp - c[:, None]),
                              eye6[:3, :3].expand(*sp.shape, 3)], -1)
            jw_pp = j_pp * (w * pp_weight)[..., None, None]  # (B, S, 3, 6)
            JtJ = JtJ + torch.einsum("bsij,bsik->bjk", jw_pp, j_pp)
            Jtr = Jtr + torch.einsum("bsij,bsi->bj", jw_pp, sp - q)
        delta = smallmat.chol_solve(JtJ + 1e-6 * eye6, -Jtr)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        # trust region: the linearization holds for small steps only
        wn = torch.linalg.vector_norm(delta[:, :3], dim=-1)
        scale = torch.clamp(0.5 / (wn + 1e-12), max=1.0)
        delta = torch.cat([delta[:, :3] * scale[:, None], delta[:, 3:]], -1)
        # sp' = Rd (sp - c) + c + dt  =>  R' = Rd R, t' = Rd t + c - Rd c + dt
        Rd = _rodrigues(delta[:, :3])
        R = Rd @ R
        t = ((Rd @ t[..., None])[..., 0] + (c - (Rd @ c[..., None])[..., 0])
             + delta[:, 3:])
        res = (torch.abs(r) * w).sum(-1) / n_keep
    return R, t, res


def icp_point_to_plane(src_pts, tgt_pts, tgt_normals, src_valid=None,
                       tgt_valid=None, iters: int = 30,
                       rejection_scale: float = 2.5,
                       tolerance: float = 0.005,
                       pp_weight: float = 0.0,
                       levels: int = 2) -> ICPResult:
    """Register source points to target clouds, batched.

    Args:
      src_pts: (B, S, 3) or (S, 3) source points (rendered surface).
      tgt_pts, tgt_normals: (B, T, 3) or (T, 3) sensor cloud and normals.
      src_valid, tgt_valid: optional masks for padded points.
      iters: Gauss-Newton iterations, split across ``levels``; level l uses
        every 2^(levels-1-l)-th source point.
      rejection_scale, tolerance: pairs beyond rejection_scale x
        max(median distance, tolerance) are dropped.
      pp_weight: weight of a point-to-point term added to the
        point-to-plane normal equations (0: plane only).

    Returns :class:`ICPResult` with the delta pose p_tgt ~ R p_src + t
    (identity and ``ok=False`` when it failed or had < 10 points).
    """
    batched = src_pts.dim() == 3
    if not batched:
        src_pts, tgt_pts, tgt_normals = (x[None] for x in
                                         (src_pts, tgt_pts, tgt_normals))
        src_valid = None if src_valid is None else src_valid[None]
        tgt_valid = None if tgt_valid is None else tgt_valid[None]
    src_pts, tgt_pts, tgt_normals = (x.to(torch.float32) for x in
                                     (src_pts, tgt_pts, tgt_normals))
    b, s = src_pts.shape[:2]
    dev = src_pts.device
    if src_valid is None:
        src_valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    if tgt_valid is None:
        tgt_valid = torch.ones(tgt_pts.shape[:2], dtype=torch.bool,
                               device=dev)
    R = torch.eye(3, device=dev).expand(b, 3, 3)
    t = torch.zeros((b, 3), device=dev)
    res = torch.full((b,), torch.inf, device=dev)
    per_level = max(iters // levels, 1)
    for lvl in range(levels):
        st = 2 ** (levels - 1 - lvl)
        R, t, res = _icp_level(R, t, src_pts[:, ::st], tgt_pts, tgt_normals,
                               src_valid[:, ::st], tgt_valid, per_level,
                               rejection_scale, tolerance, pp_weight)
    ok = (torch.isfinite(res) & torch.isfinite(R).all(-1).all(-1)
          & torch.isfinite(t).all(-1)
          & (src_valid.sum(-1) >= 10) & (tgt_valid.sum(-1) >= 10))
    eye = torch.eye(3, device=dev)
    out = ICPResult(R=torch.where(ok[:, None, None], R, eye),
                    t=torch.where(ok[:, None], t, 0.0),
                    residual=torch.where(ok, res, -1.0), ok=ok)
    if not batched:
        out = ICPResult(*(x[0] for x in out))
    return out
