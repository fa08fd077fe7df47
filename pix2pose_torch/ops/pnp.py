"""Batched PnP-RANSAC (port of :mod:`pix2pose_tpu.ops.pnp`).

Replaces the reference's per-candidate
``cv2.solvePnPRansac(..., SOLVEPNP_EPNP, reprojectionError=5)``
(``pix2pose_model/recognition.py:216-223``). Every function carries an
explicit leading candidate axis where the JAX package used ``vmap``:

- hypotheses are drawn from blocks of one quality-ordered permutation of
  the valid correspondences (PROSAC-style), two populations of k=6 and
  k=12 points;
- each is solved by a pinned DLT (:func:`smallmat.dlt_min_vec`),
  decomposed to a rigid pose by quaternion power iteration, and polished
  with a few Gauss-Newton steps; raw and polished poses are both scored;
- every hypothesis scores a strided point subset; the first best wins;
- its consensus set is refit by a weighted DLT, polished with Huber
  Gauss-Newton, tightened to half the band and polished again.

Random numbers come from a ``torch.Generator``; they cannot reproduce JAX's
threefry bits, so ``sample_idx`` lets a caller inject the index sets.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from pix2pose_torch.ops import smallmat


class PnPResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3)
    n_inliers: torch.Tensor    # (...) int32; -1 when invalid
    inlier_mask: torch.Tensor  # (..., N) bool
    ok: torch.Tensor           # (...) bool


def project(obj_pts, R, t, K):
    """Pinhole projection of (..., N, 3) model points to (..., N, 2)."""
    p = obj_pts @ R.transpose(-1, -2) + t[..., None, :]
    z = p[..., 2:3]
    z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    xy = p[..., :2] / z
    x, y = xy[..., 0], xy[..., 1]
    u = _k(K, 0, 0, x) * x + _k(K, 0, 1, x) * y + _k(K, 0, 2, x)
    v = _k(K, 1, 1, x) * y + _k(K, 1, 2, x)
    return torch.stack([u, v], dim=-1)


def _k(K, i: int, j: int, like):
    """K[..., i, j] shaped to broadcast against ``like``: K is (3, 3) or
    carries the leading candidate axis (C, 3, 3)."""
    v = K[..., i, j]
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def _normalized_cam(img_pts, K):
    """Pixel -> normalized camera coordinates via K^-1."""
    pu, pv = img_pts[..., 0], img_pts[..., 1]
    v = (pv - _k(K, 1, 2, pv)) / _k(K, 1, 1, pv)
    u = (pu - _k(K, 0, 2, pu) - _k(K, 0, 1, pu) * v) / _k(K, 0, 0, pu)
    return torch.stack([u, v], dim=-1)


def _dlt_normal_matrix(obj_n, cam_n, w):
    """(..., 12, 12) normal matrix sum_i w_i (a1 a1^T + a2 a2^T) of the DLT
    system. obj_n: (..., N, 3), cam_n: (..., N, 2), w: (..., N)."""
    xh = torch.cat([obj_n, torch.ones_like(obj_n[..., :1])], dim=-1)
    zeros = torch.zeros_like(xh)
    # row for u: [X 0 -u*X]; row for v: [0 X -v*X]
    a1 = torch.cat([xh, zeros, -cam_n[..., :1] * xh], dim=-1)
    a2 = torch.cat([zeros, xh, -cam_n[..., 1:2] * xh], dim=-1)
    w = w[..., None]
    return ((a1 * w).transpose(-1, -2) @ a1
            + (a2 * w).transpose(-1, -2) @ a2)


def _pose_from_p(p_vec, obj_mean, obj_scale, sample_pts):
    """DLT solution vectors (..., 12) -> rigid poses in the original object
    frame. obj_mean: (..., 3), obj_scale: (...), sample_pts: (..., k, 3)
    fix the projective sign by cheirality."""
    P = p_vec.reshape(p_vec.shape[:-1] + (3, 4))
    z = (sample_pts @ P[..., 2, :3, None])[..., 0] + P[..., 2, 3:4]
    P = P * torch.where(z.sum(-1) < 0, -1.0, 1.0)[..., None, None]
    R, lam = smallmat.nearest_rotation_scale(P[..., :3])
    lam = torch.where(torch.abs(lam) < 1e-9, 1e-9, lam)
    t_n = P[..., 3] / lam[..., None]
    t = obj_scale[..., None] * t_n - (R @ obj_mean[..., None])[..., 0]
    return R, t


def _rodrigues(omega):
    """(..., 3) axis-angle -> (..., 3, 3) rotation."""
    th = torch.linalg.vector_norm(omega, dim=-1) + 1e-12
    k = omega / th[..., None]
    z = torch.zeros_like(k[..., 0])
    kx = torch.stack([
        torch.stack([z, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], z, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    s = torch.sin(th)[..., None, None]
    c = (1 - torch.cos(th))[..., None, None]
    return eye + s * kx + c * (kx @ kx)


def _gauss_newton_refine(R, t, obj_pts, img_pts, w, K, iters: int = 8,
                         damping: float = 1e-6, huber_px: float = 2.0):
    """Fixed-iteration damped Gauss-Newton on pixel reprojection error with
    R <- exp(omega) R, Huber-downweighting residuals beyond ``huber_px``
    (IRLS). R (..., 3, 3), t (..., 3), obj_pts (..., N, 3), img_pts
    (..., N, 2), w (..., N)."""
    ref = obj_pts[..., 0]
    fx, fy, skew = _k(K, 0, 0, ref), _k(K, 1, 1, ref), _k(K, 0, 1, ref)
    cx, cy = _k(K, 0, 2, ref), _k(K, 1, 2, ref)
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        p = obj_pts @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.where(torch.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        inv_z = 1.0 / z
        x, y = p[..., 0], p[..., 1]
        u = fx * x * inv_z + skew * y * inv_z + cx
        v = fy * y * inv_z + cy
        r = torch.stack([u, v], -1) - img_pts
        duv_dp = torch.stack([
            torch.stack([fx * inv_z, skew * inv_z,
                         -(fx * x + skew * y) * inv_z ** 2], -1),
            torch.stack([torch.zeros_like(x), fy * inv_z,
                         -fy * y * inv_z ** 2], -1),
        ], -2)                                          # (..., N, 2, 3)
        # left perturbation: J_w = duv_dp @ (-[p]_x) = cross(p, duv_dp)
        J_w = torch.linalg.cross(p[..., None, :].expand(duv_dp.shape),
                                 duv_dp, dim=-1)
        J = torch.cat([J_w, duv_dp], dim=-1)            # (..., N, 2, 6)
        r_norm = torch.linalg.vector_norm(r, dim=-1)
        huber = torch.clamp(huber_px / torch.clamp(r_norm, min=1e-9),
                            max=1.0)
        sw = torch.sqrt(torch.clamp(w * huber, min=0.0))[..., None]
        G = torch.cat([J, r[..., None]], dim=-1) * sw[..., None]
        G = G.reshape(G.shape[:-3] + (-1, 7))
        M = G.transpose(-1, -2) @ G
        JtJ, Jtr = M[..., :6, :6], M[..., :6, 6]
        delta = smallmat.chol_solve(JtJ + damping * eye6, -Jtr)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        R = _rodrigues(delta[..., :3]) @ R
        t = t + delta[..., 3:]
    return R, t


def _sample_minimal_sets(generator, valid, n_hyp: int, k: int = 6,
                         quality=None, quality_pow: float = 2.0):
    """(C, n_hyp, k) index sets drawn from the valid masks (C, N).

    One Gumbel-noised permutation per candidate ranks the valid points
    first; each hypothesis takes a k-long block of it at a random offset
    modulo the valid count. With ``quality`` (higher = more trustworthy)
    the permutation becomes a quality ordering and offsets concentrate at
    its top (off = n_valid * u^quality_pow), PROSAC-style."""
    c, n = valid.shape
    dev = valid.device
    u = torch.rand((c, n), generator=generator, device=dev)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    if quality is not None:
        q = quality.to(torch.float32)
        qmax = torch.where(valid, q, -torch.inf).amax(-1, keepdim=True)
        qmin = torch.where(valid, q, torch.inf).amin(-1, keepdim=True)
        spread = torch.clamp(qmax - qmin, min=1e-6)
        g = q * (64.0 / spread) + g
    order = torch.argsort(torch.where(valid, g, -torch.inf), dim=-1,
                          descending=True, stable=True)   # valid first
    n_valid = torch.clamp(valid.sum(-1), min=1)[:, None, None]
    u = torch.rand((c, n_hyp, 1), generator=generator, device=dev)
    if quality is not None:
        off = (u ** quality_pow * n_valid.to(torch.float32)).to(torch.int64)
    else:
        off = torch.floor(u * n_valid.to(torch.float32)).to(torch.int64)
    pos = (off + torch.arange(k, device=dev)) % n_valid
    return torch.gather(order, 1, pos.reshape(c, -1)).reshape(c, n_hyp, k)


def _take(x, idx):
    """x: (C, N, ...) gathered along N by idx (C, ...) -> (C, ..., ...)."""
    c = x.shape[0]
    ci = torch.arange(c, device=x.device).view((c,) + (1,) * (idx.dim() - 1))
    return x[ci, idx]


def compact_correspondences(obj_pts, img_pts, valid, k_max: int,
                            quality=None):
    """Pack each candidate's valid correspondences into ``k_max`` slots.

    obj_pts (C, N, 3), img_pts (C, N, 2), valid (C, N), quality (C, N) or
    None. With ``n_valid <= k_max`` every valid point is kept, densely
    packed; otherwise an order-preserving uniform subsample: the i-th valid
    point is kept when ``floor(i * k_max / n_valid)`` steps up, so the
    grid's spatial spread survives and no quality bias enters the
    consensus band. Kept points come first in their original order (one
    argsort of a key that puts kept indices before the rest).

    Returns ``(obj_k, img_k, valid_k, quality_k, n_valid, n_kept)`` with
    (C, k_max) slots; ``n_valid / max(n_kept, 1)`` rescales subsampled
    inlier counts to full-grid units.
    """
    valid = valid.to(torch.bool)
    n = valid.shape[-1]
    cum = torch.cumsum(valid.to(torch.int32), dim=-1)
    n_valid = cum[..., -1]
    scale = torch.clamp(k_max / torch.clamp(n_valid.to(torch.float32),
                                            min=1.0), max=1.0)
    tgt = torch.floor(cum.to(torch.float32) * scale[..., None] + 1e-4) \
        .to(torch.int32)
    prev = torch.cat([torch.zeros_like(tgt[..., :1]), tgt[..., :-1]], -1)
    keep = valid & (tgt > prev)
    n_kept = keep.sum(-1, dtype=torch.int32)
    ar = torch.arange(n, device=valid.device)
    idx = torch.argsort(torch.where(keep, ar, n + ar), dim=-1)[..., :k_max]
    valid_k = ar[:k_max] < n_kept[..., None]
    obj_k = torch.where(valid_k[..., None], _take(obj_pts, idx), 0.0)
    img_k = torch.where(valid_k[..., None], _take(img_pts, idx), 0.0)
    q_k = (None if quality is None
           else torch.where(valid_k, _take(quality, idx), 0.0))
    return obj_k, img_k, valid_k, q_k, n_valid, n_kept


def pnp_ransac_batch(obj_pts, img_pts, valid, K, generator=None,
                     quality=None, *, iters: int = 100,
                     reproj_px: float = 5.0, min_pts: int = 6,
                     refine_iters: int = 8, sample_k: int = 6,
                     sample_k_big: int = 12, hyp_polish_iters: int = 3,
                     select_stride: int | None = None,
                     sample_idx=None) -> PnPResult:
    """RANSAC EPnP-equivalent poses for C candidates.

    Args:
      obj_pts: (C, N, 3) model coordinates (mm).
      img_pts: (C, N, 2) pixel coordinates (u, v).
      valid: (C, N) bool correspondence masks.
      K: (3, 3) intrinsics, or (C, 3, 3) per candidate.
      generator: ``torch.Generator`` on the points' device, or a
        sequence of G of them, one per consecutive group of C/G
        candidates (unused when ``sample_idx`` is given).
      quality: optional (C, N) trust scores (higher = better), enabling
        PROSAC-style sampling.
      iters: hypotheses, split into iters//2 sets of ``sample_k`` points
        and the rest of ``sample_k_big``.
      sample_idx: optional ``(idx_small (C, iters//2, sample_k),
        idx_big (C, iters - iters//2, sample_k_big))`` index sets used in
        place of drawing them.

    The index sets are drawn eagerly; the solve that follows is
    :func:`_ransac_body`, run as it is on the CPU and replayed from a CUDA
    graph on the card (:func:`_graphed_body`): the same kernels on the same
    shapes, launched by one replay in place of ~11 000 dispatches.

    Returns:
      :class:`PnPResult` with a leading C axis; ``ok=False`` (identity
      pose, n_inliers=-1) with fewer than ``min_pts`` valid points.
    """
    dev = obj_pts.device
    obj_pts = obj_pts.to(torch.float32)
    img_pts = img_pts.to(torch.float32)
    valid = valid.to(torch.bool)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    if sample_idx is None:
        idx_a, idx_b = _draw_index_sets(generator, valid, quality, iters,
                                        sample_k, sample_k_big)
    else:
        idx_a, idx_b = (torch.as_tensor(i, device=dev).to(torch.int64)
                        for i in sample_idx)
    if select_stride is None:
        select_stride = 2 if valid.shape[-1] >= 1024 else 1
    args = (obj_pts, img_pts, valid, K, idx_a, idx_b)
    settings = dict(reproj_px=reproj_px, min_pts=min_pts,
                    refine_iters=refine_iters,
                    hyp_polish_iters=hyp_polish_iters,
                    select_stride=select_stride)
    if dev.type == "cuda":
        return _graphed_body(args, settings)
    return _ransac_body(*args, **settings)


pnp_ransac_batch.graph_captures = 0  # CUDA graphs captured, one per key
pnp_ransac_batch.graph_replays = 0   # calls served by a graph replay


def _draw_index_sets(generator, valid, quality, iters: int, sample_k: int,
                     sample_k_big: int):
    """``(idx_small (C, iters//2, sample_k), idx_big (C, iters - iters//2,
    sample_k_big))`` for the valid masks (C, N): one generator, or one per
    equal-sized group of candidates, each drawing its group's small sets
    and then its big sets, so a group's sets are those of a call on that
    group alone."""
    c = valid.shape[0]
    n_min = iters // 2
    gens = generator if isinstance(generator, (list, tuple)) \
        else [generator]
    if c % len(gens):
        raise ValueError(f"{c} candidates do not split into "
                         f"{len(gens)} equal groups")
    per = c // len(gens)
    sets = []
    for i, g in enumerate(gens):
        rows = slice(i * per, (i + 1) * per)
        q = None if quality is None else quality[rows]
        sets.append((
            _sample_minimal_sets(g, valid[rows], n_min, sample_k, q),
            _sample_minimal_sets(g, valid[rows], iters - n_min,
                                 sample_k_big, q)))
    return tuple(torch.cat(x) for x in zip(*sets))


def _ransac_body(obj_pts, img_pts, valid, K, idx_a, idx_b, *,
                 reproj_px: float, min_pts: int, refine_iters: int,
                 hyp_polish_iters: int, select_stride: int) -> PnPResult:
    """Everything after the draws: normalisation, the hypotheses, their
    scoring, the consensus refit and the final recount. obj_pts (C, N, 3)
    and img_pts (C, N, 2) float32, valid (C, N) bool, K (3, 3) or
    (C, 3, 3) float32, idx_a / idx_b int64, all on one device. Its shapes
    follow from the inputs' alone, and it neither reads a value back to the
    host nor copies one to the device, so a CUDA graph can capture it."""
    dev = obj_pts.device
    c = valid.shape[0]
    wf = valid.to(torch.float32)
    n_valid = wf.sum(-1)

    # normalize object coordinates for DLT conditioning
    obj_mean = (obj_pts * wf[..., None]).sum(-2) \
        / torch.clamp(n_valid, min=1.0)[:, None]
    centered = (obj_pts - obj_mean[:, None]) * wf[..., None]
    obj_scale = torch.sqrt((centered ** 2).sum((-2, -1))
                           / torch.clamp(n_valid * 3.0, min=1.0))
    obj_scale = torch.clamp(obj_scale, min=1e-6)
    obj_n = (obj_pts - obj_mean[:, None]) / obj_scale[:, None, None]
    cam_n = _normalized_cam(img_pts, K)

    def hypotheses(idx):
        h_obj = _take(obj_n, idx)                      # (C, R, k, 3)
        h_cam = _take(cam_n, idx)
        h_w = _take(valid, idx).to(torch.float32)
        ata = _dlt_normal_matrix(h_obj, h_cam, h_w)
        ata = torch.where(torch.isfinite(ata), ata, 0.0)
        p_min = smallmat.dlt_min_vec(ata)              # (C, R, 12)
        Rs, ts = _pose_from_p(p_min, obj_mean[:, None], obj_scale[:, None],
                              h_obj)
        if hyp_polish_iters <= 0:
            return Rs, ts
        Rs_p, ts_p = _gauss_newton_refine(
            Rs, ts, _take(obj_pts, idx), _take(img_pts, idx), h_w, K,
            iters=hyp_polish_iters, huber_px=reproj_px)
        return torch.cat([Rs, Rs_p], 1), torch.cat([ts, ts_p], 1)

    Rs_a, ts_a = hypotheses(idx_a)
    Rs_b, ts_b = hypotheses(idx_b)
    Rs = torch.cat([Rs_a, Rs_b], 1)                    # (C, H, 3, 3)
    ts = torch.cat([ts_a, ts_b], 1)

    # --- scoring: every hypothesis on a strided point subset; the first
    # maximum wins (the JAX package's chunked scan has the same rule)
    finite = (torch.isfinite(Rs).all(-1).all(-1)
              & torch.isfinite(ts).all(-1))
    ss = select_stride
    obj_s, img_s, val_s = obj_pts[:, ::ss], img_pts[:, ::ss], valid[:, ::ss]
    proj = project(obj_s[:, None], Rs, ts, K)          # (C, H, Ns, 2)
    err = torch.linalg.vector_norm(proj - img_s[:, None], dim=-1)
    depth = (obj_s[:, None] @ Rs[..., 2, :, None])[..., 0] + ts[..., 2:3]
    inl = (err < reproj_px) & val_s[:, None] & (depth > 0)
    sc = torch.where(finite, inl.sum(-1), -1)
    best = smallmat.first_argmax(sc, dim=-1)            # (C,)
    ci = torch.arange(c, device=dev)
    best_score = sc[ci, best]
    best_R, best_t = Rs[ci, best], ts[ci, best]

    # consensus set of the winning hypothesis
    err_b = torch.linalg.vector_norm(
        project(obj_pts, best_R, best_t, K) - img_pts, dim=-1)
    depth_b = (obj_pts @ best_R[:, 2, :, None])[..., 0] + best_t[:, 2:3]
    best_inl = (err_b < reproj_px) & valid & (depth_b > 0)

    # --- refit on consensus -> Huber GN -> half-band tighten -> GN
    def all_finite(x):
        return torch.isfinite(x.reshape(c, -1)).all(-1)

    w_in = best_inl.to(torch.float32)
    enough = w_in.sum(-1) >= min_pts
    w_fit = torch.where(enough[:, None], w_in, wf)  # fallback: all valid
    ata_all = _dlt_normal_matrix(obj_n, cam_n, w_fit)
    ata_all = torch.where(torch.isfinite(ata_all), ata_all, 0.0)
    p_all = smallmat.dlt_min_vec(ata_all)
    R_fit, t_fit = _pose_from_p(p_all, obj_mean, obj_scale,
                                obj_n * w_fit[..., None])
    fit_ok = all_finite(R_fit) & all_finite(t_fit)
    R_fit = torch.where(fit_ok[:, None, None], R_fit, best_R)
    t_fit = torch.where(fit_ok[:, None], t_fit, best_t)
    R_ref, t_ref = _gauss_newton_refine(R_fit, t_fit, obj_pts, img_pts,
                                        w_fit, K, iters=refine_iters)
    ref_ok = all_finite(R_ref) & all_finite(t_ref)
    R_ref = torch.where(ref_ok[:, None, None], R_ref, R_fit)
    t_ref = torch.where(ref_ok[:, None], t_ref, t_fit)

    err_t = torch.linalg.vector_norm(
        project(obj_pts, R_ref, t_ref, K) - img_pts, dim=-1)
    w_tight = ((err_t < 0.5 * reproj_px) & valid).to(torch.float32)
    tight_ok = w_tight.sum(-1) >= min_pts
    w2 = torch.where(tight_ok[:, None], w_tight, w_fit)
    R_t2, t_t2 = _gauss_newton_refine(R_ref, t_ref, obj_pts, img_pts, w2,
                                      K, iters=refine_iters // 2 + 1)
    good2 = all_finite(R_t2) & all_finite(t_t2)
    R_ref = torch.where(good2[:, None, None], R_t2, R_ref)
    t_ref = torch.where(good2[:, None], t_t2, t_ref)

    # recount inliers with the refined pose (OpenCV's returned set)
    err_f = torch.linalg.vector_norm(
        project(obj_pts, R_ref, t_ref, K) - img_pts, dim=-1)
    depth_f = (obj_pts @ R_ref[:, 2, :, None])[..., 0] + t_ref[:, 2:3]
    inl_f = (err_f < reproj_px) & valid & (depth_f > 0)

    ok = (n_valid >= min_pts) & (best_score > 0)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return PnPResult(
        R=torch.where(ok[:, None, None], R_ref, eye),
        t=torch.where(ok[:, None], t_ref, 0.0),
        n_inliers=torch.where(ok, inl_f.sum(-1), -1).to(torch.int32),
        inlier_mask=inl_f & ok[:, None],
        ok=ok)


# The solve's CUDA graphs by key: device, stream, the float32 matmul
# precision (a capture fixes the cuBLAS math mode that held when it ran),
# the inputs' shapes and types, the settings. Nothing is evicted: a key
# holds its static buffers for the life of the process.
_graphs: dict = {}
# one memory pool per (device, stream), shared by that stream's graphs:
# they never run at once, and each replay's outputs are cloned before the
# next replay can reuse the pool
_pools: dict = {}
_graph_lock = threading.Lock()


def _graphed_body(args, settings) -> PnPResult:
    """:func:`_ransac_body` on CUDA tensors as a CUDA graph replay.

    The first call for a key copies its inputs into static buffers, runs
    the body once eagerly on a side stream (as ``torch.cuda.graph`` asks)
    and captures it. Every call copies its inputs into the key's buffers,
    replays the graph on the current stream and returns clones, so no
    result aliases the graph's memory and a result held across calls
    stays as it was. The RANSAC draws stay outside the graph, so the
    generators advance as in an eager call and need no registering with
    it. One replay takes the place of ~11 000 operator dispatches a call
    (32 hypotheses, N = 1 024), and runs the same kernels on the same
    shapes: the results are bit-equal to the eager body's."""
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        key = (dev, stream.cuda_stream,
               torch.backends.cuda.matmul.allow_tf32,
               torch.get_float32_matmul_precision(),
               tuple((tuple(a.shape), a.dtype) for a in args),
               tuple(sorted(settings.items())))
        with _graph_lock:
            entry = _graphs.get(key)
            if entry is None:
                if key[:2] not in _pools:
                    _pools[key[:2]] = torch.cuda.graph_pool_handle()
                entry = _graphs[key] = _capture(args, settings, stream,
                                                _pools[key[:2]])
                pnp_ransac_batch.graph_captures += 1
            graph, static_in, static_out = entry
            for buf, a in zip(static_in, args):
                buf.copy_(a)
            graph.replay()
            out = PnPResult(*(x.clone() for x in static_out))
            pnp_ransac_batch.graph_replays += 1
    return out


def _capture(args, settings, stream, pool):
    """(graph, static inputs, static outputs) of :func:`_ransac_body` on
    buffers holding ``args``. ``thread_local`` capture: the server's
    threads go on launching beside the thread that captures."""
    static_in = tuple(a.clone(memory_format=torch.contiguous_format)
                      for a in args)
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        _ransac_body(*static_in, **settings)
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode="thread_local"):
        static_out = _ransac_body(*static_in, **settings)
    return graph, static_in, static_out


def pnp_ransac(obj_pts, img_pts, valid, K, generator=None, quality=None,
               sample_idx=None, **kwargs) -> PnPResult:
    """One candidate: (N, 3), (N, 2), (N,) -> unbatched :class:`PnPResult`.
    ``sample_idx`` is ``(idx_small (R1, k), idx_big (R2, k_big))``."""
    if sample_idx is not None:
        sample_idx = tuple(torch.as_tensor(np.asarray(i).copy())[None]
                           for i in sample_idx)
    res = pnp_ransac_batch(
        obj_pts[None], img_pts[None], valid[None], K, generator,
        None if quality is None else quality[None], sample_idx=sample_idx,
        **kwargs)
    return PnPResult(*(x[0] for x in res))
