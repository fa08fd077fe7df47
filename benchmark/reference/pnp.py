"""Plain PnP-RANSAC of the reference, in float64.

Uniform minimal sets of six correspondences, a linear (DLT) pose from
each, the consensus within the reprojection band counted on every point;
then local optimisation of the best: a DLT refit on its consensus and
Gauss-Newton on the reprojection error, recounted, for a few rounds. It
gives the largest consensus it finds, which a served pose's inlier count
is held against from below.

Nothing here imports the program.
"""

from __future__ import annotations

import torch

SAMPLE = 6


def _normalize(obj, valid):
    """Object points centred and scaled over each candidate's valid
    points: (X - mean) / scale."""
    w = valid.to(obj.dtype)[..., None]
    n = w.sum(-2).clamp(min=1.0)
    mean = (obj * w).sum(-2) / n
    sq = (((obj - mean[..., None, :]) ** 2) * w).sum((-2, -1)) \
        / (3.0 * n[..., 0])
    scale = sq.sqrt().clamp(min=1e-9)
    return (obj - mean[..., None, :]) / scale[..., None, None], mean, scale


def dlt(obj_n, cam, w, mean, scale):
    """Poses (R, t) minimizing the algebraic error of x ~ P [X_n; 1] over
    weighted correspondences: obj_n (..., n, 3) normalized, cam (..., n, 2)
    normalized image coordinates, w (..., n); mean (..., 3), scale (...)
    undo the normalization."""
    one = torch.ones_like(obj_n[..., :1])
    xh = torch.cat([obj_n, one], -1)                         # (..., n, 4)
    z = torch.zeros_like(xh)
    x, y = cam[..., 0:1], cam[..., 1:2]
    r1 = torch.cat([xh, z, -x * xh], -1)
    r2 = torch.cat([z, xh, -y * xh], -1)
    a = torch.cat([r1, r2], -2) * torch.cat([w, w], -1)[..., None].sqrt()
    ata = a.transpose(-1, -2) @ a
    ata = torch.where(torch.isfinite(ata), ata, 0.0)
    p = torch.linalg.eigh(ata)[1][..., 0].reshape(ata.shape[:-2] + (3, 4))
    # the centroid in front of the camera
    p = torch.where(p[..., 2:3, 3:4] < 0, -p, p)
    m = p[..., :3] / scale[..., None, None]
    p4 = p[..., 3] - (m @ mean[..., None])[..., 0]
    u, s, vh = torch.linalg.svd(m)
    d = torch.linalg.det(u @ vh)
    fix = torch.ones_like(s)
    fix[..., 2] = d
    rot = u @ (fix[..., None] * vh)
    t = p4 / s.mean(-1, keepdim=True).clamp(min=1e-12)
    return rot, t


def project(obj, rot, t, k):
    """Pixel coordinates and depth of obj (..., n, 3) under (R, t)."""
    p = obj @ rot.transpose(-1, -2) + t[..., None, :]
    z = p[..., 2]
    zs = torch.where(z.abs() < 1e-12, 1e-12, z)
    u = k[0, 0] * p[..., 0] / zs + k[0, 2]
    v = k[1, 1] * p[..., 1] / zs + k[1, 2]
    return torch.stack([u, v], -1), z


def inliers(obj, img, valid, rot, t, k, px: float):
    uv, z = project(obj, rot, t, k)
    err = (uv - img).norm(dim=-1)
    return (err < px) & valid & (z > 0)


def _skew(v):
    o = torch.zeros_like(v[..., 0])
    return torch.stack([o, -v[..., 2], v[..., 1], v[..., 2], o, -v[..., 0],
                        -v[..., 1], v[..., 0], o], -1) \
        .reshape(v.shape[:-1] + (3, 3))


def gauss_newton(obj, img, w, rot, t, k, iters: int = 10):
    """Damped Gauss-Newton on the weighted squared reprojection error in
    pixels, over a rotation increment (R <- exp([d]x) R) and t."""
    fx, fy = k[0, 0], k[1, 1]
    for _ in range(iters):
        rx = obj @ rot.transpose(-1, -2)                     # (..., n, 3)
        p = rx + t[..., None, :]
        z = p[..., 2]
        ok = (z > 1e-6) & (w > 0)
        zs = torch.where(ok, z, 1.0)
        uv = torch.stack([fx * p[..., 0] / zs + k[0, 2],
                          fy * p[..., 1] / zs + k[1, 2]], -1)
        r = torch.where(ok[..., None], uv - img, 0.0)
        zero = torch.zeros_like(zs)
        dpi = torch.stack([
            torch.stack([fx / zs, zero, -fx * p[..., 0] / zs ** 2], -1),
            torch.stack([zero, fy / zs, -fy * p[..., 1] / zs ** 2], -1)],
            -2)                                              # (..., n, 2, 3)
        eye = torch.eye(3, dtype=obj.dtype, device=obj.device) \
            .expand(rx.shape[:-1] + (3, 3))
        jac = dpi @ torch.cat([-_skew(rx), eye], -1)         # (..., n, 2, 6)
        wt = torch.where(ok, w, 0.0)[..., None, None]
        h = (jac.transpose(-1, -2) @ (jac * wt)).sum(-3)
        g = (jac.transpose(-1, -2) @ (r[..., None] * wt)).sum(-3)[..., 0]
        h = h + 1e-6 * torch.diag_embed(
            torch.diagonal(h, dim1=-2, dim2=-1) + 1.0)
        step = -torch.linalg.solve(h, g[..., None])[..., 0]
        step = torch.where(torch.isfinite(step), step, 0.0)
        rot = torch.linalg.matrix_exp(_skew(step[..., :3])) @ rot
        t = t + step[..., 3:]
    return rot, t


def ransac(obj, img, valid, k, gen: torch.Generator, hypotheses: int,
           px: float, rounds: int = 3, chunk: int = 16):
    """Largest consensus found per candidate: obj (C, n, 3) mm, img (C, n, 2)
    px, valid (C, n) bool, k (3, 3). Returns (count (C,) int64, R, t); a
    candidate with fewer than six valid points counts 0."""
    out_n, out_r, out_t = [], [], []
    for c0 in range(0, obj.shape[0], chunk):
        n_, r_, t_ = _ransac(obj[c0:c0 + chunk].double(),
                             img[c0:c0 + chunk].double(),
                             valid[c0:c0 + chunk], k.double(), gen,
                             hypotheses, px, rounds)
        out_n.append(n_)
        out_r.append(r_)
        out_t.append(t_)
    return torch.cat(out_n), torch.cat(out_r), torch.cat(out_t)


def _ransac(obj, img, valid, k, gen, hyps: int, px: float, rounds: int):
    c, n = valid.shape
    kinv = torch.linalg.inv(k)
    cam = (torch.cat([img, torch.ones_like(img[..., :1])], -1)
           @ kinv.T)[..., :2]
    obj_n, mean, scale = _normalize(obj, valid)
    # uniform sets of six distinct valid points
    keys = torch.rand((c, hyps, n), generator=gen, device=obj.device,
                      dtype=torch.float64)
    keys = torch.where(valid[:, None], keys, -1.0)
    idx = keys.topk(SAMPLE, dim=-1).indices                  # (C, H, 6)

    def take(a):
        return torch.take_along_dim(a[:, None], idx[..., None], dim=2)

    w_s = torch.ones(idx.shape, dtype=obj.dtype, device=obj.device)
    rot, t = dlt(take(obj_n), take(cam), w_s, mean[:, None],
                 scale[:, None])
    finite = torch.isfinite(rot).all(-1).all(-1) & torch.isfinite(t).all(-1)
    inl = inliers(obj[:, None], img[:, None], valid[:, None], rot, t, k, px)
    score = torch.where(finite, inl.sum(-1), -1)
    best = score.argmax(-1)
    ci = torch.arange(c, device=obj.device)
    b_rot, b_t, b_n = rot[ci, best], t[ci, best], score[ci, best]
    b_inl = inl[ci, best]
    for _ in range(rounds):
        w = b_inl.to(obj.dtype)
        enough = w.sum(-1) >= SAMPLE
        r2, t2 = dlt(obj_n, cam, w, mean, scale)
        r2, t2 = gauss_newton(obj, img, w, r2, t2, k)
        r3, t3 = gauss_newton(obj, img, w, b_rot, b_t, k)
        for rr, tt in ((r2, t2), (r3, t3)):
            ok = enough & torch.isfinite(rr).all(-1).all(-1) \
                & torch.isfinite(tt).all(-1)
            m = inliers(obj, img, valid, rr, tt, k, px)
            # a refined pose replaces the best on a tie
            better = ok & (m.sum(-1) >= b_n)
            b_rot = torch.where(better[:, None, None], rr, b_rot)
            b_t = torch.where(better[:, None], tt, b_t)
            b_n = torch.where(better, m.sum(-1), b_n)
            b_inl = torch.where(better[:, None], m, b_inl)
    enough_pts = valid.sum(-1) >= SAMPLE
    return torch.where(enough_pts, b_n.clamp(min=0), 0), b_rot, b_t
