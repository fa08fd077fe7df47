"""Batched small-matrix solvers (port of :mod:`pix2pose_tpu.ops.smallmat`).

Fixed-iteration, pivot-free programs over a leading batch: a Cholesky
solve whose diagonal is floored (garbage-but-finite on singular input, which
the RANSAC-style callers score and reject), the pinned DLT null-vector
solve, and the nearest rotation by quaternion power iteration. They keep
the JAX package's semantics, so PnP and ICP agree across the two packages.
"""

from __future__ import annotations

import torch


def chol_solve(A, b, damping: float = 0.0):
    """Solve SPD ``A x = b`` by a Cholesky factorization with a floored
    diagonal. A: (..., k, k); b: (..., k). ``damping`` adds
    ``damping * mean(diag(A)) * I`` for rank safety.

    Column-oriented: k vector steps per phase instead of the JAX package's
    k^3/6 scalar steps (each step is one launch on a GPU)."""
    k = A.shape[-1]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    if damping:
        tr = torch.diagonal(A, dim1=-2, dim2=-1).mean(dim=-1)
        A = A + (damping * tr + 1e-30)[..., None, None] * eye
    L = torch.zeros_like(A)
    for j in range(k):
        s = A[..., j:, j] - (L[..., j:, :j] * L[..., j:j + 1, :j]).sum(-1)
        d = torch.sqrt(torch.clamp(s[..., 0], min=1e-30))
        L[..., j, j] = d
        L[..., j + 1:, j] = s[..., 1:] / d[..., None]
    y = torch.zeros_like(b)
    for i in range(k):
        y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(-1)) \
            / L[..., i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(k)):
        x[..., i] = (y[..., i]
                     - (L[..., i + 1:, i] * x[..., i + 1:]).sum(-1)) \
            / L[..., i, i]
    return x


def dlt_min_vec(ata, pin: int = 11, damping: float = 1e-7):
    """Approximate smallest-eigenvalue vector of DLT normal matrices by a
    PINNED affine solve: component ``pin`` of p = [q; 1] is fixed to 1 and
    ``M11 q = -m12`` is solved by :func:`chol_solve`. Component 11 is the
    z-translation of the projective pose, never near zero for visible
    objects. ata: (..., 12, 12). Returns (..., 12), unit norm."""
    # the rows and columns other than ``pin``, by slices: an index list
    # would be copied to the device on every call
    rows = torch.cat([ata[..., :pin, :], ata[..., pin + 1:, :]], dim=-2)
    M11 = torch.cat([rows[..., :pin], rows[..., pin + 1:]], dim=-1)
    m12 = rows[..., pin].contiguous()
    q = chol_solve(M11, -m12, damping=damping)
    one = torch.ones(q.shape[:-1] + (1,), dtype=q.dtype, device=q.device)
    p = torch.cat([q[..., :pin], one, q[..., pin:]], dim=-1)
    return p / torch.clamp(torch.linalg.vector_norm(p, dim=-1,
                                                    keepdim=True),
                           min=1e-20)


def _quat_to_rot(q):
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def nearest_rotation_scale(M, iters: int = 20):
    """Nearest proper rotation to M (Kabsch) and the optimal scale.

    Returns (R, lam) with R = argmax_{R in SO(3)} tr(R^T M) and
    lam = tr(R^T M) / 3. The optimal quaternion is the top eigenvector of
    Davenport's 4x4 K matrix, found by shifted power iteration from all four
    basis starts at once (one start can be orthogonal to the answer for
    180-degree rotations), keeping the Rayleigh-best. M: (..., 3, 3).
    """
    m = lambda i, j: M[..., i, j]
    t = m(0, 0) + m(1, 1) + m(2, 2)
    K = torch.stack([
        torch.stack([t, m(1, 2) - m(2, 1), m(2, 0) - m(0, 2),
                     m(0, 1) - m(1, 0)], -1),
        torch.stack([m(1, 2) - m(2, 1), m(0, 0) - m(1, 1) - m(2, 2),
                     m(0, 1) + m(1, 0), m(2, 0) + m(0, 2)], -1),
        torch.stack([m(2, 0) - m(0, 2), m(0, 1) + m(1, 0),
                     m(1, 1) - m(0, 0) - m(2, 2), m(1, 2) + m(2, 1)], -1),
        torch.stack([m(0, 1) - m(1, 0), m(2, 0) + m(0, 2),
                     m(1, 2) + m(2, 1), m(2, 2) - m(0, 0) - m(1, 1)], -1),
    ], -2)
    eye4 = torch.eye(4, dtype=M.dtype, device=M.device)
    sig = 2.0 * torch.sqrt(torch.sum(M * M, dim=(-2, -1))) + 1e-12
    B = K + sig[..., None, None] * eye4
    q = eye4.expand(B.shape)          # starts on the last axis
    for _ in range(iters):
        q = B @ q
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-2,
                                                     keepdim=True),
                            min=1e-30)
    ray = torch.sum(q * (K @ q), dim=-2)  # (..., 4) Rayleigh per start
    best = first_argmax(ray, dim=-1)
    q = torch.take_along_dim(q, best[..., None, None].expand(
        q.shape[:-1] + (1,)), dim=-1)[..., 0]
    # _quat_to_rot's convention maximizes tr(R M) for this K; tr(R^T M)
    # wants the transpose
    R = _quat_to_rot(q).transpose(-1, -2)
    lam = torch.sum(R * M, dim=(-2, -1)) / 3.0
    return R, lam


def first_argmax(x, dim: int = -1):
    """Index of the FIRST maximum along ``dim`` (the tie rule of
    ``jnp.argmax``, which also ranks NaN above everything), independent
    of the backend's reduction order."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.inf, x)
    mx = x.amax(dim=dim, keepdim=True)
    n = x.shape[dim]
    ar = torch.arange(n, device=x.device)
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.where(x == mx, ar.view(shape), n)
    return idx.amin(dim=dim)
