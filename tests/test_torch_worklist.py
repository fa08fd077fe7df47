"""The z-buffer kernel's device-built (tile, chunk) work list and its
order-free key merge, in their plain versions on the CPU.

- The plain work list (:func:`rasterizer_cuda._work_list_plain`, which the
  card's build kernel is held against) gives, at 16x128 tiles, the WORK entries
  of the JAX ``_build_pairs`` with a capacity that does not overflow, and
  at the kernel's own tile the tiles that a brute-force overlap finds.
- A plain emulation of the merge (work items in a shuffled order, one
  64-bit (1/z bits, ~face) key per covered pixel and item, max merge, a and
  b recomputed from the winner) equals ``_binned_core_plain`` bit for bit,
  on a mesh with duplicated faces (exact ties) and on large triangles
  near the camera whose chunks span the whole frame.
- On the tie mesh the port's ``rasterize_binned`` (CPU: plain version) and
  the JAX ``rasterize_pallas_binned`` in interpret mode give the same mask
  and the same winning face on every covered pixel.
- The kernel's per-face cull box, copied here in float64, holds every
  pixel that the float coverage test covers, on a sphere, on
  near-degenerate slivers and on triangles a few ulps off the pixel
  grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2pose_tpu.ops import rasterizer_pallas as rp
from pix2pose_tpu.ops.rasterizer import project_vertices
from pix2pose_torch.ops import rasterizer_cuda as rc
from pix2pose_torch.ops.smallmat import first_argmax
from pix2pose_torch.utils.synthetic import CAM_K, pose_with_euler, uv_sphere

torch.set_num_threads(1)

H, W = 96, 256  # tiles by 16x128, so the JAX functions take it too


def _camera(h, w):
    k = CAM_K.copy()
    k[0, 2], k[1, 2] = w / 2.0, h / 2.0
    return k


def tie_mesh(n_hyp=2, h=H, w=W):
    """A 2024-face sphere with every face listed twice: each pair has equal
    coefficients, so every covered pixel is an exact tie. Returns numpy
    uv (P, V, 2), z (P, V), faces (F, 3)."""
    verts, faces = uv_sphere(24, 44, 40.0)
    faces = np.concatenate([faces, faces])
    uvs, zs = [], []
    for i in range(n_hyp):
        R, t = pose_with_euler(yaw=0.4 + 0.5 * i, pitch=-0.3, tx=4.0 * i,
                               ty=-2.0, tz=300.0 + 30 * i)
        uv, z = project_vertices(jnp.asarray(verts), R, t,
                                 jnp.asarray(_camera(h, w)))
        uvs.append(np.asarray(uv))
        zs.append(np.asarray(z))
    return np.stack(uvs), np.stack(zs), faces


def spanning_mesh(n_hyp=2, n_faces=1024, h=H, w=W, seed=0):
    """Large triangles near the camera: vertices uniform over twice the
    frame, depths 0.5-2, so every 128-face chunk spans the whole frame."""
    rng = np.random.default_rng(seed)
    n_v = 3 * n_faces
    uv = np.stack([rng.uniform(-0.5 * w, 1.5 * w, (n_hyp, n_v)),
                   rng.uniform(-0.5 * h, 1.5 * h, (n_hyp, n_v))],
                  -1).astype(np.float32)
    z = rng.uniform(0.5, 2.0, (n_hyp, n_v)).astype(np.float32)
    return uv, z, np.arange(n_v, dtype=np.int32).reshape(n_faces, 3)


def _set(rows):
    return {tuple(int(x) for x in r) for r in rows}


def test_work_list_matches_jax_pairs_and_brute_force():
    uv, z, faces = tie_mesh()
    suv, sz, sfaces = spanning_mesh(n_hyp=1)
    # chunks that are off-screen on each side, empty, partly off-screen,
    # on the frame's last pixel, and NaN
    extra = torch.tensor([[-30.0, -1.0, 10.0, 50.0], [H, H + 9.0, 0, 9.0],
                          [5.0, 9.0, -20.0, -0.5], [5.0, 9.0, W - 0.9, W],
                          [1e9, -1e9, 1e9, -1e9], [-5.0, 20.5, -7.0, 40.0],
                          [H - 1.0, H - 1.0, W - 1.0, W - 1.0]])
    nan = torch.tensor([[float("nan"), 3.0, 3.0, 9.0]])
    for uv_i, z_i, f_i in ((uv[0], z[0], faces), (uv[1], z[1], faces),
                           (suv[0], sz[0], sfaces)):
        _, _, jb, nc = rp._sorted_tris(jnp.asarray(uv_i), jnp.asarray(z_i),
                                       jnp.asarray(f_i), H, W)
        bounds = torch.cat([torch.as_tensor(np.array(jb)), extra])
        n_tv, n_tu = H // rp.TILE_V, W // rp.TILE_U
        tv, tu, ch, flag, dropped = rp._build_pairs(
            jnp.asarray(bounds.numpy()), n_tv, n_tu,
            len(bounds) * n_tv * n_tu)
        work = np.asarray(flag) == rp.PAIR_FLAG_WORK
        assert int(dropped) == 0
        ref = _set(np.stack([np.asarray(tv)[work], np.asarray(tu)[work],
                             np.asarray(ch)[work]], 1))
        offsets, items = rc._work_list_plain(bounds[None], H, W, rp.TILE_V,
                                             rp.TILE_U)
        assert len(items) == work.sum() == int(offsets[-1])
        assert _set(items[:, 1:]) == ref

        # kernel tile: brute force over every (chunk, tile), the chunk's
        # bbox clipped to the frame against the tile's half-open rectangle
        bounds = torch.cat([bounds, nan])
        two = torch.stack([bounds, bounds.flip(0)])  # P=2
        offsets, items = rc._work_list_plain(two, H, W)
        tv_, tu_ = rc.KERNEL_TILE_V, rc.KERNEL_TILE_U
        b = two.numpy().astype(np.float64)
        v0, v1 = np.maximum(b[..., 0], 0), np.minimum(b[..., 1], H - 1)
        u0, u1 = np.maximum(b[..., 2], 0), np.minimum(b[..., 3], W - 1)
        gv = np.arange(-(-H // tv_))[:, None] * tv_
        gu = np.arange(-(-W // tu_))[:, None] * tu_
        brute = []
        for p in range(2):
            for c in range(b.shape[1]):
                rows = np.nonzero((v0[p, c] <= v1[p, c]) & (v1[p, c] >= gv)
                                  & (v0[p, c] < gv + tv_))[0]
                cols = np.nonzero((u0[p, c] <= u1[p, c]) & (u1[p, c] >= gu)
                                  & (u0[p, c] < gu + tu_))[0]
                brute += [[p, int(r), int(q), c] for r in rows for q in cols]
        assert items.tolist() == brute  # same entries, chunk-major order
        counts = np.diff(offsets.numpy())
        assert counts.sum() == len(brute) and (counts >= 0).all()


def merge_emulation(packed, bounds, h, w, seed, batch=24):
    """The kernel's K1 pipeline in plain torch: the work items of
    ``_work_list_plain`` in a shuffled order; per item, each pixel of the
    tile takes the max 1/z over the chunk's covering faces (strict ``>``
    in ascending face order, 1/z > 0) as the key (bits(1/z) << 32) |
    (0xFFFFFFFF - face); keys merge by max; a finalize decodes them and
    recomputes a, b from the winning face."""
    p_n, _, fp = packed.shape
    _, items = rc._work_list_plain(bounds, h, w)
    items = items[torch.from_numpy(
        np.random.default_rng(seed).permutation(len(items)))]
    dv, du = torch.meshgrid(torch.arange(rc.KERNEL_TILE_V),
                            torch.arange(rc.KERNEL_TILE_U), indexing="ij")
    lane = torch.arange(rc.FACE_CHUNK)
    keys = torch.zeros(p_n * h * w, dtype=torch.int64)
    for s in range(0, len(items), batch):
        it = items[s:s + batch]
        pv = (it[:, 1, None, None] * rc.KERNEL_TILE_V + dv).flatten(1)
        pu = (it[:, 2, None, None] * rc.KERNEL_TILE_U + du).flatten(1)
        fid = it[:, 3, None] * rc.FACE_CHUNK + lane          # (n, 128)
        c = packed[it[:, 0, None], :, fid][:, None]          # (n, 1, 128, 9)
        PU, PV = pu.float()[..., None], pv.float()[..., None]
        A = c[..., 0] * PU + c[..., 1] * PV + c[..., 2]       # (n, px, 128)
        B = c[..., 3] * PU + c[..., 4] * PV + c[..., 5]
        C = 1.0 - A - B
        Z = c[..., 6] * PU + c[..., 7] * PV + c[..., 8]
        cand = torch.where((A >= 0) & (B >= 0) & (C >= 0), Z, -1.0)
        cand = torch.where(torch.isnan(cand), -1.0, cand)
        j = first_argmax(cand, dim=2)
        best = cand.gather(2, j[..., None])[..., 0]
        win = fid.gather(1, j)
        ok = (best > 0) & (pv < h) & (pu < w)
        key = (best.view(torch.int32).to(torch.int64) << 32) \
            | (0xFFFFFFFF - win)
        idx = (it[:, 0, None] * h + pv) * w + pu
        keys.scatter_reduce_(0, idx[ok], key[ok], "amax")
    keys = keys.view(p_n, h, w)
    hit = keys > 0
    izb = torch.where(hit, (keys >> 32).to(torch.int32), 0).view(torch.float32)
    fidx = torch.where(hit, 0xFFFFFFFF - (keys & 0xFFFFFFFF), -1)
    pi = torch.arange(p_n)[:, None, None]
    cf = packed[pi, :, fidx.clamp(min=0)]                    # (P, h, w, 9)
    V, U = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                          torch.arange(w, dtype=torch.float32), indexing="ij")
    a = cf[..., 0] * U + cf[..., 1] * V + cf[..., 2]
    b = cf[..., 3] * U + cf[..., 4] * V + cf[..., 5]
    return (izb, fidx.to(torch.int32), torch.where(hit, a, 0.0),
            torch.where(hit, b, 0.0))


@pytest.mark.parametrize("mesh", ["ties", "spanning"])
def test_order_free_merge_is_bit_exact(mesh):
    uv, z, faces = tie_mesh() if mesh == "ties" else spanning_mesh()
    if mesh == "spanning":
        # at 480x640 these chunks overflow the JAX binned path's default
        # capacity, max(8 * chunks, 1024) pairs
        big_uv, big_z, _ = spanning_mesh(n_hyp=1, h=480, w=640)
        stats = rp.binned_pair_stats(big_uv[0], big_z[0], faces, 480, 640)
        assert not stats["fits"]
    f = torch.as_tensor(faces)[None].expand(len(uv), -1, -1)
    packed, _, bounds = rc._sorted_tris(torch.as_tensor(uv),
                                        torch.as_tensor(z), f, H, W)
    ref = rc._binned_core_plain(packed, bounds, H, W)
    assert int((ref[0] > 0).sum()) > 3000
    for seed in (0, 1):
        got = merge_emulation(packed, bounds, H, W, seed)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))


def test_tie_mesh_matches_jax_binned(monkeypatch):
    orig = rp._attr_epilogue
    monkeypatch.setattr(rp, "_attr_epilogue",
                        lambda *a, **k: (orig(*a, **k), a[1]))
    fn = jax.jit(rp.rasterize_pallas_binned.__wrapped__,
                 static_argnames=("h", "w", "pair_factor", "interpret"))
    uv, z, faces = tie_mesh()
    verts = np.zeros((uv.shape[1], 3), np.float32)
    got = rc.rasterize_binned(torch.as_tensor(uv), torch.as_tensor(z),
                              torch.as_tensor(faces)[None].expand(2, -1, -1),
                              torch.as_tensor(verts)[None].expand(2, -1, -1),
                              H, W)
    packed, _, bounds = rc._sorted_tris(
        torch.as_tensor(uv), torch.as_tensor(z),
        torch.as_tensor(faces)[None].expand(2, -1, -1), H, W)
    fidx = rc._binned_core_plain(packed, bounds, H, W)[1].numpy()
    for i in range(2):
        ref, ref_fidx = fn(uv[i], z[i], faces, verts, H, W, pair_factor=64,
                           interpret=True)
        assert int(ref.overflow) == 0
        m = np.asarray(ref.mask)
        assert m.sum() > 3000
        np.testing.assert_array_equal(got.mask[i].numpy(), m)
        np.testing.assert_array_equal(fidx[i][m], np.asarray(ref_fidx)[m])


def cull_boxes(packed, h, w):
    """A float64 copy of ``cull_box`` in ``csrc/rasterizer.cu`` for every
    face of ``packed`` (P, 9, Fp): (u_min, u_max, v_min, v_max), each
    (P, Fp); not finite where the kernel does not cull."""
    c = packed.double()
    au, av, a0, bu, bv, b0 = (c[:, i] for i in range(6))
    eps = 2.0 ** -23
    da = 4 * eps * (au.abs() * (w - 1) + av.abs() * (h - 1) + a0.abs()) \
        + 1e-30
    db = 4 * eps * (bu.abs() * (w - 1) + bv.abs() * (h - 1) + b0.abs()) \
        + 1e-30
    dc = da + db + 8 * eps
    inv = 1.0 / (au * bv - av * bu)
    ra = torch.stack([-da, 1 + dc + db, -da]) - a0
    rb = torch.stack([-db, -db, 1 + dc + da]) - b0
    u = (ra * bv - av * rb) * inv
    v = (au * rb - ra * bu) * inv
    return u.amin(0) - 1, u.amax(0) + 1, v.amin(0) - 1, v.amax(0) + 1


def test_cull_box_holds_every_covered_pixel():
    rng = np.random.default_rng(3)
    n = 2048     # slivers: a long edge, the third vertex 1e-7..1e-1 px off
    a = rng.uniform([0, 0], [W, H], (n, 2))
    d = rng.normal(size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = a[:, None] + rng.uniform(0, 200, (n, 3))[..., None] * d[:, None]
    off = rng.normal(size=n) * 10.0 ** rng.uniform(-7, -1, n)
    pts[:, 2] += off[:, None] * np.stack([-d[:, 1], d[:, 0]], 1)
    sliver = (torch.as_tensor(pts.reshape(1, -1, 2), dtype=torch.float32),
              torch.ones(1, 3 * n), torch.arange(3 * n).reshape(1, n, 3))
    # small triangles on integer pixels moved by a few float ulps: pixel
    # centers a rounding error outside an edge, which the float test may
    # cover (the box's rounding bound and margin are there for them)
    tri = rng.integers([128, 48], [W, H], (n, 1, 2)) \
        + rng.integers(-6, 7, (n, 3, 2))
    tri = tri.astype(np.float32)
    for _ in range(3):
        tri = np.where(rng.random(tri.shape) < 0.5,
                       np.nextafter(tri, np.float32(np.inf) * rng.choice(
                           [-1, 1], tri.shape).astype(np.float32)), tri)
    snapped = (torch.as_tensor(tri.reshape(1, -1, 2)), torch.ones(1, 3 * n),
               torch.arange(3 * n).reshape(1, n, 3))
    uv, z, faces = tie_mesh(n_hyp=1)
    sphere = (torch.as_tensor(uv), torch.as_tensor(z),
              torch.as_tensor(faces[:2024])[None])
    V, U = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                          torch.arange(W, dtype=torch.float32), indexing="ij")
    PU, PV = U.reshape(-1, 1), V.reshape(-1, 1)
    for (uv, z, f), least in ((sphere, 1000), (sliver, 50),
                              (snapped, 10000)):
        packed, _, _ = rc._sorted_tris(uv, z, f, H, W)
        box = cull_boxes(packed, H, W)
        covered = 0
        for s in range(0, packed.shape[2], 256):
            cf = packed[0, :, s:s + 256]
            A = cf[0] * PU + cf[1] * PV + cf[2]
            B = cf[3] * PU + cf[4] * PV + cf[5]
            cov = (A >= 0) & (B >= 0) & (1.0 - A - B >= 0)
            u0, u1, v0, v1 = (x[0, s:s + 256] for x in box)
            cull = torch.isfinite(u0 + u1 + v0 + v1)
            inside = ((PU >= u0) & (PU <= u1) & (PV >= v0) & (PV <= v1))
            covered += int((cov & cull).sum())
            assert not (cov & cull & ~inside).any()
        assert covered > least
